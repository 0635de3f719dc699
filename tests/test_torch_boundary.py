"""aptai_tpu_torch boundaries: no JAX at import (nor pandas: the port reads
its manifests without it), no silent CPU fallback, the attention dispatch
by device, and the FLOP counts against the JAX package. The kernel and
native libraries' builds are in ``test_torch_kernel_builds.py``."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aptai_tpu.models import configs as jcfg
from aptai_tpu.utils import flops as jflops
from aptai_tpu_torch.infer import (APTAIPredictor, ForceAPTAIPredictor,
                                   W2V2PRPredictor)
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import (random_aptai, random_force_aptai,
                                    random_w2v2_pr)
from aptai_tpu_torch.train import TrainStep, force_loss_fn, torch_adam
from aptai_tpu_torch.ops import attention as tatt
from aptai_tpu_torch.utils import flops as tflops


REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import aptai_tpu_torch
for m in pkgutil.walk_packages(aptai_tpu_torch.__path__, "aptai_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
import compare_kernels
import compare_serving
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "aptai_tpu", "pandas", "msgpack", "wandb"))
print("LOADED", len([m for m in sys.modules if m.startswith("aptai_tpu_torch")]))
print("BAD", bad)
print("TRAIN", all(m in sys.modules for m in (
    "aptai_tpu_torch.train.harness", "aptai_tpu_torch.train.schedule")))
print("PR", all(m in sys.modules for m in (
    "aptai_tpu_torch.models.w2v2_pr", "aptai_tpu_torch.ops.ctc",
    "aptai_tpu_torch.ops.fused_conv", "aptai_tpu_torch.decode.beam",
    "aptai_tpu_torch.data.vocab")))
print("PR_TRAIN", all(m in sys.modules for m in (
    "aptai_tpu_torch.train.train_pr", "aptai_tpu_torch.train.train_aptai",
    "aptai_tpu_torch.train.evaluate", "aptai_tpu_torch.train.metrics",
    "aptai_tpu_torch.decode.native")))
print("FORCE", all(m in sys.modules for m in (
    "aptai_tpu_torch.models.force_aptai", "aptai_tpu_torch.models.modules",
    "aptai_tpu_torch.ops.lstm", "aptai_tpu_torch.ops.forward_sum",
    "aptai_tpu_torch.train.frozen_cache",
    "aptai_tpu_torch.train.train_force_aptai",
    "aptai_tpu_torch.data.batching")))
print("DATA", all(m in sys.modules for m in (
    "aptai_tpu_torch.decode.device", "aptai_tpu_torch.ops.align",
    "aptai_tpu_torch.ops.signal", "aptai_tpu_torch.data.manifest",
    "aptai_tpu_torch.data.textgrid", "aptai_tpu_torch.data.audio_io",
    "aptai_tpu_torch.data.hprc", "aptai_tpu_torch.data.hprc_prep",
    "aptai_tpu_torch.data.commonphone", "aptai_tpu_torch.data.synthetic",
    "aptai_tpu_torch.train.fe_cache")))
print("TRAINERS", all(m in sys.modules for m in (
    "aptai_tpu_torch.utils.logging", "aptai_tpu_torch.train.config",
    "aptai_tpu_torch.train.checkpoints", "aptai_tpu_torch.train.builders",
    "aptai_tpu_torch.train.loop", "aptai_tpu_torch.train.eval_cli",
    "aptai_tpu_torch.infer.loader")))
print("PARALLEL", all(m in sys.modules for m in (
    "aptai_tpu_torch.parallel.mesh", "aptai_tpu_torch.parallel.tensor",
    "aptai_tpu_torch.parallel.multihost",
    "aptai_tpu_torch.parallel.global_batch")))
print("PRETRAIN", all(m in sys.modules for m in (
    "aptai_tpu_torch.models.pretrain", "aptai_tpu_torch.train.pretrain")))
print("SERVING", all(m in sys.modules for m in (
    "aptai_tpu_torch.infer.streaming", "aptai_tpu_torch.infer.__main__",
    "aptai_tpu_torch.infer.serve", "aptai_tpu_torch.infer.native_transport",
    "aptai_tpu_torch.utils.cxx_build", "aptai_tpu_torch.infer.export",
    "aptai_tpu_torch.infer.transfer", "aptai_tpu_torch.ops.library")))
# importing builds and loads nothing
print("NATIVE_LOADED", sys.modules["aptai_tpu_torch.decode.native"]._lib
      is not None)
print("HTTP_LOADED", sys.modules["aptai_tpu_torch.infer.native_transport"]
      ._lib is not None)
"""


def test_port_imports_no_jax_or_reference_package():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert int(res.stdout.split("LOADED")[1].split()[0]) >= 10, res.stdout
    assert "TRAIN True" in res.stdout, res.stdout
    assert "PR True" in res.stdout, res.stdout
    assert "PR_TRAIN True" in res.stdout, res.stdout
    assert "FORCE True" in res.stdout, res.stdout
    assert "DATA True" in res.stdout, res.stdout
    assert "TRAINERS True" in res.stdout, res.stdout
    assert "SERVING True" in res.stdout, res.stdout
    assert "PRETRAIN True" in res.stdout, res.stdout
    assert "PARALLEL True" in res.stdout, res.stdout
    assert "NATIVE_LOADED False" in res.stdout, res.stdout
    assert "HTTP_LOADED False" in res.stdout, res.stdout


_RUN_CLIS = """
import runpy, sys
for name in ("train_pr", "train_aptai", "train_force_aptai", "eval_cli",
             "pretrain"):
    sys.argv = [name, "--help"]
    try:
        runpy.run_module("aptai_tpu_torch.train." + name, run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        assert e.code == 0, (name, e.code)
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "aptai_tpu", "pandas", "msgpack", "wandb"))
print("BAD", bad)
"""


def test_cli_entry_points_import_no_jax_msgpack_or_wandb():
    """``python -m aptai_tpu_torch.train.<cli> --help`` for the three
    trainers, the eval CLI and the pretrainer: each parses its flags, and
    none loads JAX, the JAX package, pandas, msgpack or wandb (wandb loads
    only inside ``RunLogger`` under ``--logging``)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", _RUN_CLIS], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    for flag in ("--cp_csv_path", "--hprc_csv_path", "--pr_model_path",
                 "--collapse_fallback", "--speaker", "--audio_csv_path",
                 "--gumbel_temp_decay"):
        assert flag in res.stdout, flag


_RUN_INFER_CLIS = """
import runpy, sys
for name in ("aptai_tpu_torch.infer", "aptai_tpu_torch.infer.serve",
             "aptai_tpu_torch.infer.export"):
    sys.argv = [name, "--help"]
    try:
        runpy.run_module(name, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        assert e.code == 0, (name, e.code)
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "aptai_tpu", "pandas", "msgpack", "wandb"))
print("BAD", bad)
"""


def test_inference_clis_import_no_jax():
    """``python -m aptai_tpu_torch.infer --help``, the serving CLI's and
    the export CLI's: each parses its flags without loading JAX or the JAX
    package."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", _RUN_INFER_CLIS], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    for flag in ("--task", "--transfer_dtype", "--transport",
                 "--max_stream_seconds", "--platforms"):
        assert flag in res.stdout, flag


# neither package is installed on the card's machine
_PREP_WITHOUT_OPTIONAL = r"""
import runpy, sys
sys.modules["requests"] = None
sys.modules["pysptk"] = None
import numpy as np
from aptai_tpu_torch.data import hprc_prep
t = np.arange(4000) / 16000
wav = (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32)
assert np.array_equal(hprc_prep.compute_f0_rapt(wav, "M01"),
                      hprc_prep.nccf_pitch(wav, 16000, 256, 50, 250))
try:
    hprc_prep.run_maus_alignment(".")
except ImportError as e:
    print("MAUS", e)
sys.argv = ["hprc_prep", "--help"]
try:
    runpy.run_module("aptai_tpu_torch.data.hprc_prep", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "flax", "aptai_tpu",
                                     "pandas", "requests", "pysptk"))
print("BAD", bad)
"""


def test_hprc_prep_runs_without_requests_or_pysptk():
    """With ``requests`` and ``pysptk`` absent, ``data/hprc_prep.py``
    imports, tracks F0 with its NCCF tracker, and its CLI parses its
    flags; MAUS raises naming ``requests``; neither JAX nor pandas
    loads."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", _PREP_WITHOUT_OPTIONAL],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert "MAUS the MAUS client needs the 'requests' package" in res.stdout
    for flag in ("--platform", "--norm_rate", "--run_maus", "--vocab"):
        assert flag in res.stdout, flag


@pytest.mark.parametrize("family", ["aptai", "w2v2_pr", "force_aptai"])
def test_predictor_without_cuda_raises(monkeypatch, family):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if family == "aptai":
        model = random_aptai(tcfg.tiny_config(), seed=0, num_phonemes=11)
        predictor = APTAIPredictor
    elif family == "w2v2_pr":
        model = random_w2v2_pr(tcfg.tiny_config(), seed=0)
        predictor = W2V2PRPredictor
    else:
        model = random_force_aptai(tcfg.tiny_config(), seed=0, vocab_size=11)
        predictor = ForceAPTAIPredictor
        # and the train step: no silent CPU fallback either
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrainStep(model, torch_adam(model), force_loss_fn())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predictor(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predictor(model, device="cuda:0")
    assert predictor(model, device="cpu").device.type == "cpu"


def test_attention_dispatch_by_device(monkeypatch):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 9, 64)).astype(
        np.float32)) for _ in range(3))
    lens = torch.tensor([9, 4], dtype=torch.int32)
    calls = []
    monkeypatch.setattr(tatt, "flash_attention_bhtd_plain",
                        lambda *a: calls.append("plain") or a[0])
    before = tatt.flash_attention_bhtd_cuda.launches
    tatt.multi_head_attention_bhtd(q, k, v, lens)
    assert calls == ["plain"]
    assert tatt.flash_attention_bhtd_cuda.launches == before
    meta = torch.empty((2, 2, 9, 64), device="meta")
    with pytest.raises(ValueError, match="no attention implementation"):
        tatt.multi_head_attention_bhtd(meta, meta, meta, None)
    # the kernel's wrapper refuses a CPU tensor before it builds anything
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.flash_attention_bhtd_cuda(q, k, v, lens)


@pytest.mark.parametrize("samples", [16_000, 48_000, 160_000])
def test_flops_match_jax(samples):
    for j, t in ((jcfg.Wav2Vec2Config(), tcfg.Wav2Vec2Config()),
                 (jcfg.tiny_config(), tcfg.tiny_config())):
        assert (tflops.aptai_forward_flops(t, samples)
                == jflops.aptai_forward_flops(j, samples))
        assert (tflops.encoder_flops(t, samples)
                == jflops.encoder_flops(j, samples))
        assert (tflops.pr_forward_flops(t, samples)
                == jflops.pr_forward_flops(j, samples))
        assert (tflops.pr_forward_flops(t, samples, vocab_size=7)
                == jflops.pr_forward_flops(j, samples, vocab_size=7))


def test_device_peak_by_card_name():
    assert tflops.device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tflops.device_peak_tflops("Some Other Card") is None
    assert tflops.mfu(10**12, 1.0, None) is None
    assert tflops.mfu(989 * 10**12, 2.0, 989.0) == pytest.approx(0.5)
