"""aptai_tpu_torch boundaries: no JAX at import (nor pandas: the port reads
its manifests without it), no silent CPU fallback, the attention dispatch
by device, the kernel libraries, and the FLOP counts against the JAX
package."""

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
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "aptai_tpu", "pandas"))
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
# importing builds and loads nothing
print("NATIVE_LOADED", sys.modules["aptai_tpu_torch.decode.native"]._lib
      is not None)
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
    assert "NATIVE_LOADED False" in res.stdout, res.stdout


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


@pytest.mark.parametrize("name", ["flash_attn_fwd", "flash_attn_bwd",
                                  "fused_conv_ln_gelu"])
def test_kernel_library_is_keyed_by_source_hash(name):
    from aptai_tpu_torch.ops import kernels

    path = kernels.library_path(name)
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert path == kernels.library_path(name)
    assert all((kernels.CSRC / src).exists() for src in kernels.SOURCES[name])


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


# the chip_smoke, attention, fused_conv and kernels names a comparison turn
# may use: each one existed already when this script was
# compare_attention.py, so older checkouts can be timed too
_PARENT_NAMES = {
    ("cs", "_qkv"), ("cs", "device_ms"), ("cs", "train_batch"),
    ("cs", "time_training_kernels"), ("cs", "fused_operands"),
    ("cs", "fe_input_lengths"), ("cs", "bf16_ulp"),
    ("attention", "flash_attention_bhtd_cuda"),
    ("attention", "flash_attention_bwd_cuda"),
    ("fused_conv", "fused_conv_ln_gelu_cuda"),
    ("fused_conv", "fused_conv_ln_gelu_plain"), ("kernels", "build_all")}


def test_backward_comparison_script_fits_this_checkout():
    """compare_kernels.py runs one snippet in each checkout it times: every
    chip_smoke, attention, fused_conv and kernels name the snippet uses is
    one older checkouts have too, and exists in this one; with no checkout
    to time it prints its usage."""
    import ast

    import chip_smoke
    import compare_kernels
    from aptai_tpu_torch.ops import fused_conv, kernels

    modules = {"cs": chip_smoke, "attention": tatt, "kernels": kernels,
               "fused_conv": fused_conv}
    used = {(node.value.id, node.attr)
            for node in ast.walk(ast.parse(compare_kernels._TURN))
            if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in modules}
    assert len(used) >= 10
    assert ("attention", "flash_attention_bhtd_cuda") in used
    assert ("fused_conv", "fused_conv_ln_gelu_cuda") in used
    assert used <= _PARENT_NAMES, used - _PARENT_NAMES
    assert all(hasattr(modules[m], name) for m, name in used), used
    assert compare_kernels.main([]) == 2
    assert compare_kernels.main(["--only", "fused_conv"]) == 2


@pytest.mark.parametrize("header", ["flash_attn_common.cuh",
                                    "wgmma_tiles.cuh", "tma_cluster.cuh"])
def test_header_edit_rebuilds_every_kernel(monkeypatch, tmp_path, header):
    """A library is named by its sources and every header, so an edited
    (or moved) header gives all three kernels new library paths: no stale
    build survives it."""
    import shutil

    from aptai_tpu_torch.ops import kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {name: kernels.library_path(name) for name in kernels.SOURCES}
    assert len(before) == 3 and len(set(before.values())) == 3
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    after = {name: kernels.library_path(name) for name in kernels.SOURCES}
    assert all(after[n] != before[n] for n in kernels.SOURCES), (before,
                                                                 after)


def test_native_library_builds_atomically_and_is_keyed_by_source(
        monkeypatch, tmp_path):
    """Four concurrent builds of the C++ helpers into one directory (as
    test workers do) leave one loadable library and no partial file; an
    edited source gets a new library path."""
    import ctypes
    import shutil
    import threading

    from aptai_tpu_torch.decode import native

    src = tmp_path / "aptai_native.cpp"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    out = native.library_path()
    errors = []

    def build():
        try:
            native._build(out)
        except RuntimeError as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [out.name]
    lib = ctypes.CDLL(str(out))
    assert hasattr(lib, "aptai_ctc_beam_search")
    with open(src, "a") as f:
        f.write("// edited\n")
    assert native.library_path() != out


def test_device_peak_by_card_name():
    assert tflops.device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tflops.device_peak_tflops("Some Other Card") is None
    assert tflops.mfu(10**12, 1.0, None) is None
    assert tflops.mfu(989 * 10**12, 2.0, 989.0) == pytest.approx(0.5)
