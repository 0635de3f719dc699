"""aptai_tpu_torch boundaries: no JAX at import, no silent CPU fallback, the
attention dispatch by device, and the FLOP count against the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aptai_tpu.models import configs as jcfg
from aptai_tpu.utils import flops as jflops
from aptai_tpu_torch.infer import APTAIPredictor
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_aptai
from aptai_tpu_torch.ops import attention as tatt
from aptai_tpu_torch.utils import flops as tflops

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import aptai_tpu_torch
for m in pkgutil.walk_packages(aptai_tpu_torch.__path__, "aptai_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "aptai_tpu"))
print("LOADED", len([m for m in sys.modules if m.startswith("aptai_tpu_torch")]))
print("BAD", bad)
print("TRAIN", all(m in sys.modules for m in (
    "aptai_tpu_torch.train.harness", "aptai_tpu_torch.train.schedule")))
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


def test_predictor_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = random_aptai(tcfg.tiny_config(), seed=0, num_phonemes=11)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        APTAIPredictor(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        APTAIPredictor(model, device="cuda:0")
    assert APTAIPredictor(model, device="cpu").device.type == "cpu"


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


def test_kernel_library_is_keyed_by_source_hash():
    from aptai_tpu_torch.ops import kernels

    path = kernels.library_path("flash_attn_fwd")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libflash_attn_fwd-") and path.suffix == ".so"
    assert path == kernels.library_path("flash_attn_fwd")
    assert (kernels.CSRC / "flash_attn_fwd.cu").exists()


@pytest.mark.parametrize("samples", [16_000, 48_000, 160_000])
def test_flops_match_jax(samples):
    for j, t in ((jcfg.Wav2Vec2Config(), tcfg.Wav2Vec2Config()),
                 (jcfg.tiny_config(), tcfg.tiny_config())):
        assert (tflops.aptai_forward_flops(t, samples)
                == jflops.aptai_forward_flops(j, samples))
        assert (tflops.encoder_flops(t, samples)
                == jflops.encoder_flops(j, samples))


def test_device_peak_by_card_name():
    assert tflops.device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tflops.device_peak_tflops("Some Other Card") is None
    assert tflops.mfu(10**12, 1.0, None) is None
    assert tflops.mfu(989 * 10**12, 2.0, 989.0) == pytest.approx(0.5)
