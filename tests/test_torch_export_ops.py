"""The ``aptai_torch`` custom ops that the serving bundles hold, float32 on
the CPU: ``torch.library.opcheck`` on every op's CPU implementation (the
four kernels' and FORCE-APTAI's two serving ops): schema, fake shapes,
dtypes and strides against the real outputs; the CPU implementations
return the plain versions' values in the kernels' output layout; a FORCE
bundle (every serving op) loads and runs in a fresh process that imports
the ops' modules and no model code.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aptai_tpu_torch.decode.device import beam_decode
from aptai_tpu_torch.ops import attention as tatt
from aptai_tpu_torch.ops.fused_conv import fused_conv_ln_gelu_op
from aptai_tpu_torch.ops.lstm import packed_lstm

from _torch_port import one_torch_thread
from _torch_export_bundles import bundles, models

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


# -- the ops -------------------------------------------------------------------

def _op_cases():
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v, dout = (t(2, 2, 9, 64) for _ in range(4))
    lens = torch.tensor([9, 4], dtype=torch.int32)
    out, lse = tatt.flash_fwd_lse(q, k, v, lens)
    _, delta = tatt.flash_bwd_dq(q, k, v, out, lse, dout, lens)
    h = 4
    weights = [t(4 * h, 5), t(4 * h, h), t(4 * h), t(4 * h)] * 2
    log_probs = torch.log_softmax(t(2, 12, 6) * 3, dim=-1)
    return {
        "flash_fwd": (tatt.flash_fwd, (q, k, v, lens)),
        "flash_fwd_lse": (tatt.flash_fwd_lse, (q, k, v, lens)),
        "flash_bwd_dq": (tatt.flash_bwd_dq, (q, k, v, out, lse, dout, lens)),
        "flash_bwd_dkv": (tatt.flash_bwd_dkv,
                          (q, k, v, dout, lse, delta, lens)),
        "fused_conv_ln_gelu": (fused_conv_ln_gelu_op, (
            t(2, 21, 64), t(128, 3, 64), t(128), t(128), t(128), 2, 1e-5)),
        "packed_lstm": (packed_lstm, (
            t(3, 7, 5), torch.tensor([7, 3, 0], dtype=torch.int32), weights,
            True)),
        "beam_decode": (beam_decode, (log_probs, torch.tensor([12, 7]), 0,
                                      10, 50.0, 8)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_opcheck_on_every_op(name):
    op, args = _op_cases()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_ops_give_the_plain_versions_in_the_kernel_layout():
    """The CPU implementations return the plain versions' values in the
    kernels' output layout: (B, H, T, D) views of (B, T, H, D) buffers."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 9, 64)).astype(
        np.float32)) for _ in range(3))
    lens = torch.tensor([9, 5], dtype=torch.int32)
    out, lse = tatt.flash_fwd_lse(q, k, v, lens)
    want, want_lse = tatt.flash_attention_bhtd_plain(q, k, v, lens,
                                                     return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert out.transpose(1, 2).is_contiguous() and lse.is_contiguous()


_FRESH_LOAD = """
import sys
import numpy as np
from aptai_tpu_torch.infer.export import load_serving_bundle
b = load_serving_bundle(sys.argv[1], device="cpu")
out = b.predict_batch([np.zeros(4000, np.float32)])
print("FIELDS", sorted(out))
print("MODELS", sorted(m for m in sys.modules if m.startswith(
    ("aptai_tpu_torch.models", "aptai_tpu_torch.train",
     "aptai_tpu_torch.infer.loader", "aptai_tpu_torch.infer.api", "jax"))))
"""


def test_bundle_loads_without_the_model_code(bundles):
    """A fresh process loads and runs a FORCE bundle (every serving op)
    importing the ops' modules only: no model, trainer or loader module."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run(
        [sys.executable, "-c", _FRESH_LOAD,
         str(bundles["force_beam_device"][0])], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "MODELS []" in res.stdout, res.stdout
    assert "'pred_ctc_phn_seq'" in res.stdout, res.stdout
