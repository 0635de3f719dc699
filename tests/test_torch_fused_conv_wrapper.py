"""aptai_tpu_torch's fused conv + LayerNorm + GELU around its kernel, on the
CPU: the kernel-layout weights follow the conv's parameters, the op runs
the plain version on a CPU tensor and never launches there, and the
kernel's wrapper refuses every operand the kernel cannot take before it
reaches the device."""

import pytest
import torch

from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_w2v2_pr
from aptai_tpu_torch.ops import fused_conv as tfc

from _torch_port import FUSED_WIDE, count_fused_plain


def test_kernel_weights_follow_parameter_changes():
    """The kernel-layout weight is made once and remade when the conv's
    parameters change in place or move to another dtype."""
    cfg = tcfg.tiny_config(**FUSED_WIDE)
    block = random_w2v2_pr(cfg, seed=0).wav2vec2.feature_extractor \
        .conv_layers[1]
    x = torch.randn(1, 41, 128)
    with torch.no_grad():
        w1, _ = block._kernel_weights(torch.float32)
        assert block._kernel_weights(torch.float32)[0] is w1
        before = block.forward_channels_last(x)
        block.conv.weight.mul_(2.0)
        w2, _ = block._kernel_weights(torch.float32)
        assert w2 is not w1
        torch.testing.assert_close(w2, tfc.kernel_weight(block.conv.weight))
        assert not torch.equal(block.forward_channels_last(x), before)
        wb, bb = block._kernel_weights(torch.bfloat16)
        assert wb.dtype == bb.dtype == torch.bfloat16


def test_fused_dispatch_by_device(monkeypatch):
    x = torch.zeros((1, 9, 128))
    w = torch.zeros((128, 3, 128))
    ones, zeros = torch.ones(128), torch.zeros(128)
    calls = count_fused_plain(monkeypatch)
    before = tfc.fused_conv_ln_gelu_cuda.launches
    out = tfc.fused_conv_ln_gelu(x, w, None, ones, zeros, 2)
    assert out.shape == (1, 4, 128) and len(calls) == 1
    assert tfc.fused_conv_ln_gelu_cuda.launches == before
    with pytest.raises(ValueError, match="no fused conv implementation"):
        meta = torch.empty((1, 9, 128), device="meta")
        tfc.fused_conv_ln_gelu(meta, w.to("meta"), None, ones, zeros, 2)
    # the kernel's wrapper refuses a CPU tensor before it builds anything
    with pytest.raises(ValueError, match="CUDA device"):
        tfc.fused_conv_ln_gelu_cuda(x, w, None, ones, zeros, 2)


def _wrapper_case(case):
    """CPU operands for the kernel wrapper, valid but for ``case``."""
    bf16 = torch.bfloat16
    dt = torch.float32 if case in ("f32 C_in", "f32 stride 5") else bf16
    c_in = {"C_in 96": 96, "f32 C_in": 24}.get(case, 128)
    c_out = 192 if case == "C_out 192" else 128
    length = 2 if case == "no rows" else 33
    x = torch.zeros((2, length, c_in), dtype=dt)
    w = torch.zeros((c_out, 3, c_in),
                    dtype=torch.float32 if case == "w dtype" else dt)
    ln_w = torch.ones(c_out, dtype=bf16 if case == "ln dtype" else
                      torch.float32)
    ln_b = torch.zeros(c_out)
    if case == "x strided":
        x = torch.zeros((2, c_in, length), dtype=dt).transpose(1, 2)
    if case == "x misaligned":
        x = torch.zeros(x.numel() + 1, dtype=dt)[1:].view(x.shape)
    stride = 5 if case in ("stride 5", "f32 stride 5") else 2
    return x, w, None, ln_w, ln_b, stride


@pytest.mark.parametrize("case,error,match", [
    ("C_in 96", ValueError, "multiple of 64"),
    ("f32 C_in", ValueError, "multiple of 16"),
    ("C_out 192", ValueError, "built for C_out"),
    ("stride 5", ValueError, "strides up to 4"),
    ("w dtype", TypeError, "same dtype"),
    ("ln dtype", TypeError, "float32"),
    ("no rows", ValueError, "no output rows"),
    ("x strided", ValueError, "contiguous"),
    ("x misaligned", ValueError, "16-byte"),
    # the float32 variant takes any stride; then only the device is wrong
    ("f32 stride 5", ValueError, "CUDA device"),
    ("valid", ValueError, "CUDA device"),
])
def test_kernel_wrapper_refuses(case, error, match):
    """The wrapper checks dtypes, shapes, widths, stride and layout before
    the device, so each refusal the kernel needs is reached on the CPU."""
    before = tfc.fused_conv_ln_gelu_cuda.launches
    with pytest.raises(error, match=match):
        tfc.fused_conv_ln_gelu_cuda(*_wrapper_case(case))
    assert tfc.fused_conv_ln_gelu_cuda.launches == before
