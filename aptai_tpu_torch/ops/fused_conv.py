"""Fused strided Conv1d → LayerNorm over channels → exact GELU, channels-last.

The function of the JAX package's Pallas kernel
``aptai_tpu/ops/fused_conv.py:fused_conv_ln_gelu``, for the homogeneous
mid-stack layers of the wav2vec2 feature extractor (kernel 2 or 3, stride 2,
wide channels):

    acc = Σ_j x[s·t + j, :] @ W[j]  in float32 over the inputs' values,
          + the bias (already rounded to the input dtype by the caller)
    y   = (acc − mean) · rsqrt(mean((acc − mean)²) + eps) · ln_w + ln_b
          (two-pass statistics over all C_out, float32 ln_w and ln_b)
    out = 0.5 · y · (1 + erf(y / √2)), rounded once to the input dtype

:func:`fused_conv_ln_gelu` is the op the encoder calls: a CUDA tensor goes
to the hand-written Hopper kernel (``csrc/fused_conv_ln_gelu.cu``, bf16 on
the tensor cores or a float32 scalar variant), a CPU tensor to
:func:`fused_conv_ln_gelu_plain`, any other device raises. Neither the TPU
kernel nor this one has a backward: with a gradient required the op raises.

Layouts: x (B, L, C_in) and the output (B, T_out, C_out) are channels-last,
as in the JAX package. The weight is taken in the kernel's layout
(C_out, k, C_in), :func:`kernel_weight` of an HF (C_out, C_in, k) Conv1d
weight; the JAX kernel's (k, C_in, C_out) is its transpose.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aptai_tpu_torch.ops.kernels import kernel_fn, launch

# the output widths the kernel is instantiated for (one block owns whole
# output rows, so C_out is a compile-time constant)
KERNEL_C_OUT = (128, 256, 512)


def kernel_weight(conv_weight: torch.Tensor) -> torch.Tensor:
    """An HF Conv1d weight (C_out, C_in, k) → the kernel's (C_out, k, C_in),
    contiguous: row n is output channel n's taps, each over C_in."""
    return conv_weight.permute(0, 2, 1).contiguous()


def _out_length(length: int, k: int, stride: int) -> int:
    return (length - k) // stride + 1


def fused_conv_ln_gelu_plain(x: torch.Tensor, w: torch.Tensor,
                             b: Optional[torch.Tensor], ln_w: torch.Tensor,
                             ln_b: torch.Tensor, stride: int,
                             eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in plain tensor ops. x (B, L, C_in); w
    (C_out, k, C_in); b (C_out,) or None; ln_w, ln_b (C_out,). Returns
    (B, T_out, C_out) in x's dtype."""
    bsz, length, c_in = x.shape
    c_out, k, _ = w.shape
    t_out = _out_length(length, k, stride)
    acc = torch.promote_types(x.dtype, torch.float32)
    # the k taps of output row t are the flat range x[s·t·C_in,
    # (s·t + k)·C_in): an im2col matrix of overlapping rows, read in place
    xc = x.contiguous()
    patches = xc.as_strided((bsz, t_out, k * c_in),
                            (length * c_in, stride * c_in, 1))
    # bf16 products are exact in float32, so float32 operands give the
    # kernel's "input-dtype products with float32 accumulation"
    out = torch.matmul(patches.to(acc), w.reshape(c_out, k * c_in).to(acc).t())
    if b is not None:
        out = out + b.to(acc)
    mean = out.mean(dim=-1, keepdim=True)
    var = ((out - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (out - mean) * torch.rsqrt(var + eps) * ln_w.to(acc) + ln_b.to(acc)
    return (0.5 * y * (1.0 + torch.erf(y * 2.0 ** -0.5))).to(x.dtype)


# -- the CUDA kernel -----------------------------------------------------------

_FNS = {torch.bfloat16: "aptai_fused_conv_ln_gelu_bf16",
        torch.float32: "aptai_fused_conv_ln_gelu_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])
# the reduction chunk each variant steps C_in by: 64 channels (128-byte rows
# of a TMA box) in bf16, 16 in float32
_C_IN_MULTIPLE = {torch.bfloat16: 64, torch.float32: 16}
# the bf16 kernel loads 64 rows of the im2col matrix as one TMA box that
# spans 64·stride rows of x, and a box spans at most 256
_BF16_MAX_STRIDE = 4


def _check_kernel_inputs(x, w, b, ln_w, ln_b, stride) -> None:
    """Raise on inputs the kernel does not take: dtypes, shapes, widths,
    stride, layout, then the device, so that every refusal but the last is
    reachable with CPU tensors."""
    tensors = {"x": x, "w": w, "ln_w": ln_w, "ln_b": ln_b}
    if b is not None:
        tensors["b"] = b
    if x.dtype not in _FNS or w.dtype != x.dtype or (
            b is not None and b.dtype != x.dtype):
        raise TypeError(f"the fused conv kernel takes bfloat16 or float32 x, "
                        f"with w and b of the same dtype (got x {x.dtype}, w "
                        f"{w.dtype}, b {None if b is None else b.dtype})")
    if ln_w.dtype != torch.float32 or ln_b.dtype != torch.float32:
        raise TypeError("ln_w and ln_b must be float32")
    if x.dim() != 3 or w.dim() != 3 or w.shape[2] != x.shape[2]:
        raise ValueError(f"x must be (B, L, C_in) and w (C_out, k, C_in), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    c_out, k, c_in = w.shape
    if any(t.shape != (c_out,) for n, t in tensors.items()
           if n not in ("x", "w")):
        raise ValueError(f"b, ln_w and ln_b must be ({c_out},)")
    if c_out not in KERNEL_C_OUT:
        raise ValueError(f"the fused conv kernel is built for C_out in "
                         f"{KERNEL_C_OUT}, got {c_out}")
    if c_in % _C_IN_MULTIPLE[x.dtype]:
        raise ValueError(f"C_in must be a multiple of "
                         f"{_C_IN_MULTIPLE[x.dtype]} for {x.dtype}, got {c_in}")
    if stride < 1 or x.shape[0] == 0 or x.shape[1] < k:
        raise ValueError(f"no output rows: x {tuple(x.shape)}, k {k}, stride "
                         f"{stride}")
    if x.dtype == torch.bfloat16 and stride > _BF16_MAX_STRIDE:
        raise ValueError(f"the bf16 kernel takes strides up to "
                         f"{_BF16_MAX_STRIDE}, got {stride}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous with a 16-byte "
                             f"aligned start")
    if not all(t.is_cuda and t.device == x.device for t in tensors.values()):
        raise ValueError(
            "the fused conv kernel needs every tensor on one CUDA device (got "
            + ", ".join(f"{n} on {t.device}" for n, t in tensors.items()) + ")")


def fused_conv_ln_gelu_cuda(x: torch.Tensor, w: torch.Tensor,
                            b: Optional[torch.Tensor], ln_w: torch.Tensor,
                            ln_b: torch.Tensor, stride: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream: x (B, L, C_in) and w
    (C_out, k, C_in), contiguous, both bf16 (tensor cores; C_in a multiple
    of 64, stride at most 4) or both float32 (scalar FMA; C_in a multiple of
    16); b (C_out,) of that dtype or None; ln_w, ln_b (C_out,) float32;
    C_out in :data:`KERNEL_C_OUT`. Returns a new (B, T_out, C_out)
    tensor of x's dtype. Raises on inputs the kernel does not take, and if
    the launch fails; it never falls back to another implementation."""
    _check_kernel_inputs(x, w, b, ln_w, ln_b, stride)
    bsz, length, c_in = x.shape
    c_out, k, _ = w.shape
    t_out = _out_length(length, k, stride)
    out = torch.empty((bsz, t_out, c_out), dtype=x.dtype, device=x.device)
    fn = kernel_fn("fused_conv_ln_gelu", _FNS[x.dtype], _ARGTYPES)
    launch(fn, "fused_conv_ln_gelu", x.device, (
        x.data_ptr(), w.data_ptr(), 0 if b is None else b.data_ptr(),
        ln_w.data_ptr(), ln_b.data_ptr(), out.data_ptr(), bsz, length, c_in,
        c_out, k, stride, t_out, eps))
    fused_conv_ln_gelu_cuda.launches += 1
    return out


fused_conv_ln_gelu_cuda.launches = 0  # kernel launches, for run checks


# -- dispatch ------------------------------------------------------------------

def fused_conv_ln_gelu(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor], ln_w: torch.Tensor,
                       ln_b: torch.Tensor, stride: int,
                       eps: float = 1e-5) -> torch.Tensor:
    """GELU(LayerNorm(conv_valid(x))), channels-last: the Hopper kernel for
    a CUDA tensor, the plain version for a CPU tensor. Raises
    ``NotImplementedError`` when a gradient is required: the op has no
    backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b, ln_w, ln_b)):
        raise NotImplementedError(
            "the fused conv+LayerNorm+GELU has no backward; run the feature "
            "extractor frozen or under torch.no_grad(), or leave "
            "fused_feature_extractor off to train it")
    if x.device.type == "cuda":
        return fused_conv_ln_gelu_cuda(x, w, b, ln_w, ln_b, stride, eps)
    if x.device.type == "cpu":
        return fused_conv_ln_gelu_plain(x, w, b, ln_w, ln_b, stride, eps)
    raise ValueError(f"no fused conv implementation for device {x.device}")
