"""Length-masked multi-head attention over (B, H, T, D).

:func:`multi_head_attention_bhtd` is the op the encoder calls:

* a CUDA tensor goes to the hand-written Hopper flash-attention forward
  (``csrc/flash_attn_fwd.cu``, launched by :func:`flash_attention_bhtd_cuda`);
* a CPU tensor goes to :func:`flash_attention_bhtd_plain`, the same function
  in ordinary tensor ops;
* any other device raises.

Both compute the TPU flash kernel's function: f32 scores with the 1/√D
scale applied after the dot, keys at ``col >= lengths[b]`` masked, softmax
probabilities rounded to the input dtype before the product with V, the
division by the row sum after it, and **0** for a row with no valid key.
Query rows past ``lengths[b]`` are computed like any other row.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

HEAD_DIM = 64  # the only head width the kernel is built for


def _lengths_or_full(lengths: Optional[torch.Tensor], b: int, t: int,
                     device) -> torch.Tensor:
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    return lengths


def flash_attention_bhtd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               lengths: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The kernel's function in plain tensor ops. q, k, v: (B, H, T, D);
    lengths: (B,) integer key lengths (None = all T). Returns (B, H, T, D)
    in the input dtype."""
    b, _, t, d = q.shape
    lengths = _lengths_or_full(lengths, b, t, q.device)
    # bf16 products are exact in f32, so f32 operands give the kernel's
    # "input-dtype dot with f32 accumulation"
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)
    valid = (torch.arange(t, device=q.device)[None, :]
             < lengths.to(q.device).clamp(max=t)[:, None])  # (B, T)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)  # no valid key
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q.dtype).float(), v.float())
    return (out / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)


# the kernel's C entry point for each input dtype
_C_FNS = {torch.bfloat16: "aptai_flash_attn_fwd_bf16",
          torch.float32: "aptai_flash_attn_fwd_f32"}


def _kernel_fn(dtype: torch.dtype):
    from aptai_tpu_torch.ops import kernels

    lib = kernels.load("flash_attn_fwd")
    fn = getattr(lib, _C_FNS[dtype])  # ctypes returns one object per name
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check_kernel_inputs(q, k, v, lengths):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_bhtd_cuda needs q, k, v on one "
                         f"CUDA device (got {q.device}, {k.device}, "
                         f"{v.device})")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one (B, H, T, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _C_FNS):
        raise TypeError("the flash-attention kernel takes bfloat16 or "
                        f"float32 q, k, v of one dtype (got {q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the flash-attention kernel is built for head "
                         f"dim {HEAD_DIM}, got {d}")
    if b == 0 or h == 0 or t == 0:
        raise ValueError(f"empty attention problem {tuple(q.shape)}")
    vec = 16 // q.element_size()  # the kernel moves rows in 16-byte pieces
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(
                f"{name} needs a contiguous head dim, batch/head/time "
                f"strides that are multiples of {vec} and a 16-byte aligned "
                f"start (strides {x.stride()})")
    if (lengths.dtype != torch.int32 or lengths.device != q.device
            or lengths.shape != (b,) or not lengths.is_contiguous()):
        raise ValueError(
            f"lengths must be a contiguous ({b},) int32 tensor on {q.device} "
            f"(got {tuple(lengths.shape)} {lengths.dtype} on "
            f"{lengths.device})")


def flash_attention_bhtd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              lengths: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Launch the Hopper flash-attention forward on the current stream.

    q, k, v: bf16 (the tensor-core kernel) or float32 (a scalar variant)
    (B, H, T, 64) CUDA tensors whose head dim is contiguous
    (other strides free, e.g. a permuted (B, T, H, D) projection output);
    lengths: (B,) int32 on the same device. Returns a (B, H, T, 64) view of
    a (B, T, H, 64) buffer, which the output projection reads without a
    copy. Raises on inputs the kernel does not take, and if the launch
    fails; it never falls back to another implementation.
    """
    b, h, t, d = q.shape
    lengths = _lengths_or_full(lengths, b, t, q.device)
    _check_kernel_inputs(q, k, v, lengths)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    o = out.permute(0, 2, 1, 3)
    fn = _kernel_fn(q.dtype)
    with torch.cuda.device(q.device):  # the runtime launches on the current one
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lengths.data_ptr(), b, h, t, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], d ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error "
                           f"{rc}")
    flash_attention_bhtd_cuda.launches += 1
    return o


flash_attention_bhtd_cuda.launches = 0  # kernel launches, for run checks


def multi_head_attention_bhtd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              lengths: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Length-masked scaled-dot-product MHA over (B, H, T, D) tensors: the
    Hopper kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if q.device.type == "cuda":
        return flash_attention_bhtd_cuda(q, k, v, lengths)
    if q.device.type == "cpu":
        return flash_attention_bhtd_plain(q, k, v, lengths)
    raise ValueError(f"no attention implementation for device {q.device}")
