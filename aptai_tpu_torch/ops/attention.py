"""Length-masked multi-head attention over (B, H, T, D), forward and backward.

:func:`multi_head_attention_bhtd` is the op the encoder calls:

* a CUDA tensor goes to the hand-written Hopper kernels: the flash forward
  (``csrc/flash_attn_fwd.cu``, :func:`flash_attention_bhtd_cuda`) and, when
  a gradient is needed, the dq and dk/dv backward kernels
  (``csrc/flash_attn_bwd.cu``, :func:`flash_attention_bwd_cuda`);
* a CPU tensor goes to :func:`flash_attention_bhtd_plain` and
  :func:`flash_attention_bhtd_bwd_plain`, the same functions in ordinary
  tensor ops;
* any other device raises.

Forward and backward are tied by :class:`FlashAttention`, a
``torch.autograd.Function`` that saves q, k, v, the output, the per-row
logsumexp and the lengths, like the JAX package's ``_mha_bhtd_flash``
custom VJP. Without a gradient the forward runs alone and writes no
logsumexp.

All versions compute the TPU flash kernels' functions: f32 scores with the
1/√D scale applied after the dot, keys at ``col >= lengths[b]`` masked,
softmax probabilities rounded to the input dtype before the product with V,
the division by the row sum after it, and **0** for a row with no valid key
(whose logsumexp is +∞, and whose gradients are exactly 0). Query rows past
``lengths[b]`` are computed like any other row. The backward recomputes
p = exp(s − lse) with keys masked by column index, ds = p ⊙ (dO·Vᵀ − Δ)
rounded to the input dtype before its products, dv = pᵀ·dO with p rounded,
dq = scale·ds·K and dk = scale·dsᵀ·Q, where Δ = rowsum(dO ⊙ O) in float32
over the saved output. The JAX package computes Δ outside its kernels; here
the dq kernel computes it for its own rows and writes it out for the dk/dv
kernel (:func:`flash_attention_bwd_dq_plain` is that kernel's function,
:func:`flash_attention_bwd_dkv_plain` the other's).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from aptai_tpu_torch.ops.kernels import kernel_fn, launch

HEAD_DIM = 64  # the only head width the kernels are built for


def _lengths_or_full(lengths: Optional[torch.Tensor], b: int, t: int,
                     device) -> torch.Tensor:
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    return lengths


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype: float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _key_valid(lengths: torch.Tensor, t: int, device) -> torch.Tensor:
    """(B, 1, 1, T) bool: key column < the item's length."""
    valid = (torch.arange(t, device=device)[None, :]
             < lengths.to(device).clamp(max=t)[:, None])
    return valid[:, None, None, :]


def flash_attention_bhtd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               lengths: Optional[torch.Tensor] = None,
                               return_lse: bool = False):
    """The forward kernel's function in plain tensor ops. q, k, v:
    (B, H, T, D); lengths: (B,) integer key lengths (None = all T). Returns
    (B, H, T, D) in the input dtype and, with ``return_lse``, the per-row
    logsumexp (B, H, T) in float32 (+∞ for a row with no valid key)."""
    b, _, t, d = q.shape
    acc = _acc_dtype(q.dtype)
    lengths = _lengths_or_full(lengths, b, t, q.device)
    # bf16 products are exact in f32, so f32 operands give the kernel's
    # "input-dtype dot with f32 accumulation"
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (d ** -0.5)
    s = s.masked_fill(~_key_valid(lengths, t, q.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)  # no valid key
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q.dtype).to(acc), v.to(acc))
    out = (out / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0, torch.full_like(l, float("inf")),
                      m + torch.log(l))[..., 0]
    return out, lse.to(acc)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ⊙ O) over the head dim, in float32 (float64 for
    float64 inputs): (B, H, T)."""
    acc = _acc_dtype(out.dtype)
    return (dout.to(acc) * out.to(acc)).sum(dim=-1)


def _bwd_probs(q, k, v, dout, lse, delta, lengths):
    """p = exp(s − lse) with keys masked (in the accumulation dtype) and
    ds = p ⊙ (dO·Vᵀ − Δ) rounded to the input dtype, both (B, H, T, T)."""
    b, _, t, d = q.shape
    acc = _acc_dtype(q.dtype)
    lengths = _lengths_or_full(lengths, b, t, q.device)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (d ** -0.5)
    p = torch.exp(s - lse.to(acc)[..., None])
    p = p.masked_fill(~_key_valid(lengths, t, q.device), 0.0)
    dp = torch.matmul(dout.to(acc), v.to(acc).transpose(-1, -2))
    ds = (p * (dp - delta.to(acc)[..., None])).to(q.dtype).to(acc)
    return p, ds


def flash_attention_bwd_dq_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, dout: torch.Tensor,
                                 lengths: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel's function in plain tensor ops: (dq in the input
    dtype, Δ = :func:`attention_delta` (B, H, T)) from the forward's inputs,
    its output ``out`` and logsumexp ``lse``, and the output gradient."""
    delta = attention_delta(out, dout)
    _, ds = _bwd_probs(q, k, v, dout, lse, delta, lengths)
    dq = torch.matmul(ds, k.to(ds.dtype)) * (q.shape[-1] ** -0.5)
    return dq.to(q.dtype), delta


def flash_attention_bwd_dkv_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, dout: torch.Tensor,
                                  lse: torch.Tensor, delta: torch.Tensor,
                                  lengths: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain tensor ops: (dk, dv) in the
    input dtype, given Δ as the dq kernel returns it."""
    p, ds = _bwd_probs(q, k, v, dout, lse, delta, lengths)
    acc = ds.dtype
    dv = torch.matmul(p.to(q.dtype).to(acc).transpose(-1, -2), dout.to(acc))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * (q.shape[-1] ** -0.5)
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bhtd_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   lse: torch.Tensor, dout: torch.Tensor,
                                   lengths: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The backward kernels' function in plain tensor ops: (dq, dk, dv) in
    the input dtype from the forward's inputs, its output ``out`` and its
    logsumexp ``lse`` (B, H, T), and the output gradient ``dout``."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, lengths)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, lengths)
    return dq, dk, dv


# -- the CUDA kernels ----------------------------------------------------------

# each kernel's C entry point per input dtype, and its ctypes signature
_FWD_FNS = {torch.bfloat16: "aptai_flash_attn_fwd_bf16",
            torch.float32: "aptai_flash_attn_fwd_f32"}
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
_DQ_FNS = {torch.bfloat16: "aptai_flash_attn_bwd_dq_bf16",
           torch.float32: "aptai_flash_attn_bwd_dq_f32"}
_DKV_FNS = {torch.bfloat16: "aptai_flash_attn_bwd_dkv_bf16",
            torch.float32: "aptai_flash_attn_bwd_dkv_f32"}
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 21 + [ctypes.c_float, ctypes.c_void_p])


def _check_kernel_inputs(lengths, **tensors):
    """Shape, dtype, stride, alignment and device checks shared by the
    kernels' wrappers: every tensor (B, H, T, 64) of one dtype on one CUDA
    device with a contiguous head dim."""
    names = list(tensors)
    q = tensors[names[0]]
    if q.dim() != 4 or any(x.shape != q.shape for x in tensors.values()):
        raise ValueError(
            ", ".join(names) + " must share one (B, H, T, D) shape, got "
            + ", ".join(str(tuple(x.shape)) for x in tensors.values()))
    if q.dtype not in _FWD_FNS or any(x.dtype != q.dtype
                                      for x in tensors.values()):
        raise TypeError(
            "the flash-attention kernels take bfloat16 or float32 inputs of "
            "one dtype (got " + ", ".join(str(x.dtype)
                                          for x in tensors.values()) + ")")
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the flash-attention kernels are built for head "
                         f"dim {HEAD_DIM}, got {d}")
    if b == 0 or h == 0 or t == 0:
        raise ValueError(f"empty attention problem {tuple(q.shape)}")
    vec = 16 // q.element_size()  # the kernels move rows in 16-byte pieces
    for name, x in tensors.items():
        if not _kernel_strides_ok(x):
            raise ValueError(
                f"{name} needs a contiguous head dim, batch/head/time "
                f"strides that are multiples of {vec} and a 16-byte aligned "
                f"start (strides {x.stride()})")
    if not all(x.is_cuda and x.device == q.device for x in tensors.values()):
        raise ValueError(
            "the flash-attention kernels need " + ", ".join(names)
            + " on one CUDA device (got "
            + ", ".join(str(x.device) for x in tensors.values()) + ")")
    if (lengths.dtype != torch.int32 or lengths.device != q.device
            or lengths.shape != (b,) or not lengths.is_contiguous()):
        raise ValueError(
            f"lengths must be a contiguous ({b},) int32 tensor on {q.device} "
            f"(got {tuple(lengths.shape)} {lengths.dtype} on "
            f"{lengths.device})")


def _kernel_strides_ok(x: torch.Tensor) -> bool:
    vec = 16 // x.element_size()
    return (x.stride(-1) == 1 and not any(s % vec for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _bthd_buffer_like(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """An empty (B, T, H, D) buffer viewed as (B, H, T, D), the layout the
    projections read without a copy."""
    b, h, t, d = x.shape
    return torch.empty((b, t, h, d), dtype=dtype or x.dtype,
                       device=x.device).permute(0, 2, 1, 3)


def flash_attention_bhtd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              lengths: Optional[torch.Tensor] = None,
                              return_lse: bool = False):
    """Launch the Hopper flash-attention forward on the current stream.

    q, k, v: bf16 (the tensor-core kernel) or float32 (a scalar variant)
    (B, H, T, 64) CUDA tensors whose head dim is contiguous
    (other strides free, e.g. a permuted (B, T, H, D) projection output);
    lengths: (B,) int32 on the same device. Returns a (B, H, T, 64) view of
    a (B, T, H, 64) buffer, which the output projection reads without a
    copy, and with ``return_lse`` also the per-row logsumexp, a contiguous
    (B, H, T) float32 tensor (+∞ for a row with no valid key). Raises on
    inputs the kernel does not take, and if the launch fails; it never
    falls back to another implementation.
    """
    b, h, t, d = q.shape
    lengths = _lengths_or_full(lengths, b, t, q.device)
    _check_kernel_inputs(lengths, q=q, k=k, v=v)
    o = _bthd_buffer_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = kernel_fn("flash_attn_fwd", _FWD_FNS[q.dtype], _FWD_ARGTYPES)
    launch(fn, "flash_attn_fwd", q.device, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if lse is None else lse.data_ptr(), lengths.data_ptr(), b, h, t, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        d ** -0.5))
    flash_attention_bhtd_cuda.launches += 1
    return (o, lse) if return_lse else o


flash_attention_bhtd_cuda.launches = 0  # kernel launches, for run checks


def _check_rows(q, **rows):
    """lse and delta: contiguous (B, H, T) float32 on q's device."""
    b, h, t, _ = q.shape
    for name, x in rows.items():
        if (x.dtype != torch.float32 or x.shape != (b, h, t)
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name} must be a contiguous ({b}, {h}, {t}) "
                             f"float32 tensor on {q.device} (got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device})")


def _bwd_args(q, k, v, dout, o, lse, delta, lengths, out_a, out_b):
    b, h, t, d = q.shape
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            0 if o is None else o.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), lengths.data_ptr(), out_a.data_ptr(),
            0 if out_b is None else out_b.data_ptr()]
    strides = [s for x in (q, k, v, dout, q if o is None else o, out_a,
                           out_a if out_b is None else out_b)
               for s in x.stride()[:3]]
    return (*ptrs, b, h, t, d, *strides, d ** -0.5)


def flash_attention_bwd_dq_cuda(q, k, v, out, lse, dout,
                                lengths: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dq kernel: Δ = rowsum(dO ⊙ O) for its rows, then
    dq = scale·(p ⊙ (dO·Vᵀ − Δ))·K, one block per (b·h, 64-query tile)
    looping over the key tiles below ``lengths[b]``. q, k, v, the forward's
    output ``out`` and ``dout`` as the forward takes its inputs; lse
    (B, H, T) float32. Returns (dq, Δ): dq a (B, H, T, 64) view of a
    (B, T, H, 64) buffer, Δ a contiguous (B, H, T) float32 tensor for
    :func:`flash_attention_bwd_dkv_cuda`."""
    b, h, t, _ = q.shape
    lengths = _lengths_or_full(lengths, b, t, q.device)
    _check_kernel_inputs(lengths, q=q, k=k, v=v, out=out, dout=dout)
    _check_rows(q, lse=lse)
    dq = _bthd_buffer_like(q)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = kernel_fn("flash_attn_bwd", _DQ_FNS[q.dtype], _BWD_ARGTYPES)
    launch(fn, "flash_attn_bwd_dq", q.device,
           _bwd_args(q, k, v, dout, out, lse, delta, lengths, dq, None))
    flash_attention_bwd_dq_cuda.launches += 1
    return dq, delta


flash_attention_bwd_dq_cuda.launches = 0


def flash_attention_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                 lengths: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel: dv = pᵀ·dO, dk = scale·dsᵀ·Q, one block per
    (b·h, 64-key tile) looping over every query tile; key tiles wholly
    past ``lengths[b]`` write zeros. ``delta`` is the Δ that the dq kernel
    returns (enqueue this launch after it). No atomics: each key's sums are
    taken by one block, in one order. Returns (dk, dv), each a (B, H, T, 64)
    view of a (B, T, H, 64) buffer."""
    b, _, t, _ = q.shape
    lengths = _lengths_or_full(lengths, b, t, q.device)
    _check_kernel_inputs(lengths, q=q, k=k, v=v, dout=dout)
    _check_rows(q, lse=lse, delta=delta)
    dk, dv = _bthd_buffer_like(k), _bthd_buffer_like(v)
    fn = kernel_fn("flash_attn_bwd", _DKV_FNS[q.dtype], _BWD_ARGTYPES)
    launch(fn, "flash_attn_bwd_dkv", q.device,
           _bwd_args(q, k, v, dout, None, lse, delta, lengths, dk, dv))
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                             lengths: Optional[torch.Tensor] = None):
    """The backward on the card: the dq kernel (which computes Δ) and then
    the dk/dv kernel. ``dout`` may come with any strides: one whose head dim
    is not contiguous, or whose other strides are not multiples of 16
    bytes, is copied with ``.contiguous()`` first. Returns (dq, dk, dv),
    (B, H, T, 64) views of (B, T, H, 64) buffers."""
    if not _kernel_strides_ok(dout):
        dout = dout.contiguous()
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, out, lse, dout, lengths)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, dout, lse, delta, lengths)
    return dq, dk, dv


# -- dispatch ------------------------------------------------------------------

def _impls(device: torch.device):
    """(forward, backward) for a tensor's device: the kernels on a CUDA
    tensor, the plain versions on a CPU tensor."""
    if device.type == "cuda":
        return flash_attention_bhtd_cuda, flash_attention_bwd_cuda
    if device.type == "cpu":
        return flash_attention_bhtd_plain, flash_attention_bhtd_bwd_plain
    raise ValueError(f"no attention implementation for device {device}")


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward: the forward saves q, k, v, its
    output, the per-row logsumexp and the lengths; the backward runs the
    dq and dk/dv kernels (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths):
        fwd, _ = _impls(q.device)
        lengths = _lengths_or_full(lengths, q.shape[0], q.shape[2], q.device)
        out, lse = fwd(q, k, v, lengths, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        _, bwd = _impls(q.device)
        dq, dk, dv = bwd(q, k, v, out, lse, dout, lengths)
        return dq, dk, dv, None


def multi_head_attention_bhtd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              lengths: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Length-masked scaled-dot-product MHA over (B, H, T, D) tensors: the
    Hopper kernels for a CUDA tensor, the plain versions for a CPU tensor.
    Differentiable in q, k, v through :class:`FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, lengths)
    fwd, _ = _impls(q.device)
    return fwd(q, k, v, lengths)
