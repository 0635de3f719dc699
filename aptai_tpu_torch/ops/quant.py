"""Dynamic W8A8 int8 inference GEMMs (the JAX package's ``ops/quant.py``).

Scheme, as in the JAX package:

* activations: one max-abs scale per row (over the contracted width),
  computed on the fly;
* weights: one max-abs scale per output channel, from the float32 weight;
* the int8 × int8 product accumulated in int32, dequantized in float32 by
  the row and channel scales, then cast to the output dtype. The bias is
  the caller's to add, in that dtype.

The numerics are those of the JAX functions as the model runs them (under
``jax.jit``), so the two packages give the same codes, scales and outputs
bit for bit:

* the scale is ``max|x| · f32(1/127)``: XLA rewrites the JAX source's
  ``max|x| / 127`` into that product, which differs from the true
  quotient in the last bit for a few percent of rows;
* the codes are ``round(x / scale)`` with a true division, rounded half to
  even (``torch.round`` as ``jnp.round``), clamped to ±127;
* the dequantization keeps each JAX function's multiply order:
  ``(y · x_scale) · w_scale`` in :func:`w8a8_matmul` (the FFN's
  ``QuantDense``), ``y · (x_scale · w_scale)`` in the attention's head and
  output projections (:func:`w8a8_head_proj`, :func:`w8a8_out_proj`).

Weights are taken in ``nn.Linear``'s (N, K) layout: the JAX package's
(K, N) kernel is its transpose, and its per-column scales are the
per-row scales here. The product goes through ``torch._int_mm``
(cuBLASLt's int8 GEMM on the card; the JAX package's is an XLA
``dot_general``, not a Pallas kernel), with the weight codes passed as
the transpose of their contiguous (N, K) tensor. It needs K and N to be
multiples of 8, which :func:`int8_mm` checks on every device, and more
than 16 rows on the card, which it pads with zero rows (codes 0) and
slices off.

INFERENCE ONLY: rounding has no useful gradient. The model's quantized
layers refuse a forward that needs one (``models/wav2vec2.py``
``QuantLinear``), where the JAX package trains through ``round``'s zero
gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

QMAX = 127.0
# XLA's rewrite of ``/ 127`` under jit: a multiply by the float32 reciprocal
INV_QMAX = float(np.float32(1.0 / QMAX))
MIN_SCALE = 1e-30  # all-zero rows stay zero, not NaN
# torch._int_mm on CUDA wants more than this many rows
INT_MM_MIN_ROWS = 16


class QuantizedRows(NamedTuple):
    """An activation quantized by rows: ``codes`` (..., K) int8 and
    ``scale`` (..., 1) float32, ``codes · scale ≈ x``."""
    codes: torch.Tensor
    scale: torch.Tensor


class QuantizedWeight(NamedTuple):
    """A Linear weight quantized by output channel: ``codes`` (N, K) int8,
    contiguous, and ``scale`` (1, N) float32."""
    codes: torch.Tensor
    scale: torch.Tensor


def dynamic_quantize(x: torch.Tensor, dims: Union[int, Sequence[int]]):
    """Quantize ``x`` to int8 with one max-abs scale per slice over
    ``dims`` (the contracted dims). Returns ``(codes int8, scale float32
    with the dims kept)``, ``codes · scale ≈ x``."""
    # the max and the division in float32 without a float32 copy of x:
    # |x| and its max are exact in x's dtype, and x / scale promotes each
    # element exactly
    scale = x.abs().amax(dim=dims, keepdim=True).float() * INV_QMAX
    scale = scale.clamp_min(MIN_SCALE)
    codes = (x / scale).round_().clamp_(-QMAX, QMAX).to(torch.int8)
    return codes, scale


def quantize_rows(x: torch.Tensor) -> QuantizedRows:
    """``x`` (..., K) quantized row by row over its last dim."""
    return QuantizedRows(*dynamic_quantize(x, -1))


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """A Linear weight (N, K) quantized by output channel."""
    codes, scale = dynamic_quantize(w, 1)
    return QuantizedWeight(codes.contiguous(), scale.reshape(1, -1))


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 → (M, N) int32, exact, through
    ``torch._int_mm``. K or N not a multiple of 8 raises; M ≤ 16 is
    padded with zero rows, which are sliced off."""
    (m, k), n = a.shape, b.shape[1]
    for name, width in (("contracted width K", k), ("output width N", n)):
        if width % 8:
            raise ValueError(f"W8A8 needs the {name} to be a multiple of 8 "
                             f"(the int8 GEMM's constraint), got {width}")
    if m <= INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, INT_MM_MIN_ROWS + 1 - m))
    return torch._int_mm(a, b)[:m]


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`int8_mm`'s function as a float64 product: exact while
    K · 127² < 2⁵³, which any K of this model meets."""
    return (a.double() @ b.double()).to(torch.int32)


def w8a8_linear(x: QuantizedRows, w: QuantizedWeight,
                fold_scales: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """The quantized product ``x @ w.T`` over codes: (..., K) rows, an
    (N, K) weight → (..., N) in ``out_dtype``. ``fold_scales`` picks the
    dequantization order: ``y · (x_scale · w_scale)`` (the attention
    projections) or ``(y · x_scale) · w_scale`` (the FFN)."""
    lead, k = x.codes.shape[:-1], x.codes.shape[-1]
    y = int8_mm(x.codes.reshape(-1, k), w.codes.t())
    xs = x.scale.reshape(-1, 1)
    # the last product in float32, written in out_dtype (one rounding, as
    # a float32 product then a cast)
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    if fold_scales:
        torch.mul(xs * w.scale, y, out=out)
    else:
        torch.mul(y * xs, w.scale, out=out)
    return out.reshape(*lead, -1)


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w.T`` in int8: ``x`` (..., K), ``w`` an (N, K) weight. The
    JAX ``w8a8_matmul``'s numerics."""
    return w8a8_linear(quantize_rows(x), quantize_weight(w), False,
                       out_dtype or x.dtype)


def w8a8_head_proj(x: torch.Tensor, w: torch.Tensor, heads: int,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The attention head projection in int8: ``x`` (B, T, C), ``w`` (C,
    C) → (B, H, T, D), a view of a (B, T, H, D) buffer (the attention
    kernel's layout). The JAX ``w8a8_head_proj``'s numerics."""
    b, t, _ = x.shape
    y = w8a8_linear(quantize_rows(x), quantize_weight(w), True,
                    out_dtype or x.dtype)
    return y.view(b, t, heads, -1).transpose(1, 2)


def w8a8_out_proj(ctx: torch.Tensor, w: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The attention output projection in int8: ``ctx`` (B, H, T, D) →
    (B, T, C). Each (b, t) row is quantized over all of its heads (the JAX
    ``axes=(1, 3)``). The JAX ``w8a8_out_proj``'s numerics."""
    b, h, t, d = ctx.shape
    rows = ctx.transpose(1, 2).reshape(b, t, h * d)
    return w8a8_linear(quantize_rows(rows), quantize_weight(w), True,
                       out_dtype or ctx.dtype)
