"""Connectionist Temporal Classification: loss and batched greedy decode.

The loss is the JAX package's log-semiring forward (alpha) recursion
(``aptai_tpu/ops/ctc.py``), a loop over time vectorised over the batch and
the extended target, differentiated by autograd. Its semantics are
``torch.nn.functional.ctc_loss(blank=0, reduction='mean',
zero_infinity=True)`` with the JAX package's numerics:

* log(0) is the finite ``LOG_EPSILON = −1e5``, so every gradient stays
  finite;
* ``zero_infinity``: an item whose loss is ≥ 5e4 (an infeasible alignment,
  e.g. a target longer than the input allows) counts 0 with gradient 0;
* ``reduction='mean'``: each item's loss is divided by max(target length, 1)
  before the batch mean; ``'sum'`` is the global batch's sum in a
  data-parallel step (``parallel/global_batch.py``).

The port does not call ``F.ctc_loss``: it differs from this on items that
are only nearly infeasible, its gradient with respect to ``log_probs`` is
the one of the softmax-fused kernel, and on the card it may go to cuDNN.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from aptai_tpu_torch.parallel.global_batch import global_sum

LOG_EPSILON = -1e5  # finite stand-in for log(0)


def ctc_forward_score(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                      targets: torch.Tensor, target_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """Per-item log-likelihood log p(targets | log_probs), shape (B,).

    ``log_probs`` (B, T, V) log-softmax scores; ``input_lengths`` (B,) valid
    frames; ``targets`` (B, S) label ids (the padding value is irrelevant);
    ``target_lengths`` (B,) valid labels."""
    b, t, _ = log_probs.shape
    s = targets.shape[1]
    dev = log_probs.device
    length = 2 * s + 1
    # extended targets [blank, y0, blank, y1, ..., blank]
    ext = torch.full((b, length), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = targets.long()
    pos = torch.arange(length, device=dev)
    prev2 = torch.cat([torch.full((b, 2), blank, dtype=torch.long,
                                  device=dev), ext[:, :-2]], dim=1)[:, :length]
    # a skip l-2 -> l for a real label that differs from the one before it
    allow_skip = (pos >= 2) & (ext != blank) & (ext != prev2)
    valid = pos[None, :] < (2 * target_lengths.long() + 1)[:, None]
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t, length))

    neg = torch.tensor(LOG_EPSILON, dtype=log_probs.dtype, device=dev)
    alpha = torch.where(pos == 0, emit[:, 0], neg)
    alpha = torch.where((pos == 1) & valid, emit[:, 0], alpha)
    in_len = input_lengths.long().to(dev)
    for step in range(1, t):
        from_prev = F.pad(alpha, (1, 0), value=LOG_EPSILON)[:, :length]
        from_skip = F.pad(alpha, (2, 0), value=LOG_EPSILON)[:, :length]
        from_skip = torch.where(allow_skip, from_skip, neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, from_prev), from_skip)
        new_alpha = torch.where(valid, merged + emit[:, step], neg)
        # the recursion stops at each item's input length
        alpha = torch.where((step < in_len)[:, None], new_alpha, alpha)

    last = 2 * target_lengths.long().to(dev)          # final blank
    second = (last - 1).clamp(min=0)                  # final label
    score_last = alpha.gather(1, last[:, None])[:, 0]
    score_second = torch.where(target_lengths.to(dev) > 0,
                               alpha.gather(1, second[:, None])[:, 0], neg)
    return torch.logaddexp(score_last, score_second)


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             targets: torch.Tensor, target_lengths: torch.Tensor,
             blank: int = 0, reduction: str = "mean",
             zero_infinity: bool = True) -> torch.Tensor:
    """CTC loss with the semantics stated in the module docstring."""
    loss = -ctc_forward_score(log_probs, input_lengths, targets,
                              target_lengths, blank=blank)
    if zero_infinity:
        # infeasible alignments surface as ~|LOG_EPSILON|-scale losses
        loss = torch.where(loss >= -0.5 * LOG_EPSILON,
                           torch.zeros_like(loss), loss)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return global_sum(loss.sum())
    if reduction == "mean":
        denom = target_lengths.to(loss.device).clamp(min=1).to(loss.dtype)
        return (loss / denom).mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def greedy_decode(logits: torch.Tensor, input_lengths: torch.Tensor,
                  blank: int = 0, max_output_length: Optional[int] = None,
                  return_truncated: bool = False):
    """Batched greedy CTC decode: argmax → collapse repeats → drop blanks.

    ``logits`` (B, T, V) (only the argmax is used); ``input_lengths`` (B,)
    valid frames. Returns ``(tokens, lengths)``: tokens (B,
    max_output_length) int32 padded with ``blank`` (``max_output_length``
    defaults to T), lengths (B,) int32; with ``return_truncated`` also the
    per-item count of tokens dropped by the cap (B,) int32."""
    b, t, _ = logits.shape
    dev = logits.device
    out_w = t if max_output_length is None else max_output_length
    ids = logits.argmax(dim=-1).to(torch.int32)                       # (B, T)
    frame_valid = (torch.arange(t, device=dev)[None, :]
                   < input_lengths.to(dev)[:, None])
    ids = torch.where(frame_valid, ids, torch.full_like(ids, blank))
    prev = F.pad(ids, (1, 0), value=-1)[:, :t]
    keep = (ids != blank) & (ids != prev) & frame_valid
    # stable compaction: a kept token goes to its prefix count; the rest
    # (and overflow past the cap) to a spill column that is cut off
    dest = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    dest = torch.where(keep & (dest < out_w), dest,
                       torch.full_like(dest, out_w))
    out = torch.full((b, out_w + 1), blank, dtype=torch.int32, device=dev)
    out.scatter_(1, dest, torch.where(dest < out_w, ids,
                                      torch.full_like(ids, blank)))
    n_kept = keep.sum(dim=1)
    lengths = n_kept.clamp(max=out_w).to(torch.int32)
    if return_truncated:
        truncated = (n_kept - out_w).clamp(min=0).to(torch.int32)
        return out[:, :out_w], lengths, truncated
    return out[:, :out_w], lengths
