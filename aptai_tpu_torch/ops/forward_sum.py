"""ForwardSum (one-TTS-alignment) loss on the port's CTC recursion (the
JAX package's ``ops/forward_sum.py``).

Numerical contract (reference models/modules.py:65-117, ``ForwardSumLoss``):

1. a blank *column* at text index 0 scored ``blank_logprob`` (−1 in the
   reference);
2. per item, the scores restricted to ``[mel_len, text_len + 1]`` and
   re-``log_softmax``-ed over the text axis. Here, as in the JAX package,
   the columns past ``text_len`` are set to the finite ``LOG_EPSILON`` =
   −1e5 before the softmax (exp(−1e5) is exactly 0 in float32, so the
   normalisation is the same) and the rows past ``mel_len`` are left to the
   recursion, which stops at each item's length;
3. CTC with the monotonic targets ``1..text_len``
   (:func:`aptai_tpu_torch.ops.ctc.ctc_forward_score`);
4. ``zero_infinity``: an item whose loss is ≥ −0.5·LOG_EPSILON (infeasible:
   fewer frames than tokens) counts 0 with gradient 0, cut *before* the
   division by max(text_len, 1); then the batch mean.

``F.ctc_loss`` is not used: its numerics differ on infeasible and nearly
infeasible items.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aptai_tpu_torch.ops.ctc import LOG_EPSILON, ctc_forward_score


def off_diag_prior_logprobs(t_mel: int, n_text: int,
                            text_lengths: torch.Tensor,
                            mel_lengths: torch.Tensor,
                            g: float = 0.2) -> torch.Tensor:
    """The reference's off-diagonal Gaussian band prior (shipped disabled
    there, models/modules.py:119-126), batched over padded shapes: per
    item, with N = text_len + 1 columns (blank included) and T = mel_len
    rows, ``W[t, n] = exp(−(n/N − t/T)² / (2g²))``, log-softmax-ed over the
    valid columns (the others masked to ``LOG_EPSILON``).

    Returns ``(B, t_mel, n_text + 1)`` float32 log-prior to add to the
    scores before the loss's own normalisation."""
    dev = text_lengths.device
    text_lengths = text_lengths.float()
    mel_lengths = mel_lengths.to(dev).float()
    cols = torch.arange(n_text + 1, device=dev)
    n_norm = cols.float()[None, None, :] / (text_lengths + 1.0)[:, None, None]
    t_norm = (torch.arange(t_mel, device=dev).float()[None, :, None]
              / mel_lengths.clamp(min=1.0)[:, None, None])
    w = torch.exp(-((n_norm - t_norm) ** 2) / (2.0 * g * g))
    col_valid = cols[None, None, :] <= text_lengths[:, None, None]
    w = torch.where(col_valid, w, torch.full_like(w, LOG_EPSILON))
    return F.log_softmax(w, dim=-1)


def forward_sum_loss(attn_logprob: torch.Tensor, text_lengths: torch.Tensor,
                     mel_lengths: torch.Tensor, blank_logprob: float = -1.0,
                     off_diag_prior: bool = False,
                     prior_g: float = 0.2) -> torch.Tensor:
    """The scalar ForwardSum loss (batch mean).

    ``attn_logprob`` (B, T_mel, N_text) attention scores (any additive
    scores: they are re-normalised); ``text_lengths`` (B,) phoneme-sequence
    lengths; ``mel_lengths`` (B,) frame counts; ``blank_logprob`` the
    blank column's score; ``off_diag_prior`` adds
    :func:`off_diag_prior_logprobs` of width ``prior_g`` to the scores."""
    b, t_mel, n_text = attn_logprob.shape
    dev = attn_logprob.device
    text_lengths = text_lengths.to(dev, torch.int64)
    mel_lengths = mel_lengths.to(dev, torch.int64)

    scores = F.pad(attn_logprob.float(), (1, 0), value=blank_logprob)
    if off_diag_prior:
        scores = scores + off_diag_prior_logprobs(
            t_mel, n_text, text_lengths, mel_lengths, g=prior_g)
    col_valid = (torch.arange(n_text + 1, device=dev)[None, None, :]
                 <= text_lengths[:, None, None])
    scores = torch.where(col_valid, scores,
                         torch.full_like(scores, LOG_EPSILON))
    log_probs = F.log_softmax(scores, dim=-1)

    targets = torch.arange(1, n_text + 1, device=dev)[None, :].expand(b, -1)
    nll = -ctc_forward_score(log_probs, mel_lengths, targets, text_lengths,
                             blank=0)
    nll = torch.where(nll >= -0.5 * LOG_EPSILON, torch.zeros_like(nll), nll)
    return (nll / text_lengths.clamp(min=1).to(nll.dtype)).mean()
