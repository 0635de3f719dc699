"""Monotonic alignment (the JAX package's ``ops/align.py``):

* :func:`dtw_force_align` — frames to a phoneme sequence by the
  max-accumulated score, on the host (numpy), each frame advancing the
  phoneme index by 0 or 1;
* :func:`viterbi_align` — the same DP batched over items, as tensor ops on
  the scores' device: a forward pass over frames keeping one back-pointer
  bit per (frame, item, position), then the backtrace.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -1e30


def dtw_force_align(cost: np.ndarray, phn_ids) -> list:
    """Align frames to a phoneme sequence by max-accumulated score.

    Args:
      cost: ``(T, V)`` frame-phoneme scores (higher = better, e.g.
        log-probs).
      phn_ids: sequence of phoneme ids (length N ≤ T).

    Returns:
      list of N-relative indices, one per frame (monotonic, starts at 0,
      ends at N−1).
    """
    scores = np.asarray(cost, np.float64)[:, list(phn_ids)]  # (T, N)
    t_len, n = scores.shape
    if n > t_len:
        raise ValueError("more phonemes than frames; alignment infeasible")
    acc = np.full((t_len, n), -np.inf)
    acc[0, 0] = scores[0, 0]
    for t in range(1, t_len):
        stay = acc[t - 1]
        adv = np.concatenate([[-np.inf], acc[t - 1, :-1]])
        acc[t] = scores[t] + np.maximum(stay, adv)
    path = np.empty(t_len, np.int64)
    j = n - 1
    path[-1] = j
    for t in range(t_len - 1, 0, -1):
        if j > 0 and acc[t - 1, j - 1] >= acc[t - 1, j]:
            j -= 1
        path[t - 1] = j
    return path.tolist()


def viterbi_align(scores: torch.Tensor, text_lengths: torch.Tensor,
                  frame_lengths: torch.Tensor) -> torch.Tensor:
    """Batched monotonic Viterbi alignment.

    ``scores`` (B, T, N) frame-phoneme scores (float32), ``text_lengths``
    and ``frame_lengths`` (B,). Each valid frame gets a phoneme position
    0..text_len−1; the path advances by 0 or 1 a frame, starts at 0 and
    ends at ``text_len − 1`` at frame ``frame_len − 1``; frames at or past
    ``frame_len`` keep the end position. Returns (B, T) int32 positions on
    ``scores``' device.
    """
    b, t_len, n = scores.shape
    dev = scores.device
    text_lengths = torch.as_tensor(text_lengths, device=dev).long()
    frame_lengths = torch.as_tensor(frame_lengths, device=dev).long()
    pos = torch.arange(n, device=dev)
    neg = torch.tensor(NEG, device=dev)
    s = torch.where((pos < text_lengths[:, None])[:, None, :],
                    scores.float(), neg)
    acc = torch.where(pos == 0, s[:, 0], neg)
    pad = torch.full((b, 1), NEG, device=dev)
    # back[t] is True where the best way into (t, j) advanced from j − 1
    back = torch.zeros((t_len, b, n), dtype=torch.bool, device=dev)
    for t in range(1, t_len):
        adv = torch.cat([pad, acc[:, :-1]], dim=1)
        back[t] = adv > acc
        acc = s[:, t] + torch.maximum(acc, adv)

    j = (text_lengths - 1).clamp(min=0)
    path = torch.empty((t_len, b), dtype=torch.int64, device=dev)
    for t in range(t_len - 1, -1, -1):
        path[t] = j
        took = back[t].gather(1, j[:, None])[:, 0]
        j = torch.where(took & (t < frame_lengths), j - 1, j)
    return path.T.to(torch.int32)
