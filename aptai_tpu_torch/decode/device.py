"""Batched CTC prefix beam search on the device (the JAX package's
``decode/device.py``).

The same Graves-style prefix search as the host decoder
(:mod:`aptai_tpu_torch.decode.beam`: ``beam_size=10``,
``beam_threshold=50``, hypotheses that share a collapsed prefix merged by
log-sum-exp), as a loop over frames of batched tensor ops on the input's
device: no host round trip per utterance, the whole batch in each op.

Prefix merging without hashing: beam prefixes are pairwise distinct, so
the only collision after extending every prefix by every token is the
"stay" candidate of prefix *i* against the "extend" candidate of a parent
*j* with ``prefix_i == prefix_j + [last_i]``. That relation is a
(beam × beam) masked comparison each frame.

Order of the top-k: the JAX search takes ``lax.top_k``, which puts the
lower index first among equal scores; ``torch.topk`` promises no order.
The search here sorts stably, descending, and takes the first K, which is
the same order. The emission times of merged hypotheses follow the host
decoder's dict insertion order, which is the slot order.

Numerics: scores accumulate in float32 (the host decoder uses float64);
the decoded sequences agree exactly on realistic posteriors. Past
``max_output_length`` prefixes keep counting length (so ``truncated``
matches the host contract) but store no tokens, and the repeat/doubling
distinction reads the last stored token, so scores are exact only while
sequences fit the cap.

:data:`beam_decode` is the search as the ``torch.library`` op
``aptai_torch::beam_decode`` (``ops/library.py``), one implementation for
every device, at a fixed output width: its frame loop reads the longest
input on the host, which ``torch.export`` cannot trace, so a program that
decodes with the beam (FORCE-APTAI's ``beam_device`` serving) holds the op
as one opaque call.
"""

from __future__ import annotations

from typing import Optional

import torch

from aptai_tpu_torch.ops.library import define

# dead-hypothesis score: far below any real log-prob sum, finite so the
# log-sum-exps stay free of NaN
NEG = -1.0e30


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, k], ...]`` for x (B, K, ...) and idx (B, K')."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(idx.shape[:2] + x.shape[2:]))


def beam_decode_device(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                       blank: int = 0, beam_size: int = 10,
                       beam_threshold: float = 50.0,
                       max_output_length: Optional[int] = None,
                       return_times: bool = False):
    """Batched CTC prefix beam search on ``log_probs``' device.

    The padded contract of :func:`aptai_tpu_torch.decode.beam.
    beam_decode_padded`: ``(seqs (B, L) int32 padded with 0, lengths (B,)
    int32, truncated (B,) int32)``, with ``return_times`` a fourth
    ``(B, L)`` int32 tensor of each token's emission frame (the host
    decoder's ``timesteps``).

    Args:
      log_probs: ``(B, T, V)`` log-softmax scores (cast to float32).
      input_lengths: ``(B,)`` valid frame counts; later frames change
        nothing (the loop stops at the longest).
      max_output_length: the output width ``L`` (``T`` when None, under
        which nothing is truncated).
    """
    lp = log_probs.float()
    dev = lp.device
    b, t_max, vocab = lp.shape
    k = beam_size
    cap = t_max if max_output_length is None else int(max_output_length)
    lengths = torch.as_tensor(input_lengths, device=dev).to(torch.int64)
    pos = torch.arange(cap, device=dev)
    vids = torch.arange(vocab, device=dev)
    slots = torch.arange(k, device=dev)
    neg = torch.tensor(NEG, device=dev)

    toks = torch.zeros((b, k, cap), dtype=torch.int64, device=dev)
    times = torch.zeros((b, k, cap), dtype=torch.int64, device=dev)
    lens = torch.zeros((b, k), dtype=torch.int64, device=dev)
    p_b = torch.full((b, k), NEG, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((b, k), NEG, device=dev)

    n_frames = int(lengths.max()) if b else 0
    for t in range(min(n_frames, t_max)):
        row = lp[:, t]                                          # (B, V)
        p_tot = torch.logaddexp(p_b, p_nb)                      # (B, K)
        alive = p_tot > NEG / 2
        floor = p_tot.max(dim=1, keepdim=True).values - beam_threshold
        keep = alive & (p_tot >= floor)
        # the last stored token (past the cap, the last slot)
        last = toks.gather(2, (lens - 1).clamp(0, cap - 1)[..., None])[..., 0]
        has_last = lens > 0
        row_last = row.gather(1, last)

        # stay: the prefix unchanged, through a blank or a repeat
        stay_pb = torch.where(keep, p_tot + row[:, blank:blank + 1], neg)
        rep = torch.where(keep & has_last & (p_tot + row_last >= floor),
                          p_nb + row_last, neg)

        # extend: prefix_j + [v]; v == last_j only from p_b (a doubled
        # token needs a blank between)
        base = torch.where(vids == last[..., None], p_b[..., None],
                           p_tot[..., None])                    # (B, K, V)
        gate = (keep[..., None] & (vids != blank)
                & (p_tot[..., None] + row[:, None] >= floor[..., None]))
        ext = torch.where(gate, base + row[:, None], neg)

        # merge: the extension of parent j lands on prefix i iff
        # prefix_i == prefix_j + [last_i]
        in_j = pos < lens[:, None, :, None]                     # (B,1,K,cap)
        prefix_eq = ((toks[:, :, None] == toks[:, None]) | ~in_j).all(-1)
        match = ((lens[:, :, None] == lens[:, None] + 1) & prefix_eq
                 & alive[:, :, None] & alive[:, None]
                 & has_last[:, :, None])                        # (B, Ki, Kj)
        ext_at_last = ext.gather(
            2, last[:, None].expand(b, k, k)).transpose(1, 2)   # [i, j]
        merge = torch.logsumexp(torch.where(match, ext_at_last, neg), dim=2)
        stay_nb = torch.logaddexp(rep, merge)
        # a merged prefix keeps the times of whichever of i and j ranks
        # first (the host's insertion order), j's with this frame appended
        j_of = match.to(torch.int8).argmax(dim=2)               # (B, K)
        use_j = match.any(dim=2) & (j_of < slots)
        times_j = torch.where(pos == lens.gather(1, j_of)[..., None], t,
                              _take(times, j_of))
        stay_times = torch.where(use_j[..., None], times_j, times)
        # the merged extension leaves the candidates
        kill = (match[..., None] & (vids == last[:, :, None, None])).any(1)
        ext = torch.where(kill, neg, ext).reshape(b, k * vocab)

        scores = torch.cat([torch.logaddexp(stay_pb, stay_nb), ext], dim=1)
        top = torch.sort(scores, dim=1, descending=True,
                         stable=True).indices[:, :k]
        is_stay = top < k
        pidx = torch.where(is_stay, top, (top - k) // vocab)
        vtok = torch.where(is_stay, 0, (top - k) % vocab)

        new_toks = _take(toks, pidx)
        new_times = torch.where(is_stay[..., None], _take(stay_times, pidx),
                                _take(times, pidx))
        new_lens = lens.gather(1, pidx)
        new_pb = torch.where(is_stay, stay_pb.gather(1, pidx), neg)
        new_pnb = torch.where(is_stay, stay_nb.gather(1, pidx),
                              ext.gather(1, (top - k).clamp(min=0)))
        # the extension's token at position len (stored below the cap)
        at = ((~is_stay & (new_lens < cap))[..., None]
              & (pos == new_lens.clamp(max=cap - 1)[..., None]))
        new_toks = torch.where(at, vtok[..., None], new_toks)
        new_times = torch.where(at, t, new_times)
        new_lens = new_lens + (~is_stay).to(torch.int64)

        active = (t < lengths)[:, None]
        toks = torch.where(active[..., None], new_toks, toks)
        times = torch.where(active[..., None], new_times, times)
        lens = torch.where(active, new_lens, lens)
        p_b = torch.where(active, new_pb, p_b)
        p_nb = torch.where(active, new_pnb, p_nb)

    best = torch.logaddexp(p_b, p_nb).argmax(dim=1)[:, None]   # first max
    seqs = _take(toks, best)[:, 0].to(torch.int32)
    n = lens.gather(1, best)[:, 0]
    out_lens = n.clamp(max=cap).to(torch.int32)
    truncated = (n - cap).clamp(min=0).to(torch.int32)
    if return_times:
        return seqs, out_lens, truncated, _take(times, best)[:, 0].to(
            torch.int32)
    return seqs, out_lens, truncated


def _fake_beam(log_probs, input_lengths, blank, beam_size, beam_threshold,
               max_output_length):
    b = log_probs.shape[0]
    return (log_probs.new_empty((b, max_output_length), dtype=torch.int32),
            log_probs.new_empty((b,), dtype=torch.int32),
            log_probs.new_empty((b,), dtype=torch.int32))


beam_decode = define(
    "beam_decode", "(Tensor log_probs, Tensor input_lengths, int blank, "
    "int beam_size, float beam_threshold, int max_output_length) -> "
    "(Tensor, Tensor, Tensor)", _fake_beam,
    any_device=lambda *a: beam_decode_device(*a))
