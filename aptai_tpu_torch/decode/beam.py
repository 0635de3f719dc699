"""Lexicon-free CTC prefix beam search, pure Python (the JAX package's
``decode/beam.py``).

The configuration surface and output contract of
``torchaudio.models.decoder.ctc_decoder(lexicon=None, nbest=1,
beam_size=10, beam_threshold=50)``: the collapsed token sequence and the
frame at which each token was emitted. Scoring is Graves-style prefix
search, hypotheses that share a collapsed prefix merged by log-sum-exp.
:func:`decode_best`, :func:`decode_with_times` and
:func:`beam_decode_padded` call the C++ twin
(:mod:`aptai_tpu_torch.decode.native`) first, as the JAX package's
predictors and evaluator do, and this search only without its library.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from aptai_tpu_torch.decode.native import beam_search_native

NEG_INF = -math.inf


def _logadd(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(min(a, b) - m))


@dataclass
class BeamHypothesis:
    tokens: Tuple[int, ...]
    timesteps: Tuple[int, ...]
    score: float


@dataclass
class _Pref:
    times: Tuple[int, ...] = ()
    p_b: float = NEG_INF
    p_nb: float = NEG_INF


def beam_search(log_probs: np.ndarray, blank: int = 0, beam_size: int = 10,
                beam_threshold: float = 50.0,
                nbest: int = 1) -> List[BeamHypothesis]:
    """Decode one utterance. ``log_probs``: (T, V) log-softmax scores."""
    log_probs = np.asarray(log_probs, np.float64)
    t_len, vocab = log_probs.shape

    beam: Dict[Tuple[int, ...], _Pref] = {(): _Pref((), 0.0, NEG_INF)}

    for t in range(t_len):
        row = log_probs[t]
        best_total = max(_logadd(p.p_b, p.p_nb) for p in beam.values())
        nxt: Dict[Tuple[int, ...], _Pref] = {}

        def get(toks: Tuple[int, ...], times: Tuple[int, ...]) -> _Pref:
            pref = nxt.get(toks)
            if pref is None:
                pref = _Pref(times)
                nxt[toks] = pref
            return pref

        for toks, pr in beam.items():
            p_tot = _logadd(pr.p_b, pr.p_nb)
            if p_tot < best_total - beam_threshold:
                continue

            # blank extension keeps the prefix
            dst = get(toks, pr.times)
            dst.p_b = _logadd(dst.p_b, p_tot + row[blank])

            for v in range(vocab):
                if v == blank:
                    continue
                pv = row[v]
                if p_tot + pv < best_total - beam_threshold:
                    continue
                if toks and toks[-1] == v:
                    # repeat without blank: same prefix
                    dst = get(toks, pr.times)
                    dst.p_nb = _logadd(dst.p_nb, pr.p_nb + pv)
                    # after a blank: doubled token
                    ext = toks + (v,)
                    dst2 = get(ext, pr.times + (t,))
                    dst2.p_nb = _logadd(dst2.p_nb, pr.p_b + pv)
                else:
                    ext = toks + (v,)
                    dst = get(ext, pr.times + (t,))
                    dst.p_nb = _logadd(dst.p_nb, p_tot + pv)

        ranked = sorted(
            nxt.items(), key=lambda kv: _logadd(kv[1].p_b, kv[1].p_nb),
            reverse=True,
        )[:beam_size]
        beam = dict(ranked)

    out = [
        BeamHypothesis(toks, pr.times, _logadd(pr.p_b, pr.p_nb))
        for toks, pr in sorted(
            beam.items(), key=lambda kv: _logadd(kv[1].p_b, kv[1].p_nb),
            reverse=True,
        )
    ]
    return out[:nbest]


def decode_best(log_probs: np.ndarray, blank: int = 0,
                beam_size: int = 10) -> List[int]:
    """The best beam's token ids for one utterance, (T, V) log-probs: the
    C++ beam if its library loads, this module's otherwise."""
    nat = beam_search_native(log_probs, blank=blank, beam_size=beam_size)
    if nat is not None:
        return nat[0]
    return list(beam_search(log_probs, blank=blank,
                            beam_size=beam_size)[0].tokens)


def decode_with_times(log_probs: np.ndarray) -> Tuple[List[int], List[int]]:
    """The best beam's token ids and the frame at which each was emitted:
    the C++ beam if its library loads, this module's otherwise."""
    nat = beam_search_native(log_probs)
    if nat is not None:
        return nat
    hyp = beam_search(log_probs)[0]
    return list(hyp.tokens), list(hyp.timesteps)


def beam_decode_padded(log_probs, frame_lengths, max_len: int,
                       out_rows: Optional[int] = None):
    """Beam-decode a batch on the host into fixed-width padded sequences:
    the host half of FORCE-APTAI's split ``beam_host`` path.

    ``log_probs`` (B, T, V) and ``frame_lengths`` (B,), tensors (fetched
    here) or arrays. Returns ``(seqs (rows, max_len) int32, lengths (rows,)
    int32, truncated (rows,) int32)``: each item's best beam cut to
    ``max_len`` tokens (the reference's 60-token cap), the tokens cut off
    counted in ``truncated``. ``out_rows`` > B appends zero-length rows, so
    a caller whose device batch has pad rows decodes only its real rows and
    keeps the batch shape."""
    lp = _host(log_probs, np.float32)
    fl = _host(frame_lengths, np.int64)
    b = lp.shape[0]
    rows = b if out_rows is None else out_rows
    if rows < b:
        raise ValueError(f"out_rows {rows} < the {b} rows to decode")
    out = np.zeros((rows, max_len), np.int32)
    lens = np.zeros((rows,), np.int32)
    trunc = np.zeros((rows,), np.int32)
    for i in range(b):
        toks = decode_best(lp[i, :fl[i]])
        n = min(len(toks), max_len)
        out[i, :n] = toks[:n]
        lens[i] = n
        trunc[i] = max(len(toks) - max_len, 0)
    return out, lens, trunc


def _host(x, dtype) -> np.ndarray:
    """A tensor (on any device, bf16 included) or array as a numpy array
    of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, dtype)
