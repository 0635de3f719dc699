"""Inputs from the seed: utterance lengths, waveforms, labels.

Every seed gets the same set of sizes in another order: lengths are the
stratified quantiles of the workload's uniform range, permuted by the seed,
so runs of different seeds do the same work. Waveform samples and labels
are drawn from the seed.
"""

from __future__ import annotations

from typing import List

import numpy as np

SAMPLE_RATE = 16_000
BUCKET = SAMPLE_RATE  # the program pads audio to whole seconds


def stratified_lengths(n: int, lo_s: float, hi_s: float,
                       rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths in samples, the midpoints of ``n`` equal strata of
    [lo_s, hi_s] seconds, in the seed's order."""
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(np.round((lo_s + (hi_s - lo_s) * q)
                                    * SAMPLE_RATE).astype(np.int64))


def waveforms(lengths: np.ndarray, rng: np.random.Generator
              ) -> List[np.ndarray]:
    """Gaussian noise at a speech-like level (std 0.1), one float32 array an
    utterance, drawn in one call."""
    flat = (rng.standard_normal(int(lengths.sum()), dtype=np.float32)
            * np.float32(0.1))
    return np.split(flat, np.cumsum(lengths)[:-1])


def bucket(samples: int) -> int:
    """The padded width of a batch whose longest item has ``samples``."""
    return max(-(-samples // BUCKET) * BUCKET, BUCKET)


def padded(wavs: List[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(wavs), width), np.float32)
    for i, w in enumerate(wavs):
        out[i, :len(w)] = w
    return out
