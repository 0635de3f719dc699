"""Padding helpers and the bucket widths of the JAX package's
``data/batching.py``: frame-level arrays pad to multiples of
``FRAME_BUCKET`` and label arrays to multiples of ``LABEL_BUCKET``, so
batches come in a few fixed shapes. The loaders (``BucketedLoader`` and
the datasets) wait for the data layer (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import math

import numpy as np

LABEL_BUCKET = 16
FRAME_BUCKET = 64


def _round_up(n: int, m: int) -> int:
    return max(int(math.ceil(n / m)) * m, m)


def _pad_to(x: np.ndarray, width: int, value) -> np.ndarray:
    pad = [(0, width - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=value)
