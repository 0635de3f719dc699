"""What a data-parallel training forward needs to know of the global batch.

Under data parallelism each process holds its rows of one global batch,
and its gradients are averaged over the data axis. Two things in a
training forward read the whole batch, and this module gives them the
global answer:

* :func:`global_mean`: a mean over the batch's valid frames (APTAI's
  masked losses). Each process returns its sum over the frame count of
  the global batch, times the number of processes, so the averaged
  gradient and the averaged value are those of the global mean;
  :func:`global_sum` likewise for a sum over the batch (CTC's
  ``reduction="sum"``);
* :func:`global_rows`: the rows a random draw is made for (SpecAugment's
  spans). Each process draws for the global batch and keeps its own rows,
  so its masks are the ones a single device draws for those rows.

The processes of the model axis hold the same rows and compute the same
loss: ``group`` is the data axis's, so the counts are summed once per data
index.

Outside :func:`data_parallel_batch` (one process, evaluation) both are
the plain single-batch forms. This module imports nothing of the package,
so the models can use it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch

_local = threading.local()


@contextlib.contextmanager
def data_parallel_batch(group, index: int, count: int):
    """Within the block this process holds rows ``[index·b, (index + 1)·b)``
    of a global batch of ``count·b`` rows, ``count`` being the size of the
    process group ``group`` (the data axis)."""
    prev = getattr(_local, "axis", None)
    _local.axis = (group, index, count)
    try:
        yield
    finally:
        _local.axis = prev


def global_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / max(count, 1)`` over the global batch, ``total`` and
    ``count`` being this process's sum and number of valid elements."""
    axis = getattr(_local, "axis", None)
    if axis is None:
        return total / count.clamp(min=1)
    group, _, n = axis
    count = count.detach().clone()
    torch.distributed.all_reduce(count, group=group)
    return total * n / count.clamp(min=1)


def global_sum(total: torch.Tensor) -> torch.Tensor:
    """The sum over the global batch, ``total`` being this process's."""
    axis = getattr(_local, "axis", None)
    return total if axis is None else total * axis[2]


def global_rows(b: int) -> Tuple[int, int]:
    """``(rows of the global batch, this process's first row)`` for a
    local batch of ``b`` rows."""
    axis = getattr(_local, "axis", None)
    if axis is None:
        return b, 0
    _, index, n = axis
    return b * n, b * index
