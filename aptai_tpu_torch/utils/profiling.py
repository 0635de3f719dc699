"""Profiling hooks (the JAX package's ``utils/profiling.py``).

* :class:`StepTimer`: per-step wall-clock statistics with a warmup skip,
  for steps/s and audio-s/s. It reads the host's clock: a block that
  times work on the card synchronises inside it (``torch.cuda.
  synchronize()``, where the JAX caller blocks until ready).
* :func:`trace_profile`: a context manager around ``torch.profiler`` that
  writes a TensorBoard-loadable trace (``*.pt.trace.json``) of the block.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import torch


class StepTimer:
    def __init__(self, warmup_steps: int = 1):
        self.warmup = warmup_steps
        self.times: List[float] = []
        self._count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def p50(self) -> float:
        if not self.times:
            return float("nan")
        s = sorted(self.times)
        return s[len(s) // 2]

    def summary(self, units_per_step: float = 1.0) -> dict:
        return {
            "steps_timed": len(self.times),
            "mean_step_seconds": self.mean,
            "p50_step_seconds": self.p50,
            "throughput_per_second": (units_per_step / self.mean
                                      if self.times else float("nan")),
        }


@contextlib.contextmanager
def trace_profile(log_dir, enabled: bool = True):
    """Profile the block's CPU activity, and its CUDA activity on a machine
    with a card, into a ``tensorboard_trace_handler(log_dir)`` trace.
    ``enabled=False`` does nothing.

    Only a failure to start the profiler is caught: it prints
    "profiling unavailable" and the block runs untraced. An exception
    raised by the block itself propagates (the JAX package's version
    catches it and yields a second time, which ``contextlib`` reports as a
    ``RuntimeError``)."""
    if not enabled:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof: Optional[profile] = None
    try:
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(str(log_dir)))
        prof.start()
    except Exception as e:  # a build or machine without profiler support
        print(f"profiling unavailable ({e}); continuing without trace")
        prof = None
    if prof is None:
        yield
        return
    try:
        yield
    finally:
        prof.stop()
