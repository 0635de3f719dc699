"""Utilities: run logging, profiling hooks, tree helpers, plotting (its
matplotlib import deferred to the call), FLOP counts and device peaks
(``utils.flops``)."""

from aptai_tpu_torch.utils.logging import RunLogger, init_logger
from aptai_tpu_torch.utils.plotting import plot_f0_wav
from aptai_tpu_torch.utils.profiling import StepTimer, trace_profile
from aptai_tpu_torch.utils.trees import param_count, tree_bytes

__all__ = [
    "RunLogger",
    "init_logger",
    "plot_f0_wav",
    "StepTimer",
    "trace_profile",
    "param_count",
    "tree_bytes",
]
