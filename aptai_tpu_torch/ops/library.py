"""The package's ``torch.library`` ops, in one namespace (``aptai_torch::``).

Each hand-written kernel is reached through a custom op with three
implementations: ``CUDA`` launches the kernel (its ``*_cuda`` wrapper, which
counts the launch), ``CPU`` runs the kernel's plain version, and the fake
implementation gives the outputs' shapes, dtypes and strides, so that
``torch.export`` traces the op as one opaque call instead of the ctypes
launch or the plain version's tensor ops. An exported program runs the same
Python implementations, so its kernels count their launches too.

Two more ops make FORCE-APTAI's serving path traceable: the packed BiLSTM
and the device beam search, whose host reads (the lengths for packing, the
longest input for the frame loop) cannot be traced. They have one
implementation for every device.

The ops are registered when their modules are imported: ``ops/attention.py``
(``flash_fwd``, ``flash_fwd_lse``, ``flash_bwd_dq``, ``flash_bwd_dkv``),
``ops/fused_conv.py`` (``fused_conv_ln_gelu``), ``ops/lstm.py``
(``packed_lstm``) and ``decode/device.py`` (``beam_decode``).
A program that holds them loads only after those modules are imported
(``infer/export.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

NAMESPACE = "aptai_torch"


def define(name: str, schema: str, fake: Callable, *,
           cuda: Optional[Callable] = None, cpu: Optional[Callable] = None,
           any_device: Optional[Callable] = None):
    """Register ``aptai_torch::<name>`` with ``schema`` (no argument
    mutated) and its fake implementation, and either a ``cuda`` and a
    ``cpu`` implementation or one for ``any_device``. Returns the op."""
    qualname = f"{NAMESPACE}::{name}"
    if any_device is not None:
        op = torch.library.custom_op(qualname, any_device, mutates_args=(),
                                     schema=schema)
    else:
        op = torch.library.custom_op(qualname, cuda, mutates_args=(),
                                     device_types="cuda", schema=schema)
        op.register_kernel("cpu")(cpu)
    op.register_fake(fake)
    return op

