"""Tree helpers over nested dicts, lists and tuples of tensors (the JAX
package's ``utils/trees.py``): parameter counts, memory accounting, and the
one-pass device→host fetch of a checkpoint write.

A tree is a ``state_dict()``, an optimizer's ``state_dict()["state"]``, or
one of the weight bridge's trees (``models/convert.py``); its leaves are
tensors, numpy arrays or Python scalars, and ``None`` leaves count as empty.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch


def _leaves(tree) -> Iterator:
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def param_count(tree) -> int:
    """Elements in the tree's leaves; a sharded (FSDP) tensor counts its
    global shape, as a sharded JAX array does."""
    return sum(x.numel() if isinstance(x, torch.Tensor)
               else int(np.asarray(x).size) for x in _leaves(tree))


def tree_bytes(tree) -> int:
    """Bytes the tree's leaves hold in this process: a sharded (FSDP)
    tensor counts its local shard, which is what shows FSDP's per-rank
    saving."""
    total = 0
    for x in _leaves(tree):
        if isinstance(x, torch.Tensor):
            if _is_dtensor(x):
                x = x.to_local()
            total += x.numel() * x.element_size()
        else:
            a = np.asarray(x)
            total += a.size * a.itemsize
    return total


def fetch_pytree(tree):
    """The tree on the host, fetched in one pipelined pass.

    Every CUDA leaf is copied ``non_blocking`` into a pinned host tensor of
    its dtype, all copies queued behind the work already on its device's
    stream; then one event per device is waited on, and only then is the
    tree returned (a pinned buffer read before that wait may still be
    filling). Host tensors come back detached, and numpy arrays and Python
    scalars as they are. Mappings come back as dicts, lists and tuples as
    their type. A sharded (FSDP) tensor raises ``TypeError``: gather it
    first (``parallel.full_state_dict``)."""
    devices = set()

    def start(x):
        if not isinstance(x, torch.Tensor):
            return x
        if _is_dtensor(x):
            raise TypeError("fetch_pytree got a sharded (DTensor) leaf; "
                            "gather the full state first")
        x = x.detach()
        if not x.is_cuda:
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        devices.add(x.device)
        return host

    def walk(t):
        if isinstance(t, Mapping):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return start(t)

    out = walk(tree)
    for dev in devices:
        with torch.cuda.device(dev):
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
    return out
