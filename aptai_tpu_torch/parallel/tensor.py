"""The model axis's collectives (Megatron tensor and sequence parallelism),
each an autograd Function whose backward is its forward's transpose.

A transformer sublayer under tensor parallelism holds a column-parallel
product (q, k and v; the FFN's first Linear: each process a slice of the
output features) and a row-parallel one (the attention's output
projection; the FFN's second Linear: each process the matching slice of
the input features). Between them every process computes on its own
heads or hidden units, so the sublayer needs two collectives over the
model axis:

* without sequence parallelism, :func:`copy_to_model` before the
  column-parallel product (identity; its backward sums the input's
  gradient over the axis) and :func:`reduce_from_model` after the
  row-parallel one (a sum; its backward is the identity): Megatron's *f*
  and *g*;
* with sequence parallelism the residual stream between the sublayers is
  split over time on the model axis, and the pair becomes
  :func:`gather_time` (an all-gather over time; its backward a
  reduce-scatter) and :func:`reduce_scatter_time` (a reduce-scatter over
  time; its backward an all-gather). :func:`scatter_time` and
  :func:`gather_time_replicated` enter and leave the split stream from a
  computation every process runs whole (their backwards an all-gather and
  a slice).

Parameters that a process applies to its own part of the work yet that
every process holds whole (the LayerNorms and the row-parallel biases on a
time shard; the replicated fused q/k/v product, of which each process
reads its heads) pass through :func:`copy_to_model` too, so that their
gradients are summed over the axis.

The kernels see plain local tensors: these functions take and return
ordinary tensors, and the collectives run on the model axis's process
group (gloo carries CUDA tensors through host memory; NCCL on the card
otherwise). This module imports nothing of the package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class ModelAxis:
    """The model axis as one process sees it: its process ``group``, this
    process's ``rank`` on it and its ``size``; ``sequence`` when the
    residual stream between sublayers is split over time
    (``Wav2Vec2Config.activation_partition``)."""

    def __init__(self, group, rank: int, size: int, sequence: bool = False):
        self.group, self.rank, self.size = group, rank, size
        self.sequence = sequence

    def __repr__(self):
        return (f"ModelAxis(rank={self.rank}, size={self.size}, "
                f"sequence={self.sequence})")

    def __deepcopy__(self, memo):
        return self  # a copy of a sharded module runs on the same group

    def shard(self, n: int) -> slice:
        """This process's slice of ``n`` features split evenly."""
        if n % self.size:
            raise ValueError(f"{n} does not split over the {self.size} "
                             "processes of the model axis")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def _all_reduce(x: torch.Tensor, axis: ModelAxis, op=dist.ReduceOp.SUM):
    # a copy: the collective writes in place, and x may be read elsewhere
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=axis.group)
    return x


def _all_gather(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim)


def _reduce_scatter(x: torch.Tensor, axis: ModelAxis, dim: int
                    ) -> torch.Tensor:
    parts = [p.contiguous() for p in x.chunk(axis.size, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=axis.group)
    return out


def _own(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    return x.chunk(axis.size, dim)[axis.rank].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, replicated):
        ctx.axis, ctx.replicated = axis, replicated
        return _all_gather(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return _own(g, ctx.axis, 1), None, None
        return _reduce_scatter(g, ctx.axis, 1), None, None


class _ReduceScatterTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _reduce_scatter(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, 1), None


class _ScatterTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _own(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, 1), None


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """``x`` as it is; in the backward its gradient is summed over the
    model axis (every process contributed a part of it)."""
    if axis is None or axis.size == 1 or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Optional[ModelAxis]
                      ) -> torch.Tensor:
    """The sum of ``x`` over the model axis (a row-parallel product's
    partial outputs); the backward passes the gradient through."""
    if axis is None or axis.size == 1:
        return x
    if not torch.is_grad_enabled():
        return _all_reduce(x, axis)
    return _ReduceFromModel.apply(x, axis)


def gather_time(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """(B, T/n, C) time shards → the (B, T, C) sequence on every process,
    for a column-parallel product (whose input gradients are partial:
    the backward reduce-scatters them)."""
    if axis.size == 1:
        return x
    if not torch.is_grad_enabled():
        return _all_gather(x, axis, 1)
    return _GatherTime.apply(x, axis, False)


def gather_time_replicated(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """(B, T/n, C) time shards → the (B, T, C) sequence, for a computation
    every process runs whole (its gradient is whole on every process: the
    backward keeps this process's slice)."""
    if axis.size == 1:
        return x
    if not torch.is_grad_enabled():
        return _all_gather(x, axis, 1)
    return _GatherTime.apply(x, axis, True)


def reduce_scatter_time(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Partial (B, T, C) sums → this process's (B, T/n, C) time shard of
    their sum over the model axis; the backward all-gathers."""
    if axis.size == 1:
        return x
    if not torch.is_grad_enabled():
        return _reduce_scatter(x, axis, 1)
    return _ReduceScatterTime.apply(x, axis)


def scatter_time(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """A (B, T, C) sequence every process holds whole → this process's
    time shard; the backward all-gathers the shards' gradients."""
    if axis.size == 1:
        return x
    if not torch.is_grad_enabled():
        return _own(x, axis, 1)
    return _ScatterTime.apply(x, axis)


def max_over_model(x: torch.Tensor, axis: Optional[ModelAxis]
                   ) -> torch.Tensor:
    """The elementwise max of ``x`` over the model axis (no gradient):
    W8A8's scales over a dimension the axis splits."""
    if axis is None or axis.size == 1:
        return x
    return _all_reduce(x, axis, dist.ReduceOp.MAX)
