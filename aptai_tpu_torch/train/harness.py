"""The train step shared by both model families: Adam with
``torch.optim.Adam`` semantics and one forward + backward + update per call.

  * :func:`torch_adam` — Adam with L2 weight decay folded into the
    gradient (not AdamW), over the trainable parameters only;
  * :class:`TrainStep` — ``step(batch, lr)``: sets the LR, runs the loss
    adapter's training forward (dropout and SpecAugment from a per-step
    seed), the backward and the optimizer update; ``grad_accum=k`` averages
    the gradients of ``k`` equal microbatches before the one update;
  * :func:`make_engine` — the trainers' ``TrainStep`` from a run's config,
    on the data axis of its processes (``parallel/``) when there are
    several.

A loss adapter is the counterpart of the JAX engine's ``loss_fn``:
``loss_fn(model, batch, generator) -> (loss, aux)``, with the batch keys it
reads in its ``batch_keys`` attribute and those it reads when present in an
``optional_keys`` one (``train_pr.pr_loss_fn``,
``train_force_aptai.force_loss_fn``, ``train_aptai.aptai_loss_fn``, the
default).

Frozen parameters (a frozen feature encoder, which the model runs without a
gradient) carry no optimizer state and stay bit-identical.

On a mesh (``TrainStep(mesh=...)``) each process steps on its rows of the
global batch, and the step is the single-device step on the global batch:
the model axis splits the encoder's attention heads and FFN units
(``parallel/tensor.py``), and under ``DistributedDataParallel``, or on a
model ``shard_tree(fsdp=True)`` sharded, the gradients are averaged over
the data axis, the masked means of the loss and SpecAugment's spans are
the global batch's (``parallel/global_batch.py``), and the returned
metrics are averaged over the data axis. Dropout draws for the local rows
(and units), so under dropout the processes' masks are not the single
device's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from aptai_tpu_torch.infer.api import resolve_device
from aptai_tpu_torch.parallel.global_batch import data_parallel_batch

# SpecAugment's generator is seeded this far from dropout's, so the two draw
# from separate Philox streams instead of repeating each other's uniforms
SPEC_AUGMENT_SEED_OFFSET = 1 << 62


def torch_adam(model: nn.Module, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0,
               frozen_prefixes: Sequence[str] = ()) -> torch.optim.Adam:
    """``torch.optim.Adam`` over ``model``'s parameters, leaving out those
    that do not require a gradient and those whose name starts with one of
    ``frozen_prefixes``. The learning rate is set per step by
    :class:`TrainStep`."""
    params = [p for name, p in model.named_parameters()
              if p.requires_grad and not name.startswith(tuple(
                  frozen_prefixes))]
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def _upload(x, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``. A host array bound for the card goes through
    pinned memory without blocking, so the upload does not wait for the
    steps already queued on the card (a copy from pageable memory
    synchronises the stream)."""
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class TrainStep:
    """One training step per call, through a loss adapter.

    ``model`` moves to ``device`` (``cuda`` unless named) and into
    ``train()`` mode; build ``optimizer`` over its parameters
    (:func:`torch_adam`). ``loss_fn`` is the family's adapter (APTAI's,
    ``aptai_loss_fn()``, when None). ``step(batch, lr)`` takes a dict
    holding the adapter's ``batch_keys`` and any of its ``optional_keys``
    (tensors or arrays, the batch on the leading axis; other keys are
    ignored) and returns the step's ``loss`` and the adapter's aux values,
    each averaged over the microbatches, as device tensors (no
    synchronisation). Each microbatch's encoder dropout draws from the
    default generator seeded with ``s = seed + step * grad_accum +
    microbatch``, and the generator passed to the adapter (SpecAugment's;
    the FORCE head's dropout) is one of its own seeded with ``s +
    SPEC_AUGMENT_SEED_OFFSET``; the process's default generators are left
    as they were.

    ``mesh`` (``parallel.make_mesh``): ``batch`` is this process's rows of
    the global batch (those of its index on the data axis), ``grad_accum``
    splits them, and the one gradient all-reduce (or reduce-scatter) over
    the data axis comes with the last microbatch. A ``model`` sharded by
    ``parallel.shard_tree(model, mesh, fsdp=True)`` (before ``optimizer``
    is built over it) steps as it is; any other is placed on the model
    axis in place (``parallel.mesh.split_model_axis``: tensor parallelism,
    and sequence parallelism under the encoder's ``activation_partition``)
    and runs under ``DistributedDataParallel`` over the data axis. Every
    process of the mesh calls the step. The processes of one data index
    draw the same dropout masks on the tensors they all hold (each is
    seeded alike); the FFN's hidden units and, under sequence parallelism,
    the time shards draw masks of their own.
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: Optional[Callable] = None, grad_accum: int = 1,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0, mesh=None):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.optimizer = optimizer
        if loss_fn is None:
            from aptai_tpu_torch.train.train_aptai import aptai_loss_fn

            loss_fn = aptai_loss_fn()
        self.loss_fn = loss_fn
        self.grad_accum = grad_accum
        self.seed = seed
        self.step_count = 0
        self.mesh = mesh
        self._runner = _LossModule(self.model, loss_fn)
        if mesh is not None:
            self._place(mesh)

    def _place(self, mesh) -> None:
        from aptai_tpu_torch.parallel.mesh import (DATA_AXIS, axis_size,
                                                   is_fsdp, mesh_device,
                                                   shard_tree)

        if mesh_device(mesh).type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh_device(mesh)}, the "
                             f"step on {self.device}")
        owned = {id(p) for p in self.model.parameters()}
        if any(id(p) not in owned for g in self.optimizer.param_groups
               for p in g["params"]):
            raise ValueError("the optimizer holds parameters the model does "
                             "not (built before shard_tree?)")
        self.fsdp = is_fsdp(self.model)
        if not self.fsdp:
            # the model axis in place (the optimizer's parameters keep
            # their identity), then DDP over the data axis
            self._runner = shard_tree(self._runner, mesh)
        self._group = mesh.get_group(DATA_AXIS)
        self._rank = mesh.get_local_rank(DATA_AXIS)
        self._size = axis_size(mesh, DATA_AXIS)

    def _batch(self, batch) -> Tuple[Dict[str, torch.Tensor], int]:
        """The adapter's keys on the device, and the batch size."""
        keys = self.loss_fn.batch_keys
        missing = set(keys) - set(batch)
        if missing:
            raise KeyError(f"batch lacks {sorted(missing)}")
        keys = tuple(keys) + tuple(
            k for k in getattr(self.loss_fn, "optional_keys", ())
            if k in batch)
        out = {k: _upload(batch[k], self.device) for k in keys}
        sizes = [x.shape[0] for x in out.values()]
        if len(set(sizes)) != 1:
            raise ValueError(f"batch keys {list(keys)} disagree on the "
                             f"batch size: {sizes}")
        if sizes[0] % self.grad_accum:
            raise ValueError(f"batch {sizes[0]} not divisible into "
                             f"{self.grad_accum} gradient-accumulation "
                             "microbatches")
        return out, sizes[0]

    def __call__(self, batch, lr: float) -> Dict[str, torch.Tensor]:
        data, b = self._batch(batch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        k = self.grad_accum
        mb = b // k
        totals: Dict[str, torch.Tensor] = {}
        devices = [self.device] if self.device.type == "cuda" else []
        for i in range(k):
            seed = self.seed + self.step_count * k + i
            sub = {n: x[i * mb:(i + 1) * mb] for n, x in data.items()}
            with torch.random.fork_rng(devices=devices), \
                    self._microbatch(last=i == k - 1):
                torch.manual_seed(seed)
                gen = torch.Generator(self.device).manual_seed(
                    (seed + SPEC_AUGMENT_SEED_OFFSET) % (1 << 64))
                loss, aux = self._runner(sub, gen)
                (loss / k).backward()
            for name, val in {"loss": loss, **aux}.items():
                val = val.detach() / k
                totals[name] = val if i == 0 else totals[name] + val
        self.optimizer.step()
        self.step_count += 1
        if self.mesh is not None:
            totals = self._average(totals)
        return totals

    @contextlib.contextmanager
    def _microbatch(self, last: bool):
        """One microbatch's forward and backward: on a mesh, over the
        global batch's rows (``data_parallel_batch``), the gradients
        synchronised only with the last microbatch."""
        if self.mesh is None:
            yield
            return
        if self.fsdp:
            self.model.set_requires_gradient_sync(last)
            sync = contextlib.nullcontext()
        else:
            sync = contextlib.nullcontext() if last else self._runner.no_sync()
        with sync, data_parallel_batch(self._group, self._rank, self._size):
            yield

    def _average(self, totals: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """The metrics averaged over the processes, in one all-reduce."""
        names = list(totals)
        flat = torch.stack([totals[n].float().reshape(()) for n in names])
        torch.distributed.all_reduce(flat, group=self._group)
        flat = flat / self._size
        return {n: flat[i].to(totals[n].dtype) for i, n in enumerate(names)}


class _LossModule(nn.Module):
    """A model and its loss adapter as one module, so that
    ``DistributedDataParallel`` sees the adapter's forward (which may call
    a method other than the model's ``forward``) as its own."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch, generator):
        return self.loss_fn(self.model, batch, generator)


def run_mesh(cfg):
    """The mesh of the run's processes: ``parallel.make_mesh(
    cfg.mesh_data, cfg.mesh_model)``; None when the process runs alone."""
    from aptai_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(data=cfg.mesh_data, model=cfg.mesh_model)


def make_engine(cfg, loss_fn: Callable, model: nn.Module,
                frozen_prefixes: Sequence[str] = ()) -> TrainStep:
    """The trainers' step for ``model``: :func:`torch_adam` with the
    config's betas, eps and weight decay, ``cfg.grad_accum``, seeded with
    ``cfg.seed``, on the config's device (``train/config.py::run_device``),
    on the mesh of the run's processes (:func:`run_mesh`), ``model``
    sharded first under ``cfg.fsdp`` (a model sharded by an earlier engine
    steps as it is).
    """
    from aptai_tpu_torch.parallel.mesh import is_fsdp, shard_tree
    from aptai_tpu_torch.train.config import run_device

    device = run_device(cfg)
    mesh = run_mesh(cfg)
    if mesh is not None and getattr(cfg, "fsdp", False) and not is_fsdp(
            model):
        model = shard_tree(model.to(device), mesh, fsdp=True)
    optimizer = torch_adam(model, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                           eps=cfg.adam_epsilon,
                           weight_decay=cfg.adam_weight_decay,
                           frozen_prefixes=frozen_prefixes)
    return TrainStep(model, optimizer, loss_fn,
                     grad_accum=getattr(cfg, "grad_accum", 1),
                     device=device, seed=cfg.seed, mesh=mesh)
