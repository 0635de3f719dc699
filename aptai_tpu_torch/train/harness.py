"""The train step shared by both model families: Adam with
``torch.optim.Adam`` semantics and one forward + backward + update per call.

  * :func:`torch_adam` — Adam with L2 weight decay folded into the
    gradient (not AdamW), over the trainable parameters only;
  * :class:`TrainStep` — ``step(batch, lr)``: sets the LR, runs the loss
    adapter's training forward (dropout and SpecAugment from a per-step
    seed), the backward and the optimizer update; ``grad_accum=k`` averages
    the gradients of ``k`` equal microbatches before the one update.

A loss adapter is the counterpart of the JAX engine's ``loss_fn``:
``loss_fn(model, batch, generator) -> (loss, aux)``, with the batch keys it
reads in its ``batch_keys`` attribute and those it reads when present in an
``optional_keys`` one (``train_pr.pr_loss_fn``,
``train_force_aptai.force_loss_fn``, ``train_aptai.aptai_loss_fn``, the
default).

Frozen parameters (a frozen feature encoder, which the model runs without a
gradient) carry no optimizer state and stay bit-identical.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from aptai_tpu_torch.infer.api import resolve_device
from aptai_tpu_torch.train.train_aptai import aptai_loss_fn

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
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: Optional[Callable] = None, grad_accum: int = 1,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.optimizer = optimizer
        self.loss_fn = aptai_loss_fn() if loss_fn is None else loss_fn
        self.grad_accum = grad_accum
        self.seed = seed
        self.step_count = 0

    def _batch(self, batch) -> Tuple[Dict[str, torch.Tensor], int]:
        """The adapter's keys on the device, and the batch size."""
        keys = self.loss_fn.batch_keys
        missing = set(keys) - set(batch)
        if missing:
            raise KeyError(f"batch lacks {sorted(missing)}")
        keys = tuple(keys) + tuple(
            k for k in getattr(self.loss_fn, "optional_keys", ())
            if k in batch)
        out = {k: torch.as_tensor(batch[k]).to(self.device) for k in keys}
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
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(seed)
                gen = torch.Generator(self.device).manual_seed(
                    (seed + SPEC_AUGMENT_SEED_OFFSET) % (1 << 64))
                loss, aux = self.loss_fn(self.model, sub, gen)
                (loss / k).backward()
            for name, val in {"loss": loss, **aux}.items():
                val = val.detach() / k
                totals[name] = val if i == 0 else totals[name] + val
        self.optimizer.step()
        self.step_count += 1
        return totals
