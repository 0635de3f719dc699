"""The shared ``fit`` loop: one epoch / validate / checkpoint loop for the
three trainers (the JAX package's ``train/loop.py``).

On the card:

  * the step loop never synchronises: each step's loss stays a device
    tensor, and the epoch's losses are stacked and fetched once, at its
    end (``detect_anomaly`` opts into a per-step fetch, its documented
    cost);
  * validation runs on the live model;
  * the checkpoint manager copies parameters and Adam moments to the host
    only on epochs that write (``--ckpt_every`` sets the last-checkpoint
    cadence; improving epochs always write), as the JAX package's files:
    the Adam state goes as a :class:`JaxAdamState` by parameter name, its
    weight decay read from the optimizer, and the manager writes the optax
    tree the JAX trainer of the model's family holds.

In a run of several processes (``parallel/``), each process trains on its
rows of every global batch (the loader's split over the data axis), and
host-side writes are the primary's: checkpoints and the run logger's
metrics, the other processes waiting at a barrier until each write is
done. The parameters and Adam state of a model placed on the mesh
(tensor-parallel, FSDP, or both) are gathered whole to the primary's host
for every checkpoint, so its files are a single device's; a resume shards
them back. A preemption signal received by any process stops every process at
the same step boundary.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from aptai_tpu_torch.data.batching import BucketedLoader
from aptai_tpu_torch.parallel.mesh import (DATA_AXIS, axis_size,
                                           full_optimizer_state,
                                           full_state_dict,
                                           load_full_state_dict)
from aptai_tpu_torch.parallel.multihost import (any_process, host_barrier,
                                                is_primary, process_count,
                                                process_index)
from aptai_tpu_torch.train.checkpoints import (CheckpointManager,
                                               JaxAdamState,
                                               load_optimizer_state)
from aptai_tpu_torch.train.harness import TrainStep, make_engine
from aptai_tpu_torch.train.schedule import epoch_learning_rate


class Preempted(SystemExit):
    """Graceful-preemption exit (code 0): the resume checkpoint is on disk.

    A ``SystemExit`` so it unwinds LOSO fold loops and trainer CLIs without
    a handler in each; catchable by name by callers that tell preemption
    from completion."""

    def __init__(self):
        super().__init__(0)


class _PreemptionGuard:
    """Scoped SIGTERM/SIGUSR1 (and a graceful first SIGINT) handling for
    ``fit``.

    The first signal only sets a flag: ``fit`` checks it at step and epoch
    boundaries, finishes the in-flight step, writes a resumable last
    checkpoint and raises :class:`Preempted`. A second SIGINT raises
    ``KeyboardInterrupt``. Handlers install only on the main thread
    (``signal.signal``'s own constraint) and are restored on exit."""

    SIGNALS = ("SIGTERM", "SIGUSR1", "SIGINT")

    def __init__(self, log_fn, enabled: bool = True):
        self.log_fn = log_fn
        self.enabled = enabled
        self.triggered: Optional[int] = None
        self._prev = {}

    def _handler(self, signum, frame):
        if signum == signal.SIGINT and self.triggered is not None:
            raise KeyboardInterrupt
        self.triggered = signum
        # only a raw write here: a buffered print from a signal handler can
        # land inside the main thread's own print and raise "reentrant
        # call", unwinding fit before the resume checkpoint is written
        msg = (f"received {signal.Signals(signum).name}: finishing the "
               "in-flight step, writing a resume checkpoint, then exiting"
               + (" (second Ctrl-C kills immediately)"
                  if signum == signal.SIGINT else "") + "\n")
        try:
            os.write(2, msg.encode())
        except OSError:
            pass

    def __enter__(self):
        if self.enabled and (
            threading.current_thread() is threading.main_thread()
        ):
            for name in self.SIGNALS:
                sig = getattr(signal, name, None)
                if sig is not None:
                    self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


def require_one_process(what: str) -> None:
    """Raise ``NotImplementedError`` in a run of several processes: for
    the trainers that do not run over several yet (pretraining's diversity
    loss reads the whole batch's code distribution; FORCE-APTAI's fold
    loop refits after a collapse and writes its tower outside ``fit``)."""
    if process_count() > 1:
        raise NotImplementedError(
            f"{what} runs in one process only (ROADMAP Queue 1 item "
            "8e-iv); launch it without --coordinator_address")


def split_rows(loader, index: int, count: int) -> None:
    """Make ``loader`` (a ``BucketedLoader``, or a loader wrapping one as
    its ``.loader``) serve process ``index`` of ``count`` its rows of each
    global batch."""
    inner = loader
    while not isinstance(inner, BucketedLoader):
        inner = getattr(inner, "loader", None)
        if inner is None:
            raise TypeError(
                f"a {type(loader).__name__} cannot split its batches over "
                "processes: train from a BucketedLoader (or a loader that "
                "wraps one as .loader)")
    if inner.batch_size % count:
        raise ValueError(f"batch_size {inner.batch_size} not divisible by "
                         f"the {count} processes")
    inner.process_index, inner.process_count = index, count


def fit(cfg, loss_fn: Callable, model: nn.Module, train_loader,
        validate_fn: Callable[[int], Dict[str, float]],
        ckpt: CheckpointManager, model_cfg: Optional[Dict] = None,
        samples_per_epoch: Optional[int] = None,
        log_fn: Callable[[str], None] = print, logger=None,
        engine: Optional[TrainStep] = None,
        frozen_prefixes: Sequence[str] = ()):
    """Train ``model`` in place; returns ``(model, history)``.

    * the step: :func:`~aptai_tpu_torch.train.harness.make_engine` (Adam
      with the config's betas, eps and decay; ``grad_accum``), unless a
      prebuilt ``engine`` over ``model`` is given; ``frozen_prefixes``
      names parameters the optimizer leaves out;
    * the LR of each epoch: ``epoch_learning_rate`` (the 3-phase schedule);
    * ``samples_per_epoch``: each epoch trains on a random subset of
      ``samples_per_epoch // batch_size`` batches, drawn by
      ``np.random.default_rng(cfg.seed)``;
    * ``validate_fn(epoch)`` (on the live model) and best/last checkpoints
      each epoch; laptop mode trains one batch an epoch;
    * with ``cfg.train_from_ckpt`` and a last checkpoint (this package's
      or the JAX package's): parameters, Adam state, the best watermark
      and the step counter (which seeds dropout and SpecAugment) are
      restored and training resumes after the saved epoch;
    * several processes (the engine on a mesh): ``train_loader``'s batches
      are global batches, of which each process takes the rows of its
      index on the data axis (:func:`split_rows`; the processes of the
      model axis take the same rows); every process calls ``fit`` and
      ``validate_fn``.
    """
    step = engine if engine is not None else make_engine(
        cfg, loss_fn, model, frozen_prefixes=frozen_prefixes)
    model, optimizer = step.model, step.optimizer
    nproc = process_count()
    primary = is_primary()
    if step.mesh is not None:
        # the processes of one data index take the same rows
        if axis_size(step.mesh, DATA_AXIS) > 1:
            split_rows(train_loader, step.mesh.get_local_rank(DATA_AXIS),
                       axis_size(step.mesh, DATA_AXIS))
    elif nproc > 1:
        split_rows(train_loader, process_index(), nproc)
    start_epoch = 0
    if getattr(cfg, "train_from_ckpt", False) and ckpt.has_last():
        params, opt_state, meta = ckpt.restore_last(map_location=step.device)
        load_full_state_dict(model, params)
        if opt_state is not None:
            # after the model is on its device: the moments land there
            load_optimizer_state(optimizer, model, opt_state)
        step.step_count = int(meta["step"])
        start_epoch = int(meta["epoch"]) + 1
        log_fn(f"resumed from epoch {meta['epoch']} "
               f"(best {ckpt.target_metric}={ckpt.best_value})")
    subset_rng = np.random.default_rng(cfg.seed)
    history = []

    def state():
        """The params and the Adam state a write takes: whole on the
        primary (gathered from an FSDP model: every process calls this)."""
        params = full_state_dict(model)
        adam = JaxAdamState.from_named_state(
            full_optimizer_state(model, optimizer), optimizer)
        return params, adam

    def save_interrupt(resume_epoch):
        params, adam = state()
        if primary:
            ckpt.save_interrupt(resume_epoch, params, opt_state=adam,
                                step=step.step_count, model_cfg=model_cfg)
        host_barrier()

    guard = _PreemptionGuard(
        log_fn, enabled=getattr(cfg, "graceful_preemption", True))

    def preempted() -> bool:
        """Whether a signal came, to this process or (agreed at every call,
        on every process) to any other."""
        if nproc > 1 and guard.enabled and any_process(
                guard.triggered is not None) and guard.triggered is None:
            guard.triggered = -1  # another process was signalled
        return guard.triggered is not None

    with guard, (torch.autograd.detect_anomaly()
                 if getattr(cfg, "debug_nans", False)
                 else contextlib.nullcontext()):
        for epoch in range(start_epoch, cfg.num_epochs):
            lr = epoch_learning_rate(
                cfg.learning_rate, epoch, cfg.num_warmup_epochs,
                cfg.num_static_epochs, cfg.lr_decay,
            )
            n_batches = len(train_loader)
            if samples_per_epoch is not None:
                epoch_steps = max(samples_per_epoch // cfg.batch_size, 1)
                chosen = set(
                    subset_rng.choice(n_batches,
                                      size=min(epoch_steps, n_batches),
                                      replace=False).tolist()
                )
            else:
                chosen = None

            t0 = time.perf_counter()
            step_losses = []  # device scalars: no per-step host sync
            for bi, batch in enumerate(train_loader):
                if chosen is not None and bi not in chosen:
                    continue
                metrics = step(batch, lr)
                if getattr(cfg, "detect_anomaly", False):
                    loss_val = float(metrics["loss"])
                    if not np.isfinite(loss_val):
                        raise FloatingPointError(
                            f"non-finite loss {loss_val} at epoch {epoch} "
                            f"batch {bi}: "
                            + str({k: float(v) for k, v in metrics.items()})
                        )
                step_losses.append(metrics["loss"])
                if preempted() or (cfg.laptop and len(step_losses) >= 1):
                    break
            # the epoch's one fetch
            losses = (torch.stack(step_losses).float().cpu().numpy()
                      if step_losses else np.zeros((0,), np.float32))
            train_time = time.perf_counter() - t0
            if losses.size and not np.all(np.isfinite(losses)):
                bad = int(np.flatnonzero(~np.isfinite(losses))[0])
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch}, step {bad} of "
                    f"{losses.size} (re-run with --detect_anomaly to sync "
                    "per step, --debug_nans to trace the origin)"
                )

            if preempted():
                # mid-epoch preemption: skip validation, persist params,
                # moments and step; resume repeats this epoch
                save_interrupt(epoch)
                log_fn(f"preempted during epoch {epoch + 1} after "
                       f"{losses.size} steps: resume checkpoint written; "
                       f"rerun with --exp_dir {ckpt.exp_dir} to continue")
                raise Preempted()

            t_val = time.perf_counter()
            val_logs = validate_fn(epoch)
            val_time = time.perf_counter() - t_val
            t_ckpt = time.perf_counter()
            ckpt_every = int(getattr(cfg, "ckpt_every", 1))
            final_epoch = epoch == cfg.num_epochs - 1
            want_last = (final_epoch
                         or ckpt_every > 0
                         and epoch % ckpt_every == ckpt_every - 1
                         or preempted())
            if ckpt_every == 0 and not final_epoch:
                # 0 → checkpoint only at the end; a preemption in this mode
                # writes only the resume checkpoint, never best
                improved = False
                want_last = False
            else:
                params, adam = state()
                # the other processes run the same epochs, never touch disk
                improved = primary and ckpt.update(
                    epoch, val_logs, params, opt_state=adam,
                    step=step.step_count, model_cfg=model_cfg,
                    save_last=want_last,
                )
                host_barrier()
            ckpt_time = time.perf_counter() - t_ckpt
            entry = {
                "epoch": epoch,
                "lr": lr,
                "mean_train_loss": float(np.mean(losses)) if losses.size
                else None,
                "train_seconds": train_time,
                "val_seconds": val_time,
                "ckpt_seconds": ckpt_time,
                "train_steps": int(losses.size),
                "improved": improved,
                **val_logs,
            }
            history.append(entry)
            if logger is not None and primary:
                logger.log(entry, step=step.step_count)
            log_fn(
                f"epoch {epoch + 1}/{cfg.num_epochs} lr={lr:.2e} "
                f"train_loss={entry['mean_train_loss']} "
                + " ".join(f"{k}={v:.4f}" for k, v in val_logs.items()
                           if isinstance(v, float))
                + (" *best*" if improved else "")
            )
            if preempted() and not final_epoch:
                # the signal came during validation or checkpointing: the
                # epoch is complete, resume at the next one
                if not (any_process(improved) or want_last):
                    save_interrupt(epoch + 1)
                log_fn(f"preempted after epoch {epoch + 1}: resume "
                       f"checkpoint written; rerun with --exp_dir "
                       f"{ckpt.exp_dir} to continue")
                raise Preempted()

    return model, history
