"""Multi-process runs over ``torch.distributed`` (the JAX package's
``parallel/multihost.py``).

One process per device: a run on N cards is N processes, each launched
with the same command and its own rank, joined through a coordinator:

    python -m aptai_tpu_torch.train.train_pr ... \\
        --coordinator_address host0:9955 --num_processes 2 --process_id $RANK

That is the JAX package's wire format. Under SLURM or Open MPI (or a
launcher that sets ``RANK`` / ``WORLD_SIZE``) the last two flags can be
left out: :func:`process_env_defaults` reads them from the environment.

The collectives run on NCCL when the run's device is the card and on gloo
when it is the CPU; one never stands in for the other. Host-side control
(the barrier around a checkpoint write, a preemption flag agreed by every
process) runs on a gloo group of the same processes, so a slow disk write
does not sit inside an NCCL collective's timeout.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

# host-side control group: (the default group it belongs to, the group)
_control = None


def init_distributed(coordinator_address: str = "",
                     num_processes: int = 0,
                     process_id: int = -1,
                     local_device_ids: Optional[Sequence[int]] = None,
                     device: Union[str, torch.device] = "cuda") -> bool:
    """Join this process to a multi-process run; True when a process group
    was set up, False when ``coordinator_address`` is empty (one process).

    ``coordinator_address`` is ``host:port`` of rank 0's TCP store. The
    backend follows ``device``, the run's device: NCCL for ``cuda`` (and
    this process's card becomes the current device: ``local_device_ids``'s
    one entry, else ``LOCAL_RANK``, else the rank modulo the cards
    present), gloo for ``cpu``.

    ``"auto"`` takes the rank and size from :func:`process_env_defaults`
    and the address from ``MASTER_ADDR`` / ``MASTER_PORT``, and raises if
    any is missing: unlike a Cloud TPU pod, the card's machine has no
    metadata server to ask. Calling it again with the same rank and size
    returns True; with others it raises."""
    if not coordinator_address:
        return False
    if coordinator_address == "auto":
        env = process_env_defaults()
        missing = [k for k in ("process_id", "num_processes")
                   if k not in env]
        missing += [k for k in ("MASTER_ADDR", "MASTER_PORT")
                    if k not in os.environ]
        if missing:
            raise ValueError(
                "--coordinator_address auto reads the launch from the "
                f"environment, which lacks {missing}")
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
        num_processes, process_id = env["num_processes"], env["process_id"]
    if num_processes <= 0 or process_id < 0:
        raise ValueError(
            "multi-process launch needs --num_processes >= 1 and "
            f"--process_id >= 0 (got {num_processes}, {process_id})")
    if process_id >= num_processes:
        raise ValueError(f"--process_id {process_id} is not below "
                         f"--num_processes {num_processes}")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise RuntimeError(
                f"this process already runs as rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {process_id} of "
                f"{num_processes}")
        return True
    device = torch.device(device)
    kwargs = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed on cuda, but CUDA is not "
                               "available (pass device='cpu' for gloo)")
        local = _local_device(process_id, local_device_ids)
        torch.cuda.set_device(local)
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local)
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    return True


def _local_device(process_id: int,
                  local_device_ids: Optional[Sequence[int]]) -> int:
    if local_device_ids is not None:
        ids = list(local_device_ids)
        if len(ids) != 1:
            raise ValueError("a process drives one card: local_device_ids "
                             f"must name one, got {ids}")
        return ids[0]
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % torch.cuda.device_count()


def process_index() -> int:
    """This process's rank (0 when it runs alone)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the run (1 when it runs alone)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns host-side writes (checkpoints, logs,
    CSVs): rank 0, or the only process."""
    return process_index() == 0


def process_env_defaults() -> dict:
    """Launcher-environment defaults (SLURM / Open MPI / ``RANK`` style) for
    the ``--process_id`` / ``--num_processes`` flags, read in the JAX
    package's order."""
    out = {}
    for k in ("SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "RANK"):
        if k in os.environ:
            out["process_id"] = int(os.environ[k])
            break
    for k in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE"):
        if k in os.environ:
            out["num_processes"] = int(os.environ[k])
            break
    return out


def control_group():
    """A gloo group of every process, for host-side control (the default
    group itself when that is gloo). Every process must make its first
    call at the same point of the program."""
    global _control
    world = dist.group.WORLD
    if _control is None or _control[0] is not world:
        group = (world if dist.get_backend() == "gloo"
                 else dist.new_group(backend="gloo",
                                     timeout=timedelta(hours=1)))
        _control = (world, group)
    return _control[1]


def host_barrier() -> None:
    """Wait until every process reaches this point (a no-op alone)."""
    if process_count() > 1:
        dist.barrier(group=control_group())


def any_process(flag: bool) -> bool:
    """True on every process if ``flag`` is true on any (``flag`` alone)."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=control_group())
    return bool(t.item())
