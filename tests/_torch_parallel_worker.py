"""One rank of the port's multi-process CPU tests (gloo), launched by
``tests/test_torch_parallel.py`` and ``tests/test_torch_parallel_fit.py``
as ``python _torch_parallel_worker.py SCENARIO RANK WORLD PORT DIR``.

It imports torch and the port only, never JAX. Its inputs (``DIR/in.pt``:
weights, batches, configs as plain values) come from the parent test,
which holds the results (``DIR/out<RANK>.pt``) against the JAX package.
Each scenario runs several checks in one process group, so a test file
spawns its ranks once.
"""

import functools
import os
import signal
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from aptai_tpu_torch.data.batching import BucketedLoader, collate_tv  # noqa
from aptai_tpu_torch.models import configs as tcfg  # noqa: E402
from aptai_tpu_torch.models.aptai import APTAI  # noqa: E402
from aptai_tpu_torch.models.w2v2_pr import W2V2PR  # noqa: E402
from aptai_tpu_torch.parallel import (init_distributed, is_primary,  # noqa
                                      make_mesh, shard_batch, shard_tree)
from aptai_tpu_torch.train import TrainStep, torch_adam  # noqa: E402
from aptai_tpu_torch.train.checkpoints import CheckpointManager  # noqa
from aptai_tpu_torch.train.config import APTAIConfig  # noqa: E402
from aptai_tpu_torch.train.loop import Preempted, fit  # noqa: E402
from aptai_tpu_torch.train.train_aptai import aptai_loss_fn  # noqa: E402
from aptai_tpu_torch.train.train_pr import pr_loss_fn  # noqa: E402
from aptai_tpu_torch.utils.trees import tree_bytes  # noqa: E402

NUM_PHN = 11


def aptai(cfg_kwargs, state_dict) -> APTAI:
    model = APTAI(tcfg.tiny_config(**cfg_kwargs), num_phonemes=NUM_PHN,
                  tv_drop=0.0, phn_drop=0.0)
    model.load_state_dict(state_dict)
    return model


def w2v2_pr(cfg_kwargs, state_dict) -> W2V2PR:
    model = W2V2PR(tcfg.tiny_config(**cfg_kwargs))
    model.load_state_dict(state_dict)
    return model


def sgd_steps(model, batch, mesh, fsdp, grad_accum=1, lr=1e-3, n=2,
              loss_fn=None):
    """``n`` SGD steps (the JAX tests' ``optax.identity`` with the LR) of
    ``model`` on this rank's rows of ``batch`` (APTAI's loss unless
    ``loss_fn``; ``mesh`` None: one process on the whole batch); the last
    loss and the full parameters after them."""
    if fsdp:
        model = shard_tree(model, mesh, fsdp=True, fsdp_min_size=0)
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=lr)
    step = TrainStep(model, opt, loss_fn or aptai_loss_fn(),
                     grad_accum=grad_accum, device="cpu", mesh=mesh)
    for _ in range(n):
        m = step(shard_batch(mesh, batch), lr)
    params = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
              .detach().clone() for k, v in model.state_dict().items()}
    return {"loss": m["loss"].item(), "params": params,
            "local_bytes": tree_bytes(model.state_dict())}


def adam_bytes(cfg_kwargs, state_dict, batch, mesh, fsdp):
    """This rank's bytes of parameters and Adam state after one step."""
    model = aptai(cfg_kwargs, state_dict)
    if fsdp:
        model = shard_tree(model, mesh, fsdp=True, fsdp_min_size=0)
    opt = torch_adam(model)
    TrainStep(model, opt, aptai_loss_fn(), device="cpu",
              mesh=mesh)(shard_batch(mesh, batch), 1e-3)
    return {"params": tree_bytes(model.state_dict()),
            "adam": tree_bytes(opt.state_dict()["state"])}


def steps(inp, rank, world):
    mesh = make_mesh()
    out = {}
    det = inp["det"]
    for name, fsdp in (("dp", False), ("fsdp", True)):
        out[name] = sgd_steps(aptai(det, inp["sd"]), inp["batch"], mesh,
                              fsdp)
    out["dp_accum"] = sgd_steps(aptai(det, inp["sd"]), inp["batch"], mesh,
                                False, grad_accum=2, n=1)
    out["dp_specaugment"] = sgd_steps(aptai(inp["masked"], inp["sd_masked"]),
                                      inp["batch"], mesh, False)
    out["dp_ctc_sum"] = sgd_steps(w2v2_pr(inp["ctc_sum"], inp["sd_pr"]),
                                  inp["pr_batch"], mesh, False,
                                  loss_fn=pr_loss_fn())
    out["bytes"] = {name: adam_bytes(det, inp["sd"], inp["batch"], mesh, fsdp)
                    for name, fsdp in (("dp", False), ("fsdp", True))}
    out["primary"] = is_primary()
    return out


class Items:
    """A map-style dataset of collate_tv items."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class SignalAt:
    """Batches of ``loader``; on rank ``rank`` a SIGUSR1 to this process
    while batch ``at`` is being served (the other ranks are not told)."""

    def __init__(self, loader, rank, at):
        self.loader, self.rank, self.at = loader, rank, at

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for i, b in enumerate(self.loader):
            if i == self.at and torch.distributed.get_rank() == self.rank:
                os.kill(os.getpid(), signal.SIGUSR1)
            yield b


def run_fit(inp, exp_dir, fsdp, epochs, resume, signal_rank=None):
    cfg = APTAIConfig(exp_dir=str(exp_dir), platform="cpu", batch_size=4,
                      num_epochs=epochs, learning_rate=1e-3, fsdp=fsdp,
                      ckpt_every=1).finalize("APTAI")
    cfg.train_from_ckpt = resume
    model = aptai(inp["det"], inp["sd"])
    loader = BucketedLoader(Items(inp["items"]), batch_size=cfg.batch_size,
                            collate_fn=functools.partial(collate_tv,
                                                         bucket=False),
                            shuffle=True, audio_bucket=3200)
    seen = []

    def validate(epoch):
        seen.append(epoch)
        return {"val_mean_rmse": float(inp["val"][epoch])}

    ckpt = CheckpointManager(exp_dir, cfg.target_metric)
    logs = []
    train = (loader if signal_rank is None
             else SignalAt(loader, signal_rank, at=1))
    try:
        fit(cfg, aptai_loss_fn(), model, train, validate, ckpt,
            model_cfg={"kind": "aptai"}, log_fn=logs.append)
        preempted = False
    except Preempted:
        preempted = True
    # after fit's barrier the primary's files are on disk for every rank
    return {"seen": seen, "logs": logs, "rows": loader.local_batch_size,
            "preempted": preempted, "wrote": dict(ckpt.write_seconds),
            "files": sorted(str(f.relative_to(exp_dir))
                            for f in Path(exp_dir).rglob("*.msgpack"))}


def fits(inp, rank, world):
    root = Path(inp["root"])
    out = {"dp": run_fit(inp, root / "dp", False, 2, False),
           "fsdp": run_fit(inp, root / "fsdp", True, 2, False),
           "fsdp_first": run_fit(inp, root / "fsdp_resumed", True, 1, False)}
    # the first run resumed from its epoch-0 files for a second epoch
    out["fsdp_resumed"] = run_fit(inp, root / "fsdp_resumed", True, 2, True)
    # rank 1 alone is signalled during the second batch of the first epoch
    out["signalled"] = run_fit(inp, root / "signalled", False, 2, False,
                               signal_rank=1)
    return out


def start(scenario, inp, work, world=2):
    """Start ``scenario`` on ``world`` gloo ranks, one child process each,
    over the inputs ``inp``; :func:`finish` waits for them. Called by the
    parent test (the children import only torch and the port), which may
    compute its JAX reference meanwhile."""
    import socket
    import subprocess

    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    torch.save(inp, work / "in.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(world), str(port),
         str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    return work, procs


def finish(started, timeout=240):
    """The ranks' outputs of a :func:`start`; a rank that failed raises
    with its error output, and no child outlives the call."""
    work, procs = started
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}:\n"
                              f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return [torch.load(work / f"out{r}.pt", weights_only=False)
            for r in range(len(procs))]


def main():
    scenario, rank, world, port, work = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    work = Path(work)
    inp = torch.load(work / "in.pt", weights_only=False)
    assert init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    out = {"steps": steps, "fits": fits}[scenario](inp, rank, world)
    out["jax_loaded"] = any(m.split(".")[0] in ("jax", "aptai_tpu")
                            for m in sys.modules)
    torch.save(out, work / f"out{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
