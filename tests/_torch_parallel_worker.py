"""One rank of the port's multi-process CPU tests (gloo), launched by
``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_fit.py``,
``tests/test_torch_parallel_{pretrain,force}.py``,
``tests/test_torch_tensor_parallel*.py`` and ``tests/test_torch_pipeline.
py`` as ``python
_torch_parallel_worker.py SCENARIO RANK WORLD PORT DIR``.

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
from aptai_tpu_torch.infer.api import (APTAIPredictor,  # noqa: E402
                                      ForceAPTAIPredictor, W2V2PRPredictor)
from aptai_tpu_torch.infer.loader import load_predictor  # noqa: E402
from aptai_tpu_torch.infer.streaming import StreamingAPTAI  # noqa: E402
from aptai_tpu_torch.infer.transfer import fetch_outputs  # noqa: E402
from aptai_tpu_torch.models import configs as tcfg  # noqa: E402
from aptai_tpu_torch.models.aptai import APTAI  # noqa: E402
from aptai_tpu_torch.models.force_aptai import ForceAPTAI  # noqa: E402
from aptai_tpu_torch.models.w2v2_pr import W2V2PR  # noqa: E402
from aptai_tpu_torch.parallel import (init_distributed, is_primary,  # noqa
                                      make_mesh, shard_batch, shard_tree)
from aptai_tpu_torch.parallel.mesh import (gather_full,  # noqa: E402
                                           split_model_axis)
from aptai_tpu_torch.train import TrainStep, torch_adam  # noqa: E402
from aptai_tpu_torch.train.checkpoints import CheckpointManager  # noqa
from aptai_tpu_torch.train.config import APTAIConfig  # noqa: E402
from aptai_tpu_torch.train.loop import Preempted, fit  # noqa: E402
from aptai_tpu_torch.train.train_aptai import aptai_loss_fn  # noqa: E402
from aptai_tpu_torch.train.train_pr import pr_loss_fn  # noqa: E402
from aptai_tpu_torch.utils.trees import tree_bytes  # noqa: E402

NUM_PHN = 11
# sequence parallelism: the residual stream's time over the model axis
SP = ("data", "model", None)


def aptai(cfg_kwargs, state_dict) -> APTAI:
    model = APTAI(tcfg.tiny_config(**cfg_kwargs), num_phonemes=NUM_PHN,
                  tv_drop=0.0, phn_drop=0.0)
    model.load_state_dict(state_dict)
    return model


def w2v2_pr(cfg_kwargs, state_dict) -> W2V2PR:
    model = W2V2PR(tcfg.tiny_config(**cfg_kwargs))
    model.load_state_dict(state_dict)
    return model


def whole_params(model):
    """A single device's state dict of ``model``, on every rank (gathered
    over the data axis from FSDP and over the model axis)."""
    return {k: v.detach().clone()
            for k, v in gather_full(model, model.state_dict()).items()}


def sgd_steps(model, batch, mesh, fsdp, grad_accum=1, lr=1e-3, n=2,
              loss_fn=None):
    """``n`` SGD steps (the JAX tests' ``optax.identity`` with the LR) of
    ``model`` on this rank's rows of ``batch`` (APTAI's loss unless
    ``loss_fn``; ``mesh`` None: one process on the whole batch); the last
    loss and the full parameters after them (a single device's tensors,
    gathered over the mesh)."""
    if fsdp:
        model = shard_tree(model, mesh, fsdp=True, fsdp_min_size=0)
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=lr)
    step = TrainStep(model, opt, loss_fn or aptai_loss_fn(),
                     grad_accum=grad_accum, device="cpu", mesh=mesh)
    for _ in range(n):
        m = step(shard_batch(mesh, batch), lr)
    return {"loss": m["loss"].item(), "params": whole_params(model),
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


def run_fit(inp, exp_dir, fsdp, epochs, resume, signal_rank=None,
            mesh_model=1, lr=1e-3):
    cfg = APTAIConfig(exp_dir=str(exp_dir), platform="cpu", batch_size=4,
                      num_epochs=epochs, learning_rate=lr, fsdp=fsdp,
                      ckpt_every=1, mesh_model=mesh_model).finalize("APTAI")
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


def tensor_steps(inp, rank, world):
    """The DP2×TP2 mesh of four ranks: SGD steps under TP (DDP over the
    data axis), TP with FSDP and TP with sequence parallelism, each rank's
    bytes, and the forward through a predictor on the mesh."""
    mesh = make_mesh(model=2)
    det, sd, batch = inp["det"], inp["sd"], inp["batch"]
    sp = dict(det, activation_partition=SP)
    out = {name: sgd_steps(aptai(kw, sd), batch, mesh, fsdp)
           for name, kw, fsdp in (("tp", det, False), ("tp_fsdp", det, True),
                                  ("tp_sp", sp, False))}
    out["bytes"] = {name: adam_bytes(det, sd, batch, mesh, fsdp)
                    for name, fsdp in (("tp", False), ("tp_fsdp", True))}
    pred = APTAIPredictor(aptai(sp, sd), device="cpu", mesh=mesh)
    out["predict"] = fetch_outputs(pred.predict_batch(inp["wavs"]))
    out["heads"] = pred.model.wav2vec2.encoder.layers[0].attention \
        .q_proj.weight.shape[0] // pred.model.cfg.head_dim
    return out


def force(cfg_kwargs, state_dict) -> ForceAPTAI:
    model = ForceAPTAI(tcfg.Wav2Vec2Config(**cfg_kwargs), vocab_size=NUM_PHN)
    model.load_state_dict(state_dict)
    return model


def quant_encoder(q, mesh):
    """The W8A8 encoder on the model axis of ``mesh`` (``q``: its config,
    weights and input): its hidden states free and with each quantized
    layer given the reference's codes and scales for its input (this
    rank's columns of them for a row-parallel layer), and this rank's own
    codes of the forced run, in call order."""
    from aptai_tpu_torch.models import wav2vec2 as tw2v
    from aptai_tpu_torch.ops.quant import QuantizedRows

    model = split_model_axis(aptai(q["cfg"], q["sd"]).wav2vec2.eval(), mesh)
    real = tw2v.quantize_rows
    own = []

    def run(forced):
        own.clear()

        def hook(x, axis=None):
            rows = real(x, axis)
            own.append(rows.codes.numpy())
            if not forced:
                return rows
            codes, scale = q["rows"][len(own) - 1]
            if axis is not None:
                codes = codes[..., axis.shard(codes.shape[-1])]
            return QuantizedRows(torch.from_numpy(codes.copy()),
                                 torch.from_numpy(scale))

        tw2v.quantize_rows = hook
        try:
            with torch.no_grad():
                return model(torch.from_numpy(q["audio"]),
                             torch.from_numpy(q["lens"]))[0].numpy()
        finally:
            tw2v.quantize_rows = real

    free = run(False)
    return {"free": free, "forced": run(True), "codes": list(own)}


def tensor_serving(inp, rank, world):
    """Two ranks on a 1×2 mesh: the predictors, ``load_predictor`` and the
    streamer over the model axis (sequence parallelism too), W8A8 on it
    beside the unsharded quantized predictor, the dropout draws of a TP
    step, and ``fit`` with ``mesh_model=2`` (written, then resumed)."""
    mesh = make_mesh(model=2)
    cfg, wavs = inp["cfg"], inp["wavs"]

    def served(pred, method="predict_batch"):
        return fetch_outputs(getattr(pred, method)(wavs))

    out = {name: served(APTAIPredictor(aptai(kw, inp["sd_serve"]),
                                       device="cpu", mesh=mesh))
           for name, kw in (("aptai", cfg),
                            ("aptai_sp", dict(cfg, activation_partition=SP)))}
    out["w2v2_pr"] = served(W2V2PRPredictor(
        w2v2_pr(cfg, inp["sd_pr"]), device="cpu", mesh=mesh), "encode_batch")
    out["force"] = served(ForceAPTAIPredictor(
        force(inp["force_cfg"], inp["sd_force"]), device="cpu", mesh=mesh))
    out["loaded"] = served(load_predictor(inp["ckpt"], device="cpu",
                                          mesh=mesh))
    out["stream"] = StreamingAPTAI(
        aptai(cfg, inp["sd_serve"]), device="cpu", mesh=mesh,
        **inp["chunking"]).predict(inp["long"])
    quant = dict(cfg, quant="w8a8")
    out["w8a8"] = served(APTAIPredictor(aptai(quant, inp["sd_serve"]),
                                        device="cpu", mesh=mesh))
    out["w8a8_single"] = served(APTAIPredictor(aptai(quant, inp["sd_serve"]),
                                               device="cpu"))
    out["w8a8_encoder"] = quant_encoder(inp["quant"], mesh)
    # dropout on the tensors every rank holds draws the single device's
    # masks; the FFN's hidden units draw their own
    for name, kw in inp["dropouts"].items():
        out[name] = sgd_steps(aptai(kw, inp["sd"]), inp["batch"], mesh,
                              False, n=1)
    root = Path(inp["root"])
    out["fit"] = run_fit(inp, root / "tp", False, 2, False, mesh_model=2)
    out["fit_first"] = run_fit(inp, root / "tp_resumed", False, 1, False,
                               mesh_model=2)
    out["fit_resumed"] = run_fit(inp, root / "tp_resumed", False, 2, True,
                                 mesh_model=2)
    out["fit_lr0"] = run_fit(inp, root / "tp_lr0", False, 1, False,
                             mesh_model=2, lr=0.0)
    return out


PIPE_FORWARDS = {  # name: (mesh, microbatches, interleave, data axis)
    "gpipe_4_2": ("pipe4", 2, 1, None), "gpipe_4_4": ("pipe4", 4, 1, None),
    "gpipe_2_4": ("pairs", 4, 1, None), "inter_2_2_2": ("pairs", 2, 2, None),
    "inter_2_4_2": ("pairs", 4, 2, None),
    "data_pipe": ("pairs", 2, 1, "data")}
PIPE_GRADS = {"gpipe_4_2": ("pipe4", 2, 1), "inter_2_2_2": ("pairs", 2, 2)}
PIPE_REFUSALS = {  # name: (mesh, microbatches, interleave)
    "ragged_groups": ("pairs", 1, 2), "microbatches": ("pipe4", 3, 1),
    "stages": ("pipe3", 2, 1), "model_axis": ("model", 2, 1)}


def pipeline(inp, rank, world):
    """Four ranks: the pipe axis over a pipe-4 mesh, over pipe-2 pairs (a
    (data, pipe) = (2, 2) mesh: each pair runs the whole batch, or with
    ``data_axis`` its rows) and the refusals. Each forward's outputs and
    attention calls, each gradient run's gradients (the model in
    ``train()`` mode: the pipe runs it deterministically) and the names
    of the parameters this rank holds, each refusal's error."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from aptai_tpu_torch.models import wav2vec2 as tw2v
    from aptai_tpu_torch.parallel import pipelined_encoder_apply

    cfg = tcfg.tiny_config(**inp["cfg"])
    audio, lens = (torch.from_numpy(inp[k]) for k in ("audio", "lens"))
    meshes = {"pipe4": init_device_mesh("cpu", (4,),
                                        mesh_dim_names=("pipe",)),
              "pairs": init_device_mesh("cpu", (2, 2),
                                        mesh_dim_names=("data", "pipe")),
              "model": init_device_mesh("cpu", (2, 2),
                                        mesh_dim_names=("model", "pipe")),
              "pipe3": DeviceMesh("cpu", [0, 1, 2],
                                  mesh_dim_names=("pipe",))}
    calls = [0]
    real = tw2v.multi_head_attention_bhtd

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    tw2v.multi_head_attention_bhtd = counted

    def encoder():
        model = tw2v.Wav2Vec2Model(cfg)
        model.load_state_dict(inp["sd"])
        return model

    def run(model, mesh, m, v, data_axis=None):
        calls[0] = 0
        return pipelined_encoder_apply(model, audio, lens, meshes[mesh],
                                       num_microbatches=m, interleave=v,
                                       data_axis=data_axis)

    # a rank's first calls of the ops take seconds on the CPU: made here
    # on every rank at once, not in the pipe one stage after another
    (encoder().eval()(audio, lens)[0] ** 2).mean().backward()
    out = {}
    for name, (mesh, m, v, data_axis) in PIPE_FORWARDS.items():
        with torch.no_grad():
            h, fl, _ = run(encoder().eval(), mesh, m, v, data_axis)
        out[name] = {"h": h.numpy(), "fl": fl.numpy(), "calls": calls[0]}
    for name, (mesh, m, v) in PIPE_GRADS.items():
        model = encoder().train()
        h, _, _ = run(model, mesh, m, v)
        (h ** 2).mean().backward()
        out["grad_" + name] = {
            "grads": {n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "held": [n for n, _ in model.named_parameters()],
            "stack_bytes": sum(p.numel() * p.element_size() for p in
                               model.encoder.layers.parameters()),
            "calls": calls[0], "training": model.training}
    for name, (mesh, m, v) in PIPE_REFUSALS.items():
        if name == "stages" and rank == 3:
            continue  # not on the three-process mesh
        try:
            run(encoder(), mesh, m, v)
            out[name] = None
        except Exception as e:  # the refusal, its type and text
            out[name] = (type(e).__name__, str(e))
    return out


class Writes:
    """The paths under ``root`` this process opens for writing while the
    block runs (``open`` and ``io.open``, which ``Path.write_text`` and
    the checkpoint writers go through)."""

    def __init__(self, root):
        self.root, self.paths = str(root), []

    def __enter__(self):
        import builtins
        import io

        self._real = builtins.open

        def recording(file, mode="r", *a, **k):
            if any(c in mode for c in "wax") and str(file).startswith(
                    self.root):
                self.paths.append(str(file))
            return self._real(file, mode, *a, **k)

        builtins.open = io.open = recording
        return self

    def __exit__(self, *exc):
        import builtins
        import io

        builtins.open = io.open = self._real
        return False


def pretrain_loss_injected(model, batch, generator):
    """Pretraining's loss on the batch's own draws (``time_mask``,
    ``gumbel_noise``, ``negative_indices``, this process's rows of the
    global batch's), recording the forward's outputs of each call."""
    out = model(batch["audio"], batch["audio_lengths"], batch["time_mask"],
                batch["gumbel_temp"].float().mean(),
                gumbel_noise=batch["gumbel_noise"],
                negative_indices=batch["negative_indices"])
    pretrain_loss_injected.seen.append(
        {k: out[k].detach().clone() for k in (
            "loss", "contrastive_loss", "diversity_loss", "feature_penalty",
            "codebook_perplexity", "contrastive_accuracy", "num_masked")})
    return out["loss"], {}


pretrain_loss_injected.batch_keys = ("audio", "audio_lengths", "time_mask",
                                     "gumbel_temp", "gumbel_noise",
                                     "negative_indices")
pretrain_loss_injected.seen = []


def pretrain_model(inp):
    from aptai_tpu_torch.models.pretrain import Wav2Vec2Pretrain

    model = Wav2Vec2Pretrain(tcfg.tiny_config(**inp["cfg"]), **inp["head"])
    model.load_state_dict(inp["sd"])
    return model


def pretrain_adam_steps(inp, mesh, fsdp=False, n=2):
    """``n`` Adam steps of the pretraining model on this rank's rows of the
    global batch and its draws: the forward's outputs on this rank at
    each step, and the whole parameters after them."""
    model = pretrain_model(inp)
    if fsdp:
        model = shard_tree(model, mesh, fsdp=True, fsdp_min_size=0)
    step = TrainStep(model, torch_adam(model, eps=inp["adam_eps"]),
                     pretrain_loss_injected, device="cpu", mesh=mesh)
    pretrain_loss_injected.seen = []
    for _ in range(n):
        step(shard_batch(mesh, inp["batch"]), inp["lr"])
    # where the quantizer's parameters are: an FSDP shard's dimension, or
    # the shape of a tensor this rank holds whole
    quantizer = {n: (("shard", p.placements[0].dim)
                     if hasattr(p, "placements") else ("whole",
                                                       tuple(p.shape)))
                 for n, p in model.quantizer.named_parameters()}
    return {"seen": [{k: v.numpy() for k, v in o.items()}
                     for o in pretrain_loss_injected.seen],
            "params": whole_params(model), "quantizer": quantizer}


def pretrain_draws(inp, mesh):
    """This rank's span mask, Gumbel noise and distractors from one
    generator seed under the data axis, and one SGD step of the real
    adapter (its own draws) on this rank's rows."""
    from aptai_tpu_torch.models import pretrain as tpre
    from aptai_tpu_torch.models.wav2vec2 import compute_time_mask
    from aptai_tpu_torch.parallel.global_batch import data_parallel_batch
    from aptai_tpu_torch.train.pretrain import pretrain_loss_fn

    d = inp["draws"]
    b = len(d["frames"]) // 2
    lo = mesh.get_local_rank("data") * b
    frames = torch.from_numpy(d["frames"][lo:lo + b])
    gen = torch.Generator().manual_seed(d["seed"])
    with data_parallel_batch(mesh.get_group("data"),
                             mesh.get_local_rank("data"), 2):
        out = {"mask": compute_time_mask(gen, frames, d["t"], *d["mask"]),
               "noise": tpre.gumbel_noise((b, d["t"], 2, d["v"]), gen,
                                          "cpu"),
               "idx": tpre.sample_negative_indices(gen, b, d["t"], frames,
                                                   d["k"])}
    out = {k: v.numpy() for k, v in out.items()}
    model = pretrain_model(inp)
    step = TrainStep(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                     pretrain_loss_fn(0.5, 4, 1), device="cpu", mesh=mesh,
                     seed=3)
    metrics = step(shard_batch(mesh, {k: inp["batch"][k] for k in (
        "audio", "audio_lengths", "gumbel_temp")}), 1e-2)
    out["step"] = {"metrics": {k: v.item() for k, v in metrics.items()},
                   "params": whole_params(model)}
    return out


def global_total_grad(inp, mesh):
    """A nonlinear function of :func:`global_total` of this rank's rows:
    its value, and the gradient averaged over the data axis as DDP
    averages it."""
    from aptai_tpu_torch.parallel.global_batch import (data_parallel_batch,
                                                       global_total)

    x = torch.from_numpy(inp["rows"])
    b = len(x) // 2
    r = mesh.get_local_rank("data")
    w = torch.from_numpy(inp["w"]).requires_grad_()
    with data_parallel_batch(mesh.get_group("data"), r, 2):
        total = global_total((x[r * b:(r + 1) * b] * w).sum(0))
        value = torch.log((total ** 2).sum())
    value.backward()
    grad = w.grad.clone()
    torch.distributed.all_reduce(grad, group=mesh.get_group("data"))
    return {"value": value.item(), "grad": (grad / 2).numpy()}


def pretrain_runs(inp, rank):
    """``pretrain.run`` over the two ranks under DDP, FSDP and a 1×2 model
    axis, each into its own directory; the paths this rank wrote."""
    import dataclasses

    from aptai_tpu_torch.train import pretrain as tpretrain

    out = {}
    for name, kw in inp["runs"].items():
        cfg = tpretrain.PretrainConfig(
            exp_dir=str(Path(inp["root"]) / name), **inp["run_cfg"], **kw
        ).finalize("pretrain")
        with Writes(inp["root"]) as w:
            history, _ = tpretrain.run(cfg, tcfg.tiny_config(**inp["cfg"]))
        out[name] = {"history": history, "writes": w.paths,
                     "cfg": dataclasses.asdict(cfg)}
    return out


def pretrain_parallel(inp, rank, world):
    """Two ranks: pretraining's Adam steps on their rows of one global
    batch and its draws over a (2, 1) mesh (DDP and FSDP) and a (1, 2)
    model axis; the draws and a step of the real adapter under the data
    axis; the all-reduce helper's gradient; ``pretrain.run`` under each
    layout."""
    data_mesh = make_mesh()
    model_mesh = make_mesh(model=2)
    out = {"dp": pretrain_adam_steps(inp, data_mesh),
           "fsdp": pretrain_adam_steps(inp, data_mesh, fsdp=True),
           "tp": pretrain_adam_steps(inp, model_mesh),
           "draws": pretrain_draws(inp, data_mesh),
           "total": global_total_grad(inp, data_mesh)}
    out["runs"] = pretrain_runs(inp, rank)
    return out


def force_model(inp, **kw) -> ForceAPTAI:
    """FORCE-APTAI on the tiny tower, its head's dropout off."""
    f = inp["force"]
    model = ForceAPTAI(tcfg.tiny_config(**f["cfg"]), hidden_drop=0.0,
                       rnn_drop=0.0, **f["kw"], **kw)
    model.load_state_dict(f["sd"])
    return model


def force_head_steps(inp, mesh):
    """Two SGD steps of FORCE's head from cached encodings on this rank's
    rows; the forward's losses on this rank at each step, and the whole
    parameters after them."""
    from aptai_tpu_torch.train.train_force_aptai import force_loss_fn

    model = force_model(inp)
    adapter = force_loss_fn(from_encoded=True)
    seen = []

    def loss_fn(m, batch, generator):
        out = m.train_from_encoded(
            *(batch[k] for k in adapter.batch_keys), generator=generator,
            tower_frame_labels=batch["tower_frame_labels"])
        seen.append({k: out[k].detach().numpy().copy()
                     for k in ("loss", "tv_loss", "align_loss", "aux_ce")})
        return out["loss"], {}

    loss_fn.batch_keys = adapter.batch_keys + ("tower_frame_labels",)
    head = [p for n, p in model.named_parameters()
            if not n.startswith("w2v2_pr.")]
    step = TrainStep(model, torch.optim.SGD(head, lr=inp["lr"]), loss_fn,
                     device="cpu", mesh=mesh)
    for _ in range(2):
        step(shard_batch(mesh, inp["encoded"]), inp["lr"])
    return {"seen": seen, "params": {k: v for k, v in whole_params(
        model).items() if not k.startswith("w2v2_pr.")}}


def counted_rows(model, method):
    """Wrap ``model.<method>`` to record the rows of each call."""
    rows = []
    real = getattr(model, method)

    def call(x, *a, **k):
        rows.append(int(x.shape[0]))
        return real(x, *a, **k)

    setattr(model, method, call)
    return rows


def cache_items(items, keys):
    return [{k: (v.copy() if hasattr(v, "copy") else v)
             for k, v in it.items() if k in keys} for it in items]


def force_caches(inp, mesh):
    """The split cache passes: ``FrozenEncodedCorpus`` greedy and
    ``beam_host``, ``FECachedLoader``; each pass's items and the rows each
    call of the tower (or extractor) encoded on this rank."""
    from aptai_tpu_torch.data import HPRCDataset, collate_tv
    from aptai_tpu_torch.train import FECachedLoader, FrozenEncodedCorpus

    out = {}
    for method in ("greedy", "beam_host"):
        model = force_model(inp, decode_method=method)
        rows = counted_rows(model, "encode_and_decode")
        corpus = FrozenEncodedCorpus(inp["rows"], inp["vocab"], model,
                                     inp["cache_batch"], mesh=mesh)
        out[method] = {"keys": list(corpus.by_key),
                       "items": cache_items(corpus.by_key.values(),
                                            inp["item_keys"]),
                       "rows": rows}
    model = aptai(inp["aptai_cfg"], inp["sd_aptai"])
    fe = model.wav2vec2.feature_extractor
    seen = []
    fe.register_forward_hook(lambda m, a, o: seen.append(int(a[0].shape[0])))
    loader = BucketedLoader(HPRCDataset(inp["rows"], inp["vocab"],
                                        rate="both"),
                            batch_size=inp["cache_batch"],
                            collate_fn=collate_tv, shuffle=False)
    fe_cache = FECachedLoader(loader, model, shuffle=False, mesh=mesh)
    out["fe"] = {"items": cache_items(fe_cache.dataset.items,
                                      inp["fe_item_keys"]), "rows": seen}
    return out


def force_runs(inp, rank):
    """``train_force_aptai.run`` over the two ranks under DDP, FSDP and a
    1×2 model axis, and a run whose validation collapses on rank 0 alone;
    per run its results and the paths this rank wrote."""
    from aptai_tpu_torch.train import builders, train_force_aptai
    from aptai_tpu_torch.train.config import ForceAPTAIConfig

    real_build = builders.random_force_aptai

    def no_dropout(*a, **k):
        return real_build(*a, **dict(k, hidden_drop=0.0, rnn_drop=0.0))

    builders.random_force_aptai = no_dropout
    real_per = train_force_aptai.ctc_seq_per
    out = {}
    for name, (kw, speakers) in inp["force_runs"].items():
        cfg = ForceAPTAIConfig(exp_dir=str(Path(inp["root"]) / name),
                               **inp["force_run_cfg"], **kw
                               ).finalize("FORCE_APTAI")
        if name == "collapse":
            # rank 0's validation sees a collapsed decode, rank 1's not
            per = 1.0 if rank == 0 else 0.0
            train_force_aptai.ctc_seq_per = lambda *a, **k: per
        try:
            with Writes(inp["root"]) as w:
                mean, _, per_spk = train_force_aptai.run(
                    cfg, tcfg.tiny_config(**inp["force"]["cfg"]), speakers)
        finally:
            train_force_aptai.ctc_seq_per = real_per
        out[name] = {"mean": mean, "per": per_spk, "writes": w.paths}
    builders.random_force_aptai = real_build
    return out


def force_parallel(inp, rank, world):
    """Two ranks: FORCE's head step from cached encodings over a (2, 1)
    mesh, the split cache passes, and ``train_force_aptai.run`` under each
    layout."""
    mesh = make_mesh()
    out = {"head": force_head_steps(inp, mesh),
           "caches": force_caches(inp, mesh)}
    out["runs"] = force_runs(inp, rank)
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
    out = {"steps": steps, "fits": fits, "tensor_steps": tensor_steps,
           "tensor_serving": tensor_serving, "pipeline": pipeline,
           "pretrain_parallel": pretrain_parallel,
           "force_parallel": force_parallel}[scenario](inp, rank, world)
    out["jax_loaded"] = any(m.split(".")[0] in ("jax", "aptai_tpu")
                            for m in sys.modules)
    torch.save(out, work / f"out{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
