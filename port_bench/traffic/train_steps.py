"""Training steps: ``TrainStep(model, torch_adam(model), loss_fn)`` over
batches of the workload's size, one step after another, dropout and
SpecAugment on.

Set-up builds the one ``TrainStep`` the window drives and runs its first
``check_steps`` steps on distinct batches through the same call; the
benchmark records what those steps drew (each dropout keep mask, read at
ATen's dropout operation under a dispatch mode that runs every operation
as it is) and reads the program's losses, the first gradient (Adam's first
moment after one step over 1 - beta1) and each leaf's change after the
checked steps. The reference repeats those steps after the window. Then
one step at each batch width not met yet warms it, and the window steps on
with nothing recorded.

A step is complete when the device has run it: each step is followed by a
CUDA event, and the steps whose event falls in the window count.

Parameters: ``batch``, ``min_s``, ``max_s``, ``pool_batches``,
``labels_per_s`` (W2V2PR's CTC targets) or frame targets (APTAI),
``check_steps``, ``trace_steps``, ``rate_metric`` (the end-to-end metric
the rate is reported under; ``train_audio_per_s`` by default).
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode

from port_bench import arith, compare, data
from port_bench.core import KindBase, float32_numerics
from port_bench.weights import build_model, seed_weights

BETA1 = 0.9


class DropoutRecorder(TorchDispatchMode):
    """While open, keeps each dropout keep mask the program draws, on the
    host, in call order. It reads them at ATen's level, below any Python
    call site: ``native_dropout``'s mask (dropout's form on the card), or
    the ``bernoulli_`` noise of dropout's composite form (the CPU's). Every
    operation runs as the program issues it. A dropout fused into a kernel
    of the program's own draws no mask here, and the check then reads not
    correct (PERF.md)."""

    def __init__(self):
        super().__init__()
        self.masks: List[torch.Tensor] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.aten.native_dropout.default:
            self._keep(out[1])
        elif func is torch.ops.aten.bernoulli_.float:
            self._keep(out != 0)
        return out

    def _keep(self, mask):
        host = torch.empty(mask.shape, dtype=torch.bool, pin_memory=(
            mask.device.type == "cuda"))
        self.masks.append(host.copy_(mask, non_blocking=True))


def make_batch(cfg, wavs, rng, labels_per_s: float
               ) -> Dict[str, np.ndarray]:
    """A training batch: audio padded to whole seconds and its lengths, and
    the family's targets drawn from ``rng``: W2V2PR's phoneme labels (ids
    1-45 at the workload's rate, padded with -100); APTAI's frame phonemes
    (pad 0) and 9 TV targets (pad -100) over the padded frames."""
    lengths = np.array([len(w) for w in wavs], np.int32)
    width = data.bucket(int(lengths.max()))
    batch = {"audio": data.padded(wavs, width), "audio_lengths": lengths}
    frames = [arith.frames(cfg, int(n)) for n in lengths]
    t = arith.frames(cfg, width)
    if cfg["family"] == "w2v2pr":
        counts = [max(1, int(round(labels_per_s * n
                                   / data.SAMPLE_RATE))) for n in lengths]
        labels = np.full((len(wavs), max(counts)), -100, np.int64)
        for i, c in enumerate(counts):
            labels[i, :c] = rng.integers(1, cfg["vocab_size"], c)
        batch["phoneme_labels"] = labels
    else:
        phn = np.zeros((len(wavs), t), np.int64)
        tv = np.full((len(wavs), t, cfg["num_tvs"]), -100.0, np.float32)
        for i, n in enumerate(frames):
            phn[i, :n] = rng.integers(1, cfg["num_phonemes"], n)
            tv[i, :n] = rng.standard_normal((n, cfg["num_tvs"]),
                                            dtype=np.float32)
        batch["phn_frames"] = phn
        batch["tv_targets"] = tv
    return batch


class Kind(KindBase):
    def __init__(self, run, overrides=None):
        from aptai_tpu_torch.train import TrainStep, torch_adam

        super().__init__(run)
        p, cfg = run.params, run.cfg
        self.cfg = cfg
        dev = run.device
        rng = np.random.default_rng(run.seed_for("traffic"))
        n = p["batch"] * p["pool_batches"]
        lengths = data.stratified_lengths(n, p["min_s"], p["max_s"], rng)
        wavs = data.waveforms(lengths, rng)
        self.pool = [make_batch(cfg, wavs[i:i + p["batch"]], rng,
                                p.get("labels_per_s", 0.0))
                     for i in range(0, n, p["batch"])]
        run.phase("inputs")
        model = build_model(cfg, dev, **(overrides or {}))
        self.p0 = {k: v.cpu() for k, v in seed_weights(
            model, run.seed_for("weights")).items()}
        run.phase("model built, weights drawn, the reference's copy on the "
                  "host")
        if cfg["family"] == "aptai":
            from aptai_tpu_torch.train import aptai_loss_fn as loss_fn
        else:
            from aptai_tpu_torch.train import pr_loss_fn as loss_fn
        self.optimizer = torch_adam(model)
        self.dropout_seed = run.seed_for("dropout")
        self.step = TrainStep(model, self.optimizer, loss_fn(), device=dev,
                              seed=self.dropout_seed)
        self.lr = cfg["learning_rate"]
        self.names = {id(q): k for k, q in model.named_parameters()}
        self._checked_steps(p["check_steps"])
        run.phase("checked steps")
        seen = {self.pool[i]["audio"].shape[1]
                for i in range(p["check_steps"])}
        self.next = p["check_steps"]
        for i, b in enumerate(self.pool):
            if b["audio"].shape[1] not in seen:
                seen.add(b["audio"].shape[1])
                self.step(b, self.lr)
        self._sync()
        run.phase("warm-up of the other widths")

    def _sync(self):
        if self.run.device == "cuda":
            torch.cuda.synchronize()

    def _checked_steps(self, k: int) -> None:
        """The first ``k`` steps: losses, recorded draws, the first
        gradient by leaf, each leaf's change after the ``k``."""
        self.masks, losses = [], []
        for s in range(k):
            with DropoutRecorder() as rec:
                out = self.step(self.pool[s], self.lr)
            losses.append(float(out["loss"]))  # waits for the step
            self.masks.append(rec.masks)
            self.run.phase(f"checked step {s + 1}")
            if s == 0:
                grad1 = {}
                for group in self.optimizer.param_groups:
                    for q in group["params"]:
                        state = self.optimizer.state.get(q)
                        if state and "exp_avg" in state:
                            grad1[self.names[id(q)]] = float(
                                state["exp_avg"].norm()) / (1 - BETA1)
        delta = {}
        with torch.no_grad():
            for group in self.optimizer.param_groups:
                for q in group["params"]:
                    if self.optimizer.state.get(q):
                        name = self.names[id(q)]
                        delta[name] = float(
                            (q - self.p0[name].to(q.device)).norm())
        self.prog = {"losses": losses, "grad1": grad1, "delta": delta}

    def _steps(self, count=None, stop_at=None):
        """Steps pool batches in turn; returns (pool index, device seconds
        from the start to the step's end) for each step enqueued."""
        cuda = self.run.device == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        marks = []
        while (count is None or len(marks) < count) and (
                stop_at is None or time.perf_counter() < stop_at):
            i = self.next % len(self.pool)
            self.next += 1
            with record_function("port_bench.train_step"):
                self.step(self.pool[i], self.lr)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((i, ev))
            else:
                marks.append((i, time.perf_counter() - t0))
        self._sync()
        if cuda:
            return [(i, start.elapsed_time(ev) / 1e3) for i, ev in marks]
        return marks

    def window(self, seconds):
        """Steps until ``seconds`` have passed; the rate is the real audio
        of the steps the device completed in the window over the time from
        its start to the last of them."""
        done = self._steps(stop_at=time.perf_counter() + seconds)
        audio_s, flops, last = 0.0, 0, 0.0
        for i, t in done:
            if t > seconds:
                continue
            lengths = self.pool[i]["audio_lengths"].tolist()
            audio_s += sum(lengths) / data.SAMPLE_RATE
            flops += arith.step_flops(self.cfg, lengths)
            last = max(last, t)
        elapsed = max(last, 1e-9)
        self.obs.update({
            "attempted": len(done), "failed": 0,
            "window_seconds": elapsed, "window_flops": flops,
            "card": (torch.cuda.get_device_name(0)
                     if self.run.device == "cuda" else "cpu")})
        return {self.run.params.get("rate_metric", "train_audio_per_s"):
                audio_s / elapsed}

    def traced(self):
        done = self._steps(count=self.run.params["trace_steps"])
        self.obs["traced_lengths"] = [
            n for i, _ in done for n in self.pool[i]["audio_lengths"]]
        self.obs["traced_units"] = len(done)

    def free(self):
        self.step = self.optimizer = None
        gc.collect()
        if self.run.device == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="f32", rows=None) -> dict:
        """The reference's checked steps (``rows``: a fault's rows)."""
        from port_bench.reference.train import run_steps

        dev = self.run.device
        k = self.run.params["check_steps"]
        batches = [{key: torch.as_tensor(v).to(dev) for key, v in b.items()}
                   for b in self.pool[:k]]
        p0 = {key: v.to(dev) for key, v in self.p0.items()}
        with float32_numerics():
            return run_steps(p0, self.cfg, batches,
                             [self.dropout_seed + s for s in range(k)],
                             self.masks, self.lr, precision=precision,
                             rows=rows)

    def check(self):
        from port_bench.reference.draws import DrawMismatch

        try:
            gaps = compare.train_gaps(self.prog, self.reference())
        except DrawMismatch as e:  # not the configured step: not correct
            print(f"port_bench: {e}", file=sys.stderr)
            gaps = {k: math.inf for k in self.run.limits}
        return [(k, gaps[k], lim) for k, lim in self.run.limits.items()]
