"""aptai_tpu_torch's trainers against the JAX package's, on the CPU:

* ``fit`` against the JAX ``fit``: one tiny float32 APTAI with the same
  weights through the bridge (dropout, SpecAugment and the heads' dropout
  off), the same synthetic HPRC fold and loaders, 2 epochs of
  ``samples_per_epoch`` batches: the same batches chosen, per-epoch
  ``mean_train_loss`` and validation metrics within 1e-4 relative, the
  same ``improved`` flags;
* resuming a JAX run: the JAX ``fit`` of APTAI (frozen FE) and of W2V2PR
  preempted mid-epoch, then resumed by the JAX ``fit`` and by the port's
  from copies of its directory (``params.msgpack``, ``opt_state.msgpack``):
  the port restores the step counter and Adam state, the remaining
  epochs' losses and metrics match within 1e-4 relative, and the port's
  last ``params.msgpack`` then holds its newest parameters (no ``.pt``
  file beside it);
* preemption and resume on the port alone: mid-epoch (the epoch repeats;
  parameters, Adam state and the step counter restored bit for bit), at an
  epoch boundary with ``ckpt_every=0`` (no best written), a second SIGINT
  raising ``KeyboardInterrupt``, the handlers restored after each;
* the trainers: ``train_pr.main(argv)``, ``train_aptai.run`` over two folds
  and ``train_force_aptai.run`` over the W2V2PR run (the corpus cache built
  once, a fold forced into the ``beam_host`` fallback), laptop mode, with
  their artifacts.

The configs are in ``test_torch_trainer_config.py``, the builders'
checkpoint formats in ``test_torch_trainer_formats.py``.
"""

import functools
import json
import os
import shutil
import signal

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from aptai_tpu.data import BucketedLoader as JaxLoader
from aptai_tpu.data import HPRCDataset as JaxHPRC
from aptai_tpu.data import collate_tv as jax_collate_tv
from aptai_tpu.data.hprc import loso_split as jax_loso_split
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import configs as jcfg
from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu.train import config as jconfig
from aptai_tpu.train import evaluate as jeval
from aptai_tpu.train import harness as jharness
from aptai_tpu.train import loop as jloop
from aptai_tpu.train import train_aptai as jtrain_aptai
from aptai_tpu.train import train_pr as jtrain_pr
from aptai_tpu_torch.data import (BucketedLoader, HPRCDataset, build_vocab,
                                  collate_tv, make_synthetic_commonphone,
                                  make_synthetic_hprc)
from aptai_tpu_torch.data.hprc import loso_split
from aptai_tpu_torch.data.manifest import read_rows
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_aptai
from aptai_tpu_torch.train import builders, make_engine
from aptai_tpu_torch.train import config as tconfig
from aptai_tpu_torch.train import (train_aptai, train_force_aptai,
                                   train_pr)
from aptai_tpu_torch.train.checkpoints import (CheckpointManager,
                                               JaxAdamState, jax_adam_state,
                                               load_flax_params, read_params)
from aptai_tpu_torch.train.evaluate import validate_pr, validate_tv
from aptai_tpu_torch.train.loop import Preempted, fit

from _torch_port import (NO_DROP, one_torch_thread, port_aptai_from_jax,
                         port_w2v2_pr_from_jax, random_jax_aptai_params,
                         random_jax_w2v2_pr_params)


# the 7-layer conv stack (49 frames a second, as the manifests), tiny widths
STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))


QUIET = dict(NO_DROP, apply_spec_augment=False)


REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def hprc(tmp_path_factory):
    """3 speakers × 2 texts × 2 rates, written by the port."""
    path = make_synthetic_hprc(tmp_path_factory.mktemp("hprc"), 2,
                               ("M01", "F02", "M03"), device="cpu")
    rows = read_rows(path)
    return path, rows, build_vocab(r["phoneme_labels"] for r in rows)


# -- fit against the JAX fit --------------------------------------------------

class _Tagged(dict):
    """A batch that records its index in ``chosen`` when the JAX ``fit``
    takes it (it pops ``batch_pad_mask`` from the batches it steps on)."""

    chosen = []

    def pop(self, key, *default):
        if key == "batch_pad_mask":
            _Tagged.chosen.append(int(self["bi"][0]))
        return super().pop(key, *default)


# a pytree node, so the JAX fit stages it as the dict it is
jax.tree_util.register_pytree_node(
    _Tagged, lambda d: (list(d.values()), list(d)),
    lambda keys, values: dict(zip(keys, values)))


class _TaggedLoader:
    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for i, b in enumerate(self.loader):
            yield _Tagged(b, bi=np.array([i], np.int32))


class _RecordingStep:
    """Wraps a port engine: the index of every batch it steps on."""

    def __init__(self, step):
        self.step, self.chosen = step, []

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, batch, lr):
        self.chosen.append(int(batch["bi"][0]))
        return self.step(batch, lr)


def _close(got, want, what):
    assert abs(got - want) <= REL * max(abs(want), 1e-6), (what, got, want)


def test_fit_matches_jax_fit(hprc, tmp_path):
    path, rows, vocab = hprc
    v = len(vocab)
    cfg_t = tcfg.tiny_config(**STACK, **QUIET)
    params = random_jax_aptai_params(cfg_t, v, seed=3)
    common = dict(num_epochs=2, batch_size=1, learning_rate=1e-3, seed=0,
                  lr_decay=0.5, target_metric="val_mean_rmse")
    samples = 2

    # JAX
    df = pd.read_csv(path)
    j_train, j_valid, _, _ = jax_loso_split(df, "M03", "both", seed=0)
    jmodel = JaxAPTAI(jcfg.tiny_config(**STACK, **QUIET), tv_drop=0.0,
                      phn_drop=0.0, num_phonemes=v)
    jcfg_run = jconfig.APTAIConfig(exp_dir=str(tmp_path / "jax"),
                                   mesh_data=1, **common)
    j_eval = jtrain_aptai.make_eval_forward(jmodel)
    j_valid_dl = JaxLoader(JaxHPRC(j_valid, vocab, "both"), 1,
                           jax_collate_tv, shuffle=False)
    _Tagged.chosen = []
    _, j_hist = jloop.fit(
        jcfg_run, None, params,
        _TaggedLoader(JaxLoader(JaxHPRC(j_train, vocab, "both"), 1,
                                jax_collate_tv, shuffle=True, seed=0)),
        lambda p, e: jeval.validate_tv(functools.partial(j_eval, p),
                                       j_valid_dl),
        jckpt.CheckpointManager(tmp_path / "jax", "val_mean_rmse"),
        samples_per_epoch=samples, log_fn=lambda m: None,
        engine=jharness.make_engine(
            jcfg_run, jtrain_aptai.aptai_loss_fn(jmodel)))

    # the port
    train, valid, _, _ = loso_split(rows, "M03", "both", seed=0)
    model = port_aptai_from_jax(cfg_t, params, v, tv_drop=0.0, phn_drop=0.0)
    tcfg_run = tconfig.APTAIConfig(exp_dir=str(tmp_path / "port"),
                                   platform="cpu", **common)
    step = _RecordingStep(make_engine(tcfg_run,
                                      train_aptai.aptai_loss_fn(), model))
    eval_fwd = train_aptai.make_eval_forward(model)
    valid_dl = BucketedLoader(HPRCDataset(valid, vocab, "both"), 1,
                              collate_tv, shuffle=False)
    _, t_hist = fit(
        tcfg_run, None, model,
        _TaggedLoader(BucketedLoader(HPRCDataset(train, vocab, "both"), 1,
                                     collate_tv, shuffle=True, seed=0)),
        lambda e: validate_tv(eval_fwd, valid_dl),
        CheckpointManager(tmp_path / "port", "val_mean_rmse"),
        samples_per_epoch=samples, log_fn=lambda m: None, engine=step)

    assert len(train) == 4 and step.chosen == _Tagged.chosen
    assert len(step.chosen) == 2 * samples
    assert len(t_hist) == len(j_hist) == 2
    for t, j in zip(t_hist, j_hist):
        assert set(t) == set(j)
        assert (t["epoch"], t["lr"], t["train_steps"], t["improved"]) == (
            j["epoch"], j["lr"], j["train_steps"], j["improved"])
        for k, val in j.items():
            if k.startswith(("mean_train_loss", "val_mean")):
                _close(t[k], val, k)
    # training moved the weights, so the epochs' losses differ
    assert t_hist[0]["mean_train_loss"] != t_hist[1]["mean_train_loss"]


# -- resuming a JAX run -------------------------------------------------------

class _PreemptingLoader:
    """Fresh copies of ``batches`` each pass (or ``loader``'s); sends
    SIGUSR1 to this process before the first batch of pass ``at``."""

    def __init__(self, batches, at=None):
        self.batches, self.at, self.epoch = batches, at, 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        epoch, self.epoch = self.epoch, self.epoch + 1
        for i, b in enumerate(self.batches):
            if (epoch, i) == (self.at, 0):
                os.kill(os.getpid(), signal.SIGUSR1)
            yield dict(b)


def _resume_jax_run(tmp_path, jax_fit, port_fit):
    """A JAX run preempted in its second of 3 epochs, then resumed by the
    JAX ``fit`` and by the port's ``fit`` from copies of its directory:
    both histories, the JAX checkpoint's meta, and what the port's
    ``log_fn`` saw of its engine at the restore."""
    with pytest.raises(jloop.Preempted):
        jax_fit(tmp_path / "jax", at=1, resume=False)
    meta = json.loads((tmp_path / "jax" / "last-model-ckpt"
                       / "train_meta.json").read_text())
    assert meta["preempted"] and meta["epoch"] == 0
    for name in ("jax_resumed", "port_resumed"):
        shutil.copytree(tmp_path / "jax", tmp_path / name)
    j_hist = jax_fit(tmp_path / "jax_resumed", at=None, resume=True)
    t_hist, seen = port_fit(tmp_path / "port_resumed")
    # the port rewrote the JAX run's files with its newest state
    last = tmp_path / "port_resumed" / "last-model-ckpt"
    saved = read_params(last)
    assert saved.keys() == seen["final"].keys()
    assert all(torch.equal(saved[k], v) for k, v in seen["final"].items())
    assert not list((tmp_path / "port_resumed").rglob("*.pt"))
    return j_hist, t_hist, meta, seen


def _port_restore_probe(engine):
    """A ``log_fn`` that records the engine's step counter and Adam state
    when ``fit`` reports the restore."""
    seen = {}

    def log_fn(msg):
        if msg.startswith("resumed"):
            opt = engine.optimizer
            seen["step"] = engine.step_count
            seen["adam_steps"] = sorted({float(s["step"])
                                         for s in opt.state.values()})
            seen["n_state"] = len(opt.state)
    return log_fn, seen


def _assert_resumes_match(j_hist, t_hist, metric_prefix):
    assert [e["epoch"] for e in t_hist] == [e["epoch"] for e in j_hist] \
        == [1, 2]
    for t, j in zip(t_hist, j_hist):
        assert (t["lr"], t["train_steps"], t["improved"]) == (
            j["lr"], j["train_steps"], j["improved"])
        for k, val in j.items():
            if k.startswith(("mean_train_loss", metric_prefix)):
                _close(t[k], val, k)


def test_port_resumes_a_jax_aptai_run(hprc, tmp_path):
    """The JAX APTAI ``fit`` (frozen FE) preempted mid-epoch: the port's
    ``fit`` restores its params, Adam moments, step and watermark from
    ``params.msgpack`` / ``opt_state.msgpack``, and the remaining epochs'
    losses and metrics match the JAX resume's within 1e-4."""
    path, rows, vocab = hprc
    v = len(vocab)
    cfg_t = tcfg.tiny_config(**STACK, **QUIET)
    params = random_jax_aptai_params(cfg_t, v, seed=3)
    common = dict(num_epochs=3, batch_size=1, learning_rate=1e-3, seed=0,
                  lr_decay=0.5, target_metric="val_mean_rmse")
    samples = 2

    df = pd.read_csv(path)
    j_train, j_valid, _, _ = jax_loso_split(df, "M03", "both", seed=0)
    jmodel = JaxAPTAI(jcfg.tiny_config(**STACK, **QUIET), tv_drop=0.0,
                      phn_drop=0.0, num_phonemes=v)
    j_eval = jtrain_aptai.make_eval_forward(jmodel)
    j_valid_dl = JaxLoader(JaxHPRC(j_valid, vocab, "both"), 1,
                           jax_collate_tv, shuffle=False)
    j_batches = list(JaxLoader(JaxHPRC(j_train, vocab, "both"), 1,
                               jax_collate_tv, shuffle=False))
    engine = None

    def jax_fit(exp_dir, at, resume):
        nonlocal engine
        cfg = jconfig.APTAIConfig(exp_dir=str(exp_dir), mesh_data=1,
                                  **common)
        cfg.train_from_ckpt = resume
        engine = engine or jharness.make_engine(
            cfg, jtrain_aptai.aptai_loss_fn(jmodel))
        return jloop.fit(
            cfg, None, params, _PreemptingLoader(j_batches, at),
            lambda p, e: jeval.validate_tv(functools.partial(j_eval, p),
                                           j_valid_dl),
            jckpt.CheckpointManager(exp_dir, "val_mean_rmse"),
            samples_per_epoch=samples, log_fn=lambda m: None,
            engine=engine)[1]

    def port_fit(exp_dir):
        train, valid, _, _ = loso_split(rows, "M03", "both", seed=0)
        # other weights: only the restore can make the runs agree
        model = port_aptai_from_jax(cfg_t, random_jax_aptai_params(
            cfg_t, v, seed=4), v, tv_drop=0.0, phn_drop=0.0)
        cfg = tconfig.APTAIConfig(exp_dir=str(exp_dir), platform="cpu",
                                  train_from_ckpt=True, **common)
        step = make_engine(cfg, train_aptai.aptai_loss_fn(), model)
        eval_fwd = train_aptai.make_eval_forward(model)
        valid_dl = BucketedLoader(HPRCDataset(valid, vocab, "both"), 1,
                                  collate_tv, shuffle=False)
        log_fn, seen = _port_restore_probe(step)
        _, hist = fit(
            cfg, None, model,
            _PreemptingLoader(list(BucketedLoader(
                HPRCDataset(train, vocab, "both"), 1, collate_tv,
                shuffle=False))),
            lambda e: validate_tv(eval_fwd, valid_dl),
            CheckpointManager(exp_dir, "val_mean_rmse"),
            samples_per_epoch=samples, log_fn=log_fn, engine=step)
        n_trained = sum(1 for _ in step.optimizer.param_groups[0]["params"])
        return hist, dict(seen, n_trainable=n_trained,
                          final=model.state_dict())

    j_hist, t_hist, meta, seen = _resume_jax_run(tmp_path, jax_fit,
                                                 port_fit)
    # epoch 0's two steps and the step the preemption let finish
    assert meta["step"] == 3
    assert seen["step"] == 3 and seen["adam_steps"] == [3.0]
    assert seen["n_state"] == seen["n_trainable"]
    _assert_resumes_match(j_hist, t_hist, "val_mean")


def test_port_resumes_a_jax_w2v2_pr_run(tmp_path):
    """The same for W2V2PR (trainable FE), validated by ``validate_pr``
    with the greedy decode."""
    det = dict(QUIET, final_dropout=0.0, mask_time_prob=0.0, **STACK)
    cfg_t = tcfg.tiny_config(**det)
    params = random_jax_w2v2_pr_params(cfg_t, seed=31)
    rng = np.random.default_rng(32)

    def batch(n, labels):
        audio = np.zeros((1, 8000), np.float32)
        audio[0, :n] = rng.standard_normal(n) * 0.1
        lab = np.full((1, 6), -100, np.int32)
        lab[0, :len(labels)] = labels
        return {"audio": audio, "audio_lengths": np.array([n], np.int32),
                "phoneme_labels": lab}

    train = [batch(8000, [3, 3, 5, 1, 7, 2]), batch(5500, [4, 9, 9, 2]),
             batch(7000, [1, 2, 3]), batch(6000, [5, 6, 7, 8, 9])]
    valid = [batch(8000, [2, 4, 6]), batch(6500, [9, 1, 1, 3])]
    common = dict(num_epochs=3, batch_size=1, learning_rate=1e-3, seed=0,
                  lr_decay=0.5, target_metric="mean_val_loss")
    samples = 2
    jmodel = JaxW2V2PR(jcfg.tiny_config(**det))
    j_eval = jtrain_pr.make_eval_forward(jmodel)
    engine = None

    def jax_fit(exp_dir, at, resume):
        nonlocal engine
        cfg = jconfig.PRConfig(exp_dir=str(exp_dir), mesh_data=1, **common)
        cfg.train_from_ckpt = resume
        engine = engine or jharness.make_engine(
            cfg, jtrain_pr.pr_loss_fn(jmodel))
        return jloop.fit(
            cfg, None, params, _PreemptingLoader(train, at),
            lambda p, e: jeval.validate_pr(functools.partial(j_eval, p),
                                           valid, decode="greedy"),
            jckpt.CheckpointManager(exp_dir, "mean_val_loss"),
            samples_per_epoch=samples, log_fn=lambda m: None,
            engine=engine)[1]

    def port_fit(exp_dir):
        model = port_w2v2_pr_from_jax(cfg_t, random_jax_w2v2_pr_params(
            cfg_t, seed=33))
        cfg = tconfig.PRConfig(exp_dir=str(exp_dir), platform="cpu",
                               train_from_ckpt=True, **common)
        step = make_engine(cfg, train_pr.pr_loss_fn(), model)
        eval_fwd = train_pr.make_eval_forward(model)
        log_fn, seen = _port_restore_probe(step)
        _, hist = fit(cfg, None, model, _PreemptingLoader(train),
                      lambda e: validate_pr(eval_fwd, valid,
                                            decode="greedy"),
                      CheckpointManager(exp_dir, "mean_val_loss"),
                      samples_per_epoch=samples, log_fn=log_fn,
                      engine=step)
        return hist, dict(seen, final=model.state_dict())

    j_hist, t_hist, meta, seen = _resume_jax_run(tmp_path, jax_fit,
                                                 port_fit)
    assert meta["step"] == 3
    assert seen["step"] == 3 and seen["adam_steps"] == [3.0]
    _assert_resumes_match(j_hist, t_hist, "mean_val")


# -- preemption and resume ----------------------------------------------------

def _toy_batches(n=3):
    """APTAI batches of 2 random 0.4 s items (20 frames)."""
    rng = np.random.default_rng(6)
    out = []
    for _ in range(n):
        out.append({"audio": (rng.standard_normal((2, 6400)) * 0.1).astype(
            np.float32), "audio_lengths": np.array([6400, 5000], np.int32),
            "phn_frames": rng.integers(1, 5, (2, 19)).astype(np.int32),
            "tv_targets": rng.standard_normal((2, 19, 9)).astype(
                np.float32)})
    return out


class _SignalLoader:
    """Toy batches; sends ``signals`` to this process before batch ``i`` of
    epoch ``e`` for each ``(e, i)`` in ``at``."""

    def __init__(self, at=(), signals=(signal.SIGUSR1,)):
        self.batches, self.at, self.signals = _toy_batches(), at, signals
        self.epoch = 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        epoch, self.epoch = self.epoch, self.epoch + 1
        for i, b in enumerate(self.batches):
            if (epoch, i) in self.at:
                for sig in self.signals:
                    os.kill(os.getpid(), sig)
            yield dict(b)


def _toy_run(tmp_path, **kw):
    cfg = tconfig.APTAIConfig(exp_dir=str(tmp_path), num_epochs=3,
                              batch_size=2, learning_rate=1e-3,
                              platform="cpu", **kw)
    model = random_aptai(tcfg.tiny_config(), seed=0, num_phonemes=5)
    return cfg, model


def _validate(model):
    def validate(epoch):
        w = model.tv_linear.weight
        return {"val_mean_rmse": w.detach().abs().mean().item() + epoch}
    return validate


def _handlers():
    return {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT,
                                             signal.SIGUSR1)}


def _same_adam(live: JaxAdamState, other: JaxAdamState) -> bool:
    """The same count, and the same moments bit for bit for each parameter
    ``other`` holds them for; the parameters the port never stepped (the
    frozen FE) have zeros in ``live`` (the JAX package's zero moments)."""
    zero = lambda t: not t.any()
    return live.count == other.count and all(
        torch.equal(m, other.exp_avg[k])
        and torch.equal(live.exp_avg_sq[k], other.exp_avg_sq[k])
        if k in other.exp_avg else zero(m) and zero(live.exp_avg_sq[k])
        for k, m in live.exp_avg.items()) and set(other.exp_avg) <= set(
            live.exp_avg)


def test_preempted_mid_epoch_then_resumed_bit_for_bit(tmp_path):
    before = _handlers()
    cfg, model = _toy_run(tmp_path)
    ckpt = CheckpointManager(tmp_path, "val_mean_rmse")
    engine = make_engine(cfg, train_aptai.aptai_loss_fn(), model)
    with pytest.raises(Preempted) as exc:
        fit(cfg, None, model, _SignalLoader(at={(1, 1)}), _validate(model),
            ckpt, log_fn=lambda m: None, engine=engine)
    assert exc.value.code == 0 and _handlers() == before
    last = tmp_path / "last-model-ckpt"
    meta = json.loads((last / "train_meta.json").read_text())
    # epoch 0's 3 steps, then epoch 1's first two (the signal lands before
    # batch 1, whose step still runs)
    assert meta["preempted"] and meta["epoch"] == 0 and meta["step"] == 5
    assert engine.step_count == 5
    preempted = JaxAdamState.from_optimizer(engine.optimizer, model)

    cfg2, model2 = _toy_run(tmp_path, train_from_ckpt=True)
    engine2 = make_engine(cfg2, train_aptai.aptai_loss_fn(), model2)
    seen = {}

    def log_fn(msg):
        if msg.startswith("resumed"):
            live = JaxAdamState.from_optimizer(engine2.optimizer, model2)
            saved = jax_adam_state(
                load_flax_params(last / "opt_state.msgpack"),
                load_flax_params(last / "params.msgpack"))
            seen["step"] = engine2.step_count
            # as the file holds it, and as the preempted run held it
            seen["adam"] = (_same_adam(live, saved)
                            and _same_adam(live, preempted))
            seen["params"] = all(torch.equal(x, model.state_dict()[k])
                                 for k, x in model2.state_dict().items())

    _, hist = fit(cfg2, None, model2, _SignalLoader(), _validate(model2),
                  CheckpointManager(tmp_path, "val_mean_rmse"),
                  log_fn=log_fn, engine=engine2)
    assert seen == {"step": meta["step"], "adam": True, "params": True}
    assert [e["epoch"] for e in hist] == [1, 2]
    assert engine2.step_count == 5 + 2 * 3 and _handlers() == before


def test_preempted_at_epoch_boundary_writes_no_best(tmp_path):
    before = _handlers()
    cfg, model = _toy_run(tmp_path, ckpt_every=0)
    validate = _validate(model)

    def signalling(epoch):
        os.kill(os.getpid(), signal.SIGTERM)
        return validate(epoch)

    with pytest.raises(Preempted):
        fit(cfg, train_aptai.aptai_loss_fn(), model, _SignalLoader(),
            signalling, CheckpointManager(tmp_path, "val_mean_rmse"),
            log_fn=lambda m: None)
    meta = json.loads((tmp_path / "last-model-ckpt"
                       / "train_meta.json").read_text())
    assert meta["preempted"] and meta["epoch"] == 0 and meta["step"] == 3
    assert not (tmp_path / "best-model-ckpt").exists()
    assert _handlers() == before


def test_second_sigint_raises_keyboard_interrupt(tmp_path):
    before = _handlers()
    cfg, model = _toy_run(tmp_path)
    with pytest.raises(KeyboardInterrupt):
        fit(cfg, train_aptai.aptai_loss_fn(), model,
            _SignalLoader(at={(0, 1)}, signals=(signal.SIGINT,
                                                signal.SIGINT)),
            _validate(model), CheckpointManager(tmp_path, "val_mean_rmse"),
            log_fn=lambda m: None)
    assert _handlers() == before


# -- the trainers -------------------------------------------------------------

@pytest.fixture(scope="module")
def pr_run(hprc, tmp_path_factory):
    """``train_pr.main`` through its argv, wav2vec2-large replaced by the
    tiny config."""
    root = tmp_path_factory.mktemp("pr")
    cp_csv = make_synthetic_commonphone(root / "cp", 4, 2, 2)
    exp = root / "run"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(builders, "make_backbone_config",
                   lambda c, v: tcfg.tiny_config(**STACK, vocab_size=v))
        history, results = train_pr.main([
            "--exp_dir", str(exp), "--cp_csv_path", str(cp_csv),
            "--hprc_csv_path", str(hprc[0]), "--laptop", "--batch_size", "2",
            "--samples_per_epoch", "4", "--val_decode", "greedy",
            "--platform", "cpu"])
    return exp, history, results


def test_train_pr_main(pr_run):
    exp, history, results = pr_run
    for f in ("vocab.json", "train.csv", "valid.csv", "test.csv",
              "experiment_args.json", "metrics.jsonl", "test_results.json",
              "best-model-ckpt/params.msgpack",
              "best-model-ckpt/model_cfg.json",
              "last-model-ckpt/params.msgpack",
              "last-model-ckpt/opt_state.msgpack",
              "last-model-ckpt/train_meta.json"):
        assert (exp / f).exists(), f
    assert not list(exp.rglob("*.pt"))
    assert history[0]["train_steps"] == 1
    assert np.isfinite(history[0]["mean_train_loss"])
    assert set(results) == {"mean_cp_test_per", "mean_hprcN_per",
                            "mean_hprcF_per"}
    assert json.loads((exp / "test_results.json").read_text()) == results
    assert pd.read_csv(exp / "train.csv").split.eq("train").all()
    cfg = json.loads((exp / "best-model-ckpt" / "model_cfg.json").read_text())
    assert cfg["kind"] == "w2v2_pr" and cfg["backbone"]["dtype"] == "float32"


def test_train_aptai_run_two_folds(hprc, tmp_path):
    path, _, _ = hprc
    cfg = tconfig.APTAIConfig(exp_dir=str(tmp_path), hprc_csv_path=str(path),
                              laptop=True, batch_size=2, platform="cpu",
                              vocab_path="").finalize("APTAI")
    mean, std, per = train_aptai.run(cfg, tcfg.tiny_config(**STACK),
                                     speakers=["M01", "F02"])
    assert len(per) == 2 and set(mean) == set(per[0]) == set(std)
    for spk in ("M01", "F02"):
        assert (tmp_path / "test_metrics" / f"{spk}.csv").exists()
        fold = tmp_path / f"best-model-ckpt-{spk}"
        assert (fold / "best-model-ckpt" / "params.msgpack").exists()
    got = pd.read_csv(tmp_path / "loso_mean.csv").iloc[0]
    np.testing.assert_allclose(got["test_N_mean_rmse"],
                               np.mean([p["test_N_mean_rmse"] for p in per]),
                               rtol=1e-6)
    assert (tmp_path / "loso_std.csv").exists()


def test_train_force_aptai_over_the_pr_run(hprc, pr_run, tmp_path,
                                           monkeypatch):
    path, _, _ = hprc
    exp = pr_run[0]
    built = []

    class Counted(train_force_aptai.FrozenEncodedCorpus):
        def __init__(self, *a, **k):
            built.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(train_force_aptai, "FrozenEncodedCorpus", Counted)
    cfg = tconfig.ForceAPTAIConfig(
        exp_dir=str(tmp_path), hprc_csv_path=str(path),
        pr_model_path=str(exp), vocab_path=str(exp / "vocab.json"),
        laptop=True, batch_size=2, platform="cpu",
        collapse_per_threshold=0.0, collapse_patience=1,
        collapse_fallback=True).finalize("FORCE_APTAI")
    mean, _, per = train_force_aptai.run(cfg, speakers=["M01", "F02"])
    assert built == [1]
    assert [p["decode_fallback"] for p in per] == [1, 1]
    assert mean["decode_fallback"] == 1.0
    assert all(np.isfinite(v) for p in per for v in p.values())
    pr_tower = read_params(exp / "best-model-ckpt")
    for spk in ("M01", "F02"):
        fold = tmp_path / f"best-model-ckpt-{spk}"
        assert (fold / "frozen_tower.msgpack").exists()
        for sub in ("best-model-ckpt", "last-model-ckpt"):
            sd = read_params(fold / sub)
            assert all(torch.equal(sd[f"w2v2_pr.{k}"], v)
                       for k, v in pr_tower.items()), sub
        cfg_json = json.loads((fold / "best-model-ckpt"
                               / "model_cfg.json").read_text())
        assert cfg_json["pr_spliced"] and cfg_json["kind"] == "force_aptai"
    assert (tmp_path / "loso_mean.csv").exists()
