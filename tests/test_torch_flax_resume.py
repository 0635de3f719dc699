"""The JAX package reads, resumes and serves runs of the port, on the CPU
at tiny sizes:

* the port's ``fit`` of APTAI (frozen FE, which the port's Adam never
  steps: its moments go out as zeros) and of W2V2PR, preempted mid-epoch
  by SIGUSR1, then resumed by the JAX ``fit`` and by the port's from
  copies of its directory: the remaining epochs' losses and metrics agree
  within 1e-4 relative (the mirror of ``test_torch_trainers.py``'s
  resumes of a JAX run);
* the JAX ``load_predictor`` on such a run's ``best-model-ckpt`` gives the
  port predictor's outputs within 1e-4, and the same decoded sequences;
* a port FORCE head run from the frozen-tower cache (head-only saves
  beside ``frozen_tower.msgpack``, preempted mid-epoch): the JAX
  trainer's tower-merging manager restores its last checkpoint into the
  JAX templates (params, optax state), and after the fold's
  ``finalize`` its whole-model best and last.
"""

import dataclasses
import functools
import shutil

import flax.linen as fnn
import jax
import numpy as np
import pytest
from flax import serialization
from test_torch_quant import _shape_only_init
from test_torch_trainers import (QUIET, STACK, _assert_resumes_match,
                                 _PreemptingLoader)

from aptai_tpu.infer import loader as jloader
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
from aptai_tpu.train.train_force_aptai import \
    _TowerMergingCkpt as JaxTowerMergingCkpt
from aptai_tpu_torch.infer.loader import load_predictor
from aptai_tpu_torch.models import ForceAPTAI
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models.convert import (any_state_dict_from_jax,
                                            jax_params_from_any_state_dict)
from aptai_tpu_torch.train import (TrainStep, collate_encoded, encode_items,
                                   force_loss_fn, make_engine, torch_adam)
from aptai_tpu_torch.train import config as tconfig
from aptai_tpu_torch.train import train_aptai, train_force_aptai, train_pr
from aptai_tpu_torch.train.checkpoints import (CheckpointManager,
                                               JaxAdamState, to_host)
from aptai_tpu_torch.train.evaluate import validate_pr, validate_tv
from aptai_tpu_torch.train.loop import Preempted, fit

from _torch_port import (one_torch_thread, port_aptai_from_jax,
                         port_w2v2_pr_from_jax, random_jax_aptai_params,
                         random_jax_force_params, random_jax_w2v2_pr_params)

TOL = 1e-4
COMMON = dict(num_epochs=3, batch_size=1, learning_rate=1e-3, seed=0,
              lr_decay=0.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _resume_port_run(root, port_fit, jax_fit):
    """A port run preempted in its second of 3 epochs, then resumed by the
    JAX ``fit`` and by the port's from copies of its directory; both
    histories, and what the JAX ``fit`` logged."""
    with pytest.raises(Preempted):
        port_fit(root / "port", at=1, seed=3)
    for name in ("jax_resumed", "port_resumed"):
        shutil.copytree(root / "port", root / name)
    logged = []
    j_hist = jax_fit(root / "jax_resumed", logged.append)
    t_hist = port_fit(root / "port_resumed", at=None, seed=4)
    return j_hist, t_hist, logged


def _aptai_batches(cfg, v, n, seed):
    """``n`` APTAI batches of 2 items of 0.4 s, the second 0.31 s: one
    shape, so each package compiles its step and its forward once."""
    rng = np.random.default_rng(seed)
    lengths = np.array([6400, 5000], np.int32)
    frames = cfg.feat_extract_output_lengths(lengths).astype(np.int32)
    t = int(frames[0])
    return [{"audio": (rng.standard_normal((2, 6400)) * 0.1).astype(
                 np.float32),
             "audio_lengths": lengths, "frame_lengths": frames,
             "phn_frames": rng.integers(1, v, (2, t)).astype(np.int32),
             "tv_targets": rng.standard_normal((2, t, 9)).astype(
                 np.float32)} for _ in range(n)]


def _aptai_run(root):
    v = 7
    cfg_t = tcfg.tiny_config(**STACK, **QUIET)
    common = dict(COMMON, batch_size=2, target_metric="val_mean_rmse")
    model_cfg = {"backbone": dataclasses.asdict(cfg_t), "kind": "aptai",
                 "vocab": {f"p{i}": i for i in range(v)}}
    train = _aptai_batches(cfg_t, v, 4, 40)
    valid = _aptai_batches(cfg_t, v, 2, 41)

    def port_fit(exp_dir, at, seed):
        # resumed from other weights: only the restore can make runs agree
        model = port_aptai_from_jax(cfg_t, random_jax_aptai_params(
            cfg_t, v, seed), v, tv_drop=0.0, phn_drop=0.0)
        cfg = tconfig.APTAIConfig(exp_dir=str(exp_dir), platform="cpu",
                                  train_from_ckpt=at is None, **common)
        step = make_engine(cfg, train_aptai.aptai_loss_fn(), model)
        eval_fwd = train_aptai.make_eval_forward(model)
        return fit(cfg, None, model, _PreemptingLoader(train, at),
                   lambda e: validate_tv(eval_fwd, valid),
                   CheckpointManager(exp_dir, "val_mean_rmse"),
                   model_cfg=model_cfg, samples_per_epoch=4,
                   log_fn=lambda m: None, engine=step)[1]

    jmodel = JaxAPTAI(jcfg.tiny_config(**STACK, **QUIET), tv_drop=0.0,
                      phn_drop=0.0, num_phonemes=v)
    j_eval = jtrain_aptai.make_eval_forward(jmodel)

    def jax_fit(exp_dir, log_fn):
        cfg = jconfig.APTAIConfig(exp_dir=str(exp_dir), mesh_data=1,
                                  **common)
        cfg.train_from_ckpt = True
        return jloop.fit(
            cfg, None, random_jax_aptai_params(cfg_t, v, 4),
            _PreemptingLoader(train),
            lambda p, e: jeval.validate_tv(functools.partial(j_eval, p),
                                           valid),
            jckpt.CheckpointManager(exp_dir, "val_mean_rmse"),
            samples_per_epoch=4, log_fn=log_fn,
            engine=jharness.make_engine(cfg, jtrain_aptai.aptai_loss_fn(
                jmodel)))[1]

    return _resume_port_run(root, port_fit, jax_fit) + ("val_mean",)


def _w2v2_pr_run(root):
    det = dict(QUIET, final_dropout=0.0, mask_time_prob=0.0, **STACK)
    cfg_t = tcfg.tiny_config(**det)
    common = dict(COMMON, target_metric="mean_val_loss")
    model_cfg = {"backbone": dataclasses.asdict(cfg_t), "kind": "w2v2_pr",
                 "vocab": {f"p{i}": i for i in range(cfg_t.vocab_size)}}
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

    def port_fit(exp_dir, at, seed):
        model = port_w2v2_pr_from_jax(cfg_t, random_jax_w2v2_pr_params(
            cfg_t, seed))
        cfg = tconfig.PRConfig(exp_dir=str(exp_dir), platform="cpu",
                               train_from_ckpt=at is None, **common)
        step = make_engine(cfg, train_pr.pr_loss_fn(), model)
        eval_fwd = train_pr.make_eval_forward(model)
        return fit(cfg, None, model, _PreemptingLoader(train, at),
                   lambda e: validate_pr(eval_fwd, valid, decode="greedy"),
                   CheckpointManager(exp_dir, "mean_val_loss"),
                   model_cfg=model_cfg, samples_per_epoch=2,
                   log_fn=lambda m: None, engine=step)[1]

    jmodel = JaxW2V2PR(jcfg.tiny_config(**det))
    j_eval = jtrain_pr.make_eval_forward(jmodel)

    def jax_fit(exp_dir, log_fn):
        cfg = jconfig.PRConfig(exp_dir=str(exp_dir), mesh_data=1, **common)
        cfg.train_from_ckpt = True
        return jloop.fit(
            cfg, None, random_jax_w2v2_pr_params(cfg_t, 4),
            _PreemptingLoader(train),
            lambda p, e: jeval.validate_pr(functools.partial(j_eval, p),
                                           valid, decode="greedy"),
            jckpt.CheckpointManager(exp_dir, "mean_val_loss"),
            samples_per_epoch=2, log_fn=log_fn,
            engine=jharness.make_engine(cfg, jtrain_pr.pr_loss_fn(
                jmodel)))[1]

    return _resume_port_run(root, port_fit, jax_fit) + ("mean_val",)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Each family's run, made at its first use."""
    made = {}

    def run(kind):
        if kind not in made:
            root = tmp_path_factory.mktemp(kind)
            made[kind] = (root, _aptai_run(root) if kind == "aptai"
                          else _w2v2_pr_run(root))
        return made[kind]
    return run


@pytest.mark.parametrize("kind", ["aptai", "w2v2_pr"])
def test_jax_fit_resumes_a_port_run(port_runs, kind):
    root, (j_hist, t_hist, logged, prefix) = port_runs(kind)
    assert any(m.startswith("resumed from epoch 0") for m in logged)
    _assert_resumes_match(j_hist, t_hist, prefix)
    assert not list(root.rglob("*.pt"))


# kind: (predictor entry, outputs within TOL, outputs equal)
SERVED = {"aptai": ("predict_batch", ("tvs_pred", "phn_fc_probs"),
                    ("phn_fc_pred",)),
          "w2v2_pr": ("encode_batch", ("phoneme_logits",), ())}


@pytest.mark.parametrize("kind", list(SERVED))
def test_jax_load_predictor_serves_a_port_run(port_runs, kind, monkeypatch):
    best = port_runs(kind)[0] / "port_resumed" / "best-model-ckpt"
    entry, close, equal = SERVED[kind]
    rng = np.random.default_rng(5)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (16_000, 9_000)]
    port = load_predictor(best, device="cpu")
    got = getattr(port, entry)(wavs)
    monkeypatch.setattr(fnn.Module, "init", _shape_only_init(fnn.Module.init))
    monkeypatch.setattr("aptai_tpu.decode.native._load", lambda: None)
    jpred = jloader.load_predictor(best)
    want = getattr(jpred, entry)(wavs)
    for k in close:
        w, g = np.asarray(want[k], np.float32), got[k].float().numpy()
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= TOL * np.abs(w).max(), k
    for k in equal:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if kind == "w2v2_pr":  # the beam-decoded sequences
        for wav in wavs:
            np.testing.assert_array_equal(
                port.pred_phn_seq(wav)["phn_seq_idx"],
                jpred.pred_phn_seq(wav)["phn_seq_idx"])


def _force_batches(n_batches, v):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n_batches):
        lab = np.full((2, 6), -100, np.int32)
        lab[0, :5] = rng.integers(1, v, 5)
        lab[1, :3] = rng.integers(1, v, 3)
        out.append({
            "audio": (rng.standard_normal((2, 6400)) * 0.1).astype(
                np.float32),
            "audio_lengths": np.array([6400, 5000], np.int32),
            "tv_targets": rng.standard_normal((2, 19, 9)).astype(np.float32),
            "phoneme_labels": lab})
    return out


def test_jax_force_adapter_restores_a_port_head_run(tmp_path):
    v = 9
    tree = random_jax_force_params(jcfg.tiny_config(**STACK), v, 5)
    model = ForceAPTAI(tcfg.tiny_config(**STACK), vocab_size=v)
    model.load_state_dict(any_state_dict_from_jax(tree))
    model.eval()
    items = encode_items(_force_batches(3, v), model)
    encoded = [collate_encoded(items[i:i + 2]) for i in range(0, 6, 2)]
    cfg = tconfig.ForceAPTAIConfig(exp_dir=str(tmp_path), platform="cpu",
                                   **dict(COMMON, num_epochs=2))
    step = TrainStep(model, torch_adam(model), force_loss_fn(
        from_encoded=True), device="cpu")
    tower, _ = train_force_aptai._split_tower(model.state_dict())
    ckpt = train_force_aptai._TowerMergingCkpt(
        CheckpointManager(tmp_path / "fold", "m"), tower)
    best = {}

    def validate(epoch):  # epoch 0's params become the best
        best.update(_jax_tree(model))
        return {"m": 1.0}

    with pytest.raises(Preempted):
        fit(cfg, None, model, _PreemptingLoader(encoded, at=1), validate,
            ckpt, log_fn=lambda m: None, engine=step,
            frozen_prefixes=(train_force_aptai.TOWER,))
    fold = tmp_path / "fold"
    assert (fold / "frozen_tower.msgpack").exists()
    assert not list(fold.rglob("*.pt"))

    live = _jax_tree(model)
    adam = JaxAdamState.from_optimizer(step.optimizer, model)
    head = {k: x for k, x in tree.items() if k != "w2v2_pr"}
    tx = jharness.torch_adam(frozen_prefixes=("w2v2_pr",))
    jax_ckpt = JaxTowerMergingCkpt(jckpt.CheckpointManager(fold, "m"),
                                   {"w2v2_pr": tree["w2v2_pr"]})
    params, opt, meta = jax_ckpt.restore_last(head, tx.init(head))
    assert meta["preempted"] and meta["step"] == step.step_count == 4
    _tree_equal(params, {k: x for k, x in live.items() if k != "w2v2_pr"})
    scale = opt.inner_state[0]
    assert int(scale.count) == adam.count == 4
    np.testing.assert_array_equal(
        scale.mu["frame_lin"]["kernel"],
        adam.exp_avg["frame_lin.weight"].numpy().T)
    np.testing.assert_array_equal(
        scale.nu["rnn"]["w_hh_bwd"],
        adam.exp_avg_sq["rnn.lstm.weight_hh_l0_reverse"].numpy())
    # the one tower file: the JAX package's tree of the tower
    _tree_equal(serialization.from_bytes(
        {"w2v2_pr": tree["w2v2_pr"]},
        (fold / "frozen_tower.msgpack").read_bytes()),
        {"w2v2_pr": jax.tree.map(np.asarray, tree["w2v2_pr"])})

    # the fold's end: whole-model best and last, which the JAX adapter's
    # restores read through their full-model fallbacks
    ckpt.finalize()
    _tree_equal(jax_ckpt.restore_best(head), best)
    params, opt, _ = jax_ckpt.restore_last(head, tx.init(head))
    _tree_equal(params, {k: x for k, x in live.items() if k != "w2v2_pr"})
    assert int(opt.inner_state[0].count) == 4


def _jax_tree(model):
    """The JAX tree of ``model``'s parameters now, as numpy copies."""
    return jax.tree.map(lambda t: t.numpy().copy(), to_host(
        jax_params_from_any_state_dict(model.state_dict())))


def _tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
        return
    got = np.asarray(got)
    assert got.dtype == np.float32 and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)
