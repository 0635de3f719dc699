"""aptai_tpu_torch's checkpoints against the JAX package's (the
``CheckpointManager`` is in ``test_torch_checkpoint_manager.py``):

* the flax msgpack reader against ``flax.serialization.msgpack_restore``,
  bit for bit, on tiny W2V2PR, APTAI and FORCE-APTAI trees with a bfloat16
  leaf, numpy scalars and arrays split into chunks;
* ``load_model`` / ``load_predictor`` on experiment directories the JAX
  ``CheckpointManager`` wrote, for each model kind: the port's predictor
  outputs equal the JAX predictor's (float32, within 1e-4 of the largest
  magnitude; decoded sequences equal), and for an APTAI run whose
  backbone has ``fused_qkv`` and ``do_stable_layer_norm=False``;
* a JAX run's optax Adam state: the masked FORCE state (the tower frozen,
  weight decay on) puts the head's moments on their parameters by name and
  ``count`` in ``step``; a state other than the trainers' Adam, or a
  parameter the JAX run froze but the port trains, raises.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from aptai_tpu.infer import api as japi
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu.train import harness as jharness
from aptai_tpu_torch.infer.loader import (backbone_from_dict, load_model,
                                          load_predictor,
                                          resolve_checkpoint_dir)
from aptai_tpu_torch.models import APTAI, ForceAPTAI
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.train import checkpoints as tckpt
from aptai_tpu_torch.train import torch_adam

from _torch_port import (jax_lstm_one_step_a_loop, one_torch_thread,
                         random_jax_aptai_params, random_jax_force_params,
                         random_jax_w2v2_pr_params)


# the 7-layer conv stack (49 frames a second), tiny widths
STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
V = 11
VOCAB = {f"p{i}": i for i in range(V)}
TOL = 1e-4
VARIANTS = dict(fused_qkv=True, attention_layout="bthd",
                do_stable_layer_norm=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module", autouse=True)
def _jax_lstm_one_step_a_loop():
    with pytest.MonkeyPatch.context() as mp:
        jax_lstm_one_step_a_loop(mp)
        yield


# -- the flax msgpack reader --------------------------------------------------

@pytest.fixture(scope="module")
def jax_trees():
    cfg_t = tcfg.tiny_config(**STACK)
    return {"w2v2_pr": random_jax_w2v2_pr_params(cfg_t, 1),
            "aptai": random_jax_aptai_params(cfg_t, V, 2),
            "force_aptai": random_jax_force_params(
                jcfg.tiny_config(**STACK), V, 3)}


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):  # bfloat16 by way of uint16
        assert got.dtype == torch.bfloat16, path
        assert np.array_equal(got.view(torch.uint16).numpy(),
                              np.asarray(want).view(np.uint16)), path
    else:
        assert type(got) is type(want), path
        assert np.asarray(got).dtype == np.asarray(want).dtype, path
        assert np.array_equal(got, want), path


@pytest.mark.parametrize("kind", ["w2v2_pr", "aptai", "force_aptai"])
def test_msgpack_reader_matches_flax(jax_trees, kind, monkeypatch):
    tree = dict(jax_trees[kind])
    rng = np.random.default_rng(4)
    tree["extra"] = {
        "bf16": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
        "scalar_f32": np.float32(1.5), "scalar_i64": np.int64(-7),
        "big": rng.standard_normal((50, 3)).astype(np.float32),
        "big_bf16": jnp.asarray(rng.standard_normal(300), jnp.bfloat16),
        "empty": np.zeros((0, 4), np.int32)}
    # arrays over 256 bytes split into chunks, as flax splits those over
    # its 1 GiB limit
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    want = serialization.msgpack_restore(data)
    got = tckpt.msgpack_restore(data)
    _assert_same_tree(got, want)


def test_msgpack_reader_refuses_what_flax_does_not_write():
    with pytest.raises(ValueError, match="truncated"):
        tckpt.msgpack_restore(serialization.msgpack_serialize(
            {"a": np.ones(4, np.float32)})[:-3])
    with pytest.raises(ValueError, match="not used by flax"):
        tckpt.msgpack_restore(b"\xc1")


# -- aptai_tpu experiment directories -----------------------------------------

def _jax_backbone(kind):
    backbone = jcfg.tiny_config(**STACK)
    if kind == "w2v2_pr":
        backbone = dataclasses.replace(backbone, vocab_size=V)
    return backbone


def _jax_predictor(kind, params):
    """The JAX package's predictor over ``params`` (its own ``load_model``
    would rebuild the same tree through an eager ``init``)."""
    backbone = _jax_backbone(kind)
    if kind == "w2v2_pr":
        return japi.W2V2PRPredictor(JaxW2V2PR(backbone), params, VOCAB)
    if kind == "aptai":
        return japi.APTAIPredictor(JaxAPTAI(backbone, num_phonemes=V),
                                   params)
    return japi.ForceAPTAIPredictor(JaxForceAPTAI(backbone, vocab_size=V),
                                    params)


def _jax_experiment(root, kind, params):
    """What a JAX trainer leaves: best and last checkpoints with
    ``model_cfg.json``."""
    backbone = _jax_backbone(kind)
    model_cfg = {"backbone": dataclasses.asdict(backbone), "vocab": VOCAB,
                 "kind": kind}
    if kind == "force_aptai":
        model_cfg.update(decode_method="greedy", pr_spliced=True)
    manager = jckpt.CheckpointManager(root / kind, "m")
    manager.update(0, {"m": 1.0}, params, model_cfg=model_cfg)
    return root / kind


@pytest.fixture(scope="module")
def jax_experiments(jax_trees, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_runs")
    return {kind: _jax_experiment(root, kind, tree)
            for kind, tree in jax_trees.items()}


def _wavs():
    rng = np.random.default_rng(5)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (16_000, 9_000, 24_000)]


OUTPUTS = {"w2v2_pr": ("encode_batch", ("phoneme_logits",
                                        "last_transf_hidden"), ()),
           "aptai": ("predict_batch", ("tvs_pred", "phn_fc_probs"),
                     ("phn_fc_pred",)),
           "force_aptai": ("predict_batch", ("tvs_pred", "hidden_tvs"),
                           ("pred_ctc_phn_seq", "phn_seq_lengths",
                            "pred_frame_phns"))}


@pytest.mark.parametrize("kind", ["w2v2_pr", "aptai", "force_aptai"])
def test_load_predictor_on_jax_experiment_matches_jax(jax_trees,
                                                      jax_experiments, kind):
    exp = jax_experiments[kind]
    assert resolve_checkpoint_dir(exp) == exp / "best-model-ckpt"
    got_kind, model, vocab = load_model(exp)
    assert got_kind == kind and vocab == VOCAB and not model.training
    method, close, equal = OUTPUTS[kind]
    wavs = _wavs()
    got = getattr(load_predictor(exp, device="cpu"), method)(wavs)
    want = getattr(_jax_predictor(kind, jax_trees[kind]), method)(wavs)
    for k in close:
        w = np.asarray(want[k], np.float32)
        g = got[k].float().numpy()
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= TOL * np.abs(w).max(), k
    for k in equal:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_backbone_dicts_cross_and_unported_fields_raise(jax_experiments):
    d = json.loads((jax_experiments["aptai"] / "best-model-ckpt"
                    / "model_cfg.json").read_text())["backbone"]
    assert (dataclasses.asdict(backbone_from_dict(d))
            == dataclasses.asdict(tcfg.tiny_config(**STACK)))
    variants = dict(d, fused_qkv=True, attention_layout="bthd",
                    do_stable_layer_norm=False)
    assert (dataclasses.asdict(backbone_from_dict(variants))
            == dataclasses.asdict(tcfg.tiny_config(**STACK, **VARIANTS)))
    # a JSON list crosses as the tuple; a spec the port cannot place raises
    assert backbone_from_dict(dict(d, activation_partition=[
        "data", "model", None])).activation_partition == ("data", "model",
                                                           None)
    with pytest.raises(ValueError, match="activation_partition"):
        backbone_from_dict(dict(d, activation_partition=["data", None,
                                                         "model"]))
    # quant replaces the backbone's field; the parameters do not change
    _, exact, _ = load_model(jax_experiments["aptai"])
    _, model, _ = load_model(jax_experiments["aptai"], quant="w8a8")
    assert model.cfg.quant == "w8a8" and exact.cfg.quant == "none"
    assert (dataclasses.replace(model.cfg, quant="none") == exact.cfg)
    want = exact.state_dict()
    got = model.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # a mesh on another kind of device than the predictor's raises
    with pytest.raises(ValueError, match="the mesh runs on cuda"):
        load_predictor(jax_experiments["aptai"], device="cpu",
                       mesh=types.SimpleNamespace(device_type="cuda"))


def test_load_model_on_a_jax_experiment_with_the_encoder_variants(tmp_path):
    """A JAX APTAI run whose backbone has ``fused_qkv`` and
    ``do_stable_layer_norm=False``: ``load_model`` builds that encoder
    (``qkv_proj`` through the bridge) and ``load_predictor`` predicts as
    the JAX predictor does."""
    backbone = jcfg.tiny_config(**STACK, fused_qkv=True,
                                do_stable_layer_norm=False)
    params = random_jax_aptai_params(
        tcfg.tiny_config(**STACK, fused_qkv=True,
                         do_stable_layer_norm=False), V, 6)
    manager = jckpt.CheckpointManager(tmp_path / "aptai", "m")
    manager.update(0, {"m": 1.0}, params, model_cfg={
        "backbone": dataclasses.asdict(backbone), "vocab": VOCAB,
        "kind": "aptai"})
    kind, model, _ = load_model(tmp_path / "aptai")
    assert kind == "aptai" and model.cfg.fused_qkv
    assert not model.cfg.do_stable_layer_norm
    assert "wav2vec2.encoder.layers.0.attention.qkv_proj.weight" \
        in model.state_dict()
    wavs = _wavs()
    got = load_predictor(tmp_path / "aptai", device="cpu").predict_batch(
        wavs)
    want = japi.APTAIPredictor(JaxAPTAI(backbone, num_phonemes=V),
                               params).predict_batch(wavs)
    for k in ("tvs_pred", "phn_fc_probs"):
        w = np.asarray(want[k], np.float32)
        g = got[k].float().numpy()
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= TOL * np.abs(w).max(), k
    np.testing.assert_array_equal(got["phn_fc_pred"].numpy(),
                                  np.asarray(want["phn_fc_pred"]))


# -- a JAX run's optax Adam state ---------------------------------------------

def _jax_adam_checkpoint(root, params, frozen=(), weight_decay=0.0, seed=0):
    """A JAX last checkpoint of ``params`` whose optax state (the JAX
    trainers' ``torch_adam``) took one update of random gradients, written
    by the JAX manager; returns the state's ``count``, ``mu`` and ``nu``."""
    tx = jharness.torch_adam(weight_decay=weight_decay,
                             frozen_prefixes=frozen)
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), params)
    state = jax.jit(tx.init)(params)
    update = jax.jit(tx.update)
    for _ in range(2):
        _, state = update(grads, state, params)
    state = jax.device_get(state)
    jckpt.CheckpointManager(root, "m").save_interrupt(
        1, params, opt_state=state, step=2)
    inner = state.inner_state if frozen else state
    adam = [s for s in inner if isinstance(s, optax.ScaleByAdamState)][0]
    return int(adam.count), adam.mu, adam.nu


def test_force_head_moments_restored_from_a_jax_run(jax_trees, tmp_path):
    """A masked FORCE state (the tower frozen, weight decay on): the head's
    moments land on their parameters by name, the tower holds none."""
    params = jax.tree.map(np.asarray, jax_trees["force_aptai"])
    count, mu, nu = _jax_adam_checkpoint(tmp_path, params,
                                         frozen=("w2v2_pr",),
                                         weight_decay=1e-2)
    manager = tckpt.CheckpointManager(tmp_path, "m")
    assert manager.has_last()
    sd, opt_state, meta = manager.restore_last()
    assert meta["step"] == count == 2
    model = ForceAPTAI(tcfg.tiny_config(**STACK), vocab_size=V)
    model.load_state_dict(sd)
    opt = torch_adam(model)
    tckpt.load_optimizer_state(opt, model, opt_state)
    state = {n: opt.state[p] for n, p in model.named_parameters()
             if p in opt.state}
    assert set(state) == {n for n, p in model.named_parameters()
                          if not n.startswith("w2v2_pr.")}
    for name, want_mu, want_nu in (
            ("frame_lin.weight", mu["frame_lin"]["kernel"].T,
             nu["frame_lin"]["kernel"].T),
            ("rnn.lstm.weight_hh_l0_reverse", mu["rnn"]["w_hh_bwd"],
             nu["rnn"]["w_hh_bwd"]),
            ("phn_encoder.embed.weight", mu["phn_encoder"]["embed"][
                "embedding"], nu["phn_encoder"]["embed"]["embedding"])):
        np.testing.assert_array_equal(state[name]["exp_avg"].numpy(),
                                      np.asarray(want_mu), err_msg=name)
        np.testing.assert_array_equal(state[name]["exp_avg_sq"].numpy(),
                                      np.asarray(want_nu), err_msg=name)
        assert state[name]["step"].dtype == torch.float32
        assert float(state[name]["step"]) == count


def test_unmappable_jax_optimizer_state_raises(jax_trees, tmp_path):
    """An optax state other than the trainers' Adam names itself in an
    error; resuming never starts over in silence."""
    params = jax.tree.map(np.asarray, jax_trees["aptai"])
    state = optax.sgd(0.1, momentum=0.9).init(params)
    jckpt.CheckpointManager(tmp_path, "m").save_interrupt(
        1, params, opt_state=state, step=2)
    with pytest.raises(ValueError, match="cannot map this optax state"):
        tckpt.CheckpointManager(tmp_path, "m").restore_last()

    # a parameter the port trains but the JAX run froze
    _jax_adam_checkpoint(tmp_path, params, frozen=("tv_linear",))
    _, opt_state, _ = tckpt.CheckpointManager(tmp_path, "m").restore_last()
    model = APTAI(tcfg.tiny_config(**STACK), num_phonemes=V)
    with pytest.raises(ValueError, match="tv_linear.weight.*frozen"):
        tckpt.load_optimizer_state(torch_adam(model), model, opt_state)
