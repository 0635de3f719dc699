"""aptai_tpu_torch W2V2PR training against the JAX package, float32 on the
CPU: two Adam steps through ``TrainStep`` with ``pr_loss_fn`` against
``make_train_step(pr_loss_fn(model), torch_adam())`` with the feature
encoder trainable and frozen, the 10 ms frame rate, ``train_from_features``,
``remat_policy="dots"`` (against ``"none"``, against JAX's ``"dots"``, and
what it saves and recomputes), the APTAI adapter against the step it
replaces, and the evaluation forwards.

The config is tiny in width but keeps the 7-layer conv stack, so frames
come at ~49 Hz and the CTC recursion stays short; dropout and SpecAugment
are off where the port is held to JAX."""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import configs as jcfg
from aptai_tpu.train import create_train_state, make_train_step
from aptai_tpu.train import harness as jharness
from aptai_tpu.train.train_pr import pr_loss_fn as jax_pr_loss_fn
from aptai_tpu_torch.models import random_aptai, random_w2v2_pr
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import w2v2_pr_state_dict_from_jax
from aptai_tpu_torch.ops import attention as tatt
from aptai_tpu_torch.train import (TrainStep, aptai_loss_fn, pr_loss_fn,
                                   torch_adam)
from aptai_tpu_torch.train import train_aptai, train_pr
from aptai_tpu_torch.train.harness import SPEC_AUGMENT_SEED_OFFSET

from _torch_port import NO_DROP, port_w2v2_pr_from_jax, \
    random_jax_w2v2_pr_params

STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
DET = dict(NO_DROP, final_dropout=0.0, mask_time_prob=0.0, **STACK)
FE = "wav2vec2.feature_extractor."
# softmax is invariant to a shift shared by a row's logits, so the key
# projection's bias gets only roundoff, which Adam scales up to ±lr a step
ZERO_GRAD = "attention.k_proj.bias"
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    cfg_t = tcfg.tiny_config(**DET)
    params = random_jax_w2v2_pr_params(cfg_t, seed=31)
    rng = np.random.default_rng(32)
    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    audio[1, 5500:] = 0.0
    batch = {"audio": audio,
             "audio_lengths": np.array([8000, 5500], np.int32),
             "phoneme_labels": np.array([[3, 3, 5, 1, 7, 2],
                                         [4, 9, 9, 2, -100, -100]],
                                        np.int32)}
    return cfg_t, params, batch


def _jax_model(cfg_j, **kw):
    return JaxW2V2PR(cfg_j, **kw)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _assert_grads_match_jax(model, jgrads, n_expected):
    want = w2v2_pr_state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    checked = 0
    for name, p in model.named_parameters():
        if p.grad is None:  # the mask embedding: no mask is drawn
            assert name.endswith("masked_spec_embed"), name
            assert not want[name].numpy().any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
        checked += 1
    assert checked == n_expected


@pytest.mark.parametrize("freeze", [False, True])
def test_adam_steps_match_jax_make_train_step(setup, freeze):
    """Two Adam steps at lr 1e-3 through ``TrainStep(pr_loss_fn())``
    against JAX's engine with its ``pr_loss_fn``: every parameter within
    1e-5 after each step; a frozen feature encoder stays bit-identical and
    a trainable one moves."""
    cfg_t, params, batch = setup
    jmodel = _jax_model(jcfg.tiny_config(**DET),
                        freeze_feature_encoder=freeze)
    jstep = make_train_step(jax_pr_loss_fn(jmodel), jharness.torch_adam())
    state = create_train_state(jax.tree.map(jnp.array, params),
                               jharness.torch_adam())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = port_w2v2_pr_from_jax(cfg_t, params,
                                  freeze_feature_encoder=freeze)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = TrainStep(model, torch_adam(model), pr_loss_fn(), device="cpu")

    for i in range(2):
        state, jm = jstep(state, jb, jax.random.PRNGKey(0), jnp.float32(LR))
        m = step(batch, LR)
        assert set(m) == {"loss"}
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-4)
        want = w2v2_pr_state_dict_from_jax(
            jax.tree.map(np.asarray, state.params))
        for name, p in model.named_parameters():
            if name.endswith(ZERO_GRAD):
                assert (p.detach() - want[name]).abs().max() <= 2 * LR * (i + 1)
                assert p.grad.abs().max() < 1e-6
                continue
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"step {i + 1}: {name}")
    fe_moved = [not torch.equal(p, before[n])
                for n, p in model.named_parameters() if n.startswith(FE)]
    assert fe_moved and (not any(fe_moved) if freeze else all(fe_moved))


def test_ten_ms_loss_and_gradients_match_jax(setup):
    """``with_ten_ms()`` (last conv stride 1, twice the frames): the loss
    and every gradient, feature encoder included, against JAX."""
    cfg_t, params, batch = setup
    cfg_t = cfg_t.with_ten_ms()
    jmodel = _jax_model(jcfg.tiny_config(**DET).with_ten_ms())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_pr_loss_fn(jmodel)(p, jb, {}), has_aux=True))(params)

    model = port_w2v2_pr_from_jax(cfg_t, params).train()
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = pr_loss_fn()(model, data, None)
    loss.backward()
    assert aux == {}
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
    with torch.no_grad():
        t = model(data["audio"], data["audio_lengths"],
                  data["phoneme_labels"])["log_probs"].shape[1]
    assert t == cfg_t.feat_extract_output_lengths(8000) > 2 * (
        tcfg.tiny_config(**DET).feat_extract_output_lengths(8000) - 1)
    _assert_grads_match_jax(model, jgrads, len(list(model.parameters())) - 1)


def test_train_from_features_equals_audio_step(setup):
    """On a frozen feature encoder, a step from its output
    (``pr_loss_fn(from_features=True)``, batch key ``fe_features``) equals
    the step from the audio, with dropout and SpecAugment on and the same
    seed: the same loss and the same parameters after the update."""
    cfg_t, params, batch = setup
    cfg_t = dataclasses.replace(cfg_t, hidden_dropout=0.1,
                                attention_dropout=0.1, final_dropout=0.1,
                                mask_time_prob=0.3)
    runs = []
    for from_features in (False, True):
        model = port_w2v2_pr_from_jax(cfg_t, params,
                                      freeze_feature_encoder=True)
        data = dict(batch)
        if from_features:
            with torch.no_grad():
                data = {"fe_features": model.wav2vec2.feature_extractor(
                    torch.from_numpy(batch["audio"])),
                    "audio_lengths": batch["audio_lengths"],
                    "phoneme_labels": batch["phoneme_labels"]}
        step = TrainStep(model, torch_adam(model),
                         pr_loss_fn(from_features=from_features),
                         device="cpu", seed=5)
        runs.append((step(data, LR)["loss"], model.state_dict()))
    (l0, s0), (l1, s1) = runs
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for name in s0:
        torch.testing.assert_close(s1[name], s0[name], rtol=0, atol=1e-7,
                                   msg=name)


def _step_grads(cfg, remat, batch, seed=7):
    model = random_w2v2_pr(dataclasses.replace(cfg, remat_policy=remat),
                           seed=3)
    loss = TrainStep(model, torch_adam(model), pr_loss_fn(), device="cpu",
                     seed=seed)(batch, LR)["loss"]
    return loss, _grads(model)


@pytest.mark.parametrize("dropout", [False, True])
def test_remat_dots_gives_the_gradients_of_none(setup, dropout):
    """``"dots"`` recomputes each layer but its dense products in the
    backward, dropout masks included: the loss and every gradient of
    ``"none"``, with dropout and SpecAugment on or off."""
    cfg_t, _, batch = setup
    if dropout:
        cfg_t = tcfg.tiny_config(**STACK)
    l0, g0 = _step_grads(cfg_t, "none", batch)
    l1, g1 = _step_grads(cfg_t, "dots", batch)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    assert set(g0) == set(g1)
    assert any(n.startswith(FE) for n in g0)
    assert any("masked_spec_embed" in n for n in g0) == dropout
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-6,
                                   msg=n)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_saves_dense_products_and_recomputes_attention(
        setup, monkeypatch):
    """In the backward, ``"full"`` runs each layer's six projections
    (``addmm``) again and ``"dots"`` none, while both run attention's
    forward again (the flash kernel on the card, its plain version here)
    and recompute the elementwise ops (GELU); ``"none"`` recomputes
    nothing."""
    cfg_t, _, batch = setup
    cfg_t = tcfg.tiny_config(**STACK)
    layers = cfg_t.num_hidden_layers
    attn = []
    plain = tatt.flash_attention_bhtd_plain
    monkeypatch.setattr(tatt, "flash_attention_bhtd_plain",
                        lambda *a, **k: attn.append(1) or plain(*a, **k))
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    seen = {}
    for remat in ("none", "full", "dots"):
        model = random_w2v2_pr(dataclasses.replace(cfg_t,
                                                   remat_policy=remat),
                               seed=3).train()
        torch.manual_seed(0)
        loss, _ = pr_loss_fn()(model, data, torch.Generator().manual_seed(1))
        attn.clear()
        with _OpCounter() as count:
            loss.backward()
        aten = torch.ops.aten
        seen[remat] = (count.ops[aten.addmm.default], len(attn),
                       count.ops[aten.gelu.default])
    assert seen["none"] == (0, 0, 0)
    assert seen["full"] == (6 * layers, layers, layers)
    assert seen["dots"] == (0, layers, layers)


def test_remat_dots_matches_jax_dots(setup):
    """The port's ``"dots"`` against JAX's ``remat_policy="dots"``
    (``dots_saveable``) in a training forward: the loss and every
    gradient."""
    cfg_t, params, batch = setup
    jmodel = _jax_model(jcfg.tiny_config(**DET, remat_policy="dots"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_pr_loss_fn(jmodel)(p, jb, {}), has_aux=True))(params)
    model = port_w2v2_pr_from_jax(
        dataclasses.replace(cfg_t, remat_policy="dots"), params).train()
    loss, _ = pr_loss_fn()(model, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, None)
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
    _assert_grads_match_jax(model, jgrads, len(list(model.parameters())) - 1)


def test_aptai_adapter_step_equals_the_direct_step():
    """``TrainStep``'s default adapter is APTAI's: two steps with dropout
    and SpecAugment on give the loss, aux and parameters of the step
    written out by hand (the model called on the four batch keys, dropout
    from ``seed + step``, SpecAugment from its own generator), bit for
    bit."""
    cfg = tcfg.tiny_config()
    rng = np.random.default_rng(33)
    t = int(cfg.feat_extract_output_lengths(2400))
    batch = {"audio": (rng.standard_normal((2, 2400)) * 0.1).astype(
                 np.float32),
             "audio_lengths": np.array([2400, 1900], np.int32),
             "phn_frames": rng.integers(1, 11, (2, t)).astype(np.int32),
             "tv_targets": rng.standard_normal((2, t, 9)).astype(np.float32)}
    data = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = random_aptai(cfg, seed=2, num_phonemes=11).train()
    ref_opt = torch_adam(ref)
    model = random_aptai(cfg, seed=2, num_phonemes=11)
    step = TrainStep(model, torch_adam(model), device="cpu", seed=9)
    assert step.loss_fn.batch_keys == aptai_loss_fn().batch_keys
    for i in range(2):
        for group in ref_opt.param_groups:
            group["lr"] = LR
        ref_opt.zero_grad(set_to_none=True)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(9 + i)
            gen = torch.Generator().manual_seed(9 + i
                                                + SPEC_AUGMENT_SEED_OFFSET)
            out = ref(data["audio"], data["audio_lengths"],
                      data["phn_frames"], data["tv_targets"], generator=gen)
            out["loss"].backward()
        ref_opt.step()
        got = step(batch, LR)
        assert set(got) == {"loss", "mse_loss", "ce_loss"}
        for name in got:
            assert torch.equal(got[name], out[name].detach()), name
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), name


def test_train_step_checks_the_adapters_keys(setup):
    """``TrainStep`` reads exactly its adapter's keys: a missing one and
    keys that disagree on the batch size raise, extra keys are ignored."""
    cfg_t, _, batch = setup
    model = random_w2v2_pr(cfg_t, seed=1)
    step = TrainStep(model, torch_adam(model), pr_loss_fn(), device="cpu")
    with pytest.raises(KeyError, match="phoneme_labels"):
        step({k: batch[k] for k in ("audio", "audio_lengths")}, LR)
    with pytest.raises(ValueError, match="disagree"):
        step(dict(batch, audio_lengths=batch["audio_lengths"][:1]), LR)
    with pytest.raises(KeyError, match="fe_features"):
        TrainStep(model, torch_adam(model), pr_loss_fn(from_features=True),
                  device="cpu")(batch, LR)
    assert step(dict(batch, phn_frames=None), LR)["loss"].isfinite()


@pytest.mark.parametrize("family", ["w2v2_pr", "aptai"])
def test_eval_forward_restores_mode_and_takes_no_gradient(setup, family):
    """``make_eval_forward``: the eval-mode forward (no dropout: two calls
    agree) under ``no_grad``, the JAX package's fields, and the module's
    train/eval state as it was."""
    cfg_t, _, batch = setup
    cfg = tcfg.tiny_config(**STACK)
    if family == "w2v2_pr":
        model, mod = random_w2v2_pr(cfg, seed=1), train_pr
    else:
        model, mod = random_aptai(cfg, seed=1, num_phonemes=11), train_aptai
        t = int(cfg.feat_extract_output_lengths(8000))
        batch = dict(batch, phn_frames=np.ones((2, t), np.int32),
                     tv_targets=np.zeros((2, t, 9), np.float32))
    forward = mod.make_eval_forward(model)
    for training in (True, False):
        model.train(training)
        a, b = forward(batch), forward(batch)
        assert model.training == training
        assert tuple(a) == mod.EVAL_FIELDS
        for k in a:
            assert not a[k].requires_grad
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
