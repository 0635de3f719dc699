"""aptai_tpu_torch training path against the JAX package, float32 on the
CPU: the masked loss, every parameter's gradient, Adam steps through
``TrainStep`` against ``make_train_step(loss_fn, torch_adam())``, the
encoder's training options (external time mask, ``output_hidden_states``,
``train_from_features``, remat, gradient accumulation), the SpecAugment
span sampler, the LR schedule and the training FLOP count."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu.models import wav2vec2 as jw2v
from aptai_tpu.train import create_train_state, make_train_step
from aptai_tpu.train import harness as jharness
from aptai_tpu.train import schedule as jschedule
from aptai_tpu.utils import flops as jflops
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_aptai
from aptai_tpu_torch.models.convert import state_dict_from_jax
from aptai_tpu_torch.models.wav2vec2 import (compute_time_mask,
                                             sample_span_starts,
                                             spans_to_mask)
from aptai_tpu_torch.train import (TrainStep, epoch_learning_rate, lr_lambda,
                                   torch_adam)
from aptai_tpu_torch.utils import flops as tflops

from _torch_port import NO_DROP, port_aptai_from_jax, random_jax_aptai_params

NUM_PHN = 11
DET = dict(NO_DROP, mask_time_prob=0.0)  # a deterministic training forward
HEADS_OFF = dict(tv_drop=0.0, phn_drop=0.0)
FE = "wav2vec2.feature_extractor."
# the key projection's bias has an exactly zero gradient (softmax is
# invariant to a shift shared by a row's logits), so both packages see
# only roundoff, which Adam's normalisation then scales up to ±lr
ZERO_GRAD = "attention.k_proj.bias"


def _batch(seed, b, samples, lengths, cfg, width_delta=0, pad_targets=True):
    """Audio silent past each length; phoneme ids 1..NUM_PHN-1 and TV
    targets, carrying the pad sentinels (0, -100) past each item's frames
    when ``pad_targets``; targets ``width_delta`` frames wider than the
    encoder's output (negative: narrower)."""
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((b, samples)) * 0.1).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    t = int(cfg.feat_extract_output_lengths(samples)) + width_delta
    phn = rng.integers(1, NUM_PHN, (b, t)).astype(np.int32)
    tv = rng.standard_normal((b, t, 9)).astype(np.float32)
    if pad_targets:
        for i, n in enumerate(cfg.feat_extract_output_lengths(lens)):
            phn[i, n:] = 0
            tv[i, n:] = -100.0
    return {"audio": audio, "audio_lengths": lens, "phn_frames": phn,
            "tv_targets": tv}


def _torch_batch(batch):
    return [torch.from_numpy(batch[k]) for k in
            ("audio", "audio_lengths", "phn_frames", "tv_targets")]


@pytest.fixture(scope="module")
def setup():
    cfg_t = tcfg.tiny_config(**DET)
    params = random_jax_aptai_params(cfg_t, NUM_PHN, seed=11)
    jmodel = JaxAPTAI(jcfg.tiny_config(**DET), num_phonemes=NUM_PHN,
                      **HEADS_OFF)
    batch = _batch(12, 2, 2400, [2400, 1700], cfg_t, width_delta=-4)
    return cfg_t, params, jmodel, batch


def _jax_loss_fn(jmodel):
    def loss_fn(p, b, rngs=None):
        out = jmodel.apply({"params": p}, b["audio"], b["audio_lengths"],
                           b["phn_frames"], b["tv_targets"],
                           deterministic=False, rngs=rngs)
        return out["loss"], {"mse_loss": out["mse_loss"],
                             "ce_loss": out["ce_loss"]}
    return loss_fn


def test_loss_and_gradients_match_jax(setup):
    """(d) loss, MSE and CE of the training forward in train() mode with
    dropout and masking off, and (e) the gradient of every trainable
    parameter, mapped from the JAX tree through ``state_dict_from_jax``;
    the frozen feature encoder gets none (zeros in JAX)."""
    cfg_t, params, jmodel, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jmodel), has_aux=True))(params, jb)
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))

    model = port_aptai_from_jax(cfg_t, params, NUM_PHN, **HEADS_OFF).train()
    out = model(*_torch_batch(batch))
    out["loss"].backward()
    for name in ("loss", "mse_loss", "ce_loss"):
        want = float(jloss if name == "loss" else jaux[name])
        assert out[name].item() == pytest.approx(want, rel=2e-3), name
    assert out["tvs_pred"].shape[1] == batch["phn_frames"].shape[1] + 4

    n_checked = 0
    for name, p in model.named_parameters():
        want = want_grads[name].numpy()
        if p.grad is None:
            # no gradient: the frozen FE, and the mask embedding (no mask)
            assert name.startswith(FE) or name.endswith("masked_spec_embed")
            assert not want.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-5, err_msg=name)
        n_checked += 1
    assert n_checked == len(want_grads) - 4 * 3 - 1  # FE layers, embedding


def test_adam_steps_match_jax_make_train_step(setup):
    """(f) two Adam steps at lr 1e-3: the port's ``TrainStep`` with
    ``torch_adam`` against ``make_train_step(loss_fn, torch_adam())``;
    every parameter agrees to 1e-5 after each step and the feature encoder
    stays bit-identical."""
    cfg_t, params, jmodel, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = make_train_step(_jax_loss_fn(jmodel), jharness.torch_adam())
    state = create_train_state(jax.tree.map(jnp.array, params),
                               jharness.torch_adam())
    model = port_aptai_from_jax(cfg_t, params, NUM_PHN, **HEADS_OFF)
    fe_before = {n: p.detach().clone() for n, p in model.named_parameters()
                 if n.startswith(FE)}
    step = TrainStep(model, torch_adam(model), device="cpu")
    assert model.training

    for i in range(2):
        state, jm = jstep(state, jb, jax.random.PRNGKey(0), jnp.float32(1e-3))
        m = step(batch, 1e-3)
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=2e-3)
        want = state_dict_from_jax(jax.tree.map(np.asarray, state.params))
        for name, p in model.named_parameters():
            if name.endswith(ZERO_GRAD):
                # both moved by at most lr per step, from roundoff alone
                assert (p.detach() - want[name]).abs().max() <= 2e-3 * (i + 1)
                assert p.grad.abs().max() < 1e-6
                continue
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"step {i + 1}: {name}")
    for name, p in model.named_parameters():
        if name.startswith(FE):
            assert torch.equal(p, fe_before[name]), name


def test_encoder_with_external_time_mask_matches_jax(setup):
    """(g) the encoder in train() mode with one external (B, T) time mask,
    against the JAX encoder given the same mask; (i) its
    ``output_hidden_states`` (HF indexing: N + 1 states, the last the
    final LayerNorm output) against JAX's."""
    cfg_t, params, _, batch = setup
    enc = jw2v.Wav2Vec2Encoder(jcfg.tiny_config(**DET))
    model = port_aptai_from_jax(cfg_t, params, NUM_PHN).wav2vec2.train()
    audio, lens = (torch.from_numpy(batch[k])
                   for k in ("audio", "audio_lengths"))
    t = int(cfg_t.feat_extract_output_lengths(audio.shape[1]))
    mask = np.random.default_rng(13).random((2, t)) < 0.3

    want_h, _, _, want_all = jax.jit(
        lambda p, a, l, m: enc.apply({"params": p}, a, l,
                                     deterministic=False, time_mask=m,
                                     output_hidden_states=True))(
        params["encoder"], jnp.asarray(batch["audio"]),
        jnp.asarray(batch["audio_lengths"]), jnp.asarray(mask))
    with torch.no_grad():
        got_h, _, _, got_all = model(audio, lens, time_mask=torch.from_numpy(
            mask), output_hidden_states=True)
        unmasked, _, _ = model(audio, lens)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-5)
    assert not torch.allclose(unmasked, got_h, atol=1e-3)  # the mask acted
    assert len(got_all) == len(want_all) == cfg_t.num_hidden_layers + 1
    for i, (g, w) in enumerate(zip(got_all, want_all)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f"hidden state {i}")
    torch.testing.assert_close(got_all[-1], got_h, rtol=0, atol=0)


def test_train_from_features_matches_forward(setup):
    """(h) the forward from per-utterance feature-extractor outputs (each
    computed alone, then zero-padded into a batch) equals the forward from
    the padded audio on every valid frame."""
    cfg_t, params, _, batch = setup
    model = port_aptai_from_jax(cfg_t, params, NUM_PHN, **HEADS_OFF).train()
    audio, lens, phn, tv = _torch_batch(batch)
    t = int(cfg_t.feat_extract_output_lengths(audio.shape[1]))
    feats = torch.zeros((2, t, cfg_t.conv_dim[-1]))
    with torch.no_grad():
        for i, n in enumerate(lens.tolist()):
            _, _, f = model.wav2vec2(audio[i:i + 1, :n])
            feats[i, :f.shape[1]] = f[0]
        direct = model(audio, lens, phn, tv)
        cached = model.train_from_features(feats, lens, phn, tv)
    frames = cfg_t.feat_extract_output_lengths(lens).tolist()
    for i, n in enumerate(frames):
        torch.testing.assert_close(cached["phn_logits"][i, :n],
                                   direct["phn_logits"][i, :n],
                                   rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(cached["frame_lengths"],
                               direct["frame_lengths"])


def test_remat_full_gives_the_same_gradients():
    """(j) ``remat_policy="full"`` recomputes each layer in the backward,
    dropout masks included, and gives the same loss and gradients as
    ``"none"`` with dropout and SpecAugment on."""
    cfg = tcfg.tiny_config()
    runs = []
    for remat in ("none", "full"):
        model = random_aptai(dataclasses.replace(cfg, remat_policy=remat),
                             seed=3, num_phonemes=NUM_PHN)
        step = TrainStep(model, torch_adam(model), device="cpu", seed=7)
        batch = _batch(14, 2, 2400, [2400, 2000], cfg)
        loss = step(batch, 1e-3)["loss"]
        runs.append((loss, {n: p.grad for n, p in model.named_parameters()
                            if p.grad is not None}))
    (l0, g0), (l1, g1) = runs
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    assert set(g0) == set(g1) and any("masked_spec_embed" in n for n in g0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7,
                                   msg=n)


def test_grad_accum_two_equals_one():
    """(k) ``grad_accum=2`` averages two equal microbatches' gradients:
    with every frame valid (equal loss denominators) that is the
    full-batch gradient."""
    cfg = tcfg.tiny_config(**DET)
    batch = _batch(15, 4, 1600, [1600] * 4, cfg, pad_targets=False)
    runs = []
    for k in (1, 2):
        model = random_aptai(cfg, seed=4, num_phonemes=NUM_PHN, **HEADS_OFF)
        m = TrainStep(model, torch_adam(model), grad_accum=k,
                      device="cpu")(batch, 1e-3)
        runs.append((m, {n: p.grad for n, p in model.named_parameters()
                         if p.grad is not None}))
    (m1, g1), (m2, g2) = runs
    for name in ("loss", "mse_loss", "ce_loss"):
        torch.testing.assert_close(m2[name], m1[name], rtol=1e-5, atol=0)
    assert set(g1) == set(g2)
    for n in g1:
        torch.testing.assert_close(g2[n], g1[n], rtol=1e-4, atol=1e-6,
                                   msg=n)
    with pytest.raises(ValueError, match="not divisible"):
        TrainStep(model, torch_adam(model), grad_accum=3,
                  device="cpu")(batch, 1e-3)


def test_span_sampler_masks_inside_lengths():
    """(n) SpecAugment spans: ``mask_time_length`` frames each, starting
    inside the item's length so that the span ends inside it too (when the
    item is longer than a span), at least ``mask_time_min_masks`` and at
    most the JAX cap of them; the count follows prob · length / span with
    stochastic rounding."""
    gen = torch.Generator().manual_seed(0)
    lengths = torch.tensor([249, 120, 30, 5], dtype=torch.int32)
    t, span, prob, min_masks = 249, 10, 0.5, 2
    counts = []
    for _ in range(300):
        starts, n = sample_span_starts(gen, lengths, t, prob, span, min_masks)
        assert starts.shape == (4, int(prob * t / span) + 1)
        assert torch.all(n >= min_masks) and torch.all(n <= starts.shape[1])
        for i, length in enumerate(lengths.tolist()):
            used = starts[i, :n[i]]
            assert torch.all(used >= 0)
            if length > span:
                assert torch.all(used + span <= length)
            else:
                assert torch.all(used == 0)
        mask = spans_to_mask(starts, n, t, span)
        for i in range(4):
            for s in starts[i, :n[i]].tolist():
                assert mask[i, s:s + span].all()
            assert mask[i].sum() >= min(span, t)
        counts.append(n.float())
    mean = torch.stack(counts).mean(0)
    expected = torch.clamp(prob * lengths.float() / span, min=min_masks)
    expected = torch.minimum(expected, torch.tensor(13.0))
    torch.testing.assert_close(mean, expected, rtol=0, atol=0.15)
    # in the model the mask is cut to each item's frames
    frame_mask = torch.arange(t)[None, :] < lengths[:, None]
    cut = compute_time_mask(gen, lengths, t, prob, span,
                            min_masks) & frame_mask
    assert not cut[~frame_mask].any() and cut[3, :5].all()


def test_lr_schedule_matches_jax():
    """(l)"""
    for warmup, static, decay in ((5, 10, 0.9), (0, 3, 0.5), (3, 0, 0.95)):
        for epoch in range(41):
            args = (epoch, warmup, static, decay)
            assert lr_lambda(*args) == jschedule.lr_lambda(*args)
            assert (epoch_learning_rate(3e-5, *args)
                    == jschedule.epoch_learning_rate(3e-5, *args))


def test_training_flops_match_jax():
    """(m)"""
    for cfg_j, cfg_t in ((jcfg.Wav2Vec2Config(), tcfg.Wav2Vec2Config()),
                         (jcfg.tiny_config(), tcfg.tiny_config())):
        fwd = 8 * tflops.aptai_forward_flops(cfg_t, 80_000)
        assert fwd == 8 * jflops.aptai_forward_flops(cfg_j, 80_000)
        for remat in ("none", "full"):
            assert (tflops.training_step_flops(fwd)
                    == jflops.training_step_flops(fwd, remat) == 3 * fwd)
            assert (tflops.training_step_hfu_flops(fwd, remat)
                    == jflops.training_step_hfu_flops(fwd, remat))


def test_training_config_and_entry_points():
    """``remat_policy``: "none", "full" and "dots" are accepted, others
    raise; the model holds float32 parameters under bf16; ``torch_adam``
    leaves out frozen prefixes; ``TrainStep`` runs on the card unless told
    otherwise."""
    for remat in ("none", "full", "dots"):
        assert tcfg.Wav2Vec2Config(remat_policy=remat).remat_policy == remat
    with pytest.raises(ValueError, match="remat_policy"):
        tcfg.Wav2Vec2Config(remat_policy="some")
    model = random_aptai(tcfg.tiny_config(dtype="bfloat16"), seed=0,
                         num_phonemes=NUM_PHN)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    opt = torch_adam(model, frozen_prefixes=("wav2vec2.feature_extractor",))
    n_fe = sum(1 for n, _ in model.named_parameters() if n.startswith(FE))
    assert len(opt.param_groups[0]["params"]) == (
        len(list(model.parameters())) - n_fe)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrainStep(model, opt)
