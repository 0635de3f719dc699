"""aptai_tpu_torch's wav2vec2 pretraining model against the JAX package's,
float32 on the CPU, tiny config (2 layers, the 7-layer conv stack at 16
channels):

* the weight bridge (``pretrain_state_dict_from_jax``) and the family it
  is read as (``any_state_dict_from_jax``);
* ``GumbelVectorQuantizer``, deterministic and with injected Gumbel noise:
  quantized vectors, perplexity with and without a position mask, and the
  gradients through the straight-through sample;
* the distractor indices against JAX's on the same uniforms, exactly,
  lengths 0, 1, 2 and T;
* the whole ``Wav2Vec2Pretrain``, in ``train()`` at V = 8 and in
  ``eval()`` at V = 2 with distractors equal to the positive (one frame's
  all of them): its eight outputs and the gradients of ``loss`` against
  ``jax.grad`` through the bridge (losses 1e-5 relative; each gradient
  1e-3 relative + 1e-5, all together relative L2 1e-4 and cosine
  1 − 1e-8);
* ``PretrainConfig``'s flags and ``GumbelTemperatureLoader`` against
  JAX's.

The trainer's runs are in ``test_torch_pretrain_runs.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.models import pretrain as jpre_model
from aptai_tpu.train import config as jconfig
from aptai_tpu.train import pretrain as jpretrain
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models.convert import (any_state_dict_from_jax,
                                            pretrain_state_dict_from_jax)
from aptai_tpu_torch.models.pretrain import (GumbelVectorQuantizer,
                                             Wav2Vec2Pretrain,
                                             negative_indices_from_uniform,
                                             sample_negative_indices)
from aptai_tpu_torch.train import config as tconfig
from aptai_tpu_torch.train import pretrain as tpretrain

from _torch_port import _noisy_state_dict, one_torch_thread
from _torch_pretrain_tiny import (HEAD, OUTPUTS, TINY, _rel_close, jax_model,
                                  jax_tree, port_from_jax, random_jax_params)


# (V, train): the straight-through path; collisions in eval
CASES = ((8, True), (2, False))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _check_grads(model, want):
    """Each ``.grad`` against the bridged JAX gradient, and all together."""
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-3, atol=1e-5,
                                   err_msg=n)
    a = np.concatenate([got[n].ravel() for n in want]).astype(np.float64)
    b = np.concatenate([want[n].ravel() for n in want]).astype(np.float64)
    assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 1 - 1e-8


# -- the bridge ---------------------------------------------------------------

def test_bridge_round_trips_and_is_read_as_pretrain():
    cfg_t = tcfg.tiny_config(**TINY)
    sd = _noisy_state_dict(Wav2Vec2Pretrain(cfg_t, **HEAD), 3)
    params = jax_tree(sd, cfg_t.num_hidden_layers)
    for got in (pretrain_state_dict_from_jax(params),
                any_state_dict_from_jax(params)):
        assert set(got) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


# -- the quantizer ------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_quantizer_matches_jax(monkeypatch, train, use_mask):
    g, v, d, c = 2, 4, 8, 16
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, c)).astype(np.float32)
    noise = rng.gumbel(size=(2, 6, g, v)).astype(np.float32)
    pos_mask = rng.random((2, 6)) < 0.5 if use_mask else None
    params = {"codevectors": rng.random((1, g * v, d // g), np.float32),
              "weight_proj": {
                  "kernel": rng.standard_normal((c, g * v)).astype(
                      np.float32),
                  "bias": 0.1 * rng.standard_normal(g * v).astype(
                      np.float32)}}
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype: jnp.asarray(noise))
    jq = jpre_model.GumbelVectorQuantizer(g, v, d)

    def jax_fn(p, x):
        qz, ppl = jq.apply({"params": p}, x, 0.7, not train,
                           pos_mask=pos_mask,
                           rngs={"gumbel": jax.random.PRNGKey(0)})
        return jnp.sum(qz ** 2) + ppl, (qz, ppl)

    (_, (jqz, jppl)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True))(params, x)

    tq = GumbelVectorQuantizer(c, g, v, d).train(train)
    tq.load_state_dict({
        "codevectors": torch.from_numpy(params["codevectors"]),
        "weight_proj.weight": torch.from_numpy(
            params["weight_proj"]["kernel"].T.copy()),
        "weight_proj.bias": torch.from_numpy(params["weight_proj"]["bias"])})
    xt = torch.from_numpy(x).requires_grad_()
    qz, ppl = tq(xt, 0.7, None if pos_mask is None
                 else torch.from_numpy(pos_mask), noise=torch.from_numpy(
                     noise))
    (qz.pow(2).sum() + ppl).backward()
    np.testing.assert_allclose(qz.detach().numpy(), np.asarray(jqz),
                               rtol=1e-6, atol=1e-6)
    _rel_close(ppl.item(), float(jppl), "perplexity")
    # float32 gradients of exp/log chains: the repo's per-tensor bound
    for got, want in ((xt.grad, jgx),
                      (tq.weight_proj.weight.grad,
                       np.asarray(jgp["weight_proj"]["kernel"]).T),
                      (tq.weight_proj.bias.grad, jgp["weight_proj"]["bias"]),
                      (tq.codevectors.grad, jgp["codevectors"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-5)
    if train:  # the straight-through path carries a gradient to the input
        assert np.abs(xt.grad.numpy()).max() > 0


# -- the distractors ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_negative_indices_match_jax_exactly(monkeypatch, seed):
    b, t, k = 4, 23, 12
    lengths = np.array([0, 1, 2, t], np.int32)
    u = np.random.default_rng(seed).random((b, t, k), np.float32)
    u[0, 0, :2] = (0.0, np.nextafter(np.float32(1), np.float32(0)))
    u[3, 5, :2] = (0.0, np.nextafter(np.float32(1), np.float32(0)))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    want = np.asarray(jpre_model.sample_negative_indices(
        jax.random.PRNGKey(0), b, t, jnp.asarray(lengths), k))
    got = negative_indices_from_uniform(torch.from_numpy(u),
                                        torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(got, want)
    # the full-length item: every distractor valid and never the frame
    assert got[3].max() < t and not (got[3] == np.arange(t)[:, None]).any()
    drawn = sample_negative_indices(torch.Generator().manual_seed(seed), b,
                                    t, torch.from_numpy(lengths), k)
    assert drawn.shape == (b, t, k) and drawn.dtype == torch.int32
    assert int(drawn[3].max()) < t and int(drawn.min()) >= 0


# -- the whole model ----------------------------------------------------------

def _inputs(cfg_t, num_vars, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    audio[1, 5500:] = 0.0
    lens = np.array([8000, 5500], np.int32)
    t = int(cfg_t.feat_extract_output_lengths(8000))
    frames = cfg_t.feat_extract_output_lengths(lens)
    mask = rng.random((2, t)) < 0.5
    mask[0, 0] = True
    noise = rng.gumbel(size=(2, t, 2, num_vars)).astype(np.float32)
    u = rng.random((2, t, HEAD["num_negatives"]), np.float32)
    idx = negative_indices_from_uniform(torch.from_numpy(u),
                                        torch.from_numpy(frames)).numpy()
    return audio, lens, mask, noise, idx


def _collide_first_frame(model, audio, lens, mask, idx):
    """Point every distractor of item 0's frame 0 at frames with its exact
    codes (the argmax of the port's own quantizer logits), so that frame's
    logits are the positive and −∞ only."""
    with torch.no_grad():
        extract = model.wav2vec2(torch.from_numpy(audio),
                                 torch.from_numpy(lens),
                                 time_mask=torch.from_numpy(mask))[2]
        logits = model.quantizer.weight_proj(extract.float())
        logits = logits.view(*extract.shape[:2], 2, -1)
        codes = logits.argmax(-1)[0].numpy()  # (T, G)
    same = [j for j in range(1, len(codes))
            if (codes[j] == codes[0]).all()]
    assert same, "no frame shares frame 0's codes"
    idx = idx.copy()
    idx[0, 0] = np.resize(same, idx.shape[-1])
    return idx


@pytest.fixture(scope="module")
def model_cases():
    """Per case, the inputs, the port model holding the JAX weights, and the
    JAX forward's outputs and gradients, both cases in one jitted program
    (its compile is most of this module's time): V = 8 in ``train()``
    (Gumbel noise, the straight-through sample), and V = 2 in ``eval()``
    with distractors equal to the positive. The collisions are tested
    deterministically: in training the straight-through rows of one code
    differ by rounding (``hard + y_soft − y_soft``), and ``isclose``'s
    1e-8 absolute tolerance then decides entries near zero by that
    rounding, in either package."""
    cfg_t = tcfg.tiny_config(**TINY)
    cases, fns, trees = {}, [], []
    for v, train in CASES:
        params = random_jax_params(cfg_t, 5 + v, num_vars=v)
        model = port_from_jax(cfg_t, params, num_vars=v).train(train)
        audio, lens, mask, noise, idx = _inputs(cfg_t, v, seed=v)
        if not train:
            idx = _collide_first_frame(model, audio, lens, mask, idx)
        jm = jax_model(num_vars=v)

        def jax_fn(p, jm=jm, audio=audio, lens=lens, mask=mask, noise=noise,
                   idx=idx, train=train):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax.random, "gumbel",
                           lambda key, shape, dtype: jnp.asarray(noise))
                mp.setattr(jpre_model, "sample_negative_indices",
                           lambda *a: jnp.asarray(idx))
                out = jm.apply({"params": p}, audio, lens, mask,
                               jnp.float32(1.5), deterministic=not train,
                               rngs={"gumbel": jax.random.PRNGKey(1),
                                     "negatives": jax.random.PRNGKey(2),
                                     "dropout": jax.random.PRNGKey(3)})
            return out["loss"], out

        cases[v] = (model, (audio, lens, mask, noise, idx))
        fns.append(jax.value_and_grad(jax_fn, has_aux=True))
        trees.append(params)
    results = jax.jit(lambda ps: [f(p) for f, p in zip(fns, ps)])(trees)
    for v, ((_, out), grads) in zip((v for v, _ in CASES), results):
        want = {k: np.asarray(o) for k, o in out.items()}
        want_g = {k: g.numpy() for k, g in pretrain_state_dict_from_jax(
            jax.tree.map(np.asarray, grads)).items()}
        cases[v] += (want, want_g)
    return cases


@pytest.mark.parametrize("num_vars", [v for v, _ in CASES],
                         ids=["train_v8", "eval_v2_collisions"])
def test_model_outputs_and_gradients_match_jax(model_cases, num_vars):
    model, (audio, lens, mask, noise, idx), want, want_g = model_cases[
        num_vars]
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(audio), torch.from_numpy(lens),
                torch.from_numpy(mask), 1.5,
                gumbel_noise=torch.from_numpy(noise),
                negative_indices=torch.from_numpy(idx))
    out["loss"].backward()
    assert set(out) == set(OUTPUTS) == set(want)
    for k in ("num_masked", "frame_lengths"):
        np.testing.assert_array_equal(out[k].numpy(), want[k], err_msg=k)
    for k in OUTPUTS[:5]:
        _rel_close(out[k].item(), float(want[k]), k)
    assert out["contrastive_accuracy"].item() == pytest.approx(
        float(want["contrastive_accuracy"]), abs=1e-7)
    assert 0.0 <= out["contrastive_accuracy"].item() <= 1.0
    assert 0.0 < out["codebook_perplexity"].item() <= 2 * num_vars
    _check_grads(model, want_g)
    # V = 2: item 0's frame 0 scores its positive against −∞ only, and
    # every gradient stays finite
    assert all(np.isfinite(p.grad.numpy()).all()
               for p in model.parameters() if p.grad is not None)


def test_model_refuses_a_config_without_the_mask_embedding():
    with pytest.raises(ValueError, match="apply_spec_augment"):
        Wav2Vec2Pretrain(tcfg.tiny_config(apply_spec_augment=False))


# -- the trainer's pieces -----------------------------------------------------

def test_pretrain_config_matches_jax(tmp_path):
    argv = ["--exp_dir", str(tmp_path / "run"), "--crop_seconds", "3.5",
            "--mask_prob", "0.5", "--codevector_vars", "64",
            "--gumbel_temp_decay", "0.9", "--laptop", "--platform", "cpu",
            "--mesh_data", "1"]
    got = dataclasses.asdict(tconfig.parse_config(
        tpretrain.PretrainConfig, "pretrain", argv))
    want = dataclasses.asdict(jconfig.parse_config(
        jpretrain.PretrainConfig, "pretrain", argv))
    assert got.pop("date_time") and want.pop("date_time")
    assert got == want
    assert (dataclasses.asdict(tpretrain.PretrainConfig())
            == dataclasses.asdict(jpretrain.PretrainConfig()))


def test_gumbel_temperature_loader_matches_jax():
    batches = [{"audio": np.zeros((3, 4), np.float32),
                "audio_lengths": np.array([4, 3, 2], np.int32)}]
    got = tpretrain.GumbelTemperatureLoader(batches, 2.0, 0.5, 0.5)
    want = jpretrain.GumbelTemperatureLoader(batches, 2.0, 0.5, 0.5)
    assert len(got) == len(want) == 1
    for _ in range(4):
        assert got.temperature == want.temperature
        g, w = list(got), list(want)
        np.testing.assert_array_equal(g[0]["gumbel_temp"],
                                      w[0]["gumbel_temp"])
        assert g[0]["gumbel_temp"].dtype == np.float32
    assert got.temperature == 0.5  # the floor
    assert "gumbel_temp" not in batches[0]
