"""aptai_tpu_torch W2V2PR against the JAX package, float32 on the CPU: the
training forward's dict (loss, logits, log-probs, hidden states, frame
lengths) with an item padded by length, ``encode`` and ``encode_layers``,
the CTC loss's gradients with the feature encoder trainable and frozen, the
weight bridge, and the ``W2V2PRPredictor`` entry points behind the
``MicroBatcher``.

The config is tiny in width but keeps the 7-layer conv stack, so frames
come at ~49 Hz and the CTC recursion stays short."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.infer.api import W2V2PRPredictor as JaxPredictor
from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import configs as jcfg
from aptai_tpu.models.hf_convert import export_w2v2_pr
from aptai_tpu_torch.infer import MicroBatcher, W2V2PRPredictor
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_w2v2_pr, w2v2_pr_state_dict_from_jax

from _torch_port import NO_DROP, port_w2v2_pr_from_jax, \
    random_jax_w2v2_pr_params

TINY = dict(NO_DROP, conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
            conv_stride=(5, 2, 2, 2, 2, 2, 2), mask_time_prob=0.0)
FE = "wav2vec2.feature_extractor."
VOCAB = {"(blank)": 0, "(...)": 1,
         **{c: i + 2 for i, c in enumerate("abcdefghi")}}


@pytest.fixture(scope="module")
def setup():
    cfg_t = tcfg.tiny_config(**TINY)
    params = random_jax_w2v2_pr_params(cfg_t, seed=21)
    rng = np.random.default_rng(22)
    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    audio[1, 5500:] = 0.0
    lens = np.array([8000, 5500], np.int32)
    labels = np.array([[3, 3, 5, 1, 7, 2], [4, 9, 9, 2, -100, -100]],
                      np.int32)
    return cfg_t, params, audio, lens, labels


def _jax_model(**kw):
    return JaxW2V2PR(jcfg.tiny_config(**TINY), **kw)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def test_weight_bridge_matches_hf_export(setup):
    cfg_t, params, *_ = setup
    want = export_w2v2_pr(params, cfg_t.num_hidden_layers)
    got = w2v2_pr_state_dict_from_jax(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_forward_dict_matches_jax(setup):
    cfg_t, params, audio, lens, labels = setup
    want = _np(jax.jit(lambda p, a, l, y: _jax_model().apply(
        {"params": p}, a, l, y))(params, audio, lens, labels))
    model = port_w2v2_pr_from_jax(cfg_t, params)
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(lens),
                    torch.from_numpy(labels))
    assert set(got) == set(want)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["frame_lengths"],
                                  want["frame_lengths"])
    assert got["frame_lengths"][1] < got["phoneme_logits"].shape[1]
    assert got["phoneme_logits"].dtype == np.float32
    # every frame, pad frames of item 1 included; summation order
    for k in ("phoneme_logits", "log_probs", "hidden_states"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert got["loss"] == pytest.approx(float(want["loss"]), rel=1e-4)


def test_encode_and_encode_layers_match_jax(setup):
    cfg_t, params, audio, lens, _ = setup
    model = port_w2v2_pr_from_jax(cfg_t, params)
    for method, kw in (("encode", {}),
                       ("encode_layers", dict(intermediate_hidden=1,
                                              latter_hidden=2))):
        want = _np(jax.jit(lambda p, a, l: _jax_model().apply(
            {"params": p}, a, l, method=method, **kw))(params, audio, lens))
        with torch.no_grad():
            got = getattr(model, method)(torch.from_numpy(audio),
                                         torch.from_numpy(lens), **kw)
        assert set(got) == set(want), method
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{method} {k}")


@pytest.mark.parametrize("freeze", [False, True])
def test_loss_gradients_match_jax(setup, freeze):
    """The gradient of every parameter, mapped from the JAX tree through
    the bridge; a frozen feature encoder gets none (zeros in JAX)."""
    cfg_t, params, audio, lens, labels = setup
    jm = _jax_model(freeze_feature_encoder=freeze)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, audio, lens, labels)["loss"]))(params)
    want = w2v2_pr_state_dict_from_jax(jax.tree.map(np.asarray, jgrads))

    model = port_w2v2_pr_from_jax(cfg_t, params,
                                  freeze_feature_encoder=freeze)
    loss = model(torch.from_numpy(audio), torch.from_numpy(lens),
                 torch.from_numpy(labels))["loss"]
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
    checked = 0
    for name, p in model.named_parameters():
        if p.grad is None:
            # the frozen FE, and the mask embedding (no mask in eval)
            assert (freeze and name.startswith(FE)) \
                or name.endswith("masked_spec_embed"), name
            assert not want[name].numpy().any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
        checked += 1
    fe = sum(1 for n in want if n.startswith(FE))
    assert checked == len(want) - 1 - (fe if freeze else 0)


@pytest.fixture(scope="module")
def predictors(setup):
    cfg_t, params, *_ = setup
    jax_pred = JaxPredictor(_jax_model(), params, VOCAB)
    pred = W2V2PRPredictor(port_w2v2_pr_from_jax(cfg_t, params), VOCAB,
                           device="cpu")
    rng = np.random.default_rng(23)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (20_800, 11_200, 31_000)]
    return jax_pred, pred, wavs


def test_get_embeddings_matches_jax(predictors):
    jax_pred, pred, wavs = predictors
    want = jax_pred.get_embeddings(wavs)
    got = pred.get_embeddings(wavs)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["frame_seq_lens"],
                                  want["frame_seq_lens"])
    for k in ("features_hidden", "last_transf_hidden", "phoneme_logits"):
        assert got[k].shape == want[k].shape, k  # (B, C, T) transposes
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for g, w in zip(got["phn_pred_seq_idx"], want["phn_pred_seq_idx"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(pred.get_ctc_logits(wavs[1]),
                               jax_pred.get_ctc_logits(wavs[1]), rtol=1e-4,
                               atol=1e-5)


def test_predict_phonemes_durations_matches_jax(predictors):
    jax_pred, pred, wavs = predictors
    for wav in wavs[:2]:
        want = jax_pred.predict_phonemes_durations(wav)
        got = pred.predict_phonemes_durations(wav)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["phn_seq_idx"], want["phn_seq_idx"])
        assert got["phn_seq_ipa"] == want["phn_seq_ipa"]
        np.testing.assert_allclose(got["phn_seq_dur"], want["phn_seq_dur"],
                                   rtol=1e-12)
        assert pred.pred_phn_seq(wav)["phn_seq_ipa"] == want["phn_seq_ipa"]


def test_micro_batcher_serves_encode_batch(predictors):
    _, pred, wavs = predictors
    direct = pred.encode_batch(wavs, fields=("phoneme_logits",))
    assert set(direct) == {"phoneme_logits", "frame_lengths"}
    assert all(v.shape[0] == len(wavs) for v in direct.values())
    mb = MicroBatcher(pred.encode_batch, max_batch_size=4, max_wait_ms=5.0,
                      fields=("phoneme_logits",))
    served = mb.run_batch(wavs)
    for b, item in enumerate(served):
        n = int(direct["frame_lengths"][b])
        assert item["phoneme_logits"].shape == (n, 11)
        # 4 rows (one silence pad row) against 4 rows: the same shapes
        np.testing.assert_allclose(item["phoneme_logits"],
                                   direct["phoneme_logits"][b, :n].numpy(),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown output field"):
        pred.encode_batch(wavs, fields=("logits",))


def test_bf16_predictor_fetches_float32():
    """A bf16 model serves bf16 features; the host dicts carry them as
    float32 (numpy has no bfloat16)."""
    model = random_w2v2_pr(tcfg.tiny_config(**TINY, dtype="bfloat16"),
                           seed=0)
    pred = W2V2PRPredictor(model, device="cpu")
    wav = np.random.default_rng(0).standard_normal(9000).astype(np.float32)
    out = pred.encode_batch([wav])
    assert out["features_hidden"].dtype == torch.bfloat16
    assert out["phoneme_logits"].dtype == torch.float32  # the f32 head
    emb = pred.get_embeddings([wav])
    assert emb["features_hidden"].dtype == np.float32
    assert np.isfinite(emb["last_transf_hidden"]).all()
    assert pred.model.pr_head.weight.dtype == torch.float32
