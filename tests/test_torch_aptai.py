"""aptai_tpu_torch APTAI against the JAX package, f32 on the CPU:
``APTAI.predict``, the ``APTAIPredictor`` (bucketing, the three transfer
encodings, ``fields=``, ``get_aptai_output``) and the ``MicroBatcher``
running in the background.

The config is tiny in width but keeps the 7-layer conv stack of the real
model, so frames come at ~49 Hz (the rate the TV low-pass is designed for)
and second-long inputs stay cheap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import pearsonr

from aptai_tpu.infer.api import APTAIPredictor as JaxPredictor
from aptai_tpu.infer.api import dequantize_transfer, quantize_transfer
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu_torch import TV_ORDER
from aptai_tpu_torch.infer import APTAIPredictor, MicroBatcher
from aptai_tpu_torch.models import configs as tcfg

from _torch_port import NO_DROP, port_aptai_from_jax, random_jax_aptai_params

NUM_PHN = 11
TINY = dict(NO_DROP, conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
            conv_stride=(5, 2, 2, 2, 2, 2, 2))


@pytest.fixture(scope="module")
def models():
    cfg_t = tcfg.tiny_config(**TINY)
    params = random_jax_aptai_params(cfg_t, NUM_PHN, seed=5)
    jmodel = JaxAPTAI(jcfg.tiny_config(**TINY), num_phonemes=NUM_PHN,
                      tv_drop=0.0, phn_drop=0.0)
    return jmodel, params, port_aptai_from_jax(cfg_t, params, NUM_PHN)


@pytest.fixture(scope="module")
def jax_predictor(models):
    jmodel, params, _ = models
    return JaxPredictor(jmodel, params)


@pytest.fixture(scope="module")
def wavs():
    rng = np.random.default_rng(6)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (20_800, 43_200, 31_000)]  # 1.3 s, 2.7 s, 1.94 s


def _assert_outputs_match(got, want, n_frames=None):
    """The port's predict outputs against JAX's, at the stated tolerances."""
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["frame_lengths"],
                                  want["frame_lengths"])
    if "tvs_pred" in want:
        np.testing.assert_allclose(got["tvs_pred"], want["tvs_pred"],
                                   rtol=1e-3, atol=2e-4)
        for b in range(want["tvs_pred"].shape[0]):
            n = n_frames or int(want["frame_lengths"][b])
            for i in range(len(TV_ORDER)):
                r = pearsonr(got["tvs_pred"][b, :n, i],
                             want["tvs_pred"][b, :n, i])[0]
                assert r > 0.99999, (b, TV_ORDER[i], r)
    if "phn_fc_probs" in want:
        np.testing.assert_allclose(got["phn_fc_probs"], want["phn_fc_probs"],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["phn_fc_logits"],
                                   want["phn_fc_logits"], rtol=1e-3,
                                   atol=2e-4)
        np.testing.assert_array_equal(got["phn_fc_pred"],
                                      want["phn_fc_pred"])


def test_predict_matches_jax(models):
    jmodel, params, tmodel = models
    rng = np.random.default_rng(7)
    audio = rng.standard_normal((2, 24_000)).astype(np.float32) * 0.1
    audio[1, 15_000:] = 0.0
    lens = np.array([24_000, 15_000], np.int32)
    want = jax.jit(lambda p, a, l: jmodel.apply(
        {"params": p}, a, l, method="predict"))(
            params, jnp.asarray(audio), jnp.asarray(lens))
    with torch.no_grad():
        got = tmodel.predict(torch.from_numpy(audio), torch.from_numpy(lens))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["phn_fc_pred"].dtype == want["phn_fc_pred"].dtype
    # all frames, pad frames of item 1 included
    _assert_outputs_match(got, want, n_frames=got["tvs_pred"].shape[1])


@pytest.mark.parametrize("transfer_dtype", ["float32", "int16",
                                            "uint8_mulaw"])
def test_predictor_matches_jax(models, jax_predictor, wavs, transfer_dtype):
    """The JAX side decodes the transfer encoding with its own
    ``dequantize_transfer`` and runs its float32 predictor, which is what
    its predictor with that encoding does on the device (and it reuses one
    compiled forward)."""
    _, _, tmodel = models
    decoded = [np.asarray(dequantize_transfer(jnp.asarray(
        quantize_transfer(w, transfer_dtype)))) for w in wavs]
    want = jax_predictor.predict_batch(decoded)
    pred = APTAIPredictor(tmodel, device="cpu", transfer_dtype=transfer_dtype)
    got = pred.predict_batch(wavs)
    assert all(v.shape[0] == len(wavs) for v in got.values())
    _assert_outputs_match({k: v.numpy() for k, v in got.items()},
                          {k: np.asarray(v) for k, v in want.items()})


def test_predictor_fields_and_single_output(models, jax_predictor, wavs):
    _, _, tmodel = models
    pred = APTAIPredictor(tmodel, device="cpu")
    full = pred.predict_batch(wavs)
    tv_only = pred.predict_batch(wavs, fields=("tvs_pred",))
    assert set(tv_only) == {"tvs_pred", "frame_lengths"}
    torch.testing.assert_close(tv_only["tvs_pred"], full["tvs_pred"],
                               rtol=0, atol=0)
    phn_only = pred.predict_batch(wavs, fields=["phn_fc_pred"])
    assert set(phn_only) == {"phn_fc_pred", "frame_lengths"}
    torch.testing.assert_close(phn_only["phn_fc_pred"], full["phn_fc_pred"])
    with pytest.raises(ValueError, match="unknown output field"):
        pred.predict_batch(wavs, fields=("tvs",))

    got = pred.get_aptai_output(wavs[1])
    want = jax_predictor.get_aptai_output(wavs[1])
    assert set(got) == set(want)
    assert got["phn_fc_probs"].shape == want["phn_fc_probs"].shape
    np.testing.assert_allclose(got["phn_fc_probs"], want["phn_fc_probs"],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["phn_fc_pred"], want["phn_fc_pred"])
    assert list(got["tvs_pred"]) == list(TV_ORDER)
    for name in TV_ORDER:
        np.testing.assert_allclose(got["tvs_pred"][name],
                                   want["tvs_pred"][name], rtol=1e-3,
                                   atol=2e-4)


def test_micro_batcher_background_matches_run_batch(models):
    """Five requests through the background server against one synchronous
    ``run_batch`` of the same wavs. All lengths fall in one 2 s bucket, so
    every coalesced batch has the same padded shape."""
    _, _, tmodel = models
    rng = np.random.default_rng(8)
    reqs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (20_800, 30_000, 24_000, 31_900, 22_222)]
    pred = APTAIPredictor(tmodel, device="cpu")
    mb = MicroBatcher(pred.predict_batch, max_batch_size=8, max_wait_ms=5.0,
                      fields=("tvs_pred", "phn_fc_pred"))
    want = mb.run_batch(reqs)
    mb.start()
    try:
        futs = [mb.submit(w) for w in reqs]
        got = [f.result(timeout=60) for f in futs]
    finally:
        mb.stop()
    assert mb._thread is not None and not mb._thread.is_alive()
    for g, w in zip(got, want):
        assert set(g) == {"tvs_pred", "phn_fc_pred", "frame_lengths"}
        assert int(g["frame_lengths"]) == g["tvs_pred"].shape[0]
        np.testing.assert_allclose(g["tvs_pred"], w["tvs_pred"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(g["phn_fc_pred"], w["phn_fc_pred"])
