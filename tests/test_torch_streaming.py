"""aptai_tpu_torch's streamers against the JAX package's, float32 on the
CPU, with the same weights (a JAX tree crossed through the bridge):

* ``StreamingAPTAI``, ``StreamingForceAPTAI`` (greedy) and
  ``StreamingW2V2PR``: the stitched outputs of a recording of several
  chunk groups (the last one partial) and of one shorter than a chunk equal
  the JAX streamers' (continuous outputs within 1e-4 of their largest
  magnitude, integer outputs equal);
* the frame grid: the stitched length is the conv stack's output length
  of the whole recording, at any chunking;
* the window path's variants: int16 ≡ float32 on PCM-quantized input, and
  ``per_file`` ≡ ``upload_ahead`` ≡ the default, bit for bit;
* a ``beam_host`` FORCE model is refused at construction, so is
  ``upload_ahead`` with a ``mesh=`` (as in the JAX package), and nothing
  runs on the card unless asked.

The config is tiny in width with the 7-layer conv stack (49 frames a
second); each family's JAX references are computed once per module.
"""

import jax
import numpy as np
import pytest
import torch

from aptai_tpu.infer import streaming as jstreaming
from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu_torch import TV_ORDER
from aptai_tpu_torch.infer import streaming as tstreaming
from aptai_tpu_torch.infer.api import quantize_i16
from aptai_tpu_torch.models import ForceAPTAI, force_aptai_state_dict_from_jax
from aptai_tpu_torch.models import configs as tcfg

from _torch_port import (NO_DROP, jax_lstm_one_step_a_loop, one_torch_thread,
                         port_aptai_from_jax, port_w2v2_pr_from_jax,
                         random_jax_aptai_params, random_jax_force_params,
                         random_jax_w2v2_pr_params)

STACK = dict(NO_DROP, conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
V = 11
# 1 s chunks, 0.25 s overlap, two chunks a group: the 3.3 s recording
# makes 5 chunks, so 3 groups, the last one partial
CHUNKING = dict(chunk_seconds=1.0, overlap_seconds=0.25, chunk_batch=2)
TOL = 1e-4
FAMILIES = ("aptai", "force_aptai", "w2v2_pr")
INT_KEYS = ("phn_fc_pred", "pred_frame_phns")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module", autouse=True)
def _jax_lstm_one_step_a_loop():
    with pytest.MonkeyPatch.context() as mp:
        jax_lstm_one_step_a_loop(mp)
        yield


@pytest.fixture(scope="module")
def wavs():
    rng = np.random.default_rng(40)
    long = (rng.standard_normal(52_800) * 0.1).astype(np.float32)
    short = (rng.standard_normal(11_000) * 0.1).astype(np.float32)
    return {"long": long, "short": short}


def _models(family):
    """(JAX model, its params, the port's model) with the same weights."""
    cfg_t = tcfg.tiny_config(**STACK)
    cfg_j = jcfg.tiny_config(**STACK)
    if family == "aptai":
        p = random_jax_aptai_params(cfg_t, V, seed=41)
        return (JaxAPTAI(cfg_j, num_phonemes=V, tv_drop=0.0, phn_drop=0.0),
                p, port_aptai_from_jax(cfg_t, p, V))
    if family == "w2v2_pr":
        p = random_jax_w2v2_pr_params(cfg_t, seed=42)
        return JaxW2V2PR(cfg_j), p, port_w2v2_pr_from_jax(cfg_t, p)
    p = random_jax_force_params(cfg_j, V, seed=43)
    model = ForceAPTAI(cfg_t, vocab_size=V)
    model.load_state_dict(force_aptai_state_dict_from_jax(p))
    return JaxForceAPTAI(cfg_j, vocab_size=V), p, model.eval()


CLASSES = {"aptai": "StreamingAPTAI", "force_aptai": "StreamingForceAPTAI",
           "w2v2_pr": "StreamingW2V2PR"}


@pytest.fixture(scope="module")
def families(wavs):
    """Per family: the port's model and the JAX streamer's outputs for
    each recording (one compiled window program each)."""
    out = {}
    for family in FAMILIES:
        jmodel, params, tmodel = _models(family)
        jstream = getattr(jstreaming, CLASSES[family])(
            jmodel, jax.tree.map(np.asarray, params), **CHUNKING)
        out[family] = (tmodel, {name: jstream.predict(w)
                                for name, w in wavs.items()})
    return out


def _stream(family, model, **kw):
    return getattr(tstreaming, CLASSES[family])(
        model, device="cpu", **{**CHUNKING, **kw})


def _flat(out):
    """A streamer's output with the per-TV dict as one (T, 9) array."""
    flat = {k: v for k, v in out.items() if k != "tvs_pred"}
    if "tvs_pred" in out:
        flat["tvs_pred"] = np.stack([out["tvs_pred"][k] for k in TV_ORDER],
                                    axis=1)
    return flat


def _assert_same(got, want, exact=False):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if k in INT_KEYS or exact or np.ndim(w) == 0:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert g.shape == w.shape and g.dtype == np.float32, k
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("length", ["long", "short"])
def test_stream_matches_jax(families, wavs, family, length):
    model, want = families[family]
    got = _stream(family, model).predict(wavs[length])
    _assert_same(got, want[length])


@pytest.mark.parametrize("family", FAMILIES)
def test_frame_grid(families, family):
    """The stitched length is the whole recording's frame count, for
    lengths on and off the frame hop and chunkings with one group, a
    partial last group and several whole ones."""
    model, _ = families[family]
    cfg = model.cfg
    rng = np.random.default_rng(44)
    for n, kw in ((40_000, {}), (40_123, dict(chunk_batch=1)),
                  (33_001, dict(chunk_batch=3)), (15_999, {}),
                  (16_001, dict(overlap_seconds=0.5))):
        wav = (rng.standard_normal(n) * 0.1).astype(np.float32)
        out = _flat(_stream(family, model, **kw).predict(wav))
        frames = {len(v) for k, v in out.items() if np.ndim(v)}
        assert frames == {cfg.feat_extract_output_lengths(n)}, (n, kw)


@pytest.mark.parametrize("family", FAMILIES)
def test_window_path_variants_are_bit_identical(families, wavs, family):
    model, _ = families[family]
    wav = quantize_i16(wavs["long"]).astype(np.float32) / 32768.0
    base = _stream(family, model).predict(wav)
    for kw in (dict(transfer_dtype="int16"), dict(fetch_mode="per_file"),
               dict(upload_ahead=True),
               dict(upload_ahead=True, fetch_mode="per_file",
                    fetch_workers=1)):
        _assert_same(_stream(family, model, **kw).predict(wav), base,
                     exact=True)


def test_refusals(families):
    model, _ = families["force_aptai"]
    beam_host = ForceAPTAI(model.cfg, vocab_size=V,
                           decode_method="beam_host")
    with pytest.raises(ValueError, match="on-device in-step decode"):
        _stream("force_aptai", beam_host)
    aptai, _ = families["aptai"]
    with pytest.raises(ValueError, match="upload_ahead only applies"):
        _stream("aptai", aptai, mesh=object(), upload_ahead=True)
    with pytest.raises(ValueError, match="overlap must be smaller"):
        _stream("aptai", aptai, overlap_seconds=1.0)
    with pytest.raises(ValueError, match="unknown fetch_mode"):
        _stream("aptai", aptai, fetch_mode="later")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tstreaming.StreamingAPTAI(aptai)
