"""aptai_tpu_torch's batched device beam (``decode/device.py``) against the
JAX device beam and against the port's host beam (the C++ search through
``beam_decode_padded`` and ``decode_with_times``, and the Python one), on
the CPU:

* random posteriors at scales 2.5 (peaked) and 1.0 (flat, merge-heavy)
  with ragged lengths and zero-length items, emission times included;
* blank-dominated CTC-like posteriors at T 200, V 46, cap 60;
* the truncation contract and the over-cap regime on peaked posteriors;
* exactly tied scores (uniform rows, and two tokens tied each frame),
  which fix the order of the top-k: lower index first, as ``lax.top_k``;
* a tiny FORCE-APTAI with ``decode_method="beam_device"`` against the
  same weights with ``"beam_host"``: the forward, ``encode_items`` and
  ``ForceAPTAIPredictor``.

Tolerance: none. Sequences, lengths, truncated counts and times are
integers and must be equal; the FORCE outputs of the two decode methods
are the same function of the same sequences and must be equal too. The
JAX references run in one compiled program per shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.decode.device import beam_decode_device as jax_beam_device
from aptai_tpu_torch.decode import beam as tbeam
from aptai_tpu_torch.decode.device import beam_decode_device
from aptai_tpu_torch.infer import ForceAPTAIPredictor
from aptai_tpu_torch.models import ForceAPTAI, random_force_aptai
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.train import collate_encoded, encode_items

from _torch_port import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _log_softmax(logits):
    logits = logits - logits.max(-1, keepdims=True)
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(
        np.float32)


def _port(lp, lens, **kw):
    out = beam_decode_device(torch.from_numpy(lp), torch.from_numpy(lens),
                             **kw)
    return [x.numpy() for x in out]


def _jax(lp, lens, **kw):
    out = jax.jit(lambda x, l: jax_beam_device(x, l, **kw))(
        jnp.asarray(lp), jnp.asarray(lens))
    return [np.asarray(x) for x in out]


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scale", [2.5, 1.0])
def test_matches_jax_and_host_beam_with_times(scale):
    """Four draws of 6 items (T 40, V 12) in one batch, lengths 0..40 (a
    zero-length item and a full one in each): tokens, lengths, truncated
    counts and times equal JAX's device beam, and each item's tokens and
    times equal the host beam's (Python search; C++ through
    ``decode_with_times``)."""
    rng = np.random.default_rng(0 if scale > 2 else 1)
    b, t, v = 24, 40, 12
    lp = _log_softmax(rng.standard_normal((b, t, v)) * scale)
    lens = rng.integers(0, t + 1, b).astype(np.int32)
    lens[::6], lens[1::6] = 0, t
    got = _port(lp, lens, return_times=True)
    _equal(got, _jax(lp, lens, return_times=True))
    seqs, out_lens, trunc, times = got
    assert not trunc.any() and out_lens.max() > 5  # cap defaults to T
    for i in range(b):
        host = tbeam.beam_search(lp[i, :lens[i]])[0]
        native = tbeam.decode_with_times(lp[i, :lens[i]])
        n = out_lens[i]
        assert seqs[i, :n].tolist() == list(host.tokens) == native[0], i
        assert times[i, :n].tolist() == list(host.timesteps) == native[1], i
        assert not seqs[i, n:].any()


def _ctc_like(rng, b, t, v):
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    logits[..., 0] += 6.0
    for i in range(b):
        n_emit = rng.integers(20, 45)
        frames = np.sort(rng.choice(t, n_emit, replace=False))
        logits[i, frames, rng.integers(1, v, n_emit)] += 10.0
    return _log_softmax(logits)


def test_ctc_like_posteriors_at_cap_60():
    """Blank-dominated posteriors with bursts of emissions at T 200, V 46,
    cap 60 (FORCE's), ragged lengths: equal to JAX's device beam and to
    the C++ beam through ``beam_decode_padded``."""
    rng = np.random.default_rng(5)
    lp = _ctc_like(rng, 3, 200, 46)
    lens = np.array([200, 137, 64], np.int32)
    got = _port(lp, lens, max_output_length=60)
    _equal(got, _jax(lp, lens, max_output_length=60))
    _equal(got, tbeam.beam_decode_padded(lp, lens, max_len=60))
    assert got[1].min() > 5


def _peaked(seqs_true, v, extra=0):
    """Each sequence emitted one token a frame, blanks between, then a
    closing blank; lengths cover the emissions (plus ``extra`` frames)."""
    t = 2 * max(len(s) for s in seqs_true) + 2
    lp = np.full((len(seqs_true), t, v), -14.0, np.float32)
    lens = np.zeros(len(seqs_true), np.int32)
    for b, seq in enumerate(seqs_true):
        for k, tok in enumerate(seq):
            lp[b, 2 * k, tok] = -0.01
            lp[b, 2 * k + 1, 0] = -0.01
        lp[b, 2 * len(seq), 0] = -0.01
        lens[b] = min(2 * len(seq) + 1 + extra, t)
    return _log_softmax(lp), lens


def test_truncation_contract_and_over_cap_regime():
    """Sequences longer than the cap: the stored tokens cap, ``truncated``
    counts the overflow, equal to JAX's device beam and the host beam,
    with repeated tokens across the cap (where past-cap scores read the
    last stored token) and a sequence that just fits."""
    rng = np.random.default_rng(7)
    v, cap = 6, 5
    truth = [[1, 2, 3, 4, 5, 1, 2, 3], [1, 2, 3, 1, 1, 4, 5, 2, 3],
             [2, 2, 2, 2, 2, 2, 2], list(rng.integers(1, v, size=10)),
             [1, 2, 3, 4, 5], [3, 1]]
    lp, lens = _peaked(truth, v)
    got = _port(lp, lens, max_output_length=cap, return_times=True)
    _equal(got, _jax(lp, lens, max_output_length=cap, return_times=True))
    _equal(got[:3], tbeam.beam_decode_padded(lp, lens, max_len=cap))
    seqs, out_lens, trunc, times = got
    for b, seq in enumerate(truth):
        assert seqs[b, :out_lens[b]].tolist() == list(seq[:cap])
        assert trunc[b] == max(len(seq) - cap, 0)
        assert times[b, :out_lens[b]].tolist() == [
            2 * k for k in range(min(len(seq), cap))]


def test_exact_ties_keep_the_lower_index_first():
    """Uniform rows (every live candidate of a parent tied) and rows with
    two tokens tied on each frame: equal to JAX's device beam, whose
    ``lax.top_k`` puts the lower index first among equal scores. (The
    host search breaks such ties by its insertion order, which
    interleaves stays and extensions by parent, so it is not the
    reference here.)"""
    rng = np.random.default_rng(3)
    b, t, v = 4, 30, 7
    uniform = _log_softmax(np.zeros((b, t, v), np.float32))
    paired = rng.standard_normal((b, t, v)).astype(np.float32)
    top = rng.integers(1, v - 1, (b, t))
    for i in range(b):
        paired[i, np.arange(t), top[i]] = 4.0
        paired[i, np.arange(t), top[i] + 1] = 4.0
    paired = _log_softmax(paired)
    lens = np.array([30, 17, 0, 24], np.int32)
    for lp in (uniform, paired):
        got = _port(lp, lens, return_times=True)
        _equal(got, _jax(lp, lens, return_times=True))
        assert got[1].max() > 0


def test_empty_and_bf16_inputs():
    """A zero-length batch item decodes to nothing; a bf16 input is
    decoded from its float32 values."""
    rng = np.random.default_rng(2)
    lp = _log_softmax(rng.standard_normal((2, 8, 5)) * 2.0)
    seqs, lens, trunc = beam_decode_device(torch.from_numpy(lp),
                                           torch.tensor([0, 0]))
    assert not seqs.any() and not lens.any() and not trunc.any()
    half = torch.from_numpy(lp).bfloat16()
    got = beam_decode_device(half, torch.tensor([8, 5]))
    want = beam_decode_device(half.float(), torch.tensor([8, 5]))
    _equal([g.numpy() for g in got], [w.numpy() for w in want])
    assert got[0].dtype == torch.int32 and got[0].shape == (2, 8)


# -- FORCE-APTAI with decode_method="beam_device" -----------------------------

STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))


@pytest.fixture(scope="module")
def force_pair():
    """One tiny ForceAPTAI's weights under ``beam_host`` (the split path
    allowed in the forward) and ``beam_device``, and a batch of three
    items (1, 0.69 and 0.44 s) with TV targets."""
    cfg = tcfg.tiny_config(**STACK)
    dev_m = random_force_aptai(cfg, seed=4, vocab_size=11,
                               decode_method="beam_device").eval()
    host_m = ForceAPTAI(cfg, vocab_size=11, decode_method="beam_host",
                        allow_host_callback_decode=True).eval()
    host_m.load_state_dict(dev_m.state_dict())
    rng = np.random.default_rng(9)
    lens = np.array([16_000, 11_000, 7_000], np.int32)
    audio = (rng.standard_normal((3, 16_000)) * 0.1).astype(np.float32)
    for b, n in enumerate(lens):
        audio[b, n:] = 0.0
    t = int(cfg.feat_extract_output_lengths(16_000))
    tv = rng.standard_normal((3, t, 9)).astype(np.float32)
    batch = {"audio": audio, "audio_lengths": lens, "tv_targets": tv,
             "phoneme_labels": np.full((3, 4), -100, np.int32)}
    return host_m, dev_m, batch


def _same_outputs(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_force_beam_device_forward_equals_beam_host(force_pair):
    """The training forward and ``predict`` of ``beam_device`` equal
    ``beam_host``'s: the same decoded sequences, so the same outputs."""
    host_m, dev_m, batch = force_pair
    args = [torch.from_numpy(batch[k]) for k in ("audio", "audio_lengths")]
    tv = torch.from_numpy(batch["tv_targets"])
    with torch.no_grad():
        want, got = host_m(*args, tv), dev_m(*args, tv)
        _same_outputs(got, want)
        _same_outputs(dev_m.predict(*args), host_m.predict(*args))
    assert got["phn_seq_lengths"].min() > 0


def test_force_beam_device_cache_and_predictor(force_pair):
    """``encode_items`` decodes a ``beam_device`` model on the device: its
    cached sequences equal the ``beam_host`` cache's; the predictor takes
    ``beam_device`` as it takes greedy (no split path) and serves the
    model's ``predict`` outputs for its rows."""
    host_m, dev_m, batch = force_pair
    want = collate_encoded(encode_items([batch], host_m))
    got = collate_encoded(encode_items([batch], dev_m))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    wavs = [batch["audio"][b, :n] for b, n in enumerate(
        batch["audio_lengths"])]
    pred = ForceAPTAIPredictor(dev_m, device="cpu")
    out = pred.predict_batch(wavs)
    host_out = ForceAPTAIPredictor(host_m, device="cpu").predict_batch(wavs)
    for k in ("pred_ctc_phn_seq", "phn_seq_lengths", "tvs_pred"):
        assert torch.equal(out[k], host_out[k]), k
    np.testing.assert_array_equal(out["pred_ctc_phn_seq"].numpy(),
                                  want["phn_pred_seq"])
