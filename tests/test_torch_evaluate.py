"""aptai_tpu_torch's validation passes and metrics against the JAX
package's: ``validate_pr`` (beam, device beam and greedy), ``validate_tv``
and ``test_tv`` fed the same forward outputs (tensors to the port, arrays
to JAX), and every metric function against its twin. No model runs here.

The JAX side runs with its native library switched off (its pure-Python
beam and edit distance), so nothing builds inside the JAX tree."""

import numpy as np
import pytest
import torch

from aptai_tpu.decode import native as jnative
from aptai_tpu.train import evaluate as jeval
from aptai_tpu.train import metrics as jmetrics
from aptai_tpu_torch.decode import native as tnative
from aptai_tpu_torch.train import evaluate as teval
from aptai_tpu_torch.train import metrics as tmetrics


@pytest.fixture(autouse=True)
def _jax_without_native(monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda: None)


def _log_probs(rng, shape):
    logits = rng.standard_normal(shape).astype(np.float32) * 3.0
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def _pr_batches(seed=0):
    """Two batches of 3 items (the second with a pad row), their labels
    padded with -100, and the forward outputs for each."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(2):
        lens = rng.integers(8, 25, 3).astype(np.int32)
        labels = np.full((3, 12), -100, np.int32)
        for b in range(3):
            n = rng.integers(1, 12)
            labels[b, :n] = rng.integers(1, 7, n)
        batch = {"phoneme_labels": labels}
        if i == 1:
            batch["batch_pad_mask"] = np.array([True, True, False])
        fwd = {"loss": np.float32(rng.random() * 5),
               "log_probs": _log_probs(rng, (3, 24, 7)),
               "frame_lengths": lens}
        out.append((batch, fwd))
    return out


def _forward_fns(pairs):
    """(JAX forward_fn returning arrays, port forward_fn returning
    tensors), both looking the batch up by identity."""
    table = {id(b): f for b, f in pairs}
    return (lambda batch: table[id(batch)],
            lambda batch: {k: torch.as_tensor(v)
                           for k, v in table[id(batch)].items()})


def _same_dict(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), k


@pytest.mark.parametrize("decode", ["beam", "beam_device", "greedy"])
def test_validate_pr_matches_jax(decode):
    pairs = _pr_batches()
    jfwd, tfwd = _forward_fns(pairs)
    batches = [b for b, _ in pairs]
    calls = tnative.beam_search_native.calls
    got = teval.validate_pr(tfwd, batches, decode=decode)
    want = jeval.validate_pr(jfwd, batches, decode=decode)
    _same_dict(got, want)
    assert np.isfinite(got["mean_val_per"]) and got["mean_val_per"] > 0
    if decode == "beam" and tnative.native_available():
        assert tnative.beam_search_native.calls == calls + 5  # valid items
    _same_dict(teval.validate_pr(tfwd, batches, max_batches=1,
                                 decode=decode),
               jeval.validate_pr(jfwd, batches, max_batches=1,
                                 decode=decode))


def test_validate_pr_refuses_the_device_beam_and_unknown_decodes():
    """An unknown decode raises; every known one, the device beam too (no
    longer refused: ``test_validate_pr_matches_jax`` holds it to JAX's),
    takes an empty pass."""
    jfwd, tfwd = _forward_fns(_pr_batches())
    for decode in teval.DECODES:
        got = teval.validate_pr(tfwd, [], decode=decode)
        assert got["mean_val_per"] == 0.0 and np.isnan(got["mean_val_loss"])
    with pytest.raises(ValueError, match="decode"):
        teval.validate_pr(tfwd, [], decode="viterbi")
    got = teval.validate_pr(tfwd, [])
    assert got["mean_val_per"] == 0.0 and np.isnan(got["mean_val_loss"])


def test_decoders_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(5):
        lp = _log_probs(rng, (30, 8))
        assert teval.decode_greedy(lp) == jeval.decode_greedy(lp)
        assert teval.decode_best(lp) == jeval.decode_best(lp)


def _tv_batches(seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(2):
        t = 40
        lens = rng.integers(15, t + 1, 3).astype(np.int32)
        tv = rng.standard_normal((3, t, 9)).astype(np.float32)
        tv[0, 3:6] = -100.0  # pad rows inside an item are left out
        phn = np.repeat(rng.integers(1, 6, (3, t // 4)), 4, axis=1)
        batch = {"frame_lengths": lens, "tv_targets": tv,
                 "phn_frames": phn.astype(np.int32)}
        if i == 1:
            batch["batch_pad_mask"] = np.array([True, False, True])
        pred = np.where(rng.random((3, t)) < 0.8, phn,
                        rng.integers(1, 6, (3, t))).astype(np.int32)
        fwd = {"loss": np.float32(rng.random()),
               "tvs_pred": (tv + 0.3 * rng.standard_normal(tv.shape)
                            ).astype(np.float32),
               # FORCE-APTAI's field name in the second batch
               ("phn_fc_pred" if i == 0 else "pred_frame_phns"): pred}
        out.append((batch, fwd))
    return out


def test_validate_tv_matches_jax():
    pairs = _tv_batches()
    jfwd, tfwd = _forward_fns(pairs)
    batches = [b for b, _ in pairs]
    got = teval.validate_tv(tfwd, batches)
    _same_dict(got, jeval.validate_tv(jfwd, batches))
    assert len(got) == 10
    _same_dict(teval.validate_tv(tfwd, batches, max_batches=1),
               jeval.validate_tv(jfwd, batches, max_batches=1))


def test_test_tv_matches_jax():
    pairs = _tv_batches(seed=2)
    jfwd, tfwd = _forward_fns(pairs)
    batches = [b for b, _ in pairs]
    got = teval.test_tv(tfwd, batches, "N")
    _same_dict(got, jeval.test_tv(jfwd, batches, "N"))
    assert "test_N_mean_TMCD_rmse" in got and len(got) == 9 + 18


def test_metric_functions_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    for _ in range(20):
        gt = rng.integers(1, 6, rng.integers(1, 15)).tolist()
        pred = rng.integers(1, 6, rng.integers(0, 15)).tolist()
        assert tmetrics.compute_per(gt, pred) == jmetrics.compute_per(gt,
                                                                      pred)
    acc_t, acc_j = tmetrics.PERAccumulator(), jmetrics.PERAccumulator()
    for _ in range(5):
        gt = rng.integers(1, 6, 10).tolist()
        pred = rng.integers(1, 6, 8).tolist()
        acc_t.update(gt, pred)
        acc_j.update(gt, pred)
    assert (acc_t.edits, acc_t.lengths, acc_t.per) == (
        acc_j.edits, acc_j.lengths, acc_j.per)

    frames = [np.repeat(rng.integers(0, 5, 10), 3) for _ in range(3)]
    preds = [np.where(rng.random(30) < 0.7, f, 0) for f in frames]
    for name in ("frame_error_rate", "evaluate_overlap"):
        assert getattr(tmetrics, name)(frames, preds) == getattr(
            jmetrics, name)(frames, preds)
    for f, p in zip(frames, preds):
        assert tmetrics.phn_frames_to_durations(f) == \
            jmetrics.phn_frames_to_durations(f)
        assert tmetrics.frame_ids_to_sequence(f.tolist()) == \
            jmetrics.frame_ids_to_sequence(f.tolist())
        y, yhat = (tmetrics.boundaries_from_frames(x) for x in (f, p))
        np.testing.assert_array_equal(y, jmetrics.boundaries_from_frames(f))
        assert tmetrics.boundary_stats(y, yhat) == \
            jmetrics.boundary_stats(y, yhat)
    assert tmetrics.boundary_metrics(3, 4, 5, 6) == \
        jmetrics.boundary_metrics(3, 4, 5, 6)

    gt_tv = rng.standard_normal((50, 9))
    pd_tv = gt_tv + 0.2 * rng.standard_normal((50, 9))
    pd_tv[:, 2] = 1.0  # a constant series: PCC 0
    for name in ("tvs_rmse", "tvs_pcc"):
        got = getattr(tmetrics, name)(gt_tv, pd_tv)
        assert got == getattr(jmetrics, name)(gt_tv, pd_tv)
        assert list(got) == list(jmetrics.TV_ORDER)

    nested = {"a": 1, "b": {"c": 2.5, "d": {"e": "x"}}}
    assert tmetrics.flatten_dict(nested) == jmetrics.flatten_dict(nested)
    tmetrics.dict_to_csv(nested, tmp_path / "t.csv")
    jmetrics.dict_to_csv(nested, tmp_path / "j.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    speakers = [{"rmse": float(x), "pcc": float(1 - x)}
                for x in rng.random(4)]
    assert tmetrics.aggregate_mean_std(speakers) == \
        jmetrics.aggregate_mean_std(speakers)
