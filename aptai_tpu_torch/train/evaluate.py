"""The validation and test passes, with the JAX package's metric
aggregation (``aptai_tpu/train/evaluate.py``):

  * PR validation: corpus PER = Σedit/Σlen and the mean loss
    (reference train/train_phoneme_recognizer.py:507-562);
  * TV validation: the 10-metric dict (train/train_aptai.py:533-652);
  * TV test: per-TV RMSE/PCC and FER/PER/overlap/boundary per rate
    (train/train_aptai.py:655-838).

It keeps the JAX package's two deliberate deviations from reference
quirks: the TMCD slot holds TMCD, and the boundary statistics compare
boundary times taken from frame runs (×20 ms).

``forward_fn(batch)`` returns tensors (on the card) or arrays; each pass
fetches a batch's outputs to the host once, then decodes and scores on the
host, except PR validation with ``decode="beam_device"``, which decodes on
the device first and fetches only the sequences, their lengths and the
loss.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np

from aptai_tpu_torch import TV_ORDER
import torch

from aptai_tpu_torch.decode.beam import decode_best
from aptai_tpu_torch.decode.device import beam_decode_device
from aptai_tpu_torch.decode.native import edit_distance
from aptai_tpu_torch.infer.api import fetch_outputs
from aptai_tpu_torch.train.metrics import (PERAccumulator,
                                           boundaries_from_frames,
                                           boundary_stats, evaluate_overlap,
                                           frame_ids_to_sequence, tvs_pcc,
                                           tvs_rmse)

__all__ = ["decode_best", "decode_greedy", "test_tv", "validate_pr",
           "validate_tv"]

DECODES = ("beam", "beam_device", "greedy")


def decode_greedy(log_probs: np.ndarray, blank: int = 0):
    """Host greedy collapse (argmax → dedupe → de-blank), the cheap
    per-epoch validation decode."""
    ids = np.argmax(log_probs, axis=-1)
    keep = np.ones(len(ids), bool)
    keep[1:] = ids[1:] != ids[:-1]
    collapsed = ids[keep]
    return collapsed[collapsed != blank].tolist()


def validate_pr(forward_fn: Callable,
                batches: Iterable[Dict[str, np.ndarray]],
                max_batches: int | None = None,
                decode: str = "beam") -> Dict[str, float]:
    """PR validation: mean CTC loss and corpus PER, decoded by the host
    beam (``"beam"``: the C++ one first), by the batched beam on the
    log-probs' device (``"beam_device"``: the (B, T, V) log-probs stay
    there) or greedily on the host (``"greedy"``).

    ``forward_fn(batch) -> {loss, log_probs, frame_lengths}``
    (``train_pr.make_eval_forward``)."""
    if decode not in DECODES:
        raise ValueError(f"decode must be one of {DECODES}, got {decode!r}")
    per = PERAccumulator()
    losses = []
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        out = forward_fn(batch)
        if decode == "beam_device":
            seqs, seq_lens, _ = beam_decode_device(
                torch.as_tensor(out["log_probs"]),
                torch.as_tensor(out["frame_lengths"]))
            out = fetch_outputs({"loss": out["loss"], "seqs": seqs,
                                 "seq_lens": seq_lens})
            n_rows = len(out["seqs"])
            pred = lambda b: out["seqs"][b, :out["seq_lens"][b]].tolist()
        else:
            out = fetch_outputs(out)
            n_rows = len(out["log_probs"])
            dec = decode_greedy if decode == "greedy" else decode_best
            pred = lambda b: dec(out["log_probs"][b, :out["frame_lengths"][b]])
        losses.append(float(out["loss"]))
        mask = batch.get("batch_pad_mask", np.ones(n_rows, bool))
        for b in range(n_rows):
            if not mask[b]:
                continue
            labels = np.asarray(batch["phoneme_labels"][b])
            per.update(labels[labels >= 0].tolist(), pred(b))
    return {
        "mean_val_per": per.per,
        "mean_val_loss": float(np.mean(losses)) if losses else float("nan"),
    }


def _tv_frame_metrics(gt_frames: np.ndarray, pred_frames: np.ndarray):
    """FER counters, overlap, boundary stats and FC-PER pieces of one
    item."""
    corr = int((gt_frames == pred_frames).sum())
    total = len(gt_frames)
    overlap = evaluate_overlap([gt_frames], [pred_frames])
    y_b = boundaries_from_frames(gt_frames)
    yhat_b = boundaries_from_frames(pred_frames)
    if len(y_b) and len(yhat_b):
        p, r, f1, rval = boundary_stats(y_b, yhat_b)
    else:
        p = r = f1 = rval = 0.0
    y_seq = frame_ids_to_sequence(gt_frames.tolist())
    yhat_seq = frame_ids_to_sequence(pred_frames.tolist())
    fc_edit = edit_distance(y_seq, yhat_seq)
    return corr, total, overlap, (p, r, f1, rval), fc_edit, len(y_seq)


def _tv_items(forward_fn, batches, max_batches, losses=None):
    """Per valid item: (ground-truth TVs, predicted TVs) on the frames
    whose target is not the pad, and its frame metrics."""
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        out = fetch_outputs(forward_fn(batch))
        if losses is not None:
            losses.append(float(out["loss"]))
        tvs_pred = out["tvs_pred"]
        pred_key = "phn_fc_pred" if "phn_fc_pred" in out else \
            "pred_frame_phns"
        preds = out[pred_key]
        mask = batch.get("batch_pad_mask", np.ones(len(tvs_pred), bool))
        for b in range(len(tvs_pred)):
            if not mask[b]:
                continue
            n = int(batch["frame_lengths"][b])
            gt_tv = np.asarray(batch["tv_targets"][b][:n], np.float64)
            pd_tv = np.asarray(tvs_pred[b][:n], np.float64)
            valid = gt_tv[:, 0] != -100.0
            gt_f = np.asarray(batch["phn_frames"][b][:n])
            pd_f = np.asarray(preds[b][:n])
            yield gt_tv[valid], pd_tv[valid], _tv_frame_metrics(gt_f, pd_f)


class _FrameScores:
    """The frame metrics of the TV passes, summed over items."""

    def __init__(self):
        self.overlaps, self.ps, self.rs, self.f1s, self.rvals = \
            [], [], [], [], []
        self.fc_edits, self.fc_lens = [], []
        self.corr_frames = self.total_frames = 0

    def add(self, metrics):
        corr, total, overlap, (p, r, f1, rv), fce, fcl = metrics
        self.corr_frames += corr
        self.total_frames += total
        self.overlaps.append(overlap)
        self.ps.append(p)
        self.rs.append(r)
        self.f1s.append(f1)
        self.rvals.append(rv)
        self.fc_edits.append(fce)
        self.fc_lens.append(fcl)

    def summary(self, prefix: str) -> Dict[str, float]:
        return {
            f"{prefix}_FER": 1 - self.corr_frames / max(self.total_frames, 1),
            f"{prefix}_PER": float(np.sum(self.fc_edits)
                                   / max(np.sum(self.fc_lens), 1)),
            f"{prefix}_overlap": float(np.mean(self.overlaps)),
            f"{prefix}_F1": float(np.mean(self.f1s)),
            f"{prefix}_p": float(np.mean(self.ps)),
            f"{prefix}_r": float(np.mean(self.rs)),
            f"{prefix}_Rval": float(np.mean(self.rvals)),
        }


def validate_tv(forward_fn: Callable,
                batches: Iterable[Dict[str, np.ndarray]],
                max_batches: int | None = None) -> Dict[str, float]:
    """APTAI/FORCE validation: the 10-metric dict of reference
    train/train_aptai.py:641-652.

    ``forward_fn(batch) -> {loss, tvs_pred, phn_fc_pred or
    pred_frame_phns}``; the batch carries ``frame_lengths``,
    ``tv_targets`` and ``phn_frames``."""
    losses, rmses, pccs = [], [], []
    frames = _FrameScores()
    for gt_tv, pd_tv, metrics in _tv_items(forward_fn, batches, max_batches,
                                           losses):
        rmses.append(float(np.mean(list(tvs_rmse(gt_tv, pd_tv).values()))))
        pccs.append(float(np.mean(list(tvs_pcc(gt_tv, pd_tv).values()))))
        frames.add(metrics)
    out = {
        "val_mean_loss": float(np.mean(losses)),
        "val_mean_rmse": float(np.mean(rmses)),
        "val_mean_pcc": float(np.mean(pccs)),
    }
    out.update(frames.summary("val_mean"))
    out["val_mean_overlap"] = out.pop("val_mean_overlap")  # the JAX order
    return out


def test_tv(forward_fn: Callable,
            batches: Iterable[Dict[str, np.ndarray]], rate: str,
            max_batches: int | None = None) -> Dict[str, float]:
    """Per-rate test metrics with the per-TV breakdown (reference
    train/train_aptai.py:655-838)."""
    rmse_tv = {k: [] for k in TV_ORDER}
    pcc_tv = {k: [] for k in TV_ORDER}
    frames = _FrameScores()
    for gt_tv, pd_tv, metrics in _tv_items(forward_fn, batches,
                                           max_batches):
        for k, v in tvs_rmse(gt_tv, pd_tv).items():
            rmse_tv[k].append(v)
        for k, v in tvs_pcc(gt_tv, pd_tv).items():
            pcc_tv[k].append(v)
        frames.add(metrics)
    mean_rmse = {k: float(np.mean(v)) for k, v in rmse_tv.items()}
    mean_pcc = {k: float(np.mean(v)) for k, v in pcc_tv.items()}
    prefix = f"test_{rate}_mean"
    out = {
        f"{prefix}_rmse": float(np.mean(list(mean_rmse.values()))),
        f"{prefix}_pcc": float(np.mean(list(mean_pcc.values()))),
    }
    out.update(frames.summary(prefix))
    for k in mean_pcc:
        out[f"{prefix}_{k}_pcc"] = mean_pcc[k]
    for k in mean_rmse:
        out[f"{prefix}_{k}_rmse"] = mean_rmse[k]
    return out

