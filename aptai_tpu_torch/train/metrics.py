"""Metric registry — the evaluation contract of the reference, centralized
(numpy; the port's own copy of the JAX package's ``train/metrics.py``).

Definitions (BASELINE.md / SURVEY.md §5.5):
  * PER       = editdistance / #phonemes (reference utility.py:99-104;
                aggregated as Σedit/Σlen, train_phoneme_recognizer.py:560)
  * FER       = 1 − correct/total frames (train_aptai.py:592-598)
  * overlap   = hits/counts (utility.py:615-622)  (= 1 − FER)
  * boundary P/R/F1/R-value, tolerance 0.02 s, UnsupSeg-adapted
                (utility.py:572-612)
  * per-TV RMSE (utility.py:393-418) and Pearson PCC (utility.py:422-444)
  * frames→durations (utility.py:539-558), frame ids→sequence
                (utility.py:561-566)
"""

from __future__ import annotations

import math
from itertools import groupby
from typing import Dict, List, Sequence

import numpy as np

from aptai_tpu_torch import TV_ORDER
from aptai_tpu_torch.decode.native import edit_distance


# ---------------------------------------------------------------------------
# PER
# ---------------------------------------------------------------------------

def compute_per(gt: Sequence[int], pred: Sequence[int]) -> float:
    """``utility.compute_PER``: percentage, rounded to 2 decimals."""
    per = edit_distance(gt, pred) / len(gt)
    return round(per * 100, 2)


class PERAccumulator:
    """Corpus-level PER = Σ edit distances / Σ reference lengths
    (reference train/train_phoneme_recognizer.py:536-542, 559-561)."""

    def __init__(self):
        self.edits = 0
        self.lengths = 0

    def update(self, gt: Sequence[int], pred: Sequence[int]) -> None:
        self.edits += edit_distance(gt, pred)
        self.lengths += len(gt)

    @property
    def per(self) -> float:
        return self.edits / max(self.lengths, 1)


# ---------------------------------------------------------------------------
# Frame classification
# ---------------------------------------------------------------------------

def frame_error_rate(gt_frames: Sequence[Sequence[int]],
                     pred_frames: Sequence[Sequence[int]]) -> float:
    """FER = 1 − correct/total (reference train/train_aptai.py:592-598)."""
    correct = total = 0
    for g, p in zip(gt_frames, pred_frames):
        g, p = np.asarray(g), np.asarray(p)
        assert len(g) == len(p)
        correct += int((g == p).sum())
        total += len(g)
    return 1.0 - correct / max(total, 1)


def evaluate_overlap(gt_frames, pred_frames) -> float:
    """``utility.evaluate_overlap`` (utility.py:615-622)."""
    hits = counts = 0
    for g, p in zip(gt_frames, pred_frames):
        g, p = np.asarray(g), np.asarray(p)
        assert len(g) == len(p)
        hits += int((g == p).sum())
        counts += len(g)
    return hits / max(counts, 1)


# ---------------------------------------------------------------------------
# Boundary metrics (UnsupSeg-adapted)
# ---------------------------------------------------------------------------

def boundary_metrics(precision_counter, recall_counter, pred_counter,
                     gt_counter):
    """``utility.get_metrics`` (utility.py:572-585)."""
    EPS, eps = 1e-7, 1e-5
    precision = precision_counter / (pred_counter + eps)
    recall = recall_counter / (gt_counter + eps)
    f1 = 2 * (precision * recall) / (precision + recall + eps)
    os_ = recall / (precision + EPS) - 1
    r1 = np.sqrt((1 - recall) ** 2 + os_ ** 2)
    r2 = (-os_ + recall - 1) / np.sqrt(2)
    rval = 1 - (np.abs(r1) + np.abs(r2)) / 2
    return precision, recall, f1, rval


def boundary_stats(y: np.ndarray, yhat: np.ndarray, tolerance: float = 0.02):
    """``utility.get_stats`` (utility.py:588-612): precision/recall/F1/R-value
    of predicted boundary times against ground truth within 0.02 s."""
    y = np.asarray(y, np.float64)
    yhat = np.asarray(yhat, np.float64)
    precision_counter = sum(
        int(np.abs(y - yh).min() <= tolerance) for yh in yhat
    )
    recall_counter = sum(int(np.abs(yhat - yi).min() <= tolerance) for yi in y)
    return boundary_metrics(precision_counter, recall_counter, len(yhat),
                            len(y))


# ---------------------------------------------------------------------------
# Tract-variable metrics
# ---------------------------------------------------------------------------

def tvs_rmse(tvs_gt: np.ndarray, tvs_pred: np.ndarray) -> Dict[str, float]:
    """Per-TV RMSE over (T, 9) arrays in TV_ORDER (utility.py:393-418)."""
    out = {}
    for i, k in enumerate(TV_ORDER):
        se = np.square(tvs_gt[:, i] - tvs_pred[:, i])
        out[k] = math.sqrt(float(se.mean()))
    return out


def _pearsonr(x: np.ndarray, y: np.ndarray) -> float:
    if np.std(x) == 0 or np.std(y) == 0:
        return 0.0  # undefined for constant series; report no correlation
    from scipy.stats import pearsonr

    return float(pearsonr(x, y)[0])


def tvs_pcc(tvs_gt: np.ndarray, tvs_pred: np.ndarray) -> Dict[str, float]:
    """Per-TV Pearson correlation (utility.py:422-444; the r value)."""
    return {
        k: _pearsonr(tvs_gt[:, i], tvs_pred[:, i])
        for i, k in enumerate(TV_ORDER)
    }


# ---------------------------------------------------------------------------
# Frame-sequence utilities
# ---------------------------------------------------------------------------

def phn_frames_to_durations(phns: Sequence[int], resolution: float = 0.02):
    """``utility.phn_frames2dur`` (utility.py:539-558):
    frame-id run lengths → [(start_s, end_s, phoneme_id)]."""
    counter, out = 0, []
    for p, grp in groupby(phns):
        length = len(list(grp))
        out.append((round(counter * resolution, 2),
                    round((counter + length) * resolution, 2), p))
        counter += length
    return out


def frame_ids_to_sequence(frame_ids: Sequence[int]) -> List[int]:
    """``utility.phn_frame_id2phn`` (utility.py:561-566): collapse runs."""
    return [p for p, _ in groupby(frame_ids)]


def boundaries_from_frames(frame_ids: Sequence[int],
                           resolution: float = 0.02) -> np.ndarray:
    """Boundary times = starts of each phoneme run after the first —
    the form fed to boundary_stats by the trainers
    (reference train/train_aptai.py:600-613)."""
    durs = phn_frames_to_durations(frame_ids, resolution)
    return np.asarray([d[0] for d in durs[1:]], np.float64)


# ---------------------------------------------------------------------------
# Aggregation helpers (LOSO mean ± std, CSV export)
# ---------------------------------------------------------------------------

def flatten_dict(d: Dict, parent_key: str = "", sep: str = "_") -> Dict:
    """``utility.flatten_dict`` (utility.py:474-485)."""
    items = {}
    for k, v in d.items():
        key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, dict):
            items.update(flatten_dict(v, key, sep))
        else:
            items[key] = v
    return items


def dict_to_csv(d: Dict, path) -> None:
    """``utility.dict_to_csv`` (utility.py:488-501): one header + one row."""
    import csv

    flat = flatten_dict(d)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(flat))
        w.writeheader()
        w.writerow(flat)


def aggregate_mean_std(per_speaker: List[Dict[str, float]]):
    """LOSO aggregate: mean ± std per metric over speakers
    (reference train/train_aptai.py:998-1033)."""
    keys = per_speaker[0].keys()
    mean = {k: float(np.mean([d[k] for d in per_speaker])) for k in keys}
    std = {k: float(np.std([d[k] for d in per_speaker])) for k in keys}
    return mean, std
