"""The numbers that decide ``correct``, from the program's outputs and the
reference's.

Serving: for each compared utterance, over its valid frames, the RMS of
the program's error over the RMS of the reference's output, for the TVs
and for the phoneme logits; the worst utterance's. An utterance that got
no answer, or an answer with the wrong number of frames, reads infinity.

Training: each checked step's loss (``loss_gap``, the worst step's;
``loss1_gap``, the first step's), the first gradient's norm by leaf, and
each leaf's change after the checked steps, taken by the worst leaf: the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

SMALL_LEAF = 1e-3


def _finite(x: float) -> float:
    """``x``, or infinity for a NaN (a NaN compares false with any limit)."""
    return x if math.isfinite(x) else math.inf


def rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    want = np.asarray(want, np.float64)
    err = np.asarray(got, np.float64) - want
    return float(np.sqrt(np.mean(err ** 2)) /
                 max(np.sqrt(np.mean(want ** 2)), 1e-30))


def serve_errors(pairs: List[Tuple[Optional[dict], dict]]
                 ) -> Dict[str, float]:
    """``pairs``: (the program's answer or None, the reference's), each a
    dict of ``tvs_pred`` and ``phn_fc_logits`` over the valid frames.
    Returns the worst utterance's ``tv_err`` and ``logit_err``."""
    worst = {"tv_err": 0.0 if pairs else math.inf,
             "logit_err": 0.0 if pairs else math.inf}
    for got, want in pairs:
        for key, name in (("tvs_pred", "tv_err"),
                          ("phn_fc_logits", "logit_err")):
            if got is None or np.shape(got[key]) != np.shape(want[key]):
                e = math.inf
            else:
                e = rel_rms(got[key], want[key])
            worst[name] = max(worst[name], _finite(e))
    return worst


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Each kept leaf's gap between the norms, over the larger of the
    reference's norm of the leaf and of the median leaf."""
    median = float(np.median([want[k] for k in keep]))
    return {k: _finite(abs(got.get(k, math.inf) - want[k])
                       / max(want[k], median, 1e-30)) for k in keep}


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             keep: List[str]) -> float:
    return max(leaf_gaps(got, want, keep).values(), default=math.inf)


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (each checked step's), ``grad1`` and
    ``delta`` (norm by leaf). Returns ``loss_gap``, ``grad_gap`` and
    ``update_gap``."""
    if len(prog["losses"]) != len(ref["losses"]):
        return {"loss_gap": math.inf, "grad_gap": math.inf,
                "update_gap": math.inf}
    steps = [_finite(abs(a - b) / max(abs(b), 1e-30))
             for a, b in zip(prog["losses"], ref["losses"])]
    loss_gap = max(steps)
    g = ref["grad1"]
    median = float(np.median(list(g.values())))
    keep = sorted(k for k, v in g.items() if v >= SMALL_LEAF * median)
    worst, spread = {}, {}
    for name, a, b in (("grad", prog["grad1"], g),
                       ("update", prog["delta"], ref["delta"])):
        gaps = leaf_gaps(a, b, keep) if keep else {}
        order = sorted(gaps, key=gaps.get, reverse=True)[:3]
        worst[name] = [[k, gaps[k], b[k]] for k in order]
        values = list(gaps.values()) or [math.inf]
        spread[f"{name}_gap_median"] = float(np.median(values))
        spread[f"{name}_gap_p90"] = float(np.quantile(values, 0.9))
    return {"loss_gap": loss_gap, "loss1_gap": steps[0],
            "loss_gap_by_step": steps, "worst_leaves": worst, **spread,
            "grad_gap": leaf_gap(prog["grad1"], g, keep),
            "update_gap": leaf_gap(prog["delta"], ref["delta"], keep)}
