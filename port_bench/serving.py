"""What the serving kinds share: the predictor built from the seed, the span
around its calls, the warm-up of the traffic's shapes, and the comparison of
served answers with the reference."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import arith, compare, data
from port_bench.core import float32_numerics
from port_bench.weights import build_model, seed_weights


class Served:
    """An ``APTAIPredictor`` over a model with weights from the run's seed,
    and the host copy of those weights for the reference. ``predict_batch``
    wraps the predictor's with a span and records each call's host time."""

    def __init__(self, run, overrides: Optional[dict] = None):
        from aptai_tpu_torch.infer.api import APTAIPredictor

        self.run = run
        model = build_model(run.cfg, run.device, **(overrides or {}))
        run.phase("model built")
        weights = seed_weights(model, run.seed_for("weights"))
        self.weights = {k: v.cpu() for k, v in weights.items()}
        del weights
        run.phase("weights drawn, the reference's copy on the host")
        self.predictor = APTAIPredictor(model, device=run.device)
        del model
        run.phase("serving copy")
        self.host_s: List[float] = []
        self.record = True
        gc.collect()
        if run.device == "cuda":
            torch.cuda.empty_cache()

    def predict_batch(self, wavs: Sequence[np.ndarray], fields=None):
        t = time.perf_counter()
        with record_function("port_bench.predict_batch"):
            out = self.predictor.predict_batch(wavs, fields=fields)
        if self.record:
            self.host_s.append(time.perf_counter() - t)
        return out

    def warm(self, rows: int, widths: Sequence[int], fields) -> None:
        """Run and fetch each (rows, width) shape once: the shapes the
        traffic uses and no others."""
        from aptai_tpu_torch.infer.api import fetch_outputs

        self.record = False
        for width in sorted(set(widths)):
            wav = np.zeros(width, np.float32)
            fetch_outputs(self.predictor.predict_batch([wav] * rows,
                                                       fields=fields))
        self.record = True
        self.run.phase(f"warm-up of {len(set(widths))} shapes")

    def free(self) -> None:
        self.predictor = None
        gc.collect()
        if self.run.device == "cuda":
            torch.cuda.empty_cache()


def reference_answers(run, weights: Dict[str, torch.Tensor],
                      groups: List[Tuple[List[np.ndarray], int]],
                      precision: str = "f32") -> List[List[dict]]:
    """The reference's answer to each waveform of each group, a group being
    the waveforms served in one batch and that batch's padded width; each
    answer over its valid frames."""
    from port_bench.reference.encoder import predict

    dev = run.device
    p = {k: v.to(dev) for k, v in weights.items()}
    out = []
    with float32_numerics():
        for wavs, width in groups:
            audio = torch.from_numpy(data.padded(wavs, width)).to(dev)
            lengths = torch.tensor([len(w) for w in wavs], device=dev)
            ref = predict(p, run.cfg, audio, lengths, precision)
            answers = []
            for i in range(len(wavs)):
                n = int(ref["frame_lengths"][i])
                answers.append({k: ref[k][i, :n].cpu().numpy() for k in
                                ("tvs_pred", "phn_fc_logits")})
            out.append(answers)
    del p
    return out


def serve_numbers(run, pairs) -> List[Tuple[str, float, float]]:
    errs = compare.serve_errors(pairs)
    return [(k, errs[k], lim) for k, lim in run.limits.items()]


def utterance_flops(cfg, lengths) -> int:
    return sum(arith.forward_flops(cfg, int(n)) for n in lengths)
