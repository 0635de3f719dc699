"""The reference's training steps: the configuration's loss, its gradients by
autograd in float32, and ``torch.optim.Adam``'s update written out, from the
benchmark's initial weights over the same batches and draws.

Rows are independent in this model, so each step runs in blocks of rows and
sums their gradients; every mean of the loss divides by its count over the
whole batch (APTAI: valid TV frames and labelled phoneme frames; W2V2PR's
CTC: the batch), so the blocks add up to the whole batch's step. CTC is
``torch.nn.functional.ctc_loss`` in float64, each item's loss over its
target length, infeasible items zeroed.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from port_bench.reference.draws import step_draws
from port_bench.reference.encoder import (Ops, aptai_heads, encode,
                                          frame_count, pr_head)

TV_PAD = -100.0


def frozen(cfg, name: str) -> bool:
    """Whether a parameter takes no gradient (a frozen feature extractor)."""
    return (cfg.get("freeze_feature_encoder", False)
            and name.startswith("wav2vec2.feature_extractor."))


def _pad_or_trim(x: torch.Tensor, t: int, value) -> torch.Tensor:
    if x.shape[1] >= t:
        return x[:, :t]
    pad = x.new_full((x.shape[0], t - x.shape[1]) + tuple(x.shape[2:]), value)
    return torch.cat([x, pad], dim=1)


def block_loss(p, cfg, batch, rows: slice, draws, ops: Ops, counts):
    """The loss of ``rows``' share of the batch's loss."""
    h, flen = encode(p, cfg, batch["audio"][rows], batch["audio_lengths"][rows],
                     ops, draws.block(rows) if draws is not None else None)
    d = draws.block(rows) if draws is not None else None
    t = h.shape[1]
    if cfg["family"] == "aptai":
        tv, logits = aptai_heads(p, cfg, h, ops, d)
        tgt = _pad_or_trim(batch["tv_targets"][rows].float(), t, TV_PAD)
        phn = _pad_or_trim(batch["phn_frames"][rows].long(), t, 0)
        tv_mask = (tgt != TV_PAD).float()
        mse = (tv_mask * (tv - tgt) ** 2).sum() / counts["tv"]
        nll = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                            phn[:, :, None])[..., 0]
        ce = ((phn != 0).float() * nll).sum() / counts["phn"]
        return 0.5 * mse + 0.5 * ce
    logits = pr_head(p, h, ops)
    labels = batch["phoneme_labels"][rows]
    target_lengths = (labels >= 0).sum(dim=-1)
    lp = F.log_softmax(logits.double(), dim=-1).transpose(0, 1)
    nll = F.ctc_loss(lp, labels.clamp(min=0).long(), flen.long(),
                     target_lengths.long(), blank=cfg["blank_id"],
                     reduction="none", zero_infinity=True)
    return (nll / target_lengths.clamp(min=1)).sum() / counts["rows"]


def _counts(cfg, batch, t: int, rows: Sequence[int]):
    """The whole batch's counts for its means."""
    out = {"rows": float(len(rows))}
    if cfg["family"] == "aptai":
        tgt = _pad_or_trim(batch["tv_targets"][rows].float(), t, TV_PAD)
        phn = _pad_or_trim(batch["phn_frames"][rows].long(), t, 0)
        out["tv"] = (tgt != TV_PAD).float().sum().clamp(min=1)
        out["phn"] = (phn != 0).float().sum().clamp(min=1)
    return out


def run_steps(p0: Dict[str, torch.Tensor], cfg, batches: List[dict],
              seeds: List[int], masks: List[list], lr: float,
              precision: str = "f32", block: int = 4, rows=None,
              betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """Steps ``batches[i]`` (device tensors) with the draws of ``seeds[i]``
    and the recorded dropout ``masks[i]``, from ``p0``. ``rows``: the rows
    of each batch taken (all by default; the fault "half of the batch
    left out" takes the first half). Returns each step's ``losses``, the
    first step's gradient norm by leaf (``grad1``), and the norm of each
    leaf's change after the last step (``delta``)."""
    ops = Ops(precision)
    dev = next(iter(p0.values())).device
    params = {k: v.detach().clone().requires_grad_(not frozen(cfg, k))
              for k, v in p0.items()}
    train = {k: v for k, v in params.items() if v.requires_grad}
    m = {k: torch.zeros_like(v) for k, v in train.items()}
    v2 = {k: torch.zeros_like(v) for k, v in train.items()}
    b1, b2 = betas
    losses, grad1 = [], {}
    for step, (batch, seed, mk) in enumerate(zip(batches, seeds, masks), 1):
        n = batch["audio"].shape[0]
        take = list(range(n)) if rows is None else list(rows)
        t = frame_count(cfg, batch["audio"].shape[1])
        draws = step_draws(cfg, seed, mk, frame_count(
            cfg, batch["audio_lengths"].long()), t, dev)
        counts = _counts(cfg, batch, t, take)
        total = 0.0
        for lo in range(0, len(take), block):
            sel = take[lo:lo + block]
            rs = slice(sel[0], sel[-1] + 1)
            loss = block_loss(params, cfg, batch, rs, draws, ops, counts)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            if step == 1:
                grad1 = {k: float(g.grad.norm()) for k, g in train.items()
                         if g.grad is not None}
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for k, w in train.items():
                if w.grad is None:
                    continue
                g = w.grad
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / bc2 ** 0.5).add_(eps)
                w.addcdiv_(m[k], denom, value=-lr / bc1)
                w.grad = None
    with torch.no_grad():
        delta = {k: float((w - p0[k]).norm()) for k, w in train.items()}
    return {"losses": losses, "grad1": grad1, "delta": delta}
