"""A training step's random draws, for the reference.

Dropout's keep masks are the program's own: the benchmark records each
mask the step's dropout drew (``traffic/train_steps.py``), checks its shape
and its kept share against the configured rate, and the reference applies
them in float32 at the same sites, in the order the configuration's forward
draws them. SpecAugment's time spans are made again: the program documents
(``TrainStep``) that they come from a generator of the step's device seeded
with ``seed + step + 2**62`` (mod 2**64), in two uniform draws, and this
module makes the same draws and applies the configuration's rule (about
``p * length / span`` spans an item, stochastic rounding, at least
``min_masks``, starts uniform in ``[0, length - span)``).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from port_bench.reference.encoder import Draws

SPEC_AUGMENT_SEED_OFFSET = 1 << 62
# a recorded mask's kept share may lie this many binomial standard
# deviations from the configured rate's (a false alarm about once in 10**9)
KEEP_SIGMAS = 6.0


class DrawMismatch(ValueError):
    """The program drew other dropout masks than the configuration's
    forward draws: its step did not run the configured model."""


def dropout_sites(cfg) -> List[Tuple[str, str, str]]:
    """(site, rate key, width key) in the order the forward draws them."""
    sites = [("feat_proj", "feat_proj_dropout", "hidden_size"),
             ("encoder", "hidden_dropout", "hidden_size")]
    for i in range(cfg["num_hidden_layers"]):
        sites += [(f"attn{i}", "attention_dropout", "hidden_size"),
                  (f"act{i}", "activation_dropout", "intermediate_size"),
                  (f"ffn{i}", "hidden_dropout", "hidden_size")]
    if cfg["family"] == "aptai":
        sites += [("tv_head", "tv_drop", "hidden_size"),
                  ("phn_head", "phn_drop", "hidden_size")]
    else:
        sites += [("final", "final_dropout", "hidden_size")]
    return [s for s in sites if cfg[s[1]] > 0]


def keep_rate(site: str, mask: torch.Tensor, rate: float) -> None:
    """Raises unless the share of ``mask`` kept lies within ``KEEP_SIGMAS``
    standard deviations of a binomial draw at the configured ``rate``."""
    n = mask.numel()
    kept = float(mask.sum()) / n
    sigma = math.sqrt(rate * (1 - rate) / n)
    if abs(kept - (1 - rate)) > KEEP_SIGMAS * sigma:
        raise DrawMismatch(f"dropout at {site} kept {kept:.6f} of {n}; the "
                           f"configuration's rate {rate} keeps "
                           f"{1 - rate:.6f} +- {sigma:.2e}")


def time_mask(cfg, gen: torch.Generator, frame_lengths: torch.Tensor,
              t: int) -> torch.Tensor:
    """SpecAugment's (B, T) time mask, True = masked."""
    prob, span = cfg["mask_time_prob"], cfg["mask_time_length"]
    min_masks = cfg["mask_time_min_masks"]
    b, dev = frame_lengths.shape[0], frame_lengths.device
    lengths = frame_lengths.to(torch.int32)
    most = max(int(prob * t / span) + 1, min_masks)
    expected = prob * lengths.float() / span
    frac = expected - torch.floor(expected)
    extra = (torch.rand(b, generator=gen, device=dev) < frac).int()
    n = (torch.floor(expected).int() + extra).clamp(min=min_masks)
    n = n.clamp(max=most)
    u = torch.rand((b, most), generator=gen, device=dev)
    starts = (u * (lengths[:, None] - span).clamp(min=1)).int()
    pos = torch.arange(t, device=dev)[None, None, :]
    inside = (pos >= starts[:, :, None]) & (pos < starts[:, :, None] + span)
    used = torch.arange(most, device=dev)[None, :] < n[:, None]
    return (inside & used[:, :, None]).any(dim=1)


def step_draws(cfg, seed: int, masks: List[torch.Tensor],
               frame_lengths: torch.Tensor, t: int, device) -> Draws:
    """The draws of the step seeded with ``seed`` (``seed + step`` of a
    ``TrainStep`` built with ``seed``): ``masks``, the keep masks the
    program's dropout drew, in the order of :func:`dropout_sites` (checked
    against their shapes), and SpecAugment's time mask made again."""
    sites = dropout_sites(cfg)
    b = frame_lengths.shape[0]
    shapes = [(b, t, cfg[width]) for _, _, width in sites]
    got = [tuple(m.shape) for m in masks]
    if got != shapes:
        raise DrawMismatch(f"the step drew dropout masks of shapes {got}; the "
                         f"configuration's forward draws {shapes}")
    for (site, rate_key, _), m in zip(sites, masks):
        keep_rate(site, m, cfg[rate_key])
    tm = None
    if cfg["apply_spec_augment"] and cfg["mask_time_prob"] > 0:
        gen = torch.Generator(device).manual_seed(
            (seed + SPEC_AUGMENT_SEED_OFFSET) % (1 << 64))
        tm = time_mask(cfg, gen, frame_lengths.to(device), t)
    return Draws({site: m.to(device) for (site, _, _), m in
                  zip(sites, masks)}, tm,
                 {k: cfg[k] for _, k, _ in sites})
