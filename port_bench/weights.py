"""The program's model with weights from the seed, made on the device.

The model is built on the device (``torch.device`` as the default), then
every weight is drawn from one ``torch.Generator`` on that device in two
large calls (one normal, one uniform draw over all the weights at once) and
copied into place: LeCun-normal products (std 1/sqrt(fan in)), the
positional conv's ``v`` normal with std 4/sqrt(k C) and ``g`` ones, zero
biases, unit LayerNorms, SpecAugment's mask embedding uniform in [0, 1).
Parameters are float32; the program casts what it serves in bf16 itself.

The benchmark keeps a float32 copy of these weights for the reference: the
reference never reads the program's model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


def backbone_config(cfg: dict):
    """The program's ``Wav2Vec2Config`` from a configuration file: every
    key the dataclass has."""
    from aptai_tpu_torch.models.configs import Wav2Vec2Config

    names = {f.name for f in dataclasses.fields(Wav2Vec2Config)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in names}
    return Wav2Vec2Config(**kw)


def build_model(cfg: dict, device: str, **overrides) -> nn.Module:
    """The program's model of the configuration's family on ``device``,
    with the torch default initialisation (overwritten by
    :func:`seed_weights`). ``overrides`` replace backbone keys (the
    control's ``quant``)."""
    wcfg = backbone_config({**cfg, **overrides})
    with torch.device(device):
        if cfg["family"] == "aptai":
            from aptai_tpu_torch.models.aptai import APTAI

            return APTAI(wcfg, num_phonemes=cfg["num_phonemes"],
                         lowpass_cutoff_hz=cfg["lowpass_cutoff_hz"],
                         frame_rate_hz=cfg["frame_rate_hz"],
                         tv_drop=cfg["tv_drop"], phn_drop=cfg["phn_drop"],
                         freeze_feature_encoder=cfg["freeze_feature_encoder"])
        from aptai_tpu_torch.models.w2v2_pr import W2V2PR

        return W2V2PR(wcfg,
                      freeze_feature_encoder=cfg["freeze_feature_encoder"])


def _std(name: str, p: torch.Tensor) -> Tuple[str, float]:
    """How a parameter is drawn: ("normal", std), ("uniform", 0),
    ("ones", 0) or ("zeros", 0)."""
    if name.endswith("masked_spec_embed"):
        return "uniform", 0.0
    if name.endswith("weight_g"):
        return "ones", 0.0
    if name.endswith("weight_v"):
        k, c = p.shape[-1], p.shape[0]
        return "normal", 4.0 / np.sqrt(k * c)
    if name.endswith("bias"):
        return "zeros", 0.0
    if "layer_norm" in name:
        return "ones", 0.0
    return "normal", 1.0 / np.sqrt(p[0].numel())


@torch.no_grad()
def seed_weights(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Draw every parameter of ``model`` from ``seed`` in place, on its
    device; returns a float32 copy of them by name (the reference's)."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    gen = torch.Generator(dev).manual_seed(seed)
    kinds = {n: _std(n, p) for n, p in params.items()}
    n_normal = sum(p.numel() for n, p in params.items()
                   if kinds[n][0] == "normal")
    n_uniform = sum(p.numel() for n, p in params.items()
                    if kinds[n][0] == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=dev)
    uniform = torch.rand(n_uniform, generator=gen, device=dev)
    at = {"normal": 0, "uniform": 0}
    for name, p in params.items():
        kind, std = kinds[name]
        if kind in at:
            src = normal if kind == "normal" else uniform
            flat = src[at[kind]:at[kind] + p.numel()].view(p.shape)
            p.copy_(flat * std if kind == "normal" else flat)
            at[kind] += p.numel()
        elif kind == "ones":
            p.fill_(1.0)
        else:
            p.zero_()
    del normal, uniform
    return {n: p.detach().float().clone() for n, p in params.items()}
