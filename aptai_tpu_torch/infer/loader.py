"""Checkpoint directory → model or predictor (the JAX package's
``infer/loader.py``).

The trainers save ``model_cfg.json`` (backbone config, vocabulary, model
kind) beside the parameters of every best and last checkpoint, so a
checkpoint directory rebuilds its model in one call:

    from aptai_tpu_torch.infer.loader import load_predictor
    pred = load_predictor("experiments/APTAI/<run>")  # or .../best-model-ckpt

Both packages write ``params.msgpack`` (flax), which crosses the weight
bridge of ``models/convert.py``; an older run of this package's
``params.pt`` (a ``state_dict``, ``train/checkpoints.py``) is read too. The two packages'
``model_cfg.json`` backbone dicts are interchangeable; a field this package
does not implement raises (``models/configs.py``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

from torch import nn

from aptai_tpu_torch.infer.api import (APTAIPredictor, ForceAPTAIPredictor,
                                      W2V2PRPredictor)
from aptai_tpu_torch.models import APTAI, W2V2PR, ForceAPTAI, Wav2Vec2Config
from aptai_tpu_torch.train.checkpoints import (FLAX_PARAMS, PARAMS,
                                               load_json, read_params)

_UNPORTED = "ROADMAP Queue 1 item 8e-ii"


def _has_params(d: Path) -> bool:
    return (d / PARAMS).exists() or (d / FLAX_PARAMS).exists()


def resolve_checkpoint_dir(path) -> Path:
    """Accept an experiment dir, a ``best-model-ckpt``/``last-model-ckpt``
    dir, or a per-epoch ``model-ckpts/eNNNN`` dir; return the directory
    that holds ``params.pt`` or ``params.msgpack``."""
    p = Path(path)
    if _has_params(p):
        return p
    for sub in ("best-model-ckpt", "last-model-ckpt"):
        if _has_params(p / sub):
            return p / sub
    raise FileNotFoundError(
        f"no {PARAMS} or {FLAX_PARAMS} under {p} (looked in ., "
        "best-model-ckpt/, last-model-ckpt/)")


def _find_model_cfg(ckpt_dir: Path) -> Dict:
    """model_cfg.json lives next to the params for best/last checkpoints;
    per-epoch dirs (model-ckpts/eNNNN) fall back to the run's best/last."""
    for d in (ckpt_dir, ckpt_dir.parent.parent / "best-model-ckpt",
              ckpt_dir.parent.parent / "last-model-ckpt"):
        if (d / "model_cfg.json").exists():
            return load_json(d / "model_cfg.json")
    raise FileNotFoundError(f"no model_cfg.json for checkpoint {ckpt_dir}")


def backbone_from_dict(d: Dict) -> Wav2Vec2Config:
    """JSON round-trip: lists back to tuples (``dataclasses.asdict``
    serialised the tuple fields as lists)."""
    return Wav2Vec2Config(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in d.items()
    })


def _build_model(kind: str, backbone: Wav2Vec2Config,
                 cfg: Dict) -> nn.Module:
    """An untrained model of ``kind`` for ``backbone``, with the vocabulary
    size and FORCE's decode method and alignment knobs from ``cfg`` (a
    ``model_cfg.json`` dict)."""
    n_vocab = len(cfg["vocab"])
    if kind == "w2v2_pr":
        return W2V2PR(backbone)
    if kind == "aptai":
        return APTAI(backbone, num_phonemes=n_vocab)
    if kind == "force_aptai":
        return ForceAPTAI(
            backbone, vocab_size=n_vocab,
            decode_method=cfg.get("decode_method", "greedy"),
            blank_logprob=cfg.get("blank_logprob", -1.0),
            off_diag_prior=cfg.get("off_diag_prior", False),
            prior_g=cfg.get("prior_g", 0.2),
            energy_temperature=cfg.get("energy_temperature", 1.0),
            aux_frame_ce_weight=cfg.get("aux_frame_ce", 0.0),
            frame_hidden_layer=cfg.get("frame_hidden_layer", -1),
        )
    raise ValueError(f"unknown model kind {kind!r} in model_cfg.json")


def load_model(path, dtype: Optional[str] = None,
               quant: Optional[str] = None,
               ) -> Tuple[str, nn.Module, Dict[str, int]]:
    """``(kind, model, vocab)`` from a checkpoint directory: the model (on
    the CPU, in ``eval()`` mode) holds the checkpoint's weights.

    ``dtype`` overrides the compute dtype recorded at training time
    (parameters are stored in float32 either way). ``quant`` ("none",
    "w8a8_ffn" or "w8a8") overrides the backbone's dynamic W8A8 int8
    inference GEMMs (``ops/quant.py``): the parameters do not depend on
    it, so any checkpoint serves quantized."""
    ckpt_dir = resolve_checkpoint_dir(path)
    cfg = _find_model_cfg(ckpt_dir)
    backbone = backbone_from_dict(cfg["backbone"])
    if dtype is not None:
        backbone = dataclasses.replace(backbone, dtype=dtype)
    if quant is not None:
        backbone = dataclasses.replace(backbone, quant=quant)
    kind = cfg["kind"]
    model = _build_model(kind, backbone, cfg)
    model.load_state_dict(read_params(ckpt_dir), strict=True)
    return kind, model.eval(), cfg["vocab"]


def load_predictor(path, device=None, transfer_dtype: str = "float32",
                   dtype: Optional[str] = None, quant: Optional[str] = None,
                   mesh=None):
    """The predictor for a trainer checkpoint directory
    (``APTAIPredictor`` / ``ForceAPTAIPredictor`` / ``W2V2PRPredictor``)
    on ``device`` (``cuda`` unless named), with ``dtype`` and ``quant`` as
    in :func:`load_model`. ``mesh`` (several devices) is not implemented
    yet and raises."""
    if mesh is not None:
        raise NotImplementedError(f"mesh serving is not implemented in "
                                  f"aptai_tpu_torch yet ({_UNPORTED})")
    kind, model, vocab = load_model(path, dtype=dtype, quant=quant)
    if kind == "w2v2_pr":
        return W2V2PRPredictor(model, vocab, device=device,
                               transfer_dtype=transfer_dtype)
    if kind == "aptai":
        return APTAIPredictor(model, device=device,
                              transfer_dtype=transfer_dtype)
    return ForceAPTAIPredictor(model, device=device,
                               transfer_dtype=transfer_dtype)
