"""Model construction for the trainers (the JAX package's
``train/builders.py``): the backbone config, random weights from a seed,
pretrained encoder weights, and FORCE-APTAI's frozen tower from a W2V2PR
checkpoint.

Each builder returns ``(model, model_cfg)``: the model on the CPU, and the
dict saved as ``model_cfg.json`` beside its checkpoints (the JAX package's
keys), which :mod:`aptai_tpu_torch.infer.loader` rebuilds it from.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from aptai_tpu_torch.models import (APTAI, W2V2PR, ForceAPTAI,
                                    Wav2Vec2Config, random_aptai,
                                    random_force_aptai, random_w2v2_pr)
from aptai_tpu_torch.models.convert import (encoder_state_dict_from_jax,
                                            fuse_qkv_state_dict)
from aptai_tpu_torch.train.checkpoints import (FLAX_PARAMS, PARAMS,
                                               load_flax_params, load_json,
                                               load_state, read_params)
from aptai_tpu_torch.train.config import run_device

ENCODER = "wav2vec2."
# the reference's W2V2PR checkpoint file (HF names: wav2vec2. + pr_head)
REFERENCE_PR_FILE = "pytorch_model.bin"
_POS_CONV = "encoder.pos_conv_embed.conv."


def resolve_dtype(dtype: str, device) -> str:
    """``"auto"`` → bfloat16 on the card, float32 on the CPU; any other
    value is kept. The compute dtype only: parameters and Adam state stay
    float32."""
    if dtype and dtype != "auto":
        return dtype
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def make_backbone_config(cfg_train, vocab_size: int) -> Wav2Vec2Config:
    """The wav2vec2-large config with the trainer's overrides (reference
    train/train_phoneme_recognizer.py:336-347), its dtype resolved for the
    run's device."""
    cfg = Wav2Vec2Config(
        vocab_size=vocab_size,
        final_dropout=cfg_train.final_dropout,
        num_hidden_layers=cfg_train.num_hidden_layers,
        dtype=resolve_dtype(getattr(cfg_train, "dtype", "float32"),
                            run_device(cfg_train)),
        remat_policy=getattr(cfg_train, "remat_policy", "none"),
    )
    if getattr(cfg_train, "ten_ms", False):
        cfg = cfg.with_ten_ms()
    return cfg


def _hf_encoder_names(sd: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """An HF ``Wav2Vec2Model`` state dict (bare or under ``wav2vec2.``) with
    the bare names this package's encoder uses: the positional conv's
    ``parametrizations.weight.original0/1`` (torch ≥ 2.1) become
    ``weight_g`` / ``weight_v``."""
    if any(k.startswith(ENCODER) for k in sd):
        sd = {k[len(ENCODER):]: v for k, v in sd.items()
              if k.startswith(ENCODER)}
    renames = {f"{_POS_CONV}parametrizations.weight.original0":
               f"{_POS_CONV}weight_g",
               f"{_POS_CONV}parametrizations.weight.original1":
               f"{_POS_CONV}weight_v"}
    return {renames.get(k, k): v for k, v in sd.items()}


def _load_hf_encoder(encoder: nn.Module,
                     sd: Dict[str, torch.Tensor]) -> None:
    """Load an HF checkpoint's encoder into ``encoder`` (this package's
    ``Wav2Vec2Model``): every tensor the encoder has must be there; layers
    past its depth and ``masked_spec_embed`` when it has none are left out
    (the reference truncates the stack with ``--num_hidden_layers``). A
    ``fused_qkv`` encoder takes q, k and v concatenated."""
    own = encoder.state_dict()
    layer = re.compile(r"encoder\.layers\.(\d+)\.")
    depth = encoder.cfg.num_hidden_layers
    sd = _hf_encoder_names(sd)
    if encoder.cfg.fused_qkv:
        sd = fuse_qkv_state_dict(sd)
    keep = {}
    for k, v in sd.items():
        m = layer.match(k)
        if (m and int(m.group(1)) >= depth) or k not in own:
            continue
        keep[k] = v
    encoder.load_state_dict(keep, strict=True)


def _graft_pretrained_encoder(encoder: nn.Module, path: str) -> None:
    """Copy the encoder tensors of a checkpoint saved by a trainer of this
    package or of the JAX package (a directory, ``params.msgpack`` or an
    older run's ``params.pt``) into ``encoder`` name by name: the tensors both
    have transfer, the rest keep their fresh init, and the counts are
    printed."""
    from aptai_tpu_torch.infer.loader import resolve_checkpoint_dir

    file = Path(path)
    if file.is_dir():
        ckpt_dir = resolve_checkpoint_dir(file)
        file = ckpt_dir / (PARAMS if (ckpt_dir / PARAMS).exists()
                           else FLAX_PARAMS)
    if file.name == FLAX_PARAMS:
        raw = load_flax_params(file)
        src = encoder_state_dict_from_jax(raw.get("encoder", raw))
    else:
        src = load_state(file)
        src = {k.split(ENCODER, 1)[1]: v for k, v in src.items()
               if ENCODER in k} or src
    dst = encoder.state_dict()
    hit = miss = 0
    for k, v in src.items():
        if k in dst:
            if dst[k].shape != v.shape:
                raise ValueError(
                    f"pretrained encoder tensor {k} has shape "
                    f"{tuple(v.shape)}, target expects "
                    f"{tuple(dst[k].shape)} — backbone configs differ")
            dst[k] = v
            hit += 1
        else:
            miss += 1
    print(f"pretrained encoder graft from {file}: {hit} leaves spliced"
          + (f", {miss} source-only leaves skipped" if miss else ""))
    if hit == 0:
        raise ValueError(f"no overlapping encoder leaves found in {file}")
    encoder.load_state_dict(dst, strict=True)


def _maybe_load_pretrained(encoder: nn.Module,
                           checkpoint: Optional[str]) -> None:
    """Pretrained encoder weights into ``encoder``: a torch ``.bin`` /
    ``.pt`` / ``.pth`` state dict with HF names, or a trainer checkpoint
    (either package's) grafted name by name."""
    if not checkpoint:
        return
    if checkpoint.endswith((".bin", ".pt", ".pth")):
        _load_hf_encoder(encoder, torch.load(checkpoint, map_location="cpu",
                                            weights_only=True))
    else:
        _graft_pretrained_encoder(encoder, checkpoint)


def _seed(cfg_train, seed: Optional[int]) -> int:
    return cfg_train.seed if seed is None else seed


def build_pr_model(cfg_train, vocab: Dict[str, int], tiny=None,
                   seed=None) -> Tuple[W2V2PR, Dict]:
    backbone = tiny if tiny is not None else make_backbone_config(
        cfg_train, len(vocab))
    if tiny is not None:
        backbone = dataclasses.replace(backbone, vocab_size=len(vocab))
    model = random_w2v2_pr(
        backbone, seed=_seed(cfg_train, seed),
        freeze_feature_encoder=cfg_train.freeze_feature_extractor)
    _maybe_load_pretrained(model.wav2vec2, cfg_train.pretrained_checkpoint)
    model_cfg = {"backbone": dataclasses.asdict(backbone), "vocab": vocab,
                 "kind": "w2v2_pr"}
    return model, model_cfg


def build_aptai_model(cfg_train, vocab: Dict[str, int], tiny=None,
                      seed=None) -> Tuple[APTAI, Dict]:
    backbone = tiny if tiny is not None else make_backbone_config(
        cfg_train, len(vocab))
    model = random_aptai(
        backbone, seed=_seed(cfg_train, seed), num_phonemes=len(vocab),
        tv_drop=getattr(cfg_train, "tv_drop", 0.1),
        phn_drop=getattr(cfg_train, "phn_drop", 0.1))
    _maybe_load_pretrained(model.wav2vec2, cfg_train.pretrained_checkpoint)
    model_cfg = {"backbone": dataclasses.asdict(backbone), "vocab": vocab,
                 "kind": "aptai"}
    return model, model_cfg


def _load_pr_tower(model: ForceAPTAI, pr_model_path) -> bool:
    """The W2V2PR in ``<pr_model_path>/best-model-ckpt`` into ``model``'s
    tower: ``params.msgpack`` of either package (through the bridge), an
    older run of this package's ``params.pt`` or the reference's
    ``pytorch_model.bin`` (HF names: ``wav2vec2.`` and ``pr_head``); False
    when there is none."""
    best = Path(pr_model_path) / "best-model-ckpt"
    if (best / PARAMS).exists() or (best / FLAX_PARAMS).exists():
        model.w2v2_pr.load_state_dict(read_params(best), strict=True)
        return True
    if not (best / REFERENCE_PR_FILE).exists():
        return False
    sd = torch.load(best / REFERENCE_PR_FILE, map_location="cpu",
                    weights_only=True)
    _load_hf_encoder(model.w2v2_pr.wav2vec2, sd)
    model.w2v2_pr.pr_head.load_state_dict(
        {k[len("pr_head."):]: v for k, v in sd.items()
         if k.startswith("pr_head.")}, strict=True)
    return True


def build_force_model(cfg_train, vocab: Dict[str, int],
                      pr_model_path: Optional[str], tiny=None,
                      seed=None) -> Tuple[ForceAPTAI, Dict]:
    """FORCE-APTAI over a frozen W2V2PR (reference
    models/force_aptai.py:60-78): the tower's weights come from
    ``<pr_model_path>/best-model-ckpt`` (``pr_spliced`` in ``model_cfg``),
    its backbone from that checkpoint's ``model_cfg.json`` with the dtype
    resolved for this run's device; the head is random from the seed."""
    from aptai_tpu_torch.infer.loader import backbone_from_dict

    if tiny is not None:
        backbone = tiny
    else:
        pr_cfg = load_json(Path(pr_model_path) / "best-model-ckpt"
                           / "model_cfg.json")
        backbone = dataclasses.replace(
            backbone_from_dict(pr_cfg["backbone"]),
            dtype=resolve_dtype(getattr(cfg_train, "dtype", "auto"),
                                run_device(cfg_train)))
    knobs = {"decode_method": getattr(cfg_train, "decode_method", "greedy"),
             "blank_logprob": getattr(cfg_train, "blank_logprob", -1.0),
             "off_diag_prior": getattr(cfg_train, "off_diag_prior", False),
             "prior_g": getattr(cfg_train, "prior_g", 0.2),
             "energy_temperature": getattr(cfg_train, "energy_temperature",
                                           1.0),
             "aux_frame_ce": getattr(cfg_train, "aux_frame_ce", 0.0),
             "frame_hidden_layer": getattr(cfg_train, "frame_hidden_layer",
                                           -1)}
    model = random_force_aptai(
        backbone, seed=_seed(cfg_train, seed), vocab_size=len(vocab),
        decode_method=knobs["decode_method"],
        blank_logprob=knobs["blank_logprob"],
        off_diag_prior=knobs["off_diag_prior"], prior_g=knobs["prior_g"],
        energy_temperature=knobs["energy_temperature"],
        aux_frame_ce_weight=knobs["aux_frame_ce"],
        frame_hidden_layer=knobs["frame_hidden_layer"])
    spliced = (pr_model_path is not None
               and _load_pr_tower(model, pr_model_path))
    # pr_spliced: the frozen tower is the checkpoint's, the same in every
    # LOSO fold (a fold re-draws only the head), so folds can share one
    # frozen-encoding cache
    model_cfg = {"backbone": dataclasses.asdict(backbone), "vocab": vocab,
                 "kind": "force_aptai", "pr_model_path": str(pr_model_path),
                 "pr_spliced": spliced, **knobs}
    return model, model_cfg
