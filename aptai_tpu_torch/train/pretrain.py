"""The self-supervised pretraining trainer and its CLI (the JAX package's
``train/pretrain.py``): wav2vec2's masked-contrastive objective
(``models/pretrain.py``) trains the whole encoder, feature extractor
included, on raw audio. Its runs are the pretrained towers the downstream
trainers start from: ``--pretrained_checkpoint <pretrain exp_dir>`` grafts
the ``wav2vec2.`` tensors, the mask embedding included, into ``train_pr``
and ``train_aptai`` (``train/builders.py``).

Stages: config → a manifest with a wav-path column (CommonPhone's ``path``
or HPRC's ``path_wav``; labels are not read), split by its ``split``
column where one says ``valid``, else its first ``val_fraction`` rows
validate → random crops (``--crop_seconds``) → batches with the epoch's
Gumbel temperature → ``fit`` (the 3-phase LR schedule, best/last
checkpoints on ``val_loss``, resume, preemption) with a deterministic
masked-objective validation.

Usage:
  python -m aptai_tpu_torch.train.pretrain \\
      --audio_csv_path data/CommonPhone/commonphone.csv \\
      --num_epochs 100 --batch_size 8 --learning_rate 3e-5 [--platform cpu]
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

from aptai_tpu_torch.data.audio_io import load_wav_16k
from aptai_tpu_torch.data.batching import (AUDIO_BUCKET, BucketedLoader,
                                           PrefetchLoader, _pad_to,
                                           _round_up)
from aptai_tpu_torch.data.manifest import read_rows, select
from aptai_tpu_torch.models.pretrain import (Wav2Vec2Pretrain,
                                             random_wav2vec2_pretrain)
from aptai_tpu_torch.models.wav2vec2 import compute_time_mask
from aptai_tpu_torch.train.builders import make_backbone_config
from aptai_tpu_torch.train.checkpoints import CheckpointManager, save_json
from aptai_tpu_torch.train.config import (TrainConfig, parse_config,
                                          run_device)
from aptai_tpu_torch.train.loop import fit, require_one_process
from aptai_tpu_torch.train.train_aptai import eval_call
from aptai_tpu_torch.utils.logging import init_logger

BATCH_KEYS = ("audio", "audio_lengths", "gumbel_temp")
AUX_KEYS = ("contrastive_loss", "diversity_loss", "codebook_perplexity",
            "contrastive_accuracy")
VAL_KEYS = ("loss",) + AUX_KEYS
# the validation forward's fixed draws (the JAX package's PRNGKey(123) for
# the span mask and PRNGKey(7) for the distractors; torch's streams differ)
EVAL_MASK_SEED = 123
EVAL_NEGATIVES_SEED = 7
EVAL_MASK = (0.5, 10, 2)  # prob, span, min_masks


@dataclasses.dataclass
class PretrainConfig(TrainConfig):
    """Pretraining flags (the objective's constants follow fairseq / HF)."""

    audio_csv_path: str = "data/CommonPhone/commonphone.csv"
    # random-crop ceiling in seconds (0 = whole utterances)
    crop_seconds: float = 0.0
    # span masking: about mask_prob·T/span spans of `span` frames
    mask_prob: float = 0.65
    mask_span: int = 10
    mask_min_masks: int = 2
    num_negatives: int = 100
    # product quantizer
    codevector_groups: int = 2
    codevector_vars: int = 320
    codevector_dim: int = 256
    proj_codevector_dim: int = 256
    contrastive_temperature: float = 0.1
    diversity_weight: float = 0.1
    feature_penalty_weight: float = 10.0
    # Gumbel temperature: start · decay^epoch, floored at min
    gumbel_temp_start: float = 2.0
    gumbel_temp_min: float = 0.5
    gumbel_temp_decay: float = 0.96
    val_fraction: float = 0.1
    target_metric: str = "val_loss"
    num_epochs: int = 100
    learning_rate: float = 3e-5
    batch_size: int = 8


class PretrainAudioDataset:
    """Raw audio of a manifest's rows: ``{"audio", "audio_len"}`` items,
    randomly cropped to ``crop_seconds`` (fresh offsets at every read, from
    the dataset's own generator seeded with ``seed``)."""

    def __init__(self, rows, crop_seconds: float = 0.0, seed: int = 0):
        # CommonPhone manifests name the wav column ``path``, HPRC
        # manifests ``path_wav``
        col = "path_wav" if rows and "path_wav" in rows[0] else "path"
        self.paths = [r[col] for r in rows]
        self.crop = int(crop_seconds * 16000)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        audio = load_wav_16k(self.paths[i]).astype(np.float32)
        if self.crop and len(audio) > self.crop:
            off = int(self._rng.integers(0, len(audio) - self.crop + 1))
            audio = audio[off:off + self.crop]
        return {"audio": audio, "audio_len": len(audio)}


def collate_audio(items, bucket: bool = True) -> Dict[str, np.ndarray]:
    """Zero-padded ``audio`` (B, L), L rounded up to whole seconds under
    ``bucket``, and int32 ``audio_lengths``."""
    w = max(x["audio_len"] for x in items)
    if bucket:
        w = _round_up(w, AUDIO_BUCKET)
    return {
        "audio": np.stack([_pad_to(x["audio"], w, 0.0) for x in items]),
        "audio_lengths": np.asarray([x["audio_len"] for x in items],
                                    np.int32),
    }


class GumbelTemperatureLoader:
    """The epoch's Gumbel temperature in every batch of ``loader``, as a
    (B,) float32 ``gumbel_temp``. ``fit`` iterates the training loader once
    an epoch, so a counter of passes tracks the epoch; a resumed run starts
    it again at the top of the schedule, as the JAX package does (the
    floor bounds the difference)."""

    def __init__(self, loader, start: float, minimum: float, decay: float):
        self.loader = loader
        self.start, self.minimum, self.decay = start, minimum, decay
        self._epoch = 0

    def __len__(self):
        return len(self.loader)

    @property
    def temperature(self) -> float:
        return max(self.minimum, self.start * self.decay ** self._epoch)

    def __iter__(self):
        temp = np.float32(self.temperature)
        self._epoch += 1
        for batch in self.loader:
            b = len(batch["audio_lengths"])
            batch = dict(batch)
            batch["gumbel_temp"] = np.full((b,), temp, np.float32)
            yield batch


def _frames(model: Wav2Vec2Pretrain, audio: torch.Tensor,
            lengths: torch.Tensor):
    """The padded batch's frame count and each item's frame length."""
    cfg = model.cfg
    return (int(cfg.feat_extract_output_lengths(audio.shape[1])),
            cfg.feat_extract_output_lengths(lengths.to(torch.int32)))


def pretrain_loss_fn(mask_prob: float = 0.65, mask_span: int = 10,
                     mask_min_masks: int = 2) -> Callable:
    """The ``TrainStep`` adapter: ``loss_fn(model, batch, generator) ->
    (loss, aux)`` over ``audio`` (B, L), ``audio_lengths`` (B,) in samples
    and ``gumbel_temp`` (B,), whose mean is the step's temperature. The
    span mask over the padded batch's frames, the Gumbel noise and the
    distractors draw from ``generator``; dropout from the default
    generator, which the step seeds."""

    def loss_fn(model: Wav2Vec2Pretrain, batch: Dict[str, torch.Tensor],
                generator: torch.Generator):
        audio, lengths = batch["audio"], batch["audio_lengths"]
        t, frame_lengths = _frames(model, audio, lengths)
        time_mask = compute_time_mask(generator, frame_lengths, t,
                                      mask_prob, mask_span, mask_min_masks)
        out = model(audio, lengths, time_mask,
                    batch["gumbel_temp"].float().mean(), generator=generator)
        return out["loss"], {k: out[k] for k in AUX_KEYS}

    loss_fn.batch_keys = BATCH_KEYS
    return loss_fn


def make_eval_forward(model: Wav2Vec2Pretrain) -> Callable:
    """``forward(audio, lengths) -> outputs`` (device tensors): the masked
    objective in ``eval()`` mode under ``torch.no_grad()`` (no dropout,
    argmax quantization, τ = 1), its span mask (prob 0.5, span 10, at
    least 2) and distractors from generators with fixed seeds, so each
    epoch is scored on the same draws."""

    def forward(audio, lengths) -> Dict[str, torch.Tensor]:
        def call(dev):
            a = torch.as_tensor(audio).to(dev)
            n = torch.as_tensor(lengths).to(dev)
            t, frame_lengths = _frames(model, a, n)
            time_mask = compute_time_mask(
                torch.Generator(dev).manual_seed(EVAL_MASK_SEED),
                frame_lengths, t, *EVAL_MASK)
            return model(a, n, time_mask, 1.0,
                         generator=torch.Generator(dev).manual_seed(
                             EVAL_NEGATIVES_SEED))

        return eval_call(model, call)

    return forward


def build_pretrain_model(cfg: PretrainConfig, tiny=None, seed=None):
    """``(model, model_cfg)``: the wav2vec2-large backbone (``tiny``
    replaces it) with SpecAugment's mask embedding, random weights from the
    seed, and the ``model_cfg.json`` dict (``kind: "w2v2_pretrain"``)."""
    backbone = tiny if tiny is not None else make_backbone_config(cfg, 1)
    backbone = dataclasses.replace(backbone, apply_spec_augment=True)
    model = random_wav2vec2_pretrain(
        backbone, seed=cfg.seed if seed is None else seed,
        num_groups=cfg.codevector_groups,
        num_vars=cfg.codevector_vars,
        codevector_dim=cfg.codevector_dim,
        proj_codevector_dim=cfg.proj_codevector_dim,
        num_negatives=cfg.num_negatives,
        contrastive_temperature=cfg.contrastive_temperature,
        diversity_weight=cfg.diversity_weight,
        feature_penalty_weight=cfg.feature_penalty_weight,
    )
    model_cfg = {"backbone": dataclasses.asdict(backbone),
                 "kind": "w2v2_pretrain",
                 "quantizer": {"groups": cfg.codevector_groups,
                               "vars": cfg.codevector_vars,
                               "codevector_dim": cfg.codevector_dim,
                               "proj_codevector_dim":
                                   cfg.proj_codevector_dim}}
    return model, model_cfg


def split_rows(rows, val_fraction: float):
    """``(train, valid)`` rows: by the ``split`` column where a row says
    ``valid``, else the first ``val_fraction`` of the rows (at least one)
    validate and the rest train."""
    if rows and "split" in rows[0] and select(rows, "split", "valid"):
        return select(rows, "split", "train"), select(rows, "split", "valid")
    n_val = max(int(len(rows) * val_fraction), 1)
    return rows[n_val:], rows[:n_val]


def run(cfg: PretrainConfig, tiny_backbone=None):
    """Pretrain one encoder; returns ``(history, model)``.
    ``tiny_backbone`` replaces the wav2vec2-large config (tests)."""
    require_one_process("pretraining")
    device = run_device(cfg)
    exp_dir = Path(cfg.exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    save_json(exp_dir / "experiment_args.json", cfg)

    if not Path(cfg.audio_csv_path).exists():
        raise SystemExit(
            f"manifest not found: {cfg.audio_csv_path} (any CSV with a "
            "wav-path column works: CommonPhone (path) or HPRC (path_wav))")
    train_rows, val_rows = split_rows(read_rows(cfg.audio_csv_path),
                                      cfg.val_fraction)
    print(f"pretrain corpus: {len(train_rows)} train / {len(val_rows)} val "
          "utterances")

    train_dl = GumbelTemperatureLoader(
        PrefetchLoader(BucketedLoader(
            PretrainAudioDataset(train_rows, cfg.crop_seconds, cfg.seed),
            batch_size=cfg.batch_size, collate_fn=collate_audio,
            shuffle=True, seed=cfg.seed)),
        cfg.gumbel_temp_start, cfg.gumbel_temp_min, cfg.gumbel_temp_decay)
    val_dl = BucketedLoader(
        PretrainAudioDataset(val_rows, 0.0),
        batch_size=cfg.eval_batch_size or cfg.batch_size,
        collate_fn=collate_audio, shuffle=False)

    model, model_cfg = build_pretrain_model(cfg, tiny=tiny_backbone)
    model.to(device)
    eval_fwd = make_eval_forward(model)

    def validate(epoch):
        sums, n = torch.zeros(len(VAL_KEYS), dtype=torch.float64), 0
        for bi, batch in enumerate(val_dl):
            if cfg.laptop and bi >= 1:
                break
            out = eval_fwd(batch["audio"], batch["audio_lengths"])
            # one fetch a batch
            sums += torch.stack([out[k].float() for k in VAL_KEYS]).cpu()
            n += 1
        return {f"val_{k}": float(v) / max(n, 1)
                for k, v in zip(VAL_KEYS, sums)}

    ckpt = CheckpointManager(
        exp_dir, cfg.target_metric,
        bigger_is_better=cfg.target_metric_bigger_better,
        save_all_epochs=cfg.save_all_epochs,
    )
    logger = init_logger(cfg, "pretrain")
    _, history = fit(
        cfg, pretrain_loss_fn(cfg.mask_prob, cfg.mask_span,
                              cfg.mask_min_masks),
        model, train_dl, validate, ckpt, model_cfg=model_cfg, logger=logger)
    print("PRETRAIN DONE:", {k: round(v, 4) for k, v in history[-1].items()
                             if isinstance(v, float)})
    return history, model


def main(argv=None):
    cfg = parse_config(PretrainConfig, "pretrain", argv)
    return run(cfg)


if __name__ == "__main__":
    main()
