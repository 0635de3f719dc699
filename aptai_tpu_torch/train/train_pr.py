"""The CTC phoneme-recognizer trainer and its CLI (the JAX package's
``train/train_pr.py``), with W2V2PR's loss adapter and evaluation forward.

Stages: config → the CommonPhone manifest split by its ``split`` column →
vocabulary → model → ``fit`` (random batch subsets per epoch, PER
validation with ``--val_decode``, best/last checkpoints) → the best
checkpoint tested on CommonPhone's test split and on the HPRC N / F rate
sets, always with the host beam.

Usage:
  python -m aptai_tpu_torch.train.train_pr --cp_csv_path ... [--laptop] ...
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Callable, Dict

import torch
from torch import nn

from aptai_tpu_torch.data import (BucketedLoader, CommonPhoneDataset,
                                  HPRCDataset, PrefetchLoader, build_vocab,
                                  collate_ctc, save_vocab)
from aptai_tpu_torch.data.manifest import read_rows, select, write_rows
from aptai_tpu_torch.train.builders import build_pr_model
from aptai_tpu_torch.train.checkpoints import CheckpointManager, save_json
from aptai_tpu_torch.train.config import PRConfig, parse_config, run_device
from aptai_tpu_torch.train.evaluate import validate_pr
from aptai_tpu_torch.train.fe_cache import FECachedLoader
from aptai_tpu_torch.train.loop import fit
from aptai_tpu_torch.train.train_aptai import eval_call
from aptai_tpu_torch.utils.logging import init_logger

AUDIO_KEYS = ("audio", "audio_lengths", "phoneme_labels")
FEATURE_KEYS = ("fe_features", "audio_lengths", "phoneme_labels")
EVAL_FIELDS = ("loss", "log_probs", "frame_lengths")


def pr_loss_fn(from_features: bool = False) -> Callable:
    """The W2V2PR adapter: ``loss_fn(model, batch, generator) -> (loss,
    {})`` over ``audio`` (B, L), ``audio_lengths`` (B,) in samples and
    ``phoneme_labels`` (B, S) padded with −100. ``from_features``: the
    batch carries the frozen feature extractor's output ``fe_features``
    (B, T, conv_dim[-1]) in place of ``audio``
    (``W2V2PR.train_from_features``)."""

    def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: torch.Generator):
        fwd = model.train_from_features if from_features else model
        out = fwd(batch[keys[0]], batch["audio_lengths"],
                  batch["phoneme_labels"], generator=generator)
        return out["loss"], {}

    keys = FEATURE_KEYS if from_features else AUDIO_KEYS
    loss_fn.batch_keys = keys
    return loss_fn


def make_eval_forward(model: nn.Module) -> Callable:
    """``forward(batch) -> {loss, log_probs, frame_lengths}`` (device
    tensors): the model in ``eval()`` mode under ``torch.no_grad()`` on
    the batch's ``audio``, ``audio_lengths`` and ``phoneme_labels``, moved
    to the model's device; the module's train/eval state is restored
    afterwards."""

    def forward(batch) -> Dict[str, torch.Tensor]:
        out = eval_call(model, lambda dev: model(
            *(torch.as_tensor(batch[k]).to(dev) for k in AUDIO_KEYS)))
        return {k: out[k] for k in EVAL_FIELDS}

    return forward


def make_loaders(cfg, rows, vocab):
    """``(train, valid, test loaders, (train, valid, test rows))`` from a
    CommonPhone manifest's rows by their ``split`` column; the training
    loader shuffles (and crops under ``cfg.cropping``) and is prefetched."""
    if not rows or "split" not in rows[0]:
        raise NotImplementedError("manifest must carry a split column")
    parts = [select(rows, "split", s) for s in ("train", "val", "test")]
    train_ds = CommonPhoneDataset(parts[0], vocab, cropping=cfg.cropping,
                                  seed=cfg.seed)
    valid_ds = CommonPhoneDataset(parts[1], vocab)
    test_ds = CommonPhoneDataset(parts[2], vocab)
    mk = functools.partial(BucketedLoader, collate_fn=collate_ctc)
    eval_bs = cfg.eval_batch_size or cfg.batch_size
    return (
        PrefetchLoader(mk(train_ds, batch_size=cfg.batch_size, seed=cfg.seed)),
        mk(valid_ds, batch_size=eval_bs, shuffle=False),
        mk(test_ds, batch_size=eval_bs, shuffle=False),
        tuple(parts),
    )


def run(cfg: PRConfig, tiny_backbone=None):
    """Train and test one recognizer; returns ``(history, test results)``.
    ``tiny_backbone`` replaces the wav2vec2-large config (tests)."""
    device = run_device(cfg)
    exp_dir = Path(cfg.exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    save_json(exp_dir / "experiment_args.json", cfg)

    if not Path(cfg.cp_csv_path).exists():
        raise SystemExit(
            f"manifest not found: {cfg.cp_csv_path} (build it with "
            "aptai_tpu_torch.data.commonphone.commonphone_csv or "
            "aptai_tpu_torch.data.make_synthetic_commonphone)")
    rows = read_rows(cfg.cp_csv_path)
    vocab = build_vocab(r["phonemes"] for r in rows)
    save_vocab(vocab, exp_dir / "vocab.json")
    train_dl, valid_dl, test_dl, splits = make_loaders(cfg, rows, vocab)
    for name, part in zip(("train", "valid", "test"), splits):
        write_rows(exp_dir / f"{name}.csv", part, columns=list(rows[0]))

    model, model_cfg = build_pr_model(cfg, vocab, tiny=tiny_backbone)
    model.to(device)
    # FE cache precondition: frozen FE and fixed per-utterance audio
    use_fe_cache = (cfg.cache_frozen_fe and cfg.freeze_feature_extractor
                    and not cfg.cropping)
    if use_fe_cache:
        fe_dl = FECachedLoader(train_dl.loader, model, seed=cfg.seed)
        print(f"frozen-FE cache: {len(fe_dl.dataset)} utterances, "
              f"{fe_dl.cache_bytes / 1e6:.1f} MB host")
        train_dl = PrefetchLoader(fe_dl)
    eval_fwd = make_eval_forward(model)
    max_b = 1 if cfg.laptop else None

    def validate(epoch):
        return validate_pr(eval_fwd, valid_dl, max_batches=max_b,
                           decode=cfg.val_decode)

    ckpt = CheckpointManager(
        exp_dir, cfg.target_metric,
        bigger_is_better=cfg.target_metric_bigger_better,
        save_all_epochs=cfg.save_all_epochs,
    )
    logger = init_logger(cfg, "phoneme_recognizer")
    _, history = fit(cfg, pr_loss_fn(from_features=use_fe_cache), model,
                     train_dl, validate, ckpt, model_cfg=model_cfg,
                     samples_per_epoch=cfg.samples_per_epoch, logger=logger)

    # the best checkpoint on CP-test and HPRC N/F, beam-decoded (the
    # reference's reported-PER protocol)
    model.load_state_dict(ckpt.restore_best(map_location=device))
    results = {"mean_cp_test_per": validate_pr(eval_fwd, test_dl, max_b)[
        "mean_val_per"]}
    if cfg.hprc_csv_path and Path(cfg.hprc_csv_path).exists():
        hprc_rows = read_rows(cfg.hprc_csv_path)
        for rate in ("N", "F"):
            dl = BucketedLoader(
                HPRCDataset(hprc_rows, vocab, rate=rate),
                batch_size=cfg.eval_batch_size or cfg.batch_size,
                collate_fn=collate_ctc, shuffle=False,
            )
            results[f"mean_hprc{rate}_per"] = validate_pr(
                eval_fwd, dl, max_b)["mean_val_per"]
    save_json(exp_dir / "test_results.json", results)
    print("TEST RESULTS:", results)
    return history, results


def main(argv=None):
    cfg = parse_config(PRConfig, "phoneme_recognizer", argv)
    return run(cfg)


if __name__ == "__main__":
    main()
