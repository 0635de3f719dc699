"""The APTAI trainer and its CLI: the leave-one-speaker-out loop (the JAX
package's ``train/train_aptai.py``), with APTAI's loss adapter and
evaluation forward.

Per held-out speaker: a text-disjoint train/validation split of the other
speakers at ``--train_val_rate``, fresh weights (``seed + fold``), ``fit``
with the 10-metric validation and the best checkpoint by
``val_mean_rmse``, then the N- and F-rate test dicts → per-speaker CSVs and
the LOSO mean and std. Validation and test run at the training batch size
through the bucketed loader (the reference evaluates at batch 1). Over
several processes (``--coordinator_address``) every process trains its
rows of each batch and evaluates, and the primary writes the files.

Usage:
  python -m aptai_tpu_torch.train.train_aptai --hprc_csv_path ... [--laptop]
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict

import torch
from torch import nn

from aptai_tpu_torch.data import (BucketedLoader, HPRCDataset, PrefetchLoader,
                                  build_vocab, collate_tv, load_vocab)
from aptai_tpu_torch.data.hprc import loso_split
from aptai_tpu_torch.data.manifest import read_rows, unique
from aptai_tpu_torch.parallel.mesh import load_full_state_dict
from aptai_tpu_torch.parallel.multihost import is_primary
from aptai_tpu_torch.train.builders import build_aptai_model
from aptai_tpu_torch.train.checkpoints import CheckpointManager, save_json
from aptai_tpu_torch.train.config import APTAIConfig, parse_config, run_device
from aptai_tpu_torch.train.evaluate import test_tv, validate_tv
from aptai_tpu_torch.train.fe_cache import FECachedLoader
from aptai_tpu_torch.train.loop import fit
from aptai_tpu_torch.train.metrics import aggregate_mean_std, dict_to_csv
from aptai_tpu_torch.utils.logging import RunLogger

AUDIO_KEYS = ("audio", "audio_lengths", "phn_frames", "tv_targets")
FEATURE_KEYS = ("fe_features", "audio_lengths", "phn_frames", "tv_targets")
EVAL_FIELDS = ("loss", "tvs_pred", "phn_fc_pred")


def aptai_loss_fn(from_features: bool = False) -> Callable:
    """The APTAI adapter: ``loss_fn(model, batch, generator) -> (loss,
    {"mse_loss", "ce_loss"})`` over ``audio`` (B, L), ``audio_lengths``
    (B,) in samples, ``phn_frames`` (B, T) and ``tv_targets`` (B, T, 9).
    ``from_features``: the batch carries the frozen feature extractor's
    output ``fe_features`` (B, T, conv_dim[-1]) in place of ``audio``
    (``APTAI.train_from_features``)."""

    def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: torch.Generator):
        fwd = model.train_from_features if from_features else model
        out = fwd(batch[keys[0]], batch["audio_lengths"],
                  batch["phn_frames"], batch["tv_targets"],
                  generator=generator)
        return out["loss"], {"mse_loss": out["mse_loss"],
                             "ce_loss": out["ce_loss"]}

    keys = FEATURE_KEYS if from_features else AUDIO_KEYS
    loss_fn.batch_keys = keys
    return loss_fn


def make_eval_forward(model: nn.Module) -> Callable:
    """``forward(batch) -> {loss, tvs_pred, phn_fc_pred}`` (device
    tensors): the model in ``eval()`` mode under ``torch.no_grad()`` on
    the batch's ``audio``, ``audio_lengths``, ``phn_frames`` and
    ``tv_targets``, moved to the model's device; the module's train/eval
    state is restored afterwards."""

    def forward(batch) -> Dict[str, torch.Tensor]:
        out = eval_call(model, lambda dev: model(
            *(torch.as_tensor(batch[k]).to(dev) for k in AUDIO_KEYS)))
        return {k: out[k] for k in EVAL_FIELDS}

    return forward


def eval_call(model: nn.Module, fn: Callable):
    """``fn(device)`` with ``model`` in ``eval()`` mode under
    ``torch.no_grad()``, ``device`` being the model's; the module's
    train/eval state is restored afterwards."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return fn(next(model.parameters()).device)
    finally:
        model.train(was_training)


def _loader(rows, vocab, batch_size, shuffle, seed=0):
    return BucketedLoader(HPRCDataset(rows, vocab, rate="both"),
                          batch_size=batch_size, collate_fn=collate_tv,
                          shuffle=shuffle, seed=seed)


def read_hprc(cfg):
    """``(rows, vocab)`` of the run's HPRC manifest: the vocabulary from
    ``cfg.vocab_path`` when that is a file, else from the manifest."""
    if not Path(cfg.hprc_csv_path).exists():
        raise SystemExit(
            f"manifest not found: {cfg.hprc_csv_path} (build it with "
            "aptai_tpu_torch.data.make_synthetic_hprc or the HPRC prep)")
    rows = read_rows(cfg.hprc_csv_path)
    # is_file(), not exists(): an empty --vocab_path resolves to "." (a
    # directory) and falls through to the manifest's vocabulary
    if cfg.vocab_path and Path(cfg.vocab_path).is_file():
        return rows, load_vocab(cfg.vocab_path)
    return rows, build_vocab(r["phoneme_labels"] for r in rows)


def fold_peak_memory(device: torch.device, test_spk) -> None:
    """Print the card's peak memory since the fold began."""
    if device.type == "cuda":
        print(f"fold {test_spk}: peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")


def run_speaker(cfg, rows, vocab, test_spk, model, model_cfg):
    """One LOSO fold of ``model`` (on the run's device); returns the test
    metric dict for ``test_spk``."""
    exp_dir = Path(cfg.exp_dir)
    train, valid, test_n, test_f = loso_split(rows, test_spk,
                                              cfg.train_val_rate,
                                              seed=cfg.seed)
    eval_bs = cfg.eval_batch_size or cfg.batch_size
    if cfg.cache_frozen_fe:
        # the FE is frozen and this fold's FE weights are fixed: run it
        # once over the training rows
        fe_dl = FECachedLoader(_loader(train, vocab, cfg.batch_size, False),
                               model, seed=cfg.seed)
        print(f"frozen-FE cache: {len(fe_dl.dataset)} utterances, "
              f"{fe_dl.cache_bytes / 1e6:.1f} MB host")
        train_dl = PrefetchLoader(fe_dl)
    else:
        train_dl = PrefetchLoader(
            _loader(train, vocab, cfg.batch_size, True, cfg.seed))
    valid_dl = _loader(valid, vocab, eval_bs, False)
    eval_fwd = make_eval_forward(model)
    max_b = 5 if cfg.laptop else None

    def validate(epoch):
        return validate_tv(eval_fwd, valid_dl, max_batches=max_b)

    ckpt = CheckpointManager(
        exp_dir / f"best-model-ckpt-{test_spk}", cfg.target_metric,
        bigger_is_better=cfg.target_metric_bigger_better,
    )
    logger = (RunLogger(exp_dir, "APTAI", run_name=f"{cfg.prefix}_{test_spk}",
                        use_wandb=cfg.logging) if is_primary() else None)
    fit(cfg, aptai_loss_fn(from_features=cfg.cache_frozen_fe), model,
        train_dl, validate, ckpt, model_cfg=model_cfg, logger=logger)

    load_full_state_dict(model, ckpt.restore_best(
        map_location=run_device(cfg)))
    tmax = 1 if cfg.laptop else None
    results = {}
    for rate, part in (("N", test_n), ("F", test_f)):
        results.update(test_tv(eval_fwd, _loader(part, vocab, eval_bs,
                                                 False), rate,
                               max_batches=tmax))
    if is_primary():
        metrics_dir = exp_dir / "test_metrics"
        metrics_dir.mkdir(parents=True, exist_ok=True)
        dict_to_csv(results, metrics_dir / f"{test_spk}.csv")
    return results


def run(cfg, tiny_backbone=None, speakers=None):
    """The LOSO run over ``speakers`` (every speaker of the manifest by
    default); returns ``(mean, std, per-speaker results)``. Each fold
    builds fresh weights and frees the previous fold's model and optimizer
    first."""
    device = run_device(cfg)
    exp_dir = Path(cfg.exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    if is_primary():
        save_json(exp_dir / "experiment_args.json", cfg)
    rows, vocab = read_hprc(cfg)
    speakers = speakers or unique(rows, "speaker")

    per_speaker = []
    for fold, test_spk in enumerate(speakers):
        print(f"=== LOSO fold: held-out speaker {test_spk} ===")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        model, model_cfg = build_aptai_model(cfg, vocab, tiny=tiny_backbone,
                                             seed=cfg.seed + fold)
        per_speaker.append(run_speaker(cfg, rows, vocab, test_spk,
                                       model.to(device), model_cfg))
        fold_peak_memory(device, test_spk)
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()

    mean, std = aggregate_mean_std(per_speaker)
    if is_primary():
        dict_to_csv(mean, exp_dir / "loso_mean.csv")
        dict_to_csv(std, exp_dir / "loso_std.csv")
    print("LOSO mean:", {k: round(v, 4) for k, v in mean.items()
                         if k.endswith(("mean_rmse", "mean_pcc", "mean_FER"))})
    return mean, std, per_speaker


def main(argv=None):
    return run(parse_config(APTAIConfig, "APTAI", argv))


if __name__ == "__main__":
    main()
