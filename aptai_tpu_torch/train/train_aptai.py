"""APTAI's loss adapter and evaluation forward for :class:`TrainStep` and
the validation passes (the JAX package's ``train/train_aptai.py:41-80``).

The LOSO training loop and its CLI are not ported; its loaders are the
data layer's and ``train/fe_cache.py``'s.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

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
