"""W2V2PR's loss adapter and evaluation forward for :class:`TrainStep` and
``validate_pr`` (the JAX package's ``train/train_pr.py:61-101``).

The trainer's loop and CLI are not ported; its loaders are the data
layer's and ``train/fe_cache.py``'s.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from aptai_tpu_torch.train.train_aptai import eval_call

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
