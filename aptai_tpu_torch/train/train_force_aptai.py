"""FORCE-APTAI's loss adapter, batch adapter, evaluation forwards and the
decoded-sequence PER (the JAX package's ``train/train_force_aptai.py``).

The tower is frozen inside the model (``ForceAPTAI``): ``torch_adam``
gives it no state and no gradient reaches it, the counterpart of the JAX
trainer's ``optax.masked``. The LOSO loop (``run_speaker``, ``run``,
``main``, ``_TowerMergingCkpt``) waits for the trainers (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from aptai_tpu_torch.decode.native import edit_distance
from aptai_tpu_torch.infer.api import fetch_outputs
from aptai_tpu_torch.train.frozen_cache import encode_batch
from aptai_tpu_torch.train.train_aptai import eval_call

AUDIO_KEYS = ("audio", "audio_lengths", "tv_targets")
ENCODED_KEYS = ("frame_embs", "enc_frame_lengths", "phn_pred_seq",
                "phn_seq_lengths", "phn_seq_truncated", "tv_targets")
EVAL_KEYS = ("loss", "tvs_pred", "pred_frame_phns", "pred_ctc_phn_seq",
             "phn_seq_lengths", "phn_seq_truncated")


def force_loss_fn(from_encoded: bool = False) -> Callable:
    """The FORCE adapter: ``loss_fn(model, batch, generator) -> (loss,
    {"tv_loss", "align_loss"})``.

    * audio layout (default): ``audio`` (B, L), ``audio_lengths`` (B,) in
      samples and ``tv_targets`` (B, T, 9): the tower, the greedy decode
      and the head in one forward;
    * ``from_encoded``: the tower's outputs and decoded sequences
      (:func:`~aptai_tpu_torch.train.frozen_cache.collate_encoded` or
      :class:`BeamDecodedBatches`): the head alone. The aux frame CE reads
      ``tower_frame_labels`` when the batch has it (``optional_keys``).

    A ``beam_host`` model trains from the encoded layout; its audio
    forward refuses to run."""

    def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: torch.Generator):
        if from_encoded:
            out = model.train_from_encoded(
                *(batch[k] for k in ENCODED_KEYS), generator=generator,
                tower_frame_labels=batch.get("tower_frame_labels"))
        else:
            out = model(*(batch[k] for k in AUDIO_KEYS), generator=generator)
        return out["loss"], {"tv_loss": out["tv_loss"],
                             "align_loss": out["align_loss"]}

    loss_fn.batch_keys = ENCODED_KEYS if from_encoded else AUDIO_KEYS
    loss_fn.optional_keys = ("tower_frame_labels",) if from_encoded else ()
    return loss_fn


class BeamDecodedBatches:
    """Batches of the encoded layout from audio batches, for a
    ``beam_host`` model without the cache: per batch the tower on the
    model's device, the beam search on the calling thread
    (``ForceAPTAI.decode``, real rows only), and the batch with ``audio``
    replaced by ``frame_embs``, ``enc_frame_lengths``, the decoded
    sequences and ``tower_frame_labels`` (device tensors)."""

    def __init__(self, batches: Iterable[Dict], model):
        self.batches = batches
        self.model = model

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for batch in self.batches:
            mask = batch.get("batch_pad_mask")
            n = None if mask is None else int(np.asarray(mask).sum())
            enc = encode_batch(self.model, batch["audio"],
                               batch["audio_lengths"], n_real=n)
            out = {k: v for k, v in batch.items() if k != "audio"}
            out["enc_frame_lengths"] = enc.pop("frame_lengths")
            out.update(enc)
            yield out


def make_encoded_eval_forward(model: nn.Module) -> Callable:
    """``forward(batch) -> {EVAL_KEYS}`` over batches of the encoded layout
    (the head alone), in ``eval()`` under ``torch.no_grad()``."""

    def forward(batch) -> Dict[str, torch.Tensor]:
        out = eval_call(model, lambda dev: model.train_from_encoded(
            *(torch.as_tensor(batch[k]).to(dev) for k in ENCODED_KEYS)))
        return {k: out[k] for k in EVAL_KEYS}

    return forward


def make_eval_forward(model: nn.Module) -> Callable:
    """``forward(batch) -> {EVAL_KEYS}`` (device tensors) over audio
    batches (``audio``, ``audio_lengths``, ``tv_targets``), in ``eval()``
    under ``torch.no_grad()``: the whole forward for greedy; for
    ``beam_host`` the split path (tower, host beam, head)."""
    if model.decode_method != "beam_host":
        def forward(batch) -> Dict[str, torch.Tensor]:
            out = eval_call(model, lambda dev: model(
                *(torch.as_tensor(batch[k]).to(dev) for k in AUDIO_KEYS)))
            return {k: out[k] for k in EVAL_KEYS}

        return forward

    def split(dev, batch):
        enc = encode_batch(model, batch["audio"], batch["audio_lengths"])
        return model.train_from_encoded(
            enc["frame_embs"], enc["frame_lengths"], enc["phn_pred_seq"],
            enc["phn_seq_lengths"], enc["phn_seq_truncated"],
            torch.as_tensor(batch["tv_targets"]).to(dev))

    def forward(batch) -> Dict[str, torch.Tensor]:
        out = eval_call(model, lambda dev: split(dev, batch))
        return {k: out[k] for k in EVAL_KEYS}

    return forward


def ctc_seq_per(forward_fn: Callable, batches: Iterable[Dict],
                max_batches: Optional[int] = None,
                log_fn: Optional[Callable] = None) -> float:
    """PER of the decoded phoneme sequence (``pred_ctc_phn_seq``) against
    the batch's ``phoneme_labels`` (padded −100), Σedit / Σlen over the
    real rows; ``log_fn`` hears how many items lost phonemes to the
    60-token cap."""
    edits = lengths = truncated = 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        out = fetch_outputs(forward_fn(batch))
        seqs, lens = out["pred_ctc_phn_seq"], out["phn_seq_lengths"]
        trunc = out.get("phn_seq_truncated", np.zeros(len(seqs), np.int32))
        mask = batch.get("batch_pad_mask", np.ones(len(seqs), bool))
        for b in range(len(seqs)):
            if not mask[b]:
                continue
            labels = np.asarray(batch["phoneme_labels"][b])
            gt = labels[labels >= 0].tolist()
            edits += edit_distance(gt, seqs[b, :int(lens[b])].tolist())
            lengths += len(gt)
            truncated += int(trunc[b] > 0)
    if truncated and log_fn is not None:
        log_fn(f"WARNING: {truncated} utterances lost phonemes to the "
               "60-token decode cap (reference force_aptai.py:111 asserts)")
    return edits / max(lengths, 1)
