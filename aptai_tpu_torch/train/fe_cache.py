"""The frozen feature-extractor cache of APTAI and W2V2PR training (the
JAX package's ``train/fe_cache.py``).

With the conv feature extractor frozen, its output depends on the audio
alone, and everything trainable or random (the projection, SpecAugment,
dropout) acts after it. :class:`FECachedLoader` runs the extractor once
per utterance at construction and then serves shuffled, frame-bucketed
batches carrying ``fe_features`` in place of ``audio``, the inputs of
``train_from_features`` (``aptai_loss_fn(from_features=True)``,
``pr_loss_fn(from_features=True)``). At equal pad widths a step from the
cache is the step from audio.

The cache holds only while the extractor is frozen and each utterance's
audio is fixed (not under random cropping). Over a mesh each process of
the data axis runs the extractor over its rows of every batch, and the
features are all-gathered (``frozen_cache.sharded_encode``), so every
process holds the whole cache for 1/N of the pass.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from aptai_tpu_torch import (CTC_LABEL_PAD_ID, PHONEME_FRAME_PAD_ID,
                             TV_PAD_VALUE)
from aptai_tpu_torch.data.batching import (FRAME_BUCKET, LABEL_BUCKET,
                                           BucketedLoader, _pad_to,
                                           _round_up)
from aptai_tpu_torch.infer.api import fetch_outputs
from aptai_tpu_torch.models.wav2vec2 import compute_dtype
from aptai_tpu_torch.train.frozen_cache import _CachedItems, sharded_encode


def _cache_items(loader, model, mesh=None) -> List[Dict]:
    """One pass over ``loader``: the feature extractor of ``model`` (an
    APTAI or W2V2PR) over each batch on the model's device (this process's
    rows of it over ``mesh``, gathered back), then per real row the
    features trimmed to its frames and the label fields a step needs."""
    encoder = model.wav2vec2
    cfg = encoder.cfg
    dev = next(model.parameters()).device

    @torch.no_grad()
    def encode(audio, lengths, n_real):
        del lengths, n_real  # every row, the whole padded width
        return {"fe": encoder.feature_extractor(
            torch.as_tensor(audio).to(dev, compute_dtype(cfg)))}

    items: List[Dict] = []
    for batch in loader:
        feats = fetch_outputs(sharded_encode(
            encode, mesh, batch["audio"], batch["audio_lengths"]))["fe"]
        a_len = np.asarray(batch["audio_lengths"])
        f_len = cfg.feat_extract_output_lengths(a_len)
        mask = np.asarray(batch.get("batch_pad_mask",
                                    np.ones(len(feats), bool)))
        for b in range(len(feats)):
            if not mask[b]:
                continue  # a partial batch's repeated row
            t = int(f_len[b])
            item = {"fe_features": feats[b, :t].astype(np.float32),
                    "audio_length": int(a_len[b]), "frame_length": t}
            if "tv_targets" in batch:      # collate_tv (APTAI)
                item["tv_targets"] = np.asarray(batch["tv_targets"][b, :t],
                                                np.float32)
                item["phn_frames"] = np.asarray(batch["phn_frames"][b, :t],
                                                np.int32)
            if "phoneme_labels" in batch:  # collate_ctc / collate_tv
                lab = np.asarray(batch["phoneme_labels"][b])
                item["phoneme_label"] = lab[lab != CTC_LABEL_PAD_ID]
            items.append(item)
    return items


def collate_fe(items, bucket: bool = True) -> Dict[str, np.ndarray]:
    """A batch of cached items: the frame axis padded to a
    ``FRAME_BUCKET`` multiple (zero features: the encoder zeroes pad
    frames before the positional conv), labels with their sentinels."""
    f_w = max(x["frame_length"] for x in items)
    if bucket:
        f_w = _round_up(f_w, FRAME_BUCKET)
    out = {
        "fe_features": np.stack([_pad_to(x["fe_features"], f_w, 0.0)
                                 for x in items]),
        "audio_lengths": np.asarray([x["audio_length"] for x in items],
                                    np.int32),
    }
    if "tv_targets" in items[0]:
        out["tv_targets"] = np.stack(
            [_pad_to(x["tv_targets"], f_w, TV_PAD_VALUE) for x in items])
        out["phn_frames"] = np.stack(
            [_pad_to(x["phn_frames"], f_w, PHONEME_FRAME_PAD_ID)
             for x in items])
    if "phoneme_label" in items[0]:
        l_w = _round_up(max(len(x["phoneme_label"]) for x in items),
                        LABEL_BUCKET)
        out["phoneme_labels"] = np.stack(
            [_pad_to(np.asarray(x["phoneme_label"], np.int32), l_w,
                     CTC_LABEL_PAD_ID) for x in items])
    return out


class FECachedLoader(BucketedLoader):
    """Shuffled, frame-bucketed batches over the feature extractor's
    output: ``loader`` (``collate_tv`` or ``collate_ctc`` batches) is read
    once at construction through ``model``'s frozen extractor (the fused
    kernel under ``fused_feature_extractor=True``), split over ``mesh``'s
    data axis when given."""

    def __init__(self, loader, model, shuffle: bool = True, seed: int = 0,
                 mesh=None):
        super().__init__(_CachedItems(_cache_items(loader, model, mesh)),
                         batch_size=loader.batch_size, collate_fn=collate_fe,
                         shuffle=shuffle, seed=seed)

    def _item_width(self, item) -> int:
        return _round_up(item["frame_length"], FRAME_BUCKET)

    @property
    def cache_bytes(self) -> int:
        return sum(x["fe_features"].nbytes for x in self.dataset.items)
