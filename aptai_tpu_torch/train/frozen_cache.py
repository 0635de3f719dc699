"""The frozen-tower encoding cache of FORCE-APTAI training (the JAX
package's ``train/frozen_cache.py``).

FORCE-APTAI's tower is frozen and runs deterministically, so a trainer
runs it (and the in-step decode) once per utterance and then trains the
head alone from the cached outputs (``ForceAPTAI.train_from_encoded``):

* :func:`encode_items` — the one-time pass over ``collate_tv``-style
  batches: the tower, then the greedy decode on the device or the beam on
  the host (``decode_method="beam_host"``, real rows only), and trimmed
  per-utterance items with the tower's per-frame CTC argmax
  (``tower_frame_labels``, for the aux frame CE);
* :func:`place_params` and :func:`sharded_encode` — the pass over a mesh
  (``parallel/``): each process of the data axis encodes its rows of
  every batch, with the tower split over the model axis as the step splits
  the encoder, and the outputs are all-gathered over the data axis, so
  every process holds the items of a one-process pass, in its order;
* :func:`collate_encoded` — a batch of items padded to ``FRAME_BUCKET``
  multiples;
* :class:`EncodedItemsLoader` — shuffled, frame-bucketed batches over
  items; :class:`FrozenEncodedLoader` — one fold: the pass over a loader,
  then its batches; :class:`FrozenEncodedCorpus` — one leave-one-
  speaker-out run: the whole manifest encoded once, and each fold's
  loaders drawn from it by ``path_wav`` (valid while the tower is the same
  in every fold).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from aptai_tpu_torch import (CTC_LABEL_PAD_ID, PHONEME_FRAME_PAD_ID,
                             TV_PAD_VALUE)
from aptai_tpu_torch.data.batching import (FRAME_BUCKET, LABEL_BUCKET,
                                           BucketedLoader, _pad_to,
                                           _round_up)
from aptai_tpu_torch.infer.api import fetch_outputs
from aptai_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_size,
                                           is_fsdp, placed_model_axis,
                                           split_model_axis)


def encode_batch(model, audio, audio_lengths,
                 n_real: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``model.encode_and_decode`` over a batch of arrays or tensors, moved
    to the model's device first: the tower and the model's decode, without
    a gradient (a ``beam_host`` model beam-decodes the first ``n_real``
    rows only)."""
    dev = next(model.parameters()).device
    return model.encode_and_decode(torch.as_tensor(audio).to(dev),
                                   torch.as_tensor(audio_lengths).to(dev),
                                   n_real)


def place_params(model: nn.Module, mesh) -> nn.Module:
    """The model a cache pass encodes with on ``mesh``: on a model axis of
    several processes, a copy of ``model`` split as the step splits it
    (``parallel.mesh.split_model_axis``), so the trained model's
    parameters are neither sliced nor shared; ``model`` itself otherwise,
    and when it is already placed (split, or sharded by FSDP), since the
    pass only reads it."""
    if (axis_size(mesh, MODEL_AXIS) == 1 or is_fsdp(model)
            or placed_model_axis(model) is not None):
        return model
    return split_model_axis(copy.deepcopy(model), mesh)


def sharded_encode(encode: Callable, mesh, audio, audio_lengths,
                   n_real: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``encode(audio, audio_lengths, n_real)`` over a global batch whose
    real rows lead (``n_real`` of them; None: all), split over the data
    axis of ``mesh``: this process encodes its rows ``[r·B/N, (r+1)·B/N)``
    (``n_real`` becoming the number of real rows among them), then every
    output, batch-leading and equally shaped on every process, is
    all-gathered over the axis, so every process returns the whole batch's
    outputs in its order. Without a data axis of several processes, the
    call on the whole batch. A batch that does not divide over the axis
    raises ``ValueError``."""
    n = axis_size(mesh, DATA_AXIS)
    if n == 1:
        return encode(audio, audio_lengths, n_real)
    b = len(audio)
    if b % n:
        raise ValueError(f"batch {b} does not divide over the {n} "
                         "processes of the data axis")
    k, r = b // n, mesh.get_local_rank(DATA_AXIS)
    lo = r * k
    own_real = None if n_real is None else min(max(n_real - lo, 0), k)
    out = encode(audio[lo:lo + k], audio_lengths[lo:lo + k], own_real)
    group = mesh.get_group(DATA_AXIS)
    gathered = {}
    for name, t in out.items():
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        gathered[name] = torch.cat(parts)
    return gathered


def encode_items(batches: Iterable[Dict], model, mesh=None) -> List[Dict]:
    """The one-time cache pass: each ``collate_tv``-style batch (``audio``,
    ``audio_lengths``, ``tv_targets``, ``phoneme_labels``; optionally
    ``batch_pad_mask``, ``frame_lengths``, ``phn_frames``, ``utt_keys``)
    through :func:`encode_batch`, then trimmed per-utterance host items in
    batch order. Rows whose ``batch_pad_mask`` is False (a partial batch's
    repeats) are left out; the real rows lead. ``mesh``: the batches are
    global batches, split over its data axis and gathered back
    (:func:`sharded_encode`, the tower placed by :func:`place_params`)."""
    tower = place_params(model, mesh)

    def encode(audio, lengths, n_real):
        return encode_batch(tower, audio, lengths, n_real=n_real)

    items: List[Dict] = []
    for batch in batches:
        mask = np.asarray(batch.get(
            "batch_pad_mask", np.ones(len(batch["audio"]), bool)))
        enc = fetch_outputs(sharded_encode(
            encode, mesh, batch["audio"], batch["audio_lengths"],
            n_real=int(mask.sum())))
        fl = enc["frame_lengths"]
        embs = enc["frame_embs"]
        tvs = np.asarray(batch["tv_targets"])
        labels = np.asarray(batch["phoneme_labels"])
        fl_raw = np.asarray(batch.get("frame_lengths", fl))
        phn_frames = np.asarray(batch.get(
            "phn_frames", np.zeros(embs.shape[:2], np.int32)))
        keys = batch.get("utt_keys")
        for b in range(len(mask)):
            if not mask[b]:
                continue
            t = int(fl[b])
            lab = labels[b]
            items.append({
                "utt_key": None if keys is None else keys[b],
                "frame_embs": embs[b, :t],
                "frame_length": t,
                "frame_length_raw": int(fl_raw[b]),
                "phn_pred_seq": enc["phn_pred_seq"][b],
                "phn_seq_length": int(enc["phn_seq_lengths"][b]),
                "phn_seq_truncated": int(enc["phn_seq_truncated"][b]),
                "tower_frame_labels": enc["tower_frame_labels"][b, :t],
                "tv_targets": tvs[b, :t],
                "phn_frames": phn_frames[b, :t],
                "phoneme_label": lab[lab != CTC_LABEL_PAD_ID],
            })
    return items


def collate_encoded(items: Sequence[Dict], bucket: bool = True) -> Dict:
    """A batch of cached items: frame-level arrays padded to a
    ``FRAME_BUCKET`` multiple (zero embeddings, TVs −100, frame phonemes 0,
    tower labels 0), labels to a ``LABEL_BUCKET`` multiple (−100). The
    zero-padded embeddings are inert: every consumer is length-masked.
    ``enc_frame_lengths`` is the tower's frame count, ``frame_lengths``
    the manifest's (the metrics read it)."""
    f_w = max(int(x["frame_length"]) for x in items)
    if bucket:
        f_w = _round_up(f_w, FRAME_BUCKET)
    l_w = _round_up(max(len(x["phoneme_label"]) for x in items), LABEL_BUCKET)

    def frames(key, dtype, value):
        return np.stack([_pad_to(np.asarray(x[key], dtype), f_w, value)
                         for x in items])

    def per_item(key):
        return np.asarray([x[key] for x in items], np.int32)

    return {
        "frame_embs": frames("frame_embs", np.float32, 0),
        "enc_frame_lengths": per_item("frame_length"),
        "phn_pred_seq": np.stack([x["phn_pred_seq"] for x in items]),
        "phn_seq_lengths": per_item("phn_seq_length"),
        "phn_seq_truncated": per_item("phn_seq_truncated"),
        "tower_frame_labels": frames("tower_frame_labels", np.int32, 0),
        "tv_targets": frames("tv_targets", np.float32, TV_PAD_VALUE),
        "phoneme_labels": np.stack(
            [_pad_to(np.asarray(x["phoneme_label"], np.int32), l_w,
                     CTC_LABEL_PAD_ID) for x in items]),
        "phn_frames": frames("phn_frames", np.int32, PHONEME_FRAME_PAD_ID),
        "frame_lengths": per_item("frame_length_raw"),
    }


class _CachedItems:
    """A list of items as a map-style dataset."""

    def __init__(self, items: List[Dict]):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class EncodedItemsLoader(BucketedLoader):
    """Shuffled, frame-bucketed batches (:func:`collate_encoded`) over
    cached items, the inputs of ``force_loss_fn(from_encoded=True)``."""

    def __init__(self, items: List[Dict], batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        super().__init__(_CachedItems(items), batch_size=batch_size,
                         collate_fn=collate_encoded, shuffle=shuffle,
                         seed=seed)

    def _item_width(self, item) -> int:
        return _round_up(item["frame_length"], FRAME_BUCKET)

    @property
    def cache_bytes(self) -> int:
        return sum(x["frame_embs"].nbytes for x in self.dataset.items)


class FrozenEncodedLoader(EncodedItemsLoader):
    """One fold's cache: ``loader`` (``collate_tv`` batches) read once at
    construction through :func:`encode_items` (split over ``mesh``'s data
    axis when given), then batches as an :class:`EncodedItemsLoader`."""

    def __init__(self, loader, model, shuffle: bool = True, seed: int = 0,
                 mesh=None):
        super().__init__(encode_items(loader, model, mesh),
                         batch_size=loader.batch_size, shuffle=shuffle,
                         seed=seed)


class FrozenEncodedCorpus:
    """One run's cache: every row of an HPRC manifest encoded once
    (:func:`encode_items` over unshuffled ``collate_tv`` batches of
    ``batch_size``, split over ``mesh``'s data axis when given), keyed by
    ``path_wav``; :meth:`loader_for` serves a fold's rows from it."""

    def __init__(self, rows: Sequence[Dict], vocab: Dict[str, int], model,
                 batch_size: int, mesh=None):
        from aptai_tpu_torch.data import HPRCDataset, collate_tv

        def collate_with_keys(items):
            out = collate_tv(items)
            out["utt_keys"] = [x["utt_key"] for x in items]
            return out

        loader = BucketedLoader(HPRCDataset(rows, vocab, rate="both"),
                                batch_size=batch_size,
                                collate_fn=collate_with_keys, shuffle=False)
        items = encode_items(loader, model, mesh)
        self.by_key: Dict[str, Dict] = {it["utt_key"]: it for it in items}
        if len(self.by_key) != len(items):
            raise ValueError("the manifest lists a path_wav twice")

    @property
    def cache_bytes(self) -> int:
        return sum(x["frame_embs"].nbytes for x in self.by_key.values())

    def __len__(self):
        return len(self.by_key)

    def loader_for(self, fold_rows: Sequence[Dict], batch_size: int,
                   shuffle: bool = True,
                   seed: int = 0) -> EncodedItemsLoader:
        """Batches over the cached items of ``fold_rows``."""
        items = [self.by_key[str(r["path_wav"])] for r in fold_rows]
        return EncodedItemsLoader(items, batch_size, shuffle=shuffle,
                                  seed=seed)
