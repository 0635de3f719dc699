"""Padding, collation and shape-bucketed batching (the JAX package's
``data/batching.py``).

Batches are padded to a few fixed widths (audio to whole seconds, labels
to multiples of ``LABEL_BUCKET``, frames to multiples of ``FRAME_BUCKET``)
with the reference's sentinels: audio 0.0, CTC labels −100, frame
phonemes 0 (the CE ignore id), TVs −100.0.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Dict, Iterable, List, Sequence

import numpy as np

from aptai_tpu_torch import (AUDIO_PAD_VALUE, CTC_LABEL_PAD_ID,
                             PHONEME_FRAME_PAD_ID, TV_PAD_VALUE)

AUDIO_BUCKET = 16_000   # audio pads to whole seconds
LABEL_BUCKET = 16
FRAME_BUCKET = 64


def _round_up(n: int, m: int) -> int:
    return max(int(math.ceil(n / m)) * m, m)


def _pad_to(x: np.ndarray, width: int, value) -> np.ndarray:
    pad = [(0, width - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=value)


def _stack(items, key, dtype, width, value) -> np.ndarray:
    return np.stack([_pad_to(np.asarray(x[key], dtype), width, value)
                     for x in items])


def collate_ctc(items: Sequence[Dict], bucket: bool = True
                ) -> Dict[str, np.ndarray]:
    """A W2V2PR batch: ``audio``, ``audio_lengths``, ``phoneme_labels``."""
    a_w = max(len(x["audio"]) for x in items)
    l_w = max(len(x["phoneme_label"]) for x in items)
    if bucket:
        a_w = _round_up(a_w, AUDIO_BUCKET)
        l_w = _round_up(l_w, LABEL_BUCKET)
    return {
        "audio": _stack(items, "audio", np.float32, a_w, AUDIO_PAD_VALUE),
        "audio_lengths": np.asarray([x["audio_len"] for x in items],
                                    np.int32),
        "phoneme_labels": _stack(items, "phoneme_label", np.int32, l_w,
                                 CTC_LABEL_PAD_ID),
    }


def collate_tv(items: Sequence[Dict], bucket: bool = True
               ) -> Dict[str, np.ndarray]:
    """An APTAI / FORCE batch: ``audio``, ``audio_lengths``,
    ``phn_frames``, ``tv_targets`` (from the items' stacked (T, 9)
    ``tvs_norm_49hz_array``), ``phoneme_labels`` and ``frame_lengths``."""
    a_w = max(len(x["audio"]) for x in items)
    f_w = max(len(x["phn_frames_49hz"]) for x in items)
    if bucket:
        a_w = _round_up(a_w, AUDIO_BUCKET)
        f_w = _round_up(f_w, FRAME_BUCKET)
    l_w = _round_up(max(len(x["phoneme_label"]) for x in items), LABEL_BUCKET)
    return {
        "audio": _stack(items, "audio", np.float32, a_w, AUDIO_PAD_VALUE),
        "audio_lengths": np.asarray([x["audio_len"] for x in items],
                                    np.int32),
        "phn_frames": _stack(items, "phn_frames_49hz", np.int32, f_w,
                             PHONEME_FRAME_PAD_ID),
        "tv_targets": _stack(items, "tvs_norm_49hz_array", np.float32, f_w,
                             TV_PAD_VALUE),
        "phoneme_labels": _stack(items, "phoneme_label", np.int32, l_w,
                                 CTC_LABEL_PAD_ID),
        "frame_lengths": np.asarray(
            [len(x["phn_frames_49hz"]) for x in items], np.int32),
    }


class BucketedLoader:
    """Length-bucketed batches over a map-style dataset.

    Items group by padded audio width (``_item_width``), so each batch has
    one of a few shapes. Each epoch shuffles the items and the order of
    the partial buckets from one seeded stream, and serves every item: a
    bucket's last partial batch is filled by repeating its items, with
    ``batch_pad_mask`` marking the real rows (which lead).

    With ``process_count`` > 1 every process composes the same global
    batches (same seed, same order) and keeps its row shard
    ``[process_index·B/N, (process_index + 1)·B/N)``.
    """

    def __init__(self, dataset, batch_size: int, collate_fn,
                 shuffle: bool = True, seed: int = 0,
                 audio_bucket: int = AUDIO_BUCKET, process_index: int = 0,
                 process_count: int = 1):
        if batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"process_count {process_count}")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} out of range")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.audio_bucket = audio_bucket
        self.process_index = process_index
        self.process_count = process_count
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        return math.ceil(len(self.dataset) / self.batch_size)

    @property
    def local_batch_size(self) -> int:
        return self.batch_size // self.process_count

    def _item_width(self, item) -> int:
        return _round_up(item["audio_len"], self.audio_bucket)

    def __iter__(self) -> Iterable[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1

        buckets: Dict[int, List] = {}
        for idx in order:
            item = self.dataset[int(idx)]
            width = self._item_width(item)
            buckets.setdefault(width, []).append(item)
            if len(buckets[width]) == self.batch_size:
                yield self._emit(buckets.pop(width))
        widths = list(buckets)
        if self.shuffle:
            self._rng.shuffle(widths)
        for width in widths:
            yield self._emit(buckets[width])

    def _emit(self, items: List[Dict]) -> Dict[str, np.ndarray]:
        real = len(items)
        while len(items) < self.batch_size:
            items.append(items[len(items) % real])
        mask = np.zeros(self.batch_size, bool)
        mask[:real] = True
        # collate the global batch (the pad widths agree across
        # processes), then keep this process's rows
        batch = self.collate_fn(items)
        batch["batch_pad_mask"] = mask
        if self.process_count > 1:
            lo = self.process_index * self.local_batch_size
            hi = lo + self.local_batch_size
            batch = {k: v[lo:hi] for k, v in batch.items()}
        return batch


class PrefetchLoader:
    """Batches of ``loader`` made on a background thread, up to ``depth``
    ahead of the consumer (wav decoding and collation overlap the step). An
    exception in the loader is raised to the consumer."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        done = object()
        failed: List[BaseException] = []

        def producer():
            try:
                for batch in self.loader:
                    q.put(batch)
            except BaseException as e:  # re-raised on the consumer's side
                failed.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        t.join()
        if failed:
            raise failed[0]
