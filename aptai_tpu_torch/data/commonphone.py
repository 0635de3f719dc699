"""The CommonPhone corpus for CTC phoneme recognition (the JAX package's
``data/commonphone.py``): a manifest-driven dataset of ``{audio,
audio_len, phoneme_label}`` items, optionally cropped to a random second
with the labels cut to the crop, and the offline manifest builders.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from aptai_tpu_torch import SAMPLE_RATE
from aptai_tpu_torch.data.audio_io import load_wav_16k
from aptai_tpu_torch.data.manifest import (Row, read_rows, select, unique,
                                           write_rows)
from aptai_tpu_torch.data.textgrid import parse_textgrid, textgrid_phonemes
from aptai_tpu_torch.data.vocab import phonemes_to_ids

MANIFEST_COLUMNS = ("index", "lang", "path", "speaker", "text", "phonemes",
                    "phoneme_timestamps", "split")


def parse_timestamp_tuples(s: str):
    """The manifest's list of (start, end) tuples, as floats."""
    return [tuple(map(float, t)) for t in ast.literal_eval(str(s))]


class CommonPhoneDataset:
    """A map-style dataset over CommonPhone manifest rows
    (:func:`aptai_tpu_torch.data.manifest.read_rows`). Audio is resampled
    to 16 kHz; with ``cropping`` each item is a random 1 s window (from
    one stream seeded with ``seed``) with the phonemes from the one that
    holds the window's start to the one that holds its end."""

    CROP_SECONDS = 1.0

    def __init__(self, rows: Sequence[Row], vocab: Dict[str, int],
                 cropping: bool = False, seed: int = 0):
        self.rows = list(rows)
        self.vocab = vocab
        self.cropping = cropping
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Dict:
        row = self.rows[index]
        audio = load_wav_16k(row["path"])
        if self.cropping:
            n_crop = int(self.CROP_SECONDS * SAMPLE_RATE)
            start = int(self._rng.integers(0, max(len(audio) - n_crop, 1)))
            end = start + n_crop
            start_s, end_s = start / SAMPLE_RATE, end / SAMPLE_RATE
            ts = parse_timestamp_tuples(row["phoneme_timestamps"])
            first = next(i for i, (a, b) in enumerate(ts) if a <= start_s < b)
            last = next(i for i, (a, b) in enumerate(ts) if a < end_s <= b)
            tokens = str(row["phonemes"]).split(" ")[first:last + 1]
            label = phonemes_to_ids(self.vocab, tokens)
            audio = audio[start:end]
        else:
            label = phonemes_to_ids(self.vocab, row["phonemes"])
        return {
            "audio": np.asarray(audio, np.float32),
            "audio_len": len(audio),
            "phoneme_label": np.asarray(label, np.int32),
        }


def commonphone_csv(cp_path, langs: Optional[List[str]] = None) -> Path:
    """Build ``commonphone.csv`` beside a CommonPhone corpus directory: one
    row per utterance of each language's ``train.csv``, ``dev.csv`` and
    ``test.csv`` (columns ``MANIFEST_COLUMNS``), the phonemes and their
    (start, end) times from the MAUS TextGrids, the text from the
    ``ORT-MAU`` tier. Returns the manifest's path."""
    langs = langs or ["en"]
    valid = {"de", "en", "es", "fr", "it", "ru"}
    if not set(langs) <= valid:
        raise ValueError(f"languages must be in {sorted(valid)}")
    cp_path = Path(cp_path)
    rows, index = [], 0
    for lang in sorted(os.listdir(cp_path)):
        if lang not in langs:
            continue
        for split_file, split in (("train.csv", "train"), ("dev.csv", "val"),
                                  ("test.csv", "test")):
            for r in read_rows(cp_path / lang / split_file):
                wav = str(r["audio file"]).rsplit(".", 1)[0] + ".wav"
                grid = cp_path / lang / "grids" / (wav[:-4] + ".TextGrid")
                labels, timestamps = textgrid_phonemes(grid)
                words = [iv.text for iv in parse_textgrid(grid).get(
                    "ORT-MAU", []) if iv.text]
                rows.append(dict(zip(MANIFEST_COLUMNS, (
                    index, lang, str(cp_path / lang / "wav" / wav), r["id"],
                    " ".join(words), " ".join(labels), timestamps, split))))
                index += 1
    return write_rows(cp_path.parent / "commonphone.csv", rows,
                      MANIFEST_COLUMNS)


def remap_speakers(csv_path) -> None:
    """Rewrite the manifest's speakers as integers, in order of first
    appearance."""
    rows = read_rows(csv_path)
    mapping = {spk: i for i, spk in enumerate(unique(rows, "speaker"))}
    for r in rows:
        r["speaker"] = mapping[r["speaker"]]
    write_rows(csv_path, rows)


def trim_csv(csv_path, num_train=32, num_val=5, num_test=5, seed=0) -> Path:
    """A debug-size manifest ``<stem>_trimmed.csv`` beside ``csv_path``:
    ``num_*`` rows of each split drawn without replacement from
    ``np.random.RandomState(seed)``, in draw order (pandas'
    ``DataFrame.sample(n, random_state=seed)``)."""
    csv_path = Path(csv_path)
    rows = read_rows(csv_path)
    out = []
    for split, n in (("train", num_train), ("val", num_val),
                     ("test", num_test)):
        part = select(rows, "split", split)
        picks = np.random.RandomState(seed).choice(len(part), size=n,
                                                   replace=False)
        out += [part[i] for i in picks]
    return write_rows(csv_path.parent / (csv_path.stem + "_trimmed.csv"), out,
                      list(rows[0]))
