"""The HPRC (Haskins Production Rate Comparison) EMA and speech corpus
(the JAX package's ``data/hprc.py``): manifest rows point at a 16 kHz wav
and pickled features (four TV variants, mspec, mfcc) and carry the
phoneme labels, their boundaries and the 49 Hz frame phonemes.
"""

from __future__ import annotations

import ast
import pickle
from typing import Dict, Sequence

import numpy as np

from aptai_tpu_torch import TV_ORDER
from aptai_tpu_torch.data.audio_io import load_wav_16k
from aptai_tpu_torch.data.manifest import Row, select, unique
from aptai_tpu_torch.data.vocab import phonemes_to_ids

HPRC_SPEAKERS = ("M01", "M02", "M03", "M04", "F01", "F02", "F03", "F04")


def speaker_onehot(speaker: str) -> np.ndarray:
    """The speaker's 8-dim one-hot."""
    idx = HPRC_SPEAKERS.index(speaker)
    return np.eye(len(HPRC_SPEAKERS), dtype=np.float32)[idx]


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def tv_dict_to_array(tvs: Dict[str, np.ndarray]) -> np.ndarray:
    """{TV name: (T,)} → (T, 9) float32 in ``TV_ORDER``."""
    return np.stack([np.asarray(tvs[k], np.float32) for k in TV_ORDER],
                    axis=-1)


class HPRCDataset:
    """A map-style dataset over the rows of an ``hprc.csv`` manifest
    (:func:`aptai_tpu_torch.data.manifest.read_rows`), those of ``rate``
    ("N" normal, "F" fast or "both"). Items carry the TV variants as
    dicts and the normalised 49 Hz ones stacked (``tvs_norm_49hz_array``,
    (T, 9)) for the collator."""

    def __init__(self, rows: Sequence[Row], vocab: Dict[str, int],
                 rate: str):
        if rate not in ("N", "F", "both"):
            raise ValueError("rate must be one of N / F / both")
        self.vocab = vocab
        self.rate = rate
        self.rows = list(rows) if rate == "both" else select(rows, "rate",
                                                             rate)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Dict:
        row = self.rows[index]
        audio = load_wav_16k(row["path_wav"])
        mspec = _load_pickle(row["path_mspec"])
        tvs_norm_49hz = _load_pickle(row["path_tvs_norm_49hz"])
        # the f0 column is optional (absent or empty in older manifests
        # and the synthetic corpus)
        f0 = row.get("path_f0")
        return {
            # one per utterance: keys the frozen-tower cache
            "utt_key": str(row["path_wav"]),
            "audio": np.asarray(audio, np.float32),
            "audio_len": len(audio),
            "f0": None if f0 is None else _load_pickle(f0),
            "mspec": mspec,
            "mspec_len": len(mspec) if hasattr(mspec, "__len__") else 0,
            "mfccs": _load_pickle(row["path_mfccs"]),
            "spk_emb": speaker_onehot(row["speaker"]),
            "phoneme_label": np.asarray(
                phonemes_to_ids(self.vocab, row["phoneme_labels"]), np.int32),
            "phoneme_timestamps": [
                float(x) for x in ast.literal_eval(row["phoneme_timestamps"])],
            "phn_frames_49hz": np.asarray(
                ast.literal_eval(row["phn_frames_49hz"]), np.int32),
            "tvs": _load_pickle(row["path_tvs"]),
            "tvs_49hz": _load_pickle(row["path_tvs_49hz"]),
            "tvs_norm": _load_pickle(row["path_tvs_norm"]),
            "tvs_norm_49hz": tvs_norm_49hz,
            "tvs_norm_49hz_array": tv_dict_to_array(tvs_norm_49hz),
        }


def loso_split(rows: Sequence[Row], test_speaker: str, train_val_rate: str,
               valid_text_fraction: float = 0.1, seed: int = 0):
    """Leave-one-speaker-out split with a text-disjoint validation set:
    ``(train, valid, test_n, test_f)`` row lists, each in manifest order.

    The held-out speaker gives the N- and F-rate test sets; a
    ``valid_text_fraction`` of the other speakers' texts that have rows at
    ``train_val_rate``, drawn from ``seed``, go to validation (at least one
    when there are two or more and the fraction is not 0, so the set is
    never empty by rounding); train and validation then keep that rate.
    """
    if train_val_rate not in ("N", "F", "both"):
        raise ValueError("train_val_rate must be N / F / both")
    rng = np.random.default_rng(seed)
    test = [r for r in rows if r["speaker"] == test_speaker]
    rest = [r for r in rows if r["speaker"] != test_speaker]
    rate_rest = (rest if train_val_rate == "both"
                 else select(rest, "rate", train_val_rate))
    texts = unique(rate_rest, "text")
    k = int(len(texts) * valid_text_fraction)
    if k == 0 and len(texts) > 1 and valid_text_fraction > 0:
        k = 1
    valid_texts = (set(rng.choice(np.array(texts, dtype=object), size=k,
                                  replace=False)) if k else set())
    valid = [r for r in rest if r["text"] in valid_texts]
    train = [r for r in rest if r["text"] not in valid_texts]
    if train_val_rate != "both":
        train = select(train, "rate", train_val_rate)
        valid = select(valid, "rate", train_val_rate)
    return train, valid, select(test, "rate", "N"), select(test, "rate", "F")
