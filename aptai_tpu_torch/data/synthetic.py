"""Synthetic mini-corpora on disk (the JAX package's ``data/synthetic.py``):
wavs, TextGrid-free manifests, TV and feature pickles, written through the
same files the real datasets read, so tests and smoke runs exercise the
production IO path. The same seed gives the same audio, TVs, labels and
manifest rows as the JAX generators; the mel spectrogram and MFCCs come
from the port's signal ops on the card (or on the device named).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from aptai_tpu_torch import SAMPLE_RATE, TV_ORDER
from aptai_tpu_torch.data.audio_io import save_wav
from aptai_tpu_torch.data.hprc import HPRC_SPEAKERS
from aptai_tpu_torch.data.hprc_prep import (interpolate_tvs_to_frames,
                                            phoneme_frame_labels,
                                            zscore_utterance)
from aptai_tpu_torch.data.manifest import write_rows
from aptai_tpu_torch.data.vocab import build_vocab, phonemes_to_ids
from aptai_tpu_torch.ops.signal import melspectrogram, mfcc

_PHONES = ["(...)", "a", "e", "i", "o", "u", "k", "m", "s", "t"]


def _tone_for_phone(rng, phone: str, n: int) -> np.ndarray:
    """A narrowband signal of its own for each phoneme."""
    f0 = 200 + 80 * (_PHONES.index(phone) if phone in _PHONES else 0)
    t = np.arange(n) / SAMPLE_RATE
    sig = 0.3 * np.sin(2 * np.pi * f0 * t)
    sig += 0.02 * rng.standard_normal(n)
    return sig.astype(np.float32)


def _random_utterance(rng, min_phones=3, max_phones=8,
                      phone_dur=(0.08, 0.25)):
    n_ph = int(rng.integers(min_phones, max_phones + 1))
    phones = ["(...)"] + list(rng.choice(_PHONES[1:], size=n_ph)) + ["(...)"]
    durations = rng.uniform(*phone_dur, size=len(phones))
    audio, bounds, cur = [], [], 0.0
    for p, d in zip(phones, durations):
        n = int(d * SAMPLE_RATE)
        audio.append(_tone_for_phone(rng, p, n))
        bounds.append((round(cur, 4), round(cur + n / SAMPLE_RATE, 4)))
        cur += n / SAMPLE_RATE
    return phones, bounds, np.concatenate(audio)


def make_synthetic_commonphone(root, num_train=8, num_val=2, num_test=2,
                               seed=0) -> Path:
    """A CommonPhone-format manifest and its wavs; returns the csv path."""
    root = Path(root)
    wav_dir = root / "wav"
    wav_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows, idx = [], 0
    for split, n in (("train", num_train), ("val", num_val),
                     ("test", num_test)):
        for _ in range(n):
            phones, bounds, audio = _random_utterance(rng)
            path = wav_dir / f"utt_{idx:04d}.wav"
            save_wav(path, audio, SAMPLE_RATE)
            rows.append({
                "index": idx,
                "lang": "en",
                "path": str(path),
                "speaker": int(rng.integers(0, 4)),
                "text": "synthetic utterance",
                "phonemes": " ".join(phones),
                "phoneme_timestamps": [tuple(b) for b in bounds],
                "split": split,
            })
            idx += 1
    return write_rows(root / "commonphone.csv", rows)


# fixed per-(phoneme, TV) targets: the TVs are a function of the audible
# phonemes, so a model can learn them from the waveform
_PHONE_TV_TARGETS = {
    p: np.cos(0.7 * i + 1.3 * np.arange(len(TV_ORDER)))
    for i, p in enumerate(_PHONES)
}


def _phone_driven_tvs(rng, phones, bounds, n: int, total_s: float):
    """Piecewise-constant TV targets per phoneme, smoothed over ~120 ms
    (articulator-like inertia), plus a little noise."""
    t_axis = np.linspace(0.0, total_s, n, endpoint=False)
    targets = np.zeros((n, len(TV_ORDER)))
    for p, (t0, t1) in zip(phones, bounds):
        targets[(t_axis >= t0) & (t_axis < t1)] = _PHONE_TV_TARGETS[p]
    win = max(int(0.12 * n / max(total_s, 1e-6)), 1)
    kernel = np.ones(win) / win
    smooth = np.stack([np.convolve(targets[:, j], kernel, mode="same")
                       for j in range(len(TV_ORDER))], axis=1)
    smooth += 0.05 * rng.standard_normal(smooth.shape)
    return {k: smooth[:, j].astype(np.float64)
            for j, k in enumerate(TV_ORDER)}


def _dump(path: Path, obj) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def make_synthetic_hprc(root, utts_per_speaker=2, speakers=None, seed=0,
                        cfg=None, device=None) -> Path:
    """An HPRC-format prep tree and manifest (wavs, four TV pickle
    variants, mspec and mfcc pickles, the ``phn_frames_49hz`` column);
    returns the csv path. ``device``: where the spectrograms are computed
    (``cuda`` by default; without a card it raises unless ``"cpu"``)."""
    from aptai_tpu_torch.infer.api import resolve_device

    dev = resolve_device(device)
    root = Path(root)
    rng = np.random.default_rng(seed)
    speakers = speakers or HPRC_SPEAKERS[:4]
    vocab = build_vocab([" ".join(_PHONES)])
    vocab_noblank = {k: v for k, v in vocab.items() if k != "(blank)"}

    rows, idx = [], 0
    for spk in speakers:
        spk_dir = root / spk
        for d in ("audio", "tvs", "tvs_49hz", "tvs_norm", "tvs_norm_49hz",
                  "mspec", "mfccs"):
            (spk_dir / d).mkdir(parents=True, exist_ok=True)
        for u in range(utts_per_speaker):
            for rate in ("N", "F"):
                phones, bounds, audio = _random_utterance(rng)
                if rate == "F":
                    audio = audio[::2]  # a crude fast-rate variant
                name = f"{spk}_S{u:02d}_R01_{rate}"
                path = lambda sub: spk_dir / sub / (name + ".pkl")
                wav_path = spk_dir / "audio" / (name + ".wav")
                save_wav(wav_path, audio, SAMPLE_RATE)

                n_ema = int(len(audio) / SAMPLE_RATE * 100)  # 100 Hz EMA
                scale = 0.5 if rate == "F" else 1.0  # F boundaries halve
                tvs = _phone_driven_tvs(
                    rng, phones,
                    [(b[0] * scale, b[1] * scale) for b in bounds],
                    max(n_ema, 8), len(audio) / SAMPLE_RATE)
                tvs_norm = zscore_utterance(tvs)
                _dump(path("tvs"), tvs)
                _dump(path("tvs_49hz"),
                      interpolate_tvs_to_frames(tvs, len(audio), cfg))
                _dump(path("tvs_norm"), tvs_norm)
                _dump(path("tvs_norm_49hz"),
                      interpolate_tvs_to_frames(tvs_norm, len(audio), cfg))

                x = torch.from_numpy(audio).to(dev)
                _dump(path("mspec"), melspectrogram(x).cpu().numpy())
                _dump(path("mfccs"), mfcc(x).cpu().numpy())

                # boundaries as the prep writes them: the starts and the
                # final end, halved with the F-rate audio
                timestamps = [b[0] for b in bounds] + [bounds[-1][1]]
                if rate == "F":
                    timestamps = [t / 2 for t in timestamps]
                frames = phoneme_frame_labels(
                    timestamps, phonemes_to_ids(vocab_noblank, phones),
                    len(audio), cfg)
                rows.append({
                    "index": idx,
                    "path_wav": str(wav_path),
                    "speaker": spk,
                    "text": f"synthetic text {u}",
                    "phoneme_labels": " ".join(phones),
                    "phoneme_timestamps": [round(t, 4) for t in timestamps],
                    "rate": rate,
                    "path_tvs": str(path("tvs")),
                    "path_tvs_49hz": str(path("tvs_49hz")),
                    "path_tvs_norm": str(path("tvs_norm")),
                    "path_tvs_norm_49hz": str(path("tvs_norm_49hz")),
                    "path_mspec": str(path("mspec")),
                    "path_mfccs": str(path("mfccs")),
                    "phn_frames_49hz": frames,
                })
                idx += 1
    return write_rows(root / "hprc.csv", rows)
