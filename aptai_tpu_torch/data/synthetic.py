"""Synthetic mini-corpora on disk (the JAX package's ``data/synthetic.py``):
wavs, TextGrid-free manifests, TV and feature pickles, written through the
same files the real datasets read, so tests and smoke runs exercise the
production IO path. The same seed gives the same audio, TVs, labels and
manifest rows as the JAX generators; the mel spectrogram and MFCCs come
from the port's signal ops on the card (or on the device named).
:func:`make_synthetic_hprc_raw` writes the input of the HPRC preparation,
a raw ``.mat`` release, which the JAX package has no generator for.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from aptai_tpu_torch import SAMPLE_RATE, TV_ORDER
from aptai_tpu_torch.data.audio_io import save_wav
from aptai_tpu_torch.data.hprc import HPRC_SPEAKERS
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
    # imported here: ``python -m aptai_tpu_torch.data.hprc_prep`` then runs
    # a module that importing the package has not imported already
    from aptai_tpu_torch.data.hprc_prep import (interpolate_tvs_to_frames,
                                                phoneme_frame_labels,
                                                zscore_utterance)
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


_WORDS = ("Haskins", "rate", "tongue", "palate", "lips", "jaw", "speech",
          "fast", "normal", "sentence")


def _mat_cell(name: str, srate: int, signal: np.ndarray) -> np.ndarray:
    cell = np.empty((3,), dtype=object)
    cell[0], cell[1], cell[2] = name, np.array([[srate]]), signal
    return cell


def _ema_trajectory(rng, n: int) -> np.ndarray:
    """(n, 6) sensor samples (x, y, z and three angles): a random walk
    inside the palate's x range [−50, 0)."""
    walk = np.cumsum(rng.normal(0.0, 0.3, (n, 6)), axis=0)
    return np.clip(-25.0 + walk, -49.0, -1.0)


def make_synthetic_hprc_raw(root, speakers=None, texts=2,
                            repetitions=("R01", "R02"), seconds=(2.0, 4.0),
                            fs=44_100, seed=0, phonemes_root=None):
    """A raw HPRC release in its ``.mat`` layout, the input of
    :func:`aptai_tpu_torch.data.hprc_prep.prepare_hprc`: per speaker
    ``<root>/<spk>/data/<spk>_palate.mat`` (60 × 3) and, for each text,
    rate (N, F) and repetition, ``<spk>_B<text>_S01_<rep>_<rate>.mat``
    (audio at ``fs``, 100 Hz EMA of eight sensors, F02 without ML, with
    NaN dropouts) and its ``TextGrids/<key>.TextGrid`` word tier;
    utterances last ``seconds`` (uniform between the two). With
    ``phonemes_root``, the MAUS phoneme TextGrids that the alignment step
    would download are written to ``<phonemes_root>/<spk>/phonemes/``.
    Returns ``{speaker: [keys]}``."""
    import scipy.io

    from aptai_tpu_torch.data.textgrid import Interval, write_textgrid

    root = Path(root)
    rng = np.random.default_rng(seed)
    keys = {}
    for spk in speakers or HPRC_SPEAKERS:
        data_dir, tg_dir = root / spk / "data", root / spk / "TextGrids"
        data_dir.mkdir(parents=True, exist_ok=True)
        tg_dir.mkdir(exist_ok=True)
        palate = np.column_stack([np.arange(-60, 0, dtype=np.float64),
                                  np.zeros(60), rng.uniform(-2, 2, 60)])
        scipy.io.savemat(data_dir / f"{spk}_palate.mat",
                         {f"{spk}_palate": palate})
        sensors = [s for s in ("TR", "TB", "TT", "UL", "LL", "ML", "JAW",
                               "JAWL") if not (spk == "F02" and s == "ML")]
        keys[spk] = []
        for b in range(1, texts + 1):
            words = [_WORDS[(b + i) % len(_WORDS)] for i in range(3)]
            for rate in ("N", "F"):
                for rep in repetitions:
                    key = f"{spk}_B{b:02d}_S01_{rep}_{rate}"
                    total = rng.uniform(*seconds)
                    phones = (["(...)"] + list(rng.choice(_PHONES[1:],
                                                          size=8))
                              + ["(...)"])
                    cuts = np.sort(rng.uniform(0.1, 0.9, len(phones) - 1))
                    ends = np.append(np.round(cuts * total, 3), total)
                    starts = np.append(0.0, ends[:-1])
                    n = int(total * fs)
                    t = np.arange(n) / fs
                    audio = 0.02 * rng.standard_normal(n)
                    for p, s, e in zip(phones, starts, ends):
                        on = (t >= s) & (t < e)
                        audio[on] += 0.3 * np.sin(
                            2 * np.pi * (200 + 80 * _PHONES.index(p)) * t[on])
                    n_ema = int(total * 100)
                    cells = [_mat_cell("AUDIO", fs, audio[:, None])]
                    for s in sensors:
                        traj = _ema_trajectory(rng, n_ema)
                        if s == "TT":  # dropouts inside and at the end
                            traj[n_ema // 3:n_ema // 3 + 4, 0] = np.nan
                            traj[-2:, 2] = np.nan
                        cells.append(_mat_cell(s, 100, traj))
                    arr = np.empty((1, len(cells)), dtype=object)
                    for i, cell in enumerate(cells):
                        arr[0, i] = cell
                    scipy.io.savemat(data_dir / f"{key}.mat", {key: arr})
                    word_ends = np.linspace(0.0, total, 5)[1:]
                    write_textgrid(tg_dir / f"{key}.TextGrid", {"word": [
                        Interval(float(lo), float(hi), w) for lo, hi, w in
                        zip(np.append(0.0, word_ends[:-1]), word_ends,
                            [words[0], "sp", words[1], words[2]])]})
                    if phonemes_root is not None:
                        phn = Path(phonemes_root) / spk / "phonemes"
                        phn.mkdir(parents=True, exist_ok=True)
                        write_textgrid(phn / f"{key}.TextGrid", {"MAU": [
                            Interval(float(s), float(e), p)
                            for p, s, e in zip(phones, starts, ends)]})
                    keys[spk].append(key)
    return keys
