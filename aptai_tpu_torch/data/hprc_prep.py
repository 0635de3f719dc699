"""HPRC corpus preparation (the JAX package's ``data/hprc_prep.py``): from
the raw ``.mat`` release to a trainable ``hprc.csv``, in eight resumable
steps (``prepare_hprc``; ``python -m aptai_tpu_torch.data.hprc_prep``):

1. :func:`extract_mat` — ``.mat`` → 16 kHz wav, EMA and palate pickles,
   word transcripts;
2. :func:`write_acoustic_features` — F0, log-mel and MFCC pickles, the
   spectrograms on the device the caller names (the card by default);
3. :func:`run_maus_alignment` — MAUS forced alignment (network, off by
   default; existing ``<spk>/phonemes/*.TextGrid`` are used as they are);
4. :func:`write_lowpass_ema` — NaN interpolation and a Butterworth
   low-pass (10 Hz, order 5, ``scipy.signal.filtfilt``) per trajectory;
5. :func:`write_tvs` — the 9 tract variables from the EMA geometry;
6. :func:`write_tv_norm` — one of four normalisations;
7. :func:`write_tvs_49hz` — TVs resampled to the encoder's frame count;
8. :func:`build_hprc_csv` and :func:`add_phn_frames_to_csv` — the manifest
   with its 49 Hz frame phonemes.

Everything but the spectrograms is numpy float64 on the host, so a tree
prepared here holds the JAX package's pickles, and its manifest is the one
pandas writes there (``data/manifest.py`` writes pandas' bytes). The
encoder's frame count comes from the closed-form conv length formula, not
from a model.
"""

from __future__ import annotations

import ast
import csv
import pickle
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.signal import butter, filtfilt

from aptai_tpu_torch import SAMPLE_RATE, TV_ORDER
from aptai_tpu_torch.data.audio_io import (load_wav, load_wav_16k,
                                           resample_np, save_wav)
from aptai_tpu_torch.data.manifest import read_rows, write_rows
from aptai_tpu_torch.data.textgrid import parse_textgrid, textgrid_phonemes
from aptai_tpu_torch.data.vocab import (build_vocab, load_vocab,
                                        phonemes_to_ids, save_vocab)
from aptai_tpu_torch.infer.transfer import resolve_device
from aptai_tpu_torch.models.configs import Wav2Vec2Config
from aptai_tpu_torch.ops.signal import interpolate_nan, melspectrogram, mfcc

EMA_SENSORS = ("TR", "TB", "TT", "UL", "LL", "ML", "JAW", "JAWL")
NORM_SCHEMES = ("zscore_utterance", "minmax_speaker", "zscore_speaker",
                "minmax_zscore_global")


# -- 1. .mat extraction -------------------------------------------------------

def _cell_field(cell, idx: int):
    """Field ``idx`` of an HPRC ``.mat`` cell (NAME, SRATE, SIGNAL, ...),
    whichever object-array nesting scipy gives it ((3,), (1, 3), (3, 1),
    ``np.void``)."""
    if isinstance(cell, np.void):
        v = cell[idx]
    else:
        c = np.asarray(cell)
        if c.dtype == object or c.dtype.fields:
            c = c.reshape(-1)
            v = c[idx] if c.dtype == object else c[0][idx]
        else:
            v = c[idx]
    while isinstance(v, np.ndarray) and v.dtype == object and v.size == 1:
        v = v.reshape(-1)[0]
    return v


def _xyz(rows) -> Dict[str, list]:
    return {"x": [r[0] for r in rows], "y": [r[1] for r in rows],
            "z": [r[2] for r in rows]}


def extract_mat(data_path, target_path=None, resample_fs: int = SAMPLE_RATE):
    """The raw release's ``<spk>/data*/*.mat`` → ``<spk>/audio/*.wav``
    (float32 at ``resample_fs``), ``<spk>/ema/*.pkl`` (sensor → x, y, z
    lists; F02 has no ML channel and its JAW / JAWL columns sit one to the
    left) and the palate trace ``<spk>/ema/<spk>_palate.pkl``; the
    ``TextGrids`` folder's ``word`` tiers → ``<spk>/text/*.txt``, lower
    case, without ``sp``. Returns the target tree."""
    import scipy.io

    data_path = Path(data_path)
    target_path = Path(target_path or (str(data_path) + "_prep"))
    for spk_dir in sorted(p for p in data_path.iterdir() if p.is_dir()):
        spk = spk_dir.name
        for sub in spk_dir.iterdir():
            if "data" in sub.name.lower():
                for mat_file in sorted(sub.glob("*.mat")):
                    mat = scipy.io.loadmat(mat_file)
                    key = mat_file.stem
                    ema_dir = target_path / spk / "ema"
                    if "palate" in key:
                        _dump(ema_dir / (key + ".pkl"), _xyz(mat[key]))
                        continue
                    data = mat[key]
                    fs = int(np.squeeze(_cell_field(data[0, 0], 1)))
                    audio = np.squeeze(np.asarray(
                        _cell_field(data[0, 0], 2), np.float64)
                    ).astype(np.float32)
                    audio_dir = target_path / spk / "audio"
                    audio_dir.mkdir(parents=True, exist_ok=True)
                    save_wav(audio_dir / (key + ".wav"),
                             resample_np(audio, fs, resample_fs), resample_fs)
                    ema = {}
                    for i, sensor in enumerate(EMA_SENSORS, start=1):
                        if spk == "F02" and sensor == "ML":
                            continue
                        col = i - 1 if (spk == "F02" and sensor in
                                        ("JAW", "JAWL")) else i
                        ema[sensor] = _xyz(np.asarray(
                            _cell_field(data[0, col], 2), np.float64))
                    _dump(ema_dir / (key + ".pkl"), ema)
            elif "TextGrids" in sub.name:
                for tg in sorted(sub.glob("*.TextGrid")):
                    words = [iv.text for iv in parse_textgrid(tg).get(
                        "word", []) if iv.text and iv.text != "sp"]
                    txt_dir = target_path / spk / "text"
                    txt_dir.mkdir(parents=True, exist_ok=True)
                    (txt_dir / (tg.stem + ".txt")).write_text(
                        " ".join(words).lower(), encoding="utf-8")
    return target_path


# -- 2. EMA low-pass ----------------------------------------------------------

def butter_lowpass(data: np.ndarray, cutoff: float = 10.0, fs: float = 100.0,
                   order: int = 5) -> np.ndarray:
    """A Butterworth low-pass applied forward and backward
    (``scipy.signal.filtfilt``)."""
    b, a = butter(order, cutoff / (0.5 * fs), btype="low", analog=False)
    return filtfilt(b, a, data)


def lowpass_ema_dict(ema: Dict, cutoff=10.0, fs=100.0, order=5) -> Dict:
    """Every trajectory NaN-interpolated, then low-passed; the nested
    sensor dicts and the palate's flat dict alike."""

    def clean(vals):
        vals = np.asarray(vals, np.float64)
        if np.isnan(vals).any():
            vals = interpolate_nan(vals)
        return butter_lowpass(vals, cutoff, fs, order)

    return {key: ({axis: clean(v) for axis, v in val.items()}
                  if isinstance(val, dict) else clean(val))
            for key, val in ema.items()}


# -- 4. Tract variables -------------------------------------------------------

def compute_tvs(
    ema: Dict[str, Dict[str, np.ndarray]],
    palate: Dict[str, np.ndarray],
    median_llx: float,
    median_ttx: float,
    median_tbx: float,
    median_trx: float,
) -> Dict[str, np.ndarray]:
    """The 9 TVs from the EMA geometry, vectorised over time:

      LA = ‖LL − UL‖ (x, z)        LP = LLx − median(LLx)
      JA = ‖JAW − UL‖ (x, z)
      T*CL = median(Sx) − Sx       for S in TT, TB, TR
      T*CD = min over palate x in [−50, 0) of ‖(Sx, Sz) − (x, palate_z[−x−1])‖
    """
    def xz(sensor):
        return (np.asarray(ema[sensor]["x"], np.float64),
                np.asarray(ema[sensor]["z"], np.float64))

    llx, llz = xz("LL")
    ulx, ulz = xz("UL")
    jawx, jawz = xz("JAW")
    ttx, ttz = xz("TT")
    tbx, tbz = xz("TB")
    trx, trz = xz("TR")

    palate_z = np.asarray(palate["z"], np.float64)
    xs = np.arange(-50, 0, dtype=np.float64)
    pz = palate_z[(-xs).astype(int) - 1]

    def constriction_degree(sx, sz):
        d = np.sqrt((sx[:, None] - xs[None, :]) ** 2 +
                    (sz[:, None] - pz[None, :]) ** 2)
        return d.min(axis=1)

    return {
        "LA": np.sqrt((llx - ulx) ** 2 + (llz - ulz) ** 2),
        "LP": llx - median_llx,
        "JA": np.sqrt((jawx - ulx) ** 2 + (jawz - ulz) ** 2),
        "TTCL": median_ttx - ttx,
        "TTCD": constriction_degree(ttx, ttz),
        "TMCL": median_tbx - tbx,
        "TMCD": constriction_degree(tbx, tbz),
        "TBCL": median_trx - trx,
        "TBCD": constriction_degree(trx, trz),
    }


def median_sensor_x(ema_files: List[Dict], sensor: str) -> float:
    """A speaker's median of one sensor's x over all its utterances."""
    return float(np.nanmedian(np.concatenate(
        [np.asarray(e[sensor]["x"], np.float64) for e in ema_files])))


# -- 5. Normalisations --------------------------------------------------------

def zscore_utterance(tvs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-utterance z-score of each TV; the NaNs of a constant TV become
    0."""
    out = {}
    for k, v in tvs.items():
        v = np.asarray(v, np.float64)
        out[k] = np.nan_to_num((v - np.nanmean(v)) / np.nanstd(v), nan=0.0)
    return out


def minmax_speaker(tvs: Dict[str, np.ndarray],
                   spk_min: Dict[str, float],
                   spk_max: Dict[str, float]) -> Dict[str, np.ndarray]:
    """Min-max with the speaker's range."""
    return {k: (np.asarray(v, np.float64) - spk_min[k])
            / (spk_max[k] - spk_min[k]) for k, v in tvs.items()}


def zscore_speaker(tvs: Dict[str, np.ndarray],
                   spk_mean: Dict[str, float],
                   spk_std: Dict[str, float]) -> Dict[str, np.ndarray]:
    """z-score with the speaker's moments."""
    return {k: (np.asarray(v, np.float64) - spk_mean[k]) / spk_std[k]
            for k, v in tvs.items()}


def speaker_stats(tv_files: List[Dict[str, np.ndarray]]):
    """``(min, max, mean, std)`` dicts per TV over a speaker's
    utterances."""
    stats_min, stats_max, stats_mean, stats_std = {}, {}, {}, {}
    for k in TV_ORDER:
        allv = np.concatenate([np.asarray(t[k], np.float64) for t in tv_files])
        stats_min[k] = float(np.nanmin(allv))
        stats_max[k] = float(np.nanmax(allv))
        stats_mean[k] = float(np.nanmean(allv))
        stats_std[k] = float(np.nanstd(allv))
    return stats_min, stats_max, stats_mean, stats_std


def _minmax_to_unit_range(v: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """``-1 + 2 (v - lo) / (hi - lo)``."""
    return -1.0 + (np.asarray(v, np.float64) - lo) * 2.0 / (hi - lo)


def global_stats(tv_files: List[Dict[str, np.ndarray]], rates: List[str],
                 rate: str = "both"):
    """The global scheme's ``(gmin, gmax, gmean, gstd)`` dicts per TV: the
    range over the raw TVs of every utterance (all speakers) whose rate
    (``rates``, 'N' / 'F' per entry) is ``rate`` ('N', 'F' or 'both'),
    then the moments of those values scaled to [−1, 1] by that range."""
    assert rate in ("N", "F", "both")
    assert len(tv_files) == len(rates)
    sel = [t for t, r in zip(tv_files, rates) if rate == "both" or r == rate]
    if not sel:
        raise ValueError(f"no utterances match rate={rate!r}")
    gmin, gmax, gmean, gstd = {}, {}, {}, {}
    for k in TV_ORDER:
        allv = np.concatenate([np.asarray(t[k], np.float64) for t in sel])
        gmin[k] = float(np.nanmin(allv))
        gmax[k] = float(np.nanmax(allv))
        scaled = _minmax_to_unit_range(allv, gmin[k], gmax[k])
        gmean[k] = float(np.nanmean(scaled))
        gstd[k] = float(np.nanstd(scaled))
    return gmin, gmax, gmean, gstd


def minmax_zscore_global(tvs: Dict[str, np.ndarray], gmin: Dict[str, float],
                         gmax: Dict[str, float], gmean: Dict[str, float],
                         gstd: Dict[str, float]) -> Dict[str, np.ndarray]:
    """The global scheme: min-max to [−1, 1] with the cross-speaker range,
    then z-score with the scaled data's moments (:func:`global_stats`)."""
    out = {}
    for k, v in tvs.items():
        scaled = _minmax_to_unit_range(v, gmin[k], gmax[k])
        out[k] = (scaled - gmean[k]) / gstd[k]
    return out


# -- 6. Frame-rate interpolation ----------------------------------------------

def interpolate_signal(sig: np.ndarray, target_len: int) -> np.ndarray:
    """Linear resample to ``target_len`` samples."""
    sig = np.asarray(sig, np.float64)
    src = np.arange(len(sig), dtype=np.float64)
    return np.interp(np.linspace(0, len(sig) - 1, target_len), src, sig)


def encoder_frames_for_audio(num_samples: int,
                             cfg: Optional[Wav2Vec2Config] = None) -> int:
    """The encoder's frame count for a waveform, in closed form."""
    cfg = cfg or Wav2Vec2Config()
    return int(cfg.feat_extract_output_lengths(np.asarray(num_samples)))


def interpolate_tvs_to_frames(tvs: Dict[str, np.ndarray],
                              num_audio_samples: int,
                              cfg: Optional[Wav2Vec2Config] = None):
    """Every TV linearly resampled to the encoder's frame count."""
    t = encoder_frames_for_audio(num_audio_samples, cfg)
    return {k: interpolate_signal(v, t) for k, v in tvs.items()}


# -- 7. Frame-level phoneme labels --------------------------------------------

def match_phonemes_to_frames(phoneme_boundaries: List[float],
                             phoneme_list: List,
                             frame_duration: float = 0.02) -> List:
    """Walk frames of ``frame_duration`` over the centisecond grid: a frame
    takes the first phoneme whose start boundary falls inside it, else the
    previous frame's phoneme."""
    matched, current = [], None
    stop = int(phoneme_boundaries[-1] * 100) + 1
    step = int(frame_duration * 100)
    for frame_start in range(0, stop, step):
        frame_end = frame_start + step
        overlapping = [
            p for p, b in zip(phoneme_list, phoneme_boundaries)
            if frame_start / 100.0 <= b < frame_end / 100.0
        ]
        if overlapping:
            current = overlapping[0]
        matched.append(current)
    return matched


def phoneme_frame_labels(timestamps: List[float], phoneme_ids: List[int],
                         num_audio_samples: int,
                         cfg: Optional[Wav2Vec2Config] = None) -> List[int]:
    """Frame phoneme ids at the encoder rate, cut or extended (the last
    label repeated) to the encoder's frame count."""
    ts = list(timestamps)
    ts[-1] = round(ts[-1], 2)
    frames = match_phonemes_to_frames(ts, phoneme_ids, 0.02)
    t = encoder_frames_for_audio(num_audio_samples, cfg)
    diff = abs(len(frames) - t)
    if diff:
        frames = (frames[:-diff] if len(frames) > t
                  else frames + [frames[-1]] * diff)
    if len(frames) != t:
        raise AssertionError(f"{len(frames)} frame labels for {t} frames")
    return frames


# -- acoustic features (mspec, MFCC, F0) and TV smoothing ---------------------

def _audio_tensor(wav: np.ndarray, device=None) -> torch.Tensor:
    """A waveform as a float32 tensor on ``device`` (the card by
    default; without one it raises unless ``"cpu"``)."""
    return torch.as_tensor(np.asarray(wav, np.float32),
                           device=resolve_device(device))


def compute_utterance_mspec(wav_16k: np.ndarray, device=None) -> np.ndarray:
    """The normalised log-mel spectrogram (hop 256, 80 bands) of a 16 kHz
    waveform, computed on ``device`` (the card by default): (frames, 80)
    float32 numpy."""
    x = _audio_tensor(wav_16k, device)
    return melspectrogram(x).cpu().numpy()


def mspec_znorm(mspec: np.ndarray) -> np.ndarray:
    """Per-utterance z-score of each mel bin."""
    mean = np.mean(mspec, axis=0)
    std = np.std(mspec, axis=0)
    return (mspec - mean) / std


def compute_utterance_mfcc(wav_16k: np.ndarray, n_mfcc: int = 13,
                           device=None) -> np.ndarray:
    """MFCCs at a ~49 Hz hop (``int(16000 / 49) − 4`` = 322; n_fft 1024,
    90-7600 Hz), computed on ``device`` (the card by default):
    (n_mfcc, frames) float32 numpy, librosa's layout."""
    hop = int(SAMPLE_RATE / 49) - 4
    out = mfcc(_audio_tensor(wav_16k, device), n_mfcc=n_mfcc, n_fft=1024,
               hop_length=hop, fmin=90.0, fmax=7600.0)
    return out.cpu().numpy().T


def nccf_pitch(
    wav: np.ndarray,
    fs: int = SAMPLE_RATE,
    hop_length: int = 256,
    lo: float = 50.0,
    hi: float = 600.0,
    voicing_threshold: float = 0.3,
) -> np.ndarray:
    """F0 by the normalised cross-correlation at the core of RAPT (D.
    Talkin, "A Robust Algorithm for Pitch Tracking", 1995), with parabolic
    peak interpolation and a voicing threshold on the NCCF peak: one value
    in Hz per ``hop_length`` samples (``1 + len // hop`` frames, as
    ``pysptk``'s ``rapt``), 0.0 where unvoiced. numpy float64 on the
    host."""
    wav = np.asarray(wav, np.float64)
    wav = wav - np.mean(wav)
    lag_min = max(int(fs / hi), 2)
    lag_max = int(np.ceil(fs / lo))
    win = lag_max  # at least one period of the lowest F0 tracked
    n_frames = 1 + len(wav) // hop_length
    need = (n_frames - 1) * hop_length + win + lag_max + 1
    if need > len(wav):
        wav = np.pad(wav, (0, need - len(wav)))

    starts = np.arange(n_frames) * hop_length
    idx = starts[:, None] + np.arange(win + lag_max + 1)[None, :]
    frames = wav[idx]
    base = frames[:, :win]
    e0 = np.sum(base * base, axis=1)

    lags = np.arange(lag_min, lag_max + 1)
    nccf = np.zeros((n_frames, len(lags)))
    for j, k in enumerate(lags):
        shifted = frames[:, k : k + win]
        ek = np.sum(shifted * shifted, axis=1)
        denom = np.sqrt(e0 * ek)
        num = np.sum(base * shifted, axis=1)
        nccf[:, j] = np.where(denom > 0, num / np.maximum(denom, 1e-12), 0.0)

    best = np.argmax(nccf, axis=1)
    peak = nccf[np.arange(n_frames), best]

    # a parabola through the peak and its neighbours for a sub-sample lag
    prev_i = np.clip(best - 1, 0, len(lags) - 1)
    next_i = np.clip(best + 1, 0, len(lags) - 1)
    y0 = nccf[np.arange(n_frames), prev_i]
    y1 = peak
    y2 = nccf[np.arange(n_frames), next_i]
    denom = y0 - 2 * y1 + y2
    shift = np.where(np.abs(denom) > 1e-12,
                     0.5 * (y0 - y2) / np.where(denom == 0, 1, denom), 0.0)
    shift = np.clip(shift, -0.5, 0.5)
    lag = lags[best] + shift

    # voiced: a strong periodicity and more than negligible energy
    energy_gate = e0 > 1e-6 * max(float(np.max(e0)), 1e-12)
    voiced = (peak >= voicing_threshold) & energy_gate
    return np.where(voiced, fs / lag, 0.0)


def compute_f0_rapt(wav_16k: np.ndarray, speaker: str,
                    hop_length: int = 256) -> np.ndarray:
    """F0 in the speaker's range (M*: 50-250 Hz, else 100-600 Hz):
    ``pysptk``'s RAPT where that package is installed, else
    :func:`nccf_pitch`."""
    lo, hi = (50, 250) if speaker.startswith("M") else (100, 600)
    try:
        import pysptk as sptk
    except ImportError:
        return nccf_pitch(wav_16k, SAMPLE_RATE, hop_length, lo, hi)
    return sptk.rapt((np.asarray(wav_16k, np.float32) * 32768), SAMPLE_RATE,
                     hop_length, min=lo, max=hi, otype=1)


def compute_f0_mspec(wav_16k: np.ndarray, speaker: str, device=None):
    """``(f0, mspec)`` of an utterance on one 256-sample hop: F0 in the
    speaker's range and the normalised log-mel on ``device``."""
    f0 = compute_f0_rapt(wav_16k, speaker, hop_length=256)
    return f0, compute_utterance_mspec(wav_16k, device)


def _iter_speaker_wavs(prep_path: Path):
    for spk_dir in sorted(p for p in Path(prep_path).iterdir() if p.is_dir()):
        audio_dir = spk_dir / "audio"
        if not audio_dir.exists():
            continue
        for wav in sorted(audio_dir.glob("*.wav")):
            yield spk_dir, wav


def _dump(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _load_pkl(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def write_acoustic_features(prep_path, replace: bool = False,
                            znorm_mspec: bool = False,
                            features=("f0", "mspec", "mfccs"),
                            device=None) -> int:
    """``<spk>/f0/``, ``<spk>/mspec/`` (z-scored per bin when
    ``znorm_mspec``) and ``<spk>/mfccs/`` pickles for every wav of the
    tree, the spectrograms computed on ``device`` (the card by default).
    Files that exist are kept unless ``replace``; returns the number of
    utterances that had a file written."""
    dev = resolve_device(device)
    written = 0
    for spk_dir, wav_path in _iter_speaker_wavs(prep_path):
        name = wav_path.stem
        todo = {feat: spk_dir / feat / (name + ".pkl") for feat in features}
        todo = {f: p for f, p in todo.items() if replace or not p.exists()}
        if not todo:
            continue
        wav = load_wav_16k(wav_path)
        if "f0" in todo or "mspec" in todo:
            f0, mspec = compute_f0_mspec(wav, spk_dir.name, dev)
            if znorm_mspec:
                mspec = mspec_znorm(mspec)
            if "f0" in todo:
                _dump(todo["f0"], f0)
            if "mspec" in todo:
                _dump(todo["mspec"], mspec)
        if "mfccs" in todo:
            _dump(todo["mfccs"], compute_utterance_mfcc(wav, device=dev))
        written += 1
    return written


def gaussian_smooth_tvs(tvs: Dict[str, np.ndarray],
                        sigma: float = 2.0) -> Dict[str, np.ndarray]:
    """Each TV smoothed by a Gaussian of ``sigma`` samples."""
    from scipy.ndimage import gaussian_filter1d

    return {k: gaussian_filter1d(np.asarray(v, np.float64), sigma)
            for k, v in tvs.items()}


def audio_duration_range(csv_path, path_column: str = "path_wav"):
    """``(shortest, longest)`` audio in seconds over a manifest's wavs."""
    durations = [len(load_wav_16k(r[path_column])) / SAMPLE_RATE
                 for r in read_rows(csv_path)]
    return min(durations), max(durations)


# -- 3. MAUS, the BAS web service (network) -----------------------------------

MAUS_BASE = "https://clarin.phonetik.uni-muenchen.de/BASWebServices/services"


def _requests():
    try:
        import requests
    except ImportError as e:
        raise ImportError("the MAUS client needs the 'requests' package, "
                          "which is not installed") from e
    return requests


def maus_g2p(audio_path, txt_path, language: str = "eng") -> str:
    """G2P and forced alignment of one utterance through BAS CLARIN's
    ``runPipeline`` (refused while the server's load indicator reads 2);
    returns the TextGrid's download link. Needs the network and the
    ``requests`` package."""
    import xml.etree.ElementTree as et

    requests = _requests()
    status = requests.get(f"{MAUS_BASE}/getLoadIndicator", timeout=30)
    if status.status_code == 200 and status.text.strip() == "2":
        raise RuntimeError("MAUS server load is too high")
    with open(audio_path, "rb") as a_f, open(txt_path, "rb") as t_f:
        res = requests.post(
            f"{MAUS_BASE}/runPipeline",
            files={
                "SIGNAL": a_f,
                "TEXT": t_f,
                "PIPE": (None, "G2P_MAUS"),
                "LANGUAGE": (None, language),
                "OUTFORMAT": (None, "TextGrid"),
                "OUTSYMBOL": (None, "ipa"),
                "USETEXTENHANCE": (None, "false"),
            },
            timeout=600,
        )
    res.raise_for_status()
    return et.fromstring(res.text).find("downloadLink").text


def run_maus_alignment(prep_path, replace: bool = False,
                       language: str = "eng") -> int:
    """Every wav of the tree aligned through MAUS into
    ``<spk>/phonemes/<utt>.TextGrid``; files that exist are kept unless
    ``replace``. Returns the number downloaded. Needs the network and the
    ``requests`` package."""
    requests = _requests()
    downloaded = 0
    for spk_dir in sorted(p for p in Path(prep_path).iterdir() if p.is_dir()):
        audio_dir = spk_dir / "audio"
        if not audio_dir.exists():
            continue
        phn_dir = spk_dir / "phonemes"
        phn_dir.mkdir(exist_ok=True)
        for wav in sorted(audio_dir.glob("*.wav")):
            target = phn_dir / (wav.stem + ".TextGrid")
            if target.exists() and not replace:
                continue
            link = maus_g2p(wav, spk_dir / "text" / (wav.stem + ".txt"),
                            language=language)
            res = requests.get(link, allow_redirects=True, timeout=120)
            res.raise_for_status()
            target.write_bytes(res.content)
            downloaded += 1
    return downloaded


# -- 8. Manifest --------------------------------------------------------------

MANIFEST_COLUMNS = (
    "index", "path_wav", "speaker", "text", "phoneme_labels",
    "phoneme_timestamps", "rate", "path_tvs", "path_tvs_49hz",
    "path_tvs_norm", "path_tvs_norm_49hz", "path_mspec", "path_mfccs",
    "path_f0")


def build_hprc_csv(prep_path) -> Path:
    """``<prep>/hprc.csv``: a row for every first repetition (``R01``)
    wav, with its text, the MAUS phonemes and their boundaries (the
    starts, then the last end) and the paths of its pickles."""
    prep_path = Path(prep_path)
    rows, index = [], 0
    for spk_dir, wav in _iter_speaker_wavs(prep_path):
        if "R01" not in wav.stem:
            continue
        name = wav.stem
        text = (spk_dir / "text" / (name + ".txt")).read_text().rstrip()
        labels, ts_tuples = textgrid_phonemes(
            spk_dir / "phonemes" / (name + ".TextGrid"))
        timestamps = [t[0] for t in ts_tuples] + [ts_tuples[-1][1]]
        rows.append([
            index, str(wav), spk_dir.name, text, " ".join(labels), timestamps,
            name[-1],
            *(str(spk_dir / sub / (name + ".pkl")) for sub in (
                "tvs", "tvs_49hz", "tvs_norm", "tvs_norm_49hz", "mspec",
                "mfccs", "f0")),
        ])
        index += 1
    out = prep_path / "hprc.csv"
    with open(out, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f)
        w.writerow(MANIFEST_COLUMNS)
        w.writerows(rows)
    return out


def add_phn_frames_to_csv(csv_path, vocab: Dict[str, int],
                          cfg: Optional[Wav2Vec2Config] = None) -> None:
    """Add the ``phn_frames_49hz`` column: each row's phonemes as ids of
    ``vocab`` without the blank (so id 0, the CE ignore index, never is a
    target), one per encoder frame. The file is rewritten as pandas'
    ``to_csv(index=False)`` rewrites it."""
    rows = read_rows(csv_path)
    vocab_noblank = {k: v for k, v in vocab.items() if k != "(blank)"}
    for row in rows:
        ids = phonemes_to_ids(vocab_noblank, row["phoneme_labels"])
        audio, _ = load_wav(row["path_wav"])
        ts = ast.literal_eval(str(row["phoneme_timestamps"]))
        row["phn_frames_49hz"] = phoneme_frame_labels(ts, ids, len(audio), cfg)
    write_rows(csv_path, rows)


# -- corpus walkers (steps 2, 4-7 over a prepared tree) and prepare_hprc ------

def write_lowpass_ema(prep_path, replace: bool = False) -> int:
    """Every ``<spk>/ema/`` pickle, the palate's too, NaN-interpolated and
    low-passed into ``<spk>/ema_low/``; returns the number written."""
    written = 0
    for spk_dir in sorted(p for p in Path(prep_path).iterdir() if p.is_dir()):
        ema_dir = spk_dir / "ema"
        if not ema_dir.exists():
            continue
        for pkl in sorted(ema_dir.glob("*.pkl")):
            target = spk_dir / "ema_low" / pkl.name
            if target.exists() and not replace:
                continue
            _dump(target, lowpass_ema_dict(_load_pkl(pkl)))
            written += 1
    return written


def write_tvs(prep_path, lowpass: bool = True, replace: bool = False) -> int:
    """The 9 TVs of every utterance into ``<spk>/tvs/``, from
    ``ema_low`` (``ema`` when not ``lowpass``), with the speaker's sensor-x
    medians over all its utterances and its palate trace; returns the
    number written."""
    written = 0
    for spk_dir in sorted(p for p in Path(prep_path).iterdir() if p.is_dir()):
        ema_dir = spk_dir / ("ema_low" if lowpass else "ema")
        if not ema_dir.exists():
            continue
        palate_pkl = ema_dir / f"{spk_dir.name}_palate.pkl"
        utt_pkls = [p for p in sorted(ema_dir.glob("*.pkl"))
                    if "palate" not in p.name]
        if not palate_pkl.exists() or not utt_pkls:
            continue
        palate = _load_pkl(palate_pkl)
        emas = [_load_pkl(p) for p in utt_pkls]
        medians = dict(
            median_llx=median_sensor_x(emas, "LL"),
            median_ttx=median_sensor_x(emas, "TT"),
            median_tbx=median_sensor_x(emas, "TB"),
            median_trx=median_sensor_x(emas, "TR"),
        )
        for pkl, ema in zip(utt_pkls, emas):
            target = spk_dir / "tvs" / pkl.name
            if target.exists() and not replace:
                continue
            _dump(target, compute_tvs(ema, palate, **medians))
            written += 1
    return written


def _utt_rate(name: str) -> str:
    return name.rsplit("_", 1)[-1].split(".")[0]


def write_tv_norm(prep_path, scheme: str = "zscore_utterance",
                  rate: str = "both", replace: bool = False) -> int:
    """Every TV pickle normalised into ``<spk>/tvs_norm/`` by ``scheme``
    (:data:`NORM_SCHEMES`; the global one's stats from the utterances of
    ``rate``, read from the file names); returns the number written."""
    prep_path = Path(prep_path)
    spk_dirs = sorted(p for p in prep_path.iterdir() if p.is_dir())
    if scheme == "minmax_zscore_global":
        pkls = [p for d in spk_dirs for p in sorted((d / "tvs").glob("*.pkl"))]
        gstats = global_stats([_load_pkl(p) for p in pkls],
                              [_utt_rate(p.stem) for p in pkls], rate)

    written = 0
    for spk_dir in spk_dirs:
        tvs_dir = spk_dir / "tvs"
        if not tvs_dir.exists():
            continue
        pkls = sorted(tvs_dir.glob("*.pkl"))
        if scheme in ("minmax_speaker", "zscore_speaker"):
            smin, smax, smean, sstd = speaker_stats(
                [_load_pkl(p) for p in pkls])
        for pkl in pkls:
            target = spk_dir / "tvs_norm" / pkl.name
            if target.exists() and not replace:
                continue
            tvs = _load_pkl(pkl)
            if scheme == "zscore_utterance":
                norm = zscore_utterance(tvs)
            elif scheme == "minmax_speaker":
                norm = minmax_speaker(tvs, smin, smax)
            elif scheme == "zscore_speaker":
                norm = zscore_speaker(tvs, smean, sstd)
            elif scheme == "minmax_zscore_global":
                norm = minmax_zscore_global(tvs, *gstats)
            else:
                raise ValueError(f"unknown normalization scheme {scheme!r}")
            _dump(target, norm)
            written += 1
    return written


def write_tvs_49hz(prep_path, cfg: Optional[Wav2Vec2Config] = None,
                   replace: bool = False) -> int:
    """Raw and normalised TVs resampled to the encoder's frame count of
    their wav, into ``<spk>/tvs_49hz/`` and ``<spk>/tvs_norm_49hz/``;
    returns the number written."""
    written = 0
    for spk_dir, wav_path in _iter_speaker_wavs(prep_path):
        name = wav_path.stem + ".pkl"
        n_samples = None
        for src, dst in (("tvs", "tvs_49hz"), ("tvs_norm", "tvs_norm_49hz")):
            src_pkl = spk_dir / src / name
            target = spk_dir / dst / name
            if not src_pkl.exists() or (target.exists() and not replace):
                continue
            if n_samples is None:
                n_samples = len(load_wav_16k(wav_path))
            _dump(target, interpolate_tvs_to_frames(
                _load_pkl(src_pkl), n_samples, cfg))
            written += 1
    return written


def prepare_hprc(
    raw_path=None,
    prep_path=None,
    norm_scheme: str = "zscore_utterance",
    norm_rate: str = "both",
    run_maus: bool = False,
    replace: bool = False,
    vocab_path=None,
    cfg: Optional[Wav2Vec2Config] = None,
    log=print,
    device=None,
) -> Path:
    """The eight steps of the module docstring in order, over ``raw_path``
    (step 1 is skipped without it) into ``prep_path`` (default
    ``<raw_path>_prep``); the spectrograms on ``device`` (the card by
    default). Every step keeps the files that exist unless ``replace``, so
    a second run resumes an interrupted one. The vocabulary is
    ``vocab_path`` when that file exists, else built from the manifest and
    saved as ``<prep>/vocab.json``. Returns the manifest's path."""
    if raw_path is None and prep_path is None:
        raise ValueError("need raw_path and/or prep_path")
    if prep_path is None:
        prep_path = Path(str(raw_path) + "_prep")
    prep_path = Path(prep_path)

    if raw_path is not None:
        log(f"[1/8] extract_mat {raw_path} -> {prep_path}")
        extract_mat(raw_path, prep_path)
    else:
        log("[1/8] extract_mat skipped (no raw_path)")

    log("[2/8] acoustic features (f0 + mspec + mfccs)")
    n = write_acoustic_features(prep_path, replace=replace, device=device)
    log(f"      {n} utterances")

    if run_maus:
        log("[3/8] MAUS forced alignment (network)")
        n = run_maus_alignment(prep_path, replace=replace)
        log(f"      {n} TextGrids downloaded")
    else:
        log("[3/8] MAUS skipped (using existing <spk>/phonemes/ TextGrids)")

    log("[4/8] EMA low-pass")
    log(f"      {write_lowpass_ema(prep_path, replace=replace)} pickles")

    log("[5/8] tract variables")
    log(f"      {write_tvs(prep_path, replace=replace)} pickles")

    log(f"[6/8] TV normalization ({norm_scheme}, rate={norm_rate})")
    log(f"      {write_tv_norm(prep_path, norm_scheme, norm_rate, replace)}"
        " pickles")

    log("[7/8] 49 Hz interpolation")
    log(f"      {write_tvs_49hz(prep_path, cfg, replace=replace)} pickles")

    log("[8/8] manifest + frame labels")
    csv_path = build_hprc_csv(prep_path)
    if vocab_path is not None and Path(vocab_path).exists():
        vocab = load_vocab(vocab_path)
    else:
        vocab = build_vocab(r["phoneme_labels"] for r in read_rows(csv_path))
        save_vocab(vocab, prep_path / "vocab.json")
    add_phn_frames_to_csv(csv_path, vocab, cfg)
    log(f"      {csv_path}")
    return csv_path


def main(argv=None):
    import argparse

    from aptai_tpu_torch.train.config import PLATFORMS, run_device

    ap = argparse.ArgumentParser(
        prog="python -m aptai_tpu_torch.data.hprc_prep",
        description="HPRC preparation: the raw .mat release to hprc.csv")
    ap.add_argument("raw", nargs="?", default=None,
                    help="raw HPRC release (.mat tree); omit with --prep to "
                         "resume on an already-extracted tree")
    ap.add_argument("--prep", default=None,
                    help="prepared output tree (default: <raw>_prep)")
    ap.add_argument("--norm", default="zscore_utterance", choices=NORM_SCHEMES,
                    help="TV normalization scheme")
    ap.add_argument("--norm_rate", default="both", choices=["N", "F", "both"],
                    help="rate constraint for the global scheme's stats")
    ap.add_argument("--run_maus", action="store_true",
                    help="call the MAUS BAS web service (network)")
    ap.add_argument("--replace", action="store_true",
                    help="recompute outputs that already exist")
    ap.add_argument("--vocab", default=None,
                    help="vocab.json for frame labels (default: built from "
                         "the manifest and saved to <prep>/vocab.json)")
    ap.add_argument("--platform", default="auto",
                    help=f"device of the spectrograms, one of {PLATFORMS}: "
                         "'auto' is the card (it raises without one), 'cpu' "
                         "the CPU")
    args = ap.parse_args(argv)
    try:
        device = run_device(args)
    except ValueError as e:
        ap.error(str(e))
    t0 = time.perf_counter()
    csv_path = prepare_hprc(args.raw, args.prep, args.norm, args.norm_rate,
                            run_maus=args.run_maus, replace=args.replace,
                            vocab_path=args.vocab, device=device)
    print(f"prepared {csv_path} on {device} in "
          f"{time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
