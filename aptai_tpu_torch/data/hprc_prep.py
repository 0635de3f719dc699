"""The parts of the HPRC preparation (the JAX package's
``data/hprc_prep.py``) that the synthetic corpus needs: the per-utterance
TV z-score, the encoder's frame count, TVs resampled to the frame rate and
the frame-level phoneme labels.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from aptai_tpu_torch.models.configs import Wav2Vec2Config


def zscore_utterance(tvs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-utterance z-score of each TV; the NaNs of a constant TV become
    0."""
    out = {}
    for k, v in tvs.items():
        v = np.asarray(v, np.float64)
        out[k] = np.nan_to_num((v - np.nanmean(v)) / np.nanstd(v), nan=0.0)
    return out


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
