"""Wav IO on the host and resampling to the 16 kHz model rate (the JAX
package's ``data/audio_io.py``): scipy's wav reader and a numpy polyphase
resampler over the same windowed-sinc kernel as
:func:`aptai_tpu_torch.ops.signal.resample`.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.io import wavfile

from aptai_tpu_torch import SAMPLE_RATE
from aptai_tpu_torch.ops.signal import _resample_kernel


def resample_np(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """numpy twin of ``ops.signal.resample`` (torchaudio's
    sinc_interp_hann), float32 out."""
    if orig_freq == new_freq:
        return x.astype(np.float32)
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    kernel, width = _resample_kernel(orig, new)  # (new, K)
    length = x.shape[-1]
    xp = np.pad(x.astype(np.float32), (width, width + orig))
    n_frames = (len(xp) - kernel.shape[1]) // orig + 1
    idx = (np.arange(kernel.shape[1])[None, :]
           + orig * np.arange(n_frames)[:, None])
    out = (xp[idx] @ kernel.T).reshape(-1)  # (frames, new) → samples
    return out[:math.ceil(new * length / orig)]


def load_wav(path):
    """A wav file → (float32 mono waveform in [-1, 1], sample rate)."""
    sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, int(sr)


def save_wav(path, data: np.ndarray, sr: int) -> None:
    wavfile.write(path, sr, np.asarray(data, dtype=np.float32))


def load_wav_16k(path) -> np.ndarray:
    """Load and resample to 16 kHz."""
    data, sr = load_wav(path)
    return resample_np(data, sr, SAMPLE_RATE)
