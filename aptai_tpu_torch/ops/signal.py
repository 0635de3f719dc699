"""Audio and DSP ops (the JAX package's ``ops/signal.py``): STFT, mel,
MFCC, resampling, zero-phase IIR filtering and interpolation.

The tensor ops compute on their input's device; filter coefficients, mel
and DCT matrices and the resampling kernel are float64 numpy constants
made on the host. Contracts:

* :func:`stft_magnitude` — reflect padding of ``n_fft // 2``, periodic
  Hann, hop 256, |rfft|;
* :func:`melspectrogram` — Slaney mel (fmin 90, fmax 7600, 80 bands), dB
  floor 1e-5, ``(20·log10(·) − 16 + 100) / 100``;
* :func:`mfcc` — power mel → dB (top 80 dB kept, per item) → orthonormal
  DCT-II;
* :func:`resample` — torchaudio's ``resample`` defaults (windowed sinc,
  ``lowpass_filter_width=6``, ``rolloff=0.99``, Hann) as one strided
  convolution;
* :func:`filtfilt` — ``scipy.signal.filtfilt`` with its defaults
  (odd padding of 3·taps, ``lfilter_zi`` initial states), the
  direct-form-II-transposed recursion a loop over samples (offline prep).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


# -- STFT / mel / MFCC ---------------------------------------------------------

def _hann_periodic(n: int) -> np.ndarray:
    """Periodic Hann (scipy ``get_window('hann', n, fftbins=True)``)."""
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def stft_magnitude(x: torch.Tensor, n_fft: int = 1024,
                   hop_length: int = 256) -> torch.Tensor:
    """Magnitude STFT of ``x`` (..., L): (..., n_frames, n_fft//2 + 1) with
    ``n_frames = (L + 2·(n_fft//2) − (n_fft − hop)) // hop``."""
    pad = n_fft // 2
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    frames = xp[:, 0].unfold(-1, n_fft, hop_length)
    window = torch.as_tensor(_hann_periodic(n_fft), dtype=x.dtype,
                             device=x.device)
    spec = torch.fft.rfft(frames * window, n=n_fft).abs()
    return spec.reshape(lead + spec.shape[1:])


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    safe_f = np.maximum(f, min_log_hz)  # no log(0) in the unused branch
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(safe_f / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_filterbank(sr: int = 16_000, n_fft: int = 1024, n_mels: int = 80,
                   fmin: float = 90.0, fmax: float = 7600.0) -> np.ndarray:
    """librosa's Slaney-normalised mel filterbank (``htk=False,
    norm='slaney'``), ``(n_mels, n_fft//2 + 1)`` float64."""
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    return weights * enorm[:, None]


def _constant(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def melspectrogram(x: torch.Tensor, sr: int = 16_000, n_fft: int = 1024,
                   hop_length: int = 256, n_mels: int = 80,
                   fmin: float = 90.0, fmax: float = 7600.0) -> torch.Tensor:
    """Normalised log-mel of ``x`` (..., L): (..., n_frames, n_mels) in
    about [0, 1]."""
    basis = _constant(mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T, x)
    stft = stft_magnitude(x.float(), n_fft, hop_length)
    # 10^(-100/20) evaluated in float32 as the reference does
    min_level = torch.exp(-100 / 20 * torch.log(torch.tensor(10.0)))
    stft_db = 20 * torch.log10(torch.clamp(stft @ basis,
                                           min=min_level.item())) - 16
    return (stft_db + 100) / 100


def _dct_ii_ortho_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (scipy ``dct(type=2, norm='ortho')``)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    mat[0] *= 1 / np.sqrt(2)
    return mat


def mfcc(x: torch.Tensor, sr: int = 16_000, n_mfcc: int = 13,
         n_fft: int = 1024, hop_length: int = 256, n_mels: int = 80,
         fmin: float = 0.0, fmax: float | None = None) -> torch.Tensor:
    """MFCCs of ``x`` (..., L): power mel → dB (librosa's ``power_to_db``,
    ref 1, amin 1e-10, top_db 80 below each item's maximum) → orthonormal
    DCT-II; (..., n_frames, n_mfcc)."""
    fmax = sr / 2 if fmax is None else fmax
    basis = _constant(mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T, x)
    melspec = stft_magnitude(x.float(), n_fft, hop_length) ** 2 @ basis
    log_spec = 10.0 * torch.log10(torch.clamp(melspec, min=1e-10))
    top = log_spec.amax(dim=(-2, -1), keepdim=True) - 80.0
    log_spec = torch.maximum(log_spec, top)
    return log_spec @ _constant(_dct_ii_ortho_matrix(n_mfcc, n_mels), x).T


# -- resampling (torchaudio's sinc_interp_hann) --------------------------------

@functools.lru_cache(maxsize=32)
def _resample_kernel(orig_freq: int, new_freq: int,
                     lowpass_filter_width: int = 6,
                     rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """Polyphase windowed-sinc kernel ``(new_freq, 2·width + orig_freq)``
    float32, and ``width`` (torchaudio's ``_get_sinc_resample_kernel``,
    Hann window)."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * (base_freq / orig_freq)
    return kernel.astype(np.float32), width


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """Resample ``x`` (..., L) float32: one strided convolution over the
    polyphase filter bank, ``ceil(new · L / orig)`` samples out."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    kernel, width = _resample_kernel(orig, new, lowpass_filter_width, rolloff)
    length = x.shape[-1]
    xf = F.pad(x.reshape(-1, 1, length).float(), (width, width + orig))
    out = F.conv1d(xf, _constant(kernel, x)[:, None, :], stride=orig)
    out = out.transpose(1, 2).reshape(len(xf), -1)
    out = out[:, :math.ceil(new * length / orig)]
    return out.reshape(x.shape[:-1] + (-1,))


# -- zero-phase IIR filtering (scipy's filtfilt) -------------------------------

def _lfilter(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
             zi: torch.Tensor) -> torch.Tensor:
    """Direct-form-II-transposed IIR filter of ``x`` (..., L) from the
    states ``zi`` (..., taps − 1)."""
    z = zi
    y = torch.empty_like(x)
    zero = torch.zeros_like(z[..., :1])
    for n in range(x.shape[-1]):
        x_n = x[..., n:n + 1]
        y_n = b[0] * x_n + z[..., :1]
        y[..., n] = y_n[..., 0]
        z = b[1:] * x_n - a[1:] * y_n + torch.cat([z[..., 1:], zero], -1)
    return y


def filtfilt(b, a, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase filtering of ``x`` (..., L) along its last axis;
    ``scipy.signal.filtfilt``'s defaults (``padtype='odd'``, ``padlen =
    3·max(len(a), len(b))``, no Gustafsson). ``b``, ``a``: the design's
    coefficients (e.g. ``scipy.signal.butter``), normalised here."""
    from scipy.signal import lfilter_zi

    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b, a = b / a[0], a / a[0]
    padlen = 3 * max(len(a), len(b))
    if x.shape[-1] <= padlen:
        raise ValueError("input too short for filtfilt padding")
    zi = torch.as_tensor(lfilter_zi(b, a), dtype=x.dtype, device=x.device)
    bt = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    at = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    first, last = x[..., :1], x[..., -1:]
    ext = torch.cat([2 * first - x[..., 1:padlen + 1].flip(-1), x,
                     2 * last - x[..., -padlen - 1:-1].flip(-1)], dim=-1)
    y = _lfilter(bt, at, ext, zi * ext[..., :1])
    y = _lfilter(bt, at, y.flip(-1), zi * y[..., -1:]).flip(-1)
    return y[..., padlen:-padlen]


def butter_lowpass_filtfilt(x: torch.Tensor, cutoff: float, fs: float,
                            order: int = 5) -> torch.Tensor:
    """A Butterworth low-pass designed on the host (scipy), applied with
    :func:`filtfilt`."""
    from scipy.signal import butter

    b, a = butter(order, cutoff / (0.5 * fs), btype="low", analog=False)
    return filtfilt(b, a, x)


# -- interpolation -------------------------------------------------------------

def interp1d_linear(x_new: torch.Tensor, x_old: torch.Tensor,
                    y_old: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of the 1-D ``(x_old, y_old)`` at ``x_new``,
    ``np.interp``'s contract: the end values outside ``x_old``'s range."""
    n = x_old.shape[0]
    i = torch.searchsorted(x_old, x_new, right=True).clamp(1, n - 1)
    x0, y0 = x_old[i - 1], y_old[i - 1]
    dx, dy = x_old[i] - x0, y_old[i] - y0
    # an interval narrower than the spacing of eps takes its left value
    flat = dx.abs() <= np.spacing(torch.finfo(x_old.dtype).eps)
    f = torch.where(flat, y0, y0 + (x_new - x0) / torch.where(
        flat, torch.ones_like(dx), dx) * dy)
    f = torch.where(x_new < x_old[0], y_old[0], f)
    return torch.where(x_new > x_old[-1], y_old[-1], f)


def interpolate_nan(sig: np.ndarray) -> np.ndarray:
    """pandas ``Series.interpolate()`` on the host: linear between valid
    samples, trailing NaNs filled with the last valid value, leading NaNs
    kept (offline EMA prep)."""
    sig = np.asarray(sig, dtype=np.float64)
    out = sig.copy()
    valid = ~np.isnan(sig)
    if not valid.any():
        return out
    idx = np.arange(len(sig))
    first, last = idx[valid][0], idx[valid][-1]
    interior = (idx >= first) & (idx <= last)
    out[interior] = np.interp(idx[interior], idx[valid], sig[valid])
    out[last:] = np.where(np.isnan(out[last:]), out[last], out[last:])
    return out
