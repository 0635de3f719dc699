"""Windowed-sinc FIR low-pass filtering for tract-variable smoothing.

Taps follow ``LowPassFilterLayer``: cutoff ``fc = cutoff / sampling_rate``
(at most 0.5), transition band 0.08 of the sampling rate, window length
``ceil(4 / 0.08) = 50 → 51`` (forced odd), ``h[n] = sinc(2 fc (n − 25)) ·
hann(n)`` normalised to sum 1. They are designed in float64 on the host and
applied as one depthwise 'same' convolution in float32 over every channel,
with 25 zeros on each side of the time axis.
"""

from __future__ import annotations

import numpy as np
import torch


def lowpass_fir_taps(
    cutoff: float,
    sampling_rate: float,
    transition_band: float = 0.08,
) -> np.ndarray:
    """Design windowed-sinc low-pass taps (float64 numpy, host-side)."""
    fc = cutoff / sampling_rate
    if fc > 0.5:
        raise ValueError(
            "Cutoff frequency must be at most half the sampling rate "
            f"(got fc={fc})."
        )
    n_taps = int(np.ceil(4 / transition_band))
    if n_taps % 2 == 0:
        n_taps += 1  # odd length so 'same' padding is symmetric
    n = np.arange(n_taps)
    h = np.sinc(2 * fc * (n - (n_taps - 1) / 2))
    w = 0.5 * (1 - np.cos(2 * np.pi * n / (n_taps - 1)))  # Hann window
    h = h * w
    return h / np.sum(h)


def fir_lowpass(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Apply shared FIR taps to every channel of ``x``.

    Args:
      x: ``(B, T, C)`` trajectories (the (B, T, 9) TVs), any float dtype.
      taps: ``(N,)`` float32 taps from :func:`lowpass_fir_taps`, N odd.

    Returns ``(B, T, C)`` float32. The filter runs over the whole time axis
    given, pad frames included. The taps are symmetric, so correlation and
    convolution agree. The windows are gathered with ``unfold`` and reduced
    with a float32 matrix-vector product, which stays in full float32 on the
    GPU (a cuDNN convolution would default to TF32 there).
    """
    half = taps.shape[0] // 2
    x32 = x.float()
    padded = torch.nn.functional.pad(x32, (0, 0, half, half))  # (B, T+N-1, C)
    windows = padded.unfold(1, taps.shape[0], 1)               # (B, T, C, N)
    return windows @ taps.to(device=x.device, dtype=torch.float32)
