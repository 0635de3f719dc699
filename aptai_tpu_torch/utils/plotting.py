"""Diagnostic plotting (the JAX package's ``utils/plotting.py``).

The reference's F0/waveform overlay (reference utility.py:367-390
``plot_f0_wav``): the F0 track (one value per ``hop_length`` samples) on a
red left axis over the waveform on a blue right axis. matplotlib is
imported inside the function, so importing this package never loads it.
"""

from __future__ import annotations

import numpy as np


def plot_f0_wav(f0, wav, fs: int, hop_length: int = 256, save_path=None):
    """Overlay an F0 contour on its waveform.

    Args:
      f0: (n_frames,) F0 values in Hz (e.g. from
        ``aptai_tpu_torch.data.hprc_prep.compute_f0_rapt``).
      wav: (n_samples,) waveform.
      fs: sample rate in Hz.
      hop_length: samples per F0 frame (the reference hard-codes 256).
      save_path: if given, save the figure there instead of ``plt.show()``.

    Returns the matplotlib figure.
    """
    import matplotlib

    if save_path is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    f0 = np.asarray(f0)
    wav = np.asarray(wav)
    time_f0 = np.arange(len(f0)) * hop_length / fs
    time_wav = np.arange(len(wav)) / fs

    fig, ax1 = plt.subplots(figsize=(12, 6))
    ax1.plot(time_f0, f0, label="F0", color="red", marker="o")
    ax1.set_ylabel("F0 (Hz)", color="red")
    ax1.tick_params(axis="y", labelcolor="red")
    ax1.grid(True)

    ax2 = ax1.twinx()
    ax2.plot(time_wav, wav, color="blue", alpha=0.5)
    ax2.set_ylabel("Amplitude", color="blue")
    ax2.tick_params(axis="y", labelcolor="blue")

    ax1.set_xlabel("Time (seconds)")
    ax1.set_title("Original Speech Signal with F0 Estimation")

    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    else:  # pragma: no cover - interactive display
        plt.show()
    return fig
