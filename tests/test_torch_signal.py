"""aptai_tpu_torch's signal ops (``ops/signal.py``) against the JAX
package's, on the CPU. Tolerances, each relative to the reference's
largest magnitude:

* STFT magnitude, log-mel and MFCC in float32: 1e-4 (FFT and matmul
  summation orders differ; log-mel and MFCC sit behind a log);
* ``resample`` (44.1 → 16 kHz, 8 → 16 kHz, and the numpy twin
  ``resample_np``): 1e-5 (float32 sums of ≤ 475 taps in other orders);
* ``filtfilt`` in float64: 1e-9 against ``scipy.signal.filtfilt`` and
  against the JAX twin run in float64;
* ``interp1d_linear`` in float64: 1e-12 against ``np.interp`` and the JAX
  twin; ``interpolate_nan`` and the filterbank and DCT constants equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from aptai_tpu.data.audio_io import resample_np as jax_resample_np
from aptai_tpu.ops import signal as js
from aptai_tpu_torch.data.audio_io import resample_np
from aptai_tpu_torch.ops import signal as ts

from _torch_port import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _speechlike(rng, n):
    t = np.arange(n) / 16_000
    x = 0.3 * np.sin(2 * np.pi * 300 * t) + 0.1 * np.sin(2 * np.pi * 2300 * t)
    return (x + 0.02 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("name", ["stft_magnitude", "melspectrogram",
                                  "mfcc"])
def test_spectral_ops_match_jax(name):
    """One utterance of 12,345 samples (an odd frame count), then the same
    op over a batch of two, whose second item is a quieter, other
    utterance: the MFCC's top-80-dB clamp takes each item's own
    maximum."""
    rng = np.random.default_rng(0)
    x = _speechlike(rng, 12_345)
    quiet = 0.01 * _speechlike(rng, 12_345)
    quiet[:4000] = 0.0  # frames far below the item's maximum
    jax_op, port_op = getattr(js, name), getattr(ts, name)
    want = [np.asarray(jax_op(jnp.asarray(a))) for a in (x, quiet)]
    assert _rel(port_op(torch.from_numpy(x)).numpy(), want[0]) <= 1e-4
    got = port_op(torch.from_numpy(np.stack([x, quiet]))).numpy()
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


@pytest.mark.parametrize("orig,new", [(44_100, 16_000), (8_000, 16_000)])
def test_resample_matches_jax(orig, new):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3001)).astype(np.float32)
    want = np.asarray(js.resample(jnp.asarray(x), orig, new))
    got = ts.resample(torch.from_numpy(x), orig, new).numpy()
    assert _rel(got, want) <= 1e-5
    assert _rel(ts.resample(torch.from_numpy(x[0]), orig, new).numpy(),
                want[0]) <= 1e-5
    np_want = jax_resample_np(x[0], orig, new)
    np.testing.assert_array_equal(resample_np(x[0], orig, new), np_want)
    assert _rel(np_want, want[0]) <= 1e-5
    same = torch.from_numpy(x)
    assert ts.resample(same, new, new) is same


def test_filtfilt_matches_scipy_and_jax_in_float64():
    """A 5th-order Butterworth low-pass (10 Hz at 100 Hz, the EMA prep's)
    over two channels of 400 samples."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 400))
    b, a = scipy.signal.butter(5, 10 / 50)
    want = scipy.signal.filtfilt(b, a, x)
    got = ts.filtfilt(b, a, torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-9
    with jax.enable_x64(True):
        jax_got = np.asarray(js.jax_filtfilt(b, a, jnp.asarray(x[0])))
    assert _rel(got[0].numpy(), jax_got) <= 1e-9
    lp = ts.butter_lowpass_filtfilt(torch.from_numpy(x[1]), 10.0, 100.0)
    assert _rel(lp.numpy(), want[1]) <= 1e-9
    with pytest.raises(ValueError, match="too short"):
        ts.filtfilt(b, a, torch.zeros(18, dtype=torch.float64))


def test_interpolation_matches_numpy_and_jax():
    rng = np.random.default_rng(3)
    x_old = np.sort(rng.uniform(0, 10, 20))
    x_old[5] = x_old[4]  # a zero-width interval
    y_old = rng.standard_normal(20)
    x_new = np.concatenate([rng.uniform(-1, 11, 60), x_old[[0, 4, -1]]])
    got = ts.interp1d_linear(*(torch.from_numpy(a)
                               for a in (x_new, x_old, y_old))).numpy()
    with jax.enable_x64(True):
        jax_got = np.asarray(js.interp1d_linear(x_new, x_old, y_old))
    assert _rel(got, np.interp(x_new, x_old, y_old)) <= 1e-12
    assert _rel(got, jax_got) <= 1e-12

    sig = rng.standard_normal(30)
    sig[[0, 1, 7, 8, 9, 20, 28, 29]] = np.nan
    np.testing.assert_array_equal(ts.interpolate_nan(sig),
                                  js.interpolate_nan(sig))
    np.testing.assert_array_equal(ts.mel_filterbank(), js.mel_filterbank())
    np.testing.assert_array_equal(ts._dct_ii_ortho_matrix(13, 80),
                                  js._dct_ii_ortho_matrix(13, 80))
