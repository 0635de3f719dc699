"""aptai_tpu_torch FIR low-pass against the JAX package: float64 taps and
the float32 depthwise 'same' filter over (B, T, 9)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.ops import fir as jfir
from aptai_tpu_torch.ops import fir as tfir


@pytest.mark.parametrize("cutoff,rate", [(10.0, 49.0), (10.0, 100.0),
                                         (5.0, 49.0), (24.5, 49.0)])
def test_taps_match_jax(cutoff, rate):
    got = tfir.lowpass_fir_taps(cutoff, rate)
    want = jfir.lowpass_fir_taps(cutoff, rate)
    assert got.dtype == np.float64 and got.shape == (51,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_taps_reject_cutoff_above_nyquist():
    with pytest.raises(ValueError):
        tfir.lowpass_fir_taps(30.0, 49.0)


@pytest.mark.parametrize("t", [7, 60, 499])
def test_filter_matches_jax(t):
    """Short (T < taps), medium and serving-length trajectories, one with
    a flat tail like a padded batch item."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t, 9)).astype(np.float32)
    x[2, t // 2:] = 0.0
    taps = tfir.lowpass_fir_taps(10.0, 49.0)
    got = tfir.fir_lowpass(torch.from_numpy(x),
                           torch.tensor(taps, dtype=torch.float32))
    want = np.asarray(jfir.fir_lowpass(jnp.asarray(x), taps))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
