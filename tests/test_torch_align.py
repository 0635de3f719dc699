"""aptai_tpu_torch's monotonic alignment (``ops/align.py``) against the
JAX package's: ``viterbi_align`` at ragged text and frame lengths
(text length 1, a text as long as its frames, and ties between staying
and advancing included) and ``dtw_force_align`` on the host. Tolerance:
none; the positions are integers and must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aptai_tpu.ops.align import dtw_force_align as jax_dtw
from aptai_tpu.ops.align import viterbi_align as jax_viterbi
from aptai_tpu_torch.ops.align import dtw_force_align, viterbi_align


def _case(seed, quantised):
    """(B 5, T 24, N 7) scores with text lengths 7, 4, 1, 6, 3 and frame
    lengths 24, 17, 5, 6, 11; ``quantised`` rounds the scores to halves,
    so many sums tie exactly."""
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((5, 24, 7)).astype(np.float32)
    if quantised:
        scores = np.round(scores * 2) / 2
    return (scores, np.array([7, 4, 1, 6, 3], np.int32),
            np.array([24, 17, 5, 6, 11], np.int32))


@pytest.mark.parametrize("quantised", [False, True])
def test_viterbi_align_matches_jax(quantised):
    scores, text, frames = _case(11, quantised)
    want = np.asarray(jax.jit(jax_viterbi)(
        jnp.asarray(scores), jnp.asarray(text), jnp.asarray(frames)))
    got = viterbi_align(torch.from_numpy(scores), torch.from_numpy(text),
                        torch.from_numpy(frames))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(len(text)):
        n = frames[b]
        assert got[b, 0] == 0 and (got[b, n - 1:] == text[b] - 1).all()
        # without ties, the path is the DTW path of the valid block (on a
        # tie Viterbi stays and DTW's backtrace advances, in both packages)
        if not quantised:
            assert got[b, :n].tolist() == dtw_force_align(
                scores[b, :n], list(range(text[b])))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dtw_force_align_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cost = rng.standard_normal((30, 8))
    if seed == 2:
        cost = np.round(cost)  # ties between staying and advancing
    ids = [2, 5, 1, 7, 0, 5][:3 + seed]
    assert dtw_force_align(cost, ids) == jax_dtw(cost, ids)
    with pytest.raises(ValueError, match="infeasible"):
        dtw_force_align(cost[:2], ids)
