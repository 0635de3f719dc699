"""aptai_tpu_torch's C++ beam search (``decode/native.py``) against the
port's Python beam and the JAX package's pure-Python one (same ids and
timesteps), and the native-first decoders without the library."""

import numpy as np
import pytest

from aptai_tpu.decode.beam import beam_search as jax_beam_search
from aptai_tpu_torch.decode import beam as tbeam
from aptai_tpu_torch.decode import native


@pytest.fixture(scope="module")
def lib():
    assert native.native_available(), native.build_error()
    return native


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_beam_matches_python_beams(lib, seed):
    """On random (T, V) log-probs (and, seed 3, a peaked distribution with
    repeats), the C++ beam's ids and timesteps equal the port's Python
    beam's and the JAX package's."""
    rng = np.random.default_rng(seed)
    t, v = (30, 8) if seed < 3 else (60, 12)
    logits = rng.standard_normal((t, v)).astype(np.float32)
    if seed == 3:
        logits *= 4.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    before = lib.beam_search_native.calls
    toks, times = lib.beam_search_native(lp)
    assert lib.beam_search_native.calls == before + 1
    assert toks, "the test needs a non-empty decode"
    for hyp in (tbeam.beam_search(lp)[0], jax_beam_search(lp)[0]):
        assert toks == list(hyp.tokens)
        assert times == list(hyp.timesteps)
    assert tbeam.decode_with_times(lp) == (toks, times)
    assert tbeam.decode_best(lp) == toks


def test_decoders_fall_back_to_python_without_the_library(monkeypatch):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((20, 6)).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    monkeypatch.setattr(native, "_load", lambda: None)
    calls = native.beam_search_native.calls
    assert native.beam_search_native(lp) is None
    hyp = tbeam.beam_search(lp)[0]
    assert tbeam.decode_best(lp) == list(hyp.tokens)
    assert tbeam.decode_with_times(lp) == (list(hyp.tokens),
                                           list(hyp.timesteps))
    assert native.edit_distance([1, 2, 3], [1, 3]) == 1
    assert native.beam_search_native.calls == calls
