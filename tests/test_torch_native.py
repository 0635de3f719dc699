"""aptai_tpu_torch's C++ host helpers (``decode/native.py``): the edit
distance against its numpy twin and known cases, the beam search against
the port's Python beam and the JAX package's pure-Python one (same ids and
timesteps), the native-first decoders, and where the library is built.

The JAX package's own native binding is left alone here: it builds with
``make -C native`` into the JAX tree."""

import numpy as np
import pytest

from aptai_tpu.decode.beam import beam_search as jax_beam_search
from aptai_tpu_torch.decode import beam as tbeam
from aptai_tpu_torch.decode import native


@pytest.fixture(scope="module")
def lib():
    assert native.native_available(), native.build_error()
    return native


@pytest.mark.parametrize("a, b, want", [
    ([], [], 0), ([], [1, 2], 2), ([3, 4, 5], [], 3), ([1, 2, 3], [1, 2, 3], 0),
    ([1, 2, 3], [1, 3], 1), ([1, 2, 3], [3, 2, 1], 2), ([7], [8], 1),
    ([1, 1, 2, 2], [2, 2, 1, 1], 4), ([5, 6, 7, 8], [6, 7, 8, 9], 2)])
def test_edit_distance_known_cases(lib, a, b, want):
    assert lib.edit_distance(a, b) == want
    assert lib._edit_distance_py(a, b) == want


def test_edit_distance_matches_numpy_twin(lib):
    rng = np.random.default_rng(0)
    for _ in range(200):
        a = rng.integers(0, 6, rng.integers(0, 25)).tolist()
        b = rng.integers(0, 6, rng.integers(0, 25)).tolist()
        d = lib.edit_distance(a, b)
        assert d == lib._edit_distance_py(a, b) == lib.edit_distance(b, a)
        assert abs(len(a) - len(b)) <= d <= max(len(a), len(b))


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


def test_library_is_built_in_the_port_tree_keyed_by_source(lib):
    path = lib.library_path()
    assert path.parent == lib.BUILD_DIR
    assert path.parent.parent.name == "aptai_tpu_torch"
    assert path.exists() and path.name.startswith("libaptai_native-")
    assert lib.SOURCE.name == "aptai_native.cpp"
    assert "-march=native" not in lib.CXX_FLAGS
    with pytest.raises(ValueError, match=r"\(T, V\)"):
        lib.beam_search_native(np.zeros(5, np.float32))
