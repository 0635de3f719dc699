"""aptai_tpu_torch's C++ host helpers (``decode/native.py``): the edit
distance against its numpy twin and known cases, and where the library is
built. The beam search is in ``test_torch_native_beam.py``.

The JAX package's own native binding is left alone here: it builds with
``make -C native`` into the JAX tree."""

import numpy as np
import pytest

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


def test_library_is_built_in_the_port_tree_keyed_by_source(lib):
    path = lib.library_path()
    assert path.parent == lib.BUILD_DIR
    assert path.parent.parent.name == "aptai_tpu_torch"
    assert path.exists() and path.name.startswith("libaptai_native-")
    assert lib.SOURCE.name == "aptai_native.cpp"
    assert "-march=native" not in lib.CXX_FLAGS
    with pytest.raises(ValueError, match=r"\(T, V\)"):
        lib.beam_search_native(np.zeros(5, np.float32))
