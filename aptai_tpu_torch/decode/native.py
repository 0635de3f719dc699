"""ctypes bindings of the C++ host helpers in ``native/aptai_native.cpp``:
the Levenshtein distance (the PER numerator) and the CTC prefix beam search
(the JAX package's ``decode/native.py``).

``g++`` compiles ``native/aptai_native.cpp`` alone (not the HTTP server
beside it) into ``aptai_tpu_torch/_build/`` at first use, through
:mod:`aptai_tpu_torch.utils.cxx_build` (named by a hash of the source and
the flags, written atomically).

Without a compiler the functions fall back to their pure-Python versions,
as the JAX package's do: :func:`beam_search_native` returns None and the
callers use :mod:`aptai_tpu_torch.decode.beam`.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from aptai_tpu_torch.utils import cxx_build

SOURCE = cxx_build.NATIVE_DIR / "aptai_native.cpp"
BUILD_DIR = cxx_build.BUILD_DIR
CXX_FLAGS = cxx_build.CXX_FLAGS

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def library_path():
    """Where the built library lives: keyed by the source and the flags."""
    return cxx_build.library_path(SOURCE, "libaptai_native", BUILD_DIR,
                                  CXX_FLAGS)


def _build(out) -> None:
    cxx_build.build(SOURCE, out, CXX_FLAGS)


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if it cannot be
    built (the reason in :func:`build_error`)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            _build_error = str(e)
            return None
        lib.aptai_edit_distance.restype = ctypes.c_int64
        lib.aptai_edit_distance.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib.aptai_ctc_beam_search.restype = ctypes.c_int64
        lib.aptai_ctc_beam_search.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Load the library (building it if needed) and say why that failed:
    None if it loaded."""
    _load()
    return _build_error


def _int32_ptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _edit_distance_py(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance in numpy (the fallback of the C++ one)."""
    a = list(a)
    b = list(b)
    if not a:
        return len(b)
    if not b:
        return len(a)
    bb = np.asarray(b)
    prev = np.arange(len(b) + 1)
    for i, ai in enumerate(a, start=1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (bb != ai)
        np.minimum(sub, prev[1:] + 1, out=sub)
        cur[1:] = sub
        for j in range(1, len(b) + 1):  # the insertion chain
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[-1])


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance over token ids (``editdistance.eval``)."""
    lib = _load()
    an = np.ascontiguousarray(np.asarray(a, np.int32))
    bn = np.ascontiguousarray(np.asarray(b, np.int32))
    if lib is None:
        return _edit_distance_py(an.tolist(), bn.tolist())
    return int(lib.aptai_edit_distance(_int32_ptr(an), len(an),
                                       _int32_ptr(bn), len(bn)))


def beam_search_native(log_probs: np.ndarray, blank: int = 0,
                       beam_size: int = 10, beam_threshold: float = 50.0
                       ) -> Optional[Tuple[List[int], List[int]]]:
    """The C++ beam search over (T, V) log-probs: ``(tokens, timesteps)``
    of the best beam, or None without the library (the caller then uses
    :func:`aptai_tpu_torch.decode.beam.beam_search`). Each call into the
    library adds one to ``beam_search_native.calls``."""
    lib = _load()
    if lib is None:
        return None
    lp = np.ascontiguousarray(np.asarray(log_probs, np.float32))
    if lp.ndim != 2:
        raise ValueError(f"log_probs must be (T, V), got {lp.shape}")
    t, v = lp.shape
    max_out = t + 1
    toks = np.zeros(max_out, np.int32)
    times = np.zeros(max_out, np.int32)
    n = lib.aptai_ctc_beam_search(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, v, blank,
        beam_size, beam_threshold, _int32_ptr(toks), _int32_ptr(times),
        max_out)
    beam_search_native.calls += 1
    return toks[:n].tolist(), times[:n].tolist()


beam_search_native.calls = 0
