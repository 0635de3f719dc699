"""Build and load the package's CUDA kernels.

Each kernel is a ``.cu`` file under ``aptai_tpu_torch/csrc`` with a plain C
interface. ``nvcc`` compiles it for ``sm_90a`` into a shared library at
first use, and ``ctypes`` loads it. Nothing here runs at import time, and
nothing here includes PyTorch's headers, so a build takes seconds.

Libraries go to ``aptai_tpu_torch/_build`` (ignored by git), named by a hash
of the sources, the headers and the flags: an edited source builds anew, an
unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# kernel name -> its translation unit(s) under csrc/
SOURCES: Dict[str, tuple] = {
    "flash_attn_fwd": ("flash_attn_fwd.cu",),
    "flash_attn_bwd": ("flash_attn_bwd.cu",),
    "fused_conv_ln_gelu": ("fused_conv_ln_gelu.cu",),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the built library for kernel ``name`` lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        digest.update((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build every named kernel (all by default) that is not built yet,
    one ``nvcc`` process per kernel, all started together. Returns each
    kernel's compiler output ("" for one already built); raises
    ``RuntimeError`` with that output if a build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _libs_lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def kernel_fn(lib_name: str, fn_name: str, argtypes):
    """The C entry point ``fn_name`` of kernel library ``lib_name``, with
    its ctypes signature set (an int CUDA error code is returned)."""
    fn = getattr(load(lib_name), fn_name)  # one object per name
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def launch(fn, name: str, device, args) -> None:
    """Call a kernel entry point on ``device``'s current stream (passed as
    the last argument); raise if it returns a CUDA error."""
    with torch.cuda.device(device):  # the runtime launches on the current one
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
