"""The g++ build of the C++ host sources in ``native/``, each alone.

Each source compiles by itself (``native/Makefile`` links both sources into
the JAX package's tree; nothing here runs it) into
``aptai_tpu_torch/_build/``, named by a hash of the source and the flags.
The flags leave out ``-march=native``, so a checkout copied to another
machine never loads a library built for another CPU. Each build writes a
file of its own and renames it into place, so concurrent builds (test
workers) never see a partial library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def library_path(source: Path, stem: str, build_dir: Path = BUILD_DIR,
                 flags: Sequence[str] = CXX_FLAGS) -> Path:
    """Where the library of ``source`` built with ``flags`` lives:
    ``<build_dir>/<stem>-<hash>.so``."""
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(Path(source).read_bytes())
    return Path(build_dir) / f"{stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path, out: Path, flags: Sequence[str] = CXX_FLAGS) -> None:
    """``g++ <flags> -o out source`` (``$CXX`` if set), written to a file
    of this process and thread, then renamed to ``out``; raises
    RuntimeError with the compiler's output if it fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    res = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none
