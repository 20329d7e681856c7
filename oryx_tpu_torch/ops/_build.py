"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for ``sm_90a``,
into its own shared library under ``build/`` at the checkout's root (listed
in ``.gitignore``), and is bound with ``ctypes`` through a plain C
interface: no PyTorch headers, so a build takes seconds, not minutes. The
library's file name carries a hash of its source, so an edited kernel is
rebuilt and a stale one is never loaded. Only sources in the checkout are
used; a failed build raises.

:func:`build_all` starts one ``nvcc`` per source at once, so the whole build
takes as long as the slowest file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("gather_gramian", "spd_solve", "kmeans_assign")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> "tuple[subprocess.Popen, Path, Path]":
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name and rename: a half-written library is never
    # found under the final name
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> list[str]:
    """Build every named kernel whose library is missing, all ``nvcc``
    processes at once. Returns the names that were built."""
    with _lock:
        pending = [n for n in names if not _lib_path(n).exists()]
        started = [(n, *_start(n)) for n in pending]
        try:
            for n, proc, tmp, out in started:
                _finish(n, proc, tmp, out)
        finally:
            for _, proc, _, _ in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return pending


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            _loaded[name] = lib
    return lib
