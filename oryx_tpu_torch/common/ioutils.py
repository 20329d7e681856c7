"""Filesystem + network IO helpers.

A copy of the JAX package's
``oryx_tpu/common/ioutils.py``
(host code, no JAX), held equal to it by ``tests/test_torch_mlupdate.py``.
Below, "the reference" is the original Oryx that module was modelled on.

Equivalent of the reference's IOUtils (framework/oryx-common/.../io/
IOUtils.java:51-142): recursive delete, glob listing, free-port chooser for
tests, close-quietly.
"""

from __future__ import annotations

import contextlib
import glob as _glob
import os
import shutil
import socket
from pathlib import Path


def delete_recursively(path: str | Path) -> None:
    p = Path(path)
    if p.is_dir() and not p.is_symlink():
        shutil.rmtree(p, ignore_errors=True)
    elif p.exists() or p.is_symlink():
        with contextlib.suppress(OSError):
            p.unlink()


def list_files(dir_path: str | Path, pattern: str = "*") -> list[Path]:
    """Glob under dir_path, sorted; hidden files excluded (IOUtils.listFiles)."""
    results = [
        Path(p)
        for p in _glob.glob(str(Path(dir_path) / pattern))
        if not os.path.basename(p).startswith(".")
    ]
    return sorted(results)


def choose_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def close_quietly(closeable) -> None:
    if closeable is not None:
        with contextlib.suppress(Exception):
            closeable.close()


def mkdirs(path: str | Path) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def atomic_write_bytes(path: str | Path, data: bytes) -> None:
    """Crash-safe file replacement: write a UNIQUE temp file in the target
    directory, fsync it, then ``os.replace`` over the destination.

    A writer killed at any point leaves either the old complete file or the
    new complete file — never a torn mix — and the pid+object-id temp name
    means two concurrent writers cannot interleave bytes in one temp file
    (the last rename wins whole). Used for broker offset/metadata commits,
    where a torn write would corrupt resume positions for a whole consumer
    group."""
    p = Path(path)
    tmp = p.with_name(f".{p.name}.{os.getpid()}.{id(data):x}.tmp")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        # loop over short writes: renaming a partially-written temp into
        # place would install exactly the torn file this helper exists to
        # prevent
        view = memoryview(data)
        written = 0
        while written < len(view):
            written += os.write(fd, view[written:])
        os.fsync(fd)
    finally:
        os.close(fd)
    try:
        os.replace(tmp, p)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_text(path: str | Path, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))
