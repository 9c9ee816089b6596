"""The native host gather: ``csrc/gather.cpp`` built with ``g++`` and
called through ``ctypes`` (the port's counterpart of the JAX package's
``native/build.py`` and ``data/pipeline._gather``).

The library is compiled at first use with ``g++ -O3 -shared -fPIC`` into
``build/native/`` at the repository root (listed in ``.gitignore``), under
a file name that carries a hash of the source and the flags, as
``ops/native.py`` names the CUDA libraries; the compiler writes a temporary
file that is renamed into place. ``ctypes`` releases the GIL around each
call, so a prefetch thread's gather overlaps the device step.

This is a host op, not a kernel: where ``g++`` is missing or the build
fails, :func:`gather` takes numpy's fancy indexing, as the JAX package
does, and the path taken is logged once. Either path returns the same
bytes. :data:`native_calls` counts the calls that took the native path,
so a run can show which one its host took.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "gather.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# calls of gather() that took the native path (reset by whoever reads it)
native_calls = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the source builds to: the name carries a hash of the source
    and the flags, so an edited source rebuilds."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgather_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    target = library_path()
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; ``None`` where it cannot
    be built or loaded. Thread-safe; the first call logs the path taken."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except Exception as e:  # noqa: BLE001 - no toolchain, a failed build or load
            logging.info("native gather unavailable (%s); host batches gather with numpy", e)
            return None
        lib.gather_rows_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_void_p]
        lib.gather_rows_u8.restype = None
        lib.gather_rows_i32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p]
        lib.gather_rows_i32.restype = None
        logging.info("native gather: %s", library_path())
        _lib = lib
        return _lib


def gather(images: np.ndarray, labels: np.ndarray, sel) -> Tuple[np.ndarray, np.ndarray]:
    """``(images[sel], labels[sel] as int32)`` for an integer index array
    ``sel`` of any shape: the native memcpy path for C-contiguous images
    (JAX ``data/pipeline.py:110-126``), numpy's otherwise."""
    global native_calls
    lib = load()
    if lib is None or not images.flags["C_CONTIGUOUS"]:
        return images[sel], np.asarray(labels)[sel].astype(np.int32, copy=False)
    sel = np.asarray(sel)
    flat = np.ascontiguousarray(sel.reshape(-1), np.int64)
    out_img = np.empty(sel.shape + images.shape[1:], images.dtype)
    row_bytes = images.dtype.itemsize * int(np.prod(images.shape[1:]))
    lib.gather_rows_u8(images.ctypes.data_as(ctypes.c_void_p),
                       flat.ctypes.data_as(ctypes.c_void_p), len(flat), row_bytes,
                       out_img.ctypes.data_as(ctypes.c_void_p))
    labels32 = np.ascontiguousarray(labels, np.int32)
    out_lab = np.empty(sel.shape, np.int32)
    lib.gather_rows_i32(labels32.ctypes.data_as(ctypes.c_void_p),
                        flat.ctypes.data_as(ctypes.c_void_p), len(flat),
                        out_lab.ctypes.data_as(ctypes.c_void_p))
    native_calls += 1
    return out_img, out_lab
