"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), under a file name that carries a hash of the source, of the
``csrc/*.cuh`` headers it includes and of the flags, so an edited ``.cu`` or
header rebuilds and an unchanged one is reused. The
compiler's output (``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``<library>.log``.

There is no fallback: without ``nvcc`` the build raises, and a caller with a
CUDA tensor gets that error rather than some other implementation. The
wrappers share the dispatch and argument checks below: all-CPU inputs take
a plain PyTorch form, all-CUDA inputs on one device launch a kernel, and
anything else raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then the
    toolkit's default install location; raises if none exists."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_NVCC}): the CUDA kernels cannot be built"
    )


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def included_headers(source: Path) -> list:
    """The headers under ``csrc/`` that ``source`` includes with quotes,
    directly or through another such header, in the order first reached."""
    found, todo = [], [source]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_text()):
            header = CSRC_DIR / name
            if header.is_file() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source bytes, of every header it includes from ``csrc/`` and of the
    compiler flags, so editing a header rebuilds too."""
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in included_headers(source):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists.

    The compiler writes to a temporary file in the build directory that is
    renamed into place, so a concurrent or interrupted build never leaves a
    half-written library under the final name.
    """
    target = library_path(name)
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    The caller declares ``argtypes``/``restype`` of the functions it uses."""
    return ctypes.CDLL(str(build(name)))


def on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """True for all-CPU inputs, False for all-CUDA inputs on one device,
    else raise (``None`` entries are skipped)."""
    present = [t for t in tensors if t is not None]
    kinds = {t.device.type for t in present}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in present}) == 1:
        return False
    raise ValueError(
        f"kernel inputs must all lie on the CPU or on one CUDA device, "
        f"got {sorted(str(t.device) for t in present)}"
    )


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Sequence[int],
                 align: int = 1) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` whose
    data starts on an ``align``-byte boundary (16 for a tensor a kernel
    loads 16 bytes at a time)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"(contiguous={t.is_contiguous()})"
        )
    if t.data_ptr() % align:
        raise ValueError(f"{name}: its data must start on a {align}-byte boundary, "
                         f"got address {t.data_ptr():#x}")


def raise_on_error(code: int, kernel: str) -> None:
    """Raise if a launch returned a ``cudaError_t`` other than 0."""
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {code}")
