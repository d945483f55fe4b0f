"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/torch_kernels/`` at the root of the checkout.
The library's file name carries a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads from the cache. A
build writes a temporary file and renames it into place, so two
processes never load a half-written library.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels build only where the CUDA toolkit is installed"
        )
    return nvcc


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source into a temporary file; returns
    (process, temporary path, final path), or None when it is built."""
    final = _library_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=final.name + ".", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def _finish(name: str, started) -> None:
    proc, tmp, final = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{out}")
    os.replace(tmp, final)


def build_all() -> None:
    """Build every kernel source, one ``nvcc`` per source, all started
    together."""
    started = {name: _start(name) for name in sources()}
    for name, s in started.items():
        if s is not None:
            _finish(name, s)


@functools.cache
def load(name: str, signatures: tuple) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed.

    ``signatures`` is a tuple of ``(function, argtypes)`` pairs; every
    function returns the ``cudaError_t`` of its launch as an int.
    """
    started = _start(name)
    if started is not None:
        _finish(name, started)
    lib = ctypes.CDLL(str(_library_path(name)))
    for fn, argtypes in signatures:
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib
