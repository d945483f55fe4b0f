"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/torch_kernels/`` at the root of the checkout.
Host C++ that works on Python objects (``csrc/<name>.cpp``) compiles
with ``g++`` against the interpreter's headers and loads with
``ctypes.PyDLL`` (:func:`load_host`), under an exclusive file lock so
that parallel processes build it once.
The library's file name carries a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads from the cache. A
build writes a temporary file and renames it into place, so two
processes never load a half-written library.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import sysconfig
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
#: Serialises first loads: two threads that miss ``load``'s cache at once
#: (the write plane's pumps) would otherwise both start ``nvcc``.
_LOAD_LOCK = threading.Lock()
#: Guards the wrappers' launch counts (``count_launch``).
_COUNT_LOCK = threading.Lock()


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


def _gxx() -> str:
    gxx = os.environ.get("CXX") or shutil.which("g++")
    if not gxx:
        raise RuntimeError("g++ not found (CXX or PATH): the host C++ "
                           "libraries build only where g++ is installed")
    return gxx


def _host_flags() -> tuple:
    return (*HOST_FLAGS, "-I" + sysconfig.get_paths()["include"])


def _library_path(name: str, suffix: str = ".cu") -> pathlib.Path:
    if suffix == ".cu":
        flags, deps = NVCC_FLAGS, sorted(CSRC.glob("*.cuh"))
    else:
        flags, deps = _host_flags(), []
    h = hashlib.sha256(" ".join(flags).encode())
    for p in deps + [CSRC / f"{name}{suffix}"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, suffix: str = ".cu"):
    """Start ``nvcc`` (``.cu``) or ``g++`` (``.cpp``) for one source into
    a temporary file; returns (process, temporary path, final path), or
    None when it is built."""
    final = _library_path(name, suffix)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=final.name + ".", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    if suffix == ".cu":
        compiler = [_nvcc(), *NVCC_FLAGS]
    else:
        compiler = [_gxx(), *_host_flags()]
    cmd = [*compiler, "-o", tmp, str(CSRC / f"{name}{suffix}")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def _finish(name: str, started, suffix: str = ".cu") -> None:
    proc, tmp, final = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        compiler = "nvcc" if suffix == ".cu" else "g++"
        raise RuntimeError(f"{compiler} failed on csrc/{name}{suffix}:\n{out}")
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
    with _LOAD_LOCK:
        started = _start(name)
        if started is not None:
            _finish(name, started)
    lib = ctypes.CDLL(str(_library_path(name)))
    for fn, argtypes in signatures:
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


@functools.cache
def load_host(name: str) -> ctypes.PyDLL:
    """The built library of the host source ``csrc/<name>.cpp``, building
    it with ``g++`` if needed, loaded with ``ctypes.PyDLL`` (its calls
    hold the GIL and may take and return Python objects). The caller
    declares the functions' types. The build runs under an exclusive
    lock on ``build/torch_kernels/lib<name>.lock``: the first of several
    processes compiles, and the others then find the library built."""
    with _LOAD_LOCK:
        final = _library_path(name, ".cpp")
        if not final.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    started = _start(name, ".cpp")
                    if started is not None:
                        _finish(name, started, ".cpp")
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
    return ctypes.PyDLL(str(final))


def count_launch(wrapper, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` (one launch) to the count ``wrapper.<attr>``. Under a
    lock: pump threads launch concurrently, and ``+=`` on a function
    attribute is a read-modify-write that could lose a count when the
    ctypes call just before it released the GIL."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)
