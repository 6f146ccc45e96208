"""Build and load the port's CUDA kernels and native host helpers.

Each ``csrc/*.cu`` source (and each host-only ``csrc/*.cpp`` one, which
``nvcc`` hands to the host compiler) is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with :mod:`ctypes`. The
build happens at first use, into ``build/kernels/`` beside the package, or the
per-user cache where that cannot be written (see :func:`build_dir`), under a
name that carries a hash of the source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..utils.compilecache import default_cache_dir

__all__ = ["kernel_library", "library_digest", "source_path", "nvcc_path", "build_dir",
           "CSRC"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}  # one a library: different sources build at once
_libs: dict[str, ctypes.CDLL] = {}
#: compiler output (``-Xptxas -v``: registers, shared memory, spills) per source
build_log: dict[str, str] = {}


def build_dir() -> str:
    """Where the libraries go: ``$PAWS_KERNEL_BUILD_DIR``; else
    ``<checkout>/build/kernels`` when it can be created and written; else the
    per-user cache (:func:`..utils.compilecache.default_cache_dir`), as for
    an installed package in a read-only ``site-packages``."""
    env = os.environ.get("PAWS_KERNEL_BUILD_DIR")
    if env:
        return env
    local = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "kernels")
    try:
        os.makedirs(local, exist_ok=True)
    except OSError:  # read-only, or a file where a directory would go
        return default_cache_dir()
    return local if os.access(local, os.W_OK) else default_cache_dir()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH`` or
    ``/usr/local/cuda/bin/nvcc``; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME) on the machine with the card")


def source_path(name: str) -> str:
    """``csrc/<name>.cu``, else the host-only ``csrc/<name>.cpp``."""
    cu = os.path.join(CSRC, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC, f"{name}.cpp")


def library_digest(name: str) -> str:
    """The hash of the source of ``name`` (:func:`source_path`) and the build
    flags that names its library: an edited source gets another."""
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def kernel_library(name: str) -> ctypes.CDLL:
    """Load the source of ``name`` (:func:`source_path`) as a shared library,
    building it first if the build directory has no library for this source
    and these flags. Two sources build at once from two threads."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = source_path(name)
        out_dir = build_dir()
        so = os.path.join(out_dir, f"lib{name}_{library_digest(name)}.so")
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, src]
            r = subprocess.run(cmd, capture_output=True, text=True)
            build_log[name] = (r.stdout + r.stderr).strip()
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{build_log[name]}")
            os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib
