"""The per-user cache of compiled device code.

The JAX package keeps XLA's compiled executables here; the port keeps the
shared libraries that ``nvcc`` builds from ``csrc/*.cu``
(:mod:`..ops._build`). An installed package usually cannot write beside its
own sources, so a process that finds its checkout read-only builds into this
directory instead, and every later process, a spawned slice worker or a CLI
run, loads the library from there without building it again.
"""

from __future__ import annotations

import os

__all__ = ["cache_root", "default_cache_dir"]


def cache_root() -> str:
    """``$PAWSOMETRACKER_CACHE`` (the cache root the JAX package shares) or
    ``~/.cache/pawsometracker_tpu_torch``: the kernel libraries go under it,
    and the engine chooser's decisions (``pipeline.pick_bounded_engine``)."""
    return os.environ.get(
        "PAWSOMETRACKER_CACHE", os.path.expanduser("~/.cache/pawsometracker_tpu_torch")
    )


def default_cache_dir() -> str:
    """``<cache_root()>/kernels``."""
    return os.path.join(cache_root(), "kernels")
