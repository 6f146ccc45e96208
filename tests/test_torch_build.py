"""Where the port builds and finds its kernel library (``ops/_build.py``),
without ``nvcc``: ``$PAWS_KERNEL_BUILD_DIR``, else ``<checkout>/build/kernels``
when it can be written, else the per-user cache; and a library already in
the cache is loaded without building."""

import hashlib
import os
import shutil

import pytest

from pawsometracker_tpu_torch.ops import _build
from pawsometracker_tpu_torch.utils.compilecache import default_cache_dir


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A checkout root under ``tmp_path``, no build-directory override, and
    the user cache under ``tmp_path``."""
    monkeypatch.delenv("PAWS_KERNEL_BUILD_DIR", raising=False)
    monkeypatch.setenv("PAWSOMETRACKER_CACHE", str(tmp_path / "cache"))
    return tmp_path


def set_root(monkeypatch, root):
    """Make ``root`` the checkout that ``build_dir`` resolves from."""
    monkeypatch.setattr(_build, "CSRC", os.path.join(root, "pawsometracker_tpu_torch", "csrc"))


def test_env_override_wins(checkout, monkeypatch):
    set_root(monkeypatch, str(checkout))
    monkeypatch.setenv("PAWS_KERNEL_BUILD_DIR", str(checkout / "mine"))
    assert _build.build_dir() == str(checkout / "mine")


def test_writable_checkout_builds_beside_the_package(checkout, monkeypatch):
    set_root(monkeypatch, str(checkout))
    want = os.path.join(str(checkout), "build", "kernels")
    assert _build.build_dir() == want
    assert os.path.isdir(want)


def test_unwritable_checkout_falls_back_to_the_user_cache(checkout, monkeypatch):
    """A checkout whose ``build`` cannot be made (here: the root lies under a
    regular file, which stops even root) resolves to the user cache."""
    blocker = checkout / "site-packages"
    blocker.write_text("a file, not a directory")
    set_root(monkeypatch, str(blocker))
    assert _build.build_dir() == str(checkout / "cache" / "kernels")
    monkeypatch.delenv("PAWSOMETRACKER_CACHE")
    monkeypatch.setenv("HOME", str(checkout / "home"))
    assert _build.build_dir() == os.path.join(str(checkout / "home"), ".cache",
                                              "pawsometracker_tpu_torch", "kernels")
    assert default_cache_dir() == _build.build_dir()


def test_cached_library_loads_without_nvcc(checkout, monkeypatch):
    """A library already in the user cache under its source-hash name is
    loaded as it is: no compiler is looked for. (A shared library of numpy
    stands in for the kernel library.)"""
    try:
        from numpy._core import _multiarray_umath as stand_in
    except ImportError:  # numpy 1.x
        from numpy.core import _multiarray_umath as stand_in

    with open(os.path.join(_build.CSRC, "dog_scan.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_build.ARCH_FLAGS + _build.NVCC_FLAGS)
                                .encode()).hexdigest()[:16]
    os.makedirs(default_cache_dir())
    path = os.path.join(default_cache_dir(), f"libdog_scan_{digest}.so")
    shutil.copy(stand_in.__file__, path)
    monkeypatch.setattr(_build, "build_dir", default_cache_dir)
    monkeypatch.setattr(_build, "_libs", {})

    def no_nvcc():
        raise AssertionError("a cached library must not be rebuilt")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    lib = _build.kernel_library("dog_scan")
    assert os.path.samefile(lib._name, path)
    assert _build.kernel_library("dog_scan") is lib
