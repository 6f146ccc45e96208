"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
importing it has no side effects, and it never quietly runs on the CPU."""

import ast
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import pawsometracker_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "pawsometracker_tpu_torch")


def port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT_DIR):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(files)


def port_submodules():
    return sorted(m.name for m in pkgutil.walk_packages(port.__path__,
                                                        prefix="pawsometracker_tpu_torch."))


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import pawsometracker_tpu_torch\n"
        "import pawsometracker_tpu_torch.api, pawsometracker_tpu_torch.pipeline\n"
        "import pawsometracker_tpu_torch.ops.tracker_kernel\n"
        "import pawsometracker_tpu_torch.batch, pawsometracker_tpu_torch.multi\n"
        "import pawsometracker_tpu_torch.parallel.mesh\n"
        "import pawsometracker_tpu_torch.checkpoint, pawsometracker_tpu_torch.__main__\n"
        "import pawsometracker_tpu_torch.utils.compilecache, pawsometracker_tpu_torch.ops._build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pawsometracker_tpu' or m.startswith('pawsometracker_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'cv2' not in sys.modules, 'cv2 imported at package import'\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized(), 'CUDA initialised at import'\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=ROOT)
    assert r.returncode == 0 and "clean" in r.stdout, r.stdout + r.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top != "jax", f"{path} imports {name}"
        assert top != "pawsometracker_tpu", f"{path} imports the JAX package: {name}"


def test_source_scan_covers_the_package():
    rel = {os.path.relpath(p, ROOT) for p in port_sources()}
    for must in ("chip_smoke.py", "pawsometracker_tpu_torch/api.py",
                 "pawsometracker_tpu_torch/ops/tracker_kernel.py",
                 "pawsometracker_tpu_torch/io/parallel_decode.py",
                 "pawsometracker_tpu_torch/batch.py", "pawsometracker_tpu_torch/multi.py",
                 "pawsometracker_tpu_torch/parallel/mesh.py",
                 "pawsometracker_tpu_torch/parallel/__init__.py",
                 "pawsometracker_tpu_torch/checkpoint.py", "pawsometracker_tpu_torch/__main__.py",
                 "pawsometracker_tpu_torch/utils/compilecache.py"):
        assert must in rel


@pytest.mark.parametrize("mod", port_submodules())
def test_port_submodules_documented(mod):
    m = importlib.import_module(mod)
    assert m.__doc__, f"{mod} missing module docstring"
    for name, obj in vars(m).items():
        if name.startswith("_") or not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        if getattr(obj, "__module__", None) != mod:
            continue
        assert obj.__doc__, f"{mod}.{name} missing docstring"


def test_exports():
    for name in port.__all__:
        assert hasattr(port, name), name
    for name in ("track", "IJ", "make_spec", "tracker_fns", "TrackerSpec",
                 "spec_from_reference", "dog_kernel_separable", "guess_window_size",
                 "track_batch", "track_multi", "ShardedBatchTracker", "global_detect_batch",
                 "global_detect_peaks"):
        assert name in port.__all__


def test_track_signature_matches_jax_track():
    import pawsometracker_tpu as ref

    want = inspect.signature(ref.track).parameters
    got = inspect.signature(port.track).parameters
    assert list(got)[: len(want)] == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name
        assert got[name].kind == p.kind, name
    assert got["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert got["device"].default is None


@pytest.mark.parametrize("name", ["track_batch", "track_multi"])
def test_batch_and_multi_signatures_match_jax(name):
    """The JAX package's signature, defaults and kinds, plus a keyword-only
    ``device=None``."""
    import pawsometracker_tpu as ref

    want = inspect.signature(getattr(ref, name)).parameters
    got = inspect.signature(getattr(port, name)).parameters
    assert list(got) == list(want) + ["device"]
    for pname, p in want.items():
        assert got[pname].default == p.default, pname
        assert got[pname].kind == p.kind, pname
    assert got["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert got["device"].default is None


@pytest.mark.parametrize("name", ["track_batch", "track_multi"])
def test_batch_and_multi_without_device_raise_without_cuda(monkeypatch, name):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = np.full((3, 40, 40), 128, np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if name == "track_batch":
            port.track_batch([frames, frames], start_location=port.IJ(20, 20), target_width=6)
        else:
            port.track_multi(frames, [port.IJ(20, 20)], target_width=6)


def test_track_without_device_raises_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = np.full((3, 40, 40), 128, np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.track(frames, start_location=port.IJ(20, 20), target_width=6)


def test_tracker_fns_without_device_raises_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = port.make_spec((40, 40), 9, 6, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.tracker_fns(spec)


def test_parallel_decode_lazy_import_resolves():
    """io/parallel_decode.py takes its crop from the ops layer, not from the
    pipeline above it, and crops with it."""
    from pawsometracker_tpu_torch import pipeline
    from pawsometracker_tpu_torch.io import parallel_decode
    from pawsometracker_tpu_torch.ops import roi_crop

    src = open(os.path.join(PORT_DIR, "io", "parallel_decode.py")).read()
    assert "from ..ops.roi_crop import crop_with_fill" in src and "..pipeline" not in src
    assert parallel_decode.crop_with_fill is roi_crop.crop_with_fill
    assert not hasattr(pipeline, "_crop_with_fill")
    out = np.empty((3, 3), np.uint8)
    parallel_decode.ParallelNativeSource._crop(None, np.arange(12, dtype=np.uint8).reshape(3, 4),
                                               (-1, 2), 3, 3, 9, out)
    np.testing.assert_array_equal(out, [[9, 9, 9], [2, 3, 9], [6, 7, 9]])
