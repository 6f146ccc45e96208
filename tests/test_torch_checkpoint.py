"""The port's ``track_resumable``/``load_checkpoint`` against the JAX package's,
on the CPU (``device="cpu"``): the same FFV1 clips and in-memory arrays go
through both, and positions must be bit-equal (subpixel: within
``atol=1e-3`` across packages, bit-equal to the port's own ``track()``) and
timestamps exactly equal, interrupted or not, in-process or in spawned
slices, and across checkpoints written by the other package."""

import logging
import os

import numpy as np
import pytest

import helpers
import pawsometracker_tpu as jax_pkg
import pawsometracker_tpu_torch as port
from pawsometracker_tpu.checkpoint import load_checkpoint as jax_load
from pawsometracker_tpu.checkpoint import track_resumable as jax_resumable
from pawsometracker_tpu_torch import checkpoint as port_checkpoint

START = port.IJ(50, 50)
BASE = dict(fps=24, checkpoint_every=2.0, target_width=10)  # 48-frame slices
OFFSET_ATOL = 1e-3


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 5 s, 121-frame FFV1 clip of a dark disc on a spiral: 3 slices."""
    d = tmp_path_factory.mktemp("cp_clip")
    _, tra = helpers.build_trajectory(30, 24, (50, 50), np.random.default_rng(31), seconds=5.0)
    return helpers.trajectory2video(tra, str(d), 24, 100, 100, 10, True), tra


def frames_of(tra):
    return np.stack([helpers.render_frame(100, 100, ij, 10, True) for ij in tra])


def single_kwargs(kw):
    return {k: v for k, v in kw.items() if k != "checkpoint_every"}


def assert_same(got, want, subpixel=False):
    """``(ts, ij)`` pairs: ts exactly equal; ij bit-equal, or within
    ``atol`` for subpixel positions across packages."""
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].shape == want[1].shape
    if subpixel:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=OFFSET_ATOL)
    else:
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("subpixel", [False, True], ids=["int", "subpixel"])
@pytest.mark.parametrize("stream", ["full", "roi"])
def test_resumable_equals_track_and_jax(clip, tmp_path, stream, subpixel):
    f, _ = clip
    kw = dict(BASE, start_location=START, stream=stream, subpixel=subpixel)
    got = port.track_resumable(f, checkpoint_path=str(tmp_path / "p.npz"), device="cpu", **kw)
    single = port.track(f, device="cpu", **single_kwargs(kw))
    assert_same(got, single)  # the port's own uninterrupted run: bit for bit
    want = jax_resumable(f, checkpoint_path=str(tmp_path / "j.npz"), **kw)
    assert_same(got, want, subpixel)
    assert len(got[1]) == 121
    state = port.load_checkpoint(str(tmp_path / "p.npz"))
    assert state["done"]
    assert_same((state["ts"], state["ij"]), got)


@pytest.mark.parametrize("kind", ["file", "array at input_fps=48"])
def test_interrupt_and_resume(clip, tmp_path, kind):
    f, tra = clip
    kw = dict(BASE)
    if kind == "file":
        src = f
    else:  # the same motion sampled at 48 fps, tracked at 24
        _, tra48 = helpers.build_trajectory(30, 48, (50, 50), np.random.default_rng(31),
                                            seconds=5.0)
        src = frames_of(tra48)
        kw["input_fps"] = 48
    cp = str(tmp_path / "p.npz")
    ts_p, ij_p = port.track_resumable(src, checkpoint_path=cp, start_location=START,
                                      _max_slices=2, device="cpu", **kw)
    assert len(ij_p) == 96  # 2 slices x 48 frames
    state = port.load_checkpoint(cp)
    assert not state["done"] and state["next_time"] == 4.0
    got = port.track_resumable(src, checkpoint_path=cp, device="cpu", **kw)
    want = jax_resumable(src, checkpoint_path=str(tmp_path / "j.npz"), start_location=START,
                         **kw)
    assert_same(got, want)
    assert_same(got, port.track(src, start_location=START, device="cpu", **single_kwargs(kw)))
    assert port.load_checkpoint(cp)["done"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_in_the_other_package(clip, tmp_path, writer):
    """A partial checkpoint written by one package resumes in the other to
    the writer's own uninterrupted result."""
    f, _ = clip
    cp = str(tmp_path / "cp.npz")
    full = jax_resumable(f, checkpoint_path=str(tmp_path / "full.npz"), start_location=START,
                         **BASE)
    if writer == "jax":
        jax_resumable(f, checkpoint_path=cp, start_location=START, _max_slices=1, **BASE)
        assert not jax_load(cp)["done"]
        got = port.track_resumable(f, checkpoint_path=cp, device="cpu", **BASE)
    else:
        port.track_resumable(f, checkpoint_path=cp, start_location=START, _max_slices=1,
                             device="cpu", **BASE)
        assert not port.load_checkpoint(cp)["done"]
        got = jax_resumable(f, checkpoint_path=cp, **BASE)
    assert_same(got, full)
    state_j = jax_load(cp)
    state_p = port.load_checkpoint(cp)
    assert state_j["done"] and state_p["done"] and state_j["next_time"] == state_p["next_time"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_done_checkpoint_short_circuits(clip, tmp_path, monkeypatch, writer):
    f, _ = clip
    cp = str(tmp_path / "cp.npz")
    kw = dict(BASE, checkpoint_every=3.0)
    if writer == "jax":
        first = jax_resumable(f, checkpoint_path=cp, start_location=START, **kw)
    else:
        first = port.track_resumable(f, checkpoint_path=cp, start_location=START, device="cpu",
                                     **kw)

    def no_tracking(*a, **k):
        raise AssertionError("a done checkpoint must not track again")

    monkeypatch.setattr(port_checkpoint, "track", no_tracking)
    again = port.track_resumable(f, checkpoint_path=cp, device="cpu", fps=24, target_width=10)
    assert_same(again, first)


def test_corrupt_checkpoint_quarantined(clip, tmp_path, caplog):
    f, _ = clip
    cp = str(tmp_path / "cp.npz")
    with open(cp, "wb") as fh:
        fh.write(b"\x00garbage not a zipfile")
    with caplog.at_level(logging.WARNING, logger="pawsometracker_tpu_torch.checkpoint"):
        assert port.load_checkpoint(cp) is None
    assert "unreadable" in caplog.text
    assert (tmp_path / "cp.npz.corrupt").exists() and not os.path.exists(cp)
    # a full resumable run now proceeds from scratch, as the JAX package's does
    got = port.track_resumable(f, checkpoint_path=cp, start_location=START, device="cpu", **BASE)
    want = jax_resumable(f, checkpoint_path=str(tmp_path / "j.npz"), start_location=START,
                         **BASE)
    assert_same(got, want)


def test_clip_ending_at_a_slice_boundary(clip, tmp_path):
    """96 frames in 48-frame slices: the third slice starts at the end of the
    stream (EOFError), which marks the checkpoint done."""
    frames = frames_of(clip[1][:96])
    cp = str(tmp_path / "p.npz")
    got = port.track_resumable(frames, checkpoint_path=cp, start_location=START, device="cpu",
                               **BASE)
    want = jax_resumable(frames, checkpoint_path=str(tmp_path / "j.npz"), start_location=START,
                         **BASE)
    assert_same(got, want)
    assert len(got[1]) == 96
    state = port.load_checkpoint(cp)
    assert state["done"] and state["next_time"] == 4.0
    assert state["next_time"] == jax_load(str(tmp_path / "j.npz"))["next_time"]


def test_isolated_slices_equal_in_process(clip, tmp_path):
    """Each of the 3 slices in a spawned child (which loads the port itself)
    gives the in-process result and the JAX package's."""
    f, _ = clip
    kw = dict(BASE, start_location=START, device="cpu")
    iso = port.track_resumable(f, checkpoint_path=str(tmp_path / "iso.npz"),
                               isolate_slices=True, **kw)
    inproc = port.track_resumable(f, checkpoint_path=str(tmp_path / "in.npz"), **kw)
    assert_same(iso, inproc)
    kw.pop("device")
    assert_same(iso, jax_resumable(f, checkpoint_path=str(tmp_path / "j.npz"), **kw))


def test_isolated_slices_reject_frame_arrays(tmp_path):
    frames = np.zeros((4, 32, 32), np.uint8)
    with pytest.raises(ValueError, match="isolate_slices"):
        port.track_resumable(frames, checkpoint_path=str(tmp_path / "x.npz"),
                             isolate_slices=True, input_fps=24, device="cpu")


def test_without_device_raises_without_cuda(tmp_path, monkeypatch):
    """No card and no ``device=``: raises before any tracking, even for a
    checkpoint that is already done."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = frames_of([(20, 20)] * 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.track_resumable(frames, checkpoint_path=str(tmp_path / "x.npz"),
                             start_location=port.IJ(20, 20), target_width=10)
    assert not (tmp_path / "x.npz").exists()


def test_signature_matches_jax():
    import inspect

    want = inspect.signature(jax_pkg.track_resumable).parameters
    got = inspect.signature(port.track_resumable).parameters
    assert list(got) == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name
        assert got[name].kind == p.kind, name
    assert "load_checkpoint" in port.__all__ and "track_resumable" in port.__all__
