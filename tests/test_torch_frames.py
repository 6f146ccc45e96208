"""How frames reach the port's scans, against the JAX package, on the CPU.

- ``ArrayFrameSource`` serves read-only views from the frame its start maps
  onto (``io/decode.py::view_origin``) wherever the resampler maps the start
  1:1 onto the output grid, and emits exactly the JAX package's frames there
  (the JAX package walks its resampler from frame 0 for any start past 0);
  off-grid (half-slot) starts, ``input_fps`` arrays, RGB and lazy stacks walk
  in both.
- ``track_resumable`` on arrays (every slice past the first now served as
  views), ``stream="full"`` ``track``/``track_batch``/``track_multi`` at a
  start past 0 and on ``input_fps`` arrays: positions and ``ts`` equal to the
  JAX package's, offsets within ``atol=1e-3``.
- Arrays whose columns do not lie 1 byte apart (mirrored, column-strided,
  Fortran-ordered) walk, since the native copies need that layout; rows or
  frames in reverse order are still served as views.
- The prefetcher's ring (``io/decode.py::ChunkRing``, the full-frame engine's
  pinned staging on the card), with mock events: no buffer is written while
  its copy to the card is pending.
- Both packages' native decoders give byte-equal frames, into a buffer of
  the caller's (``read_chunk(out=...)``), from start 0 and past it.
- No fallback: a native staging copy that does not build or is refused
  raises.
"""

import math

import numpy as np
import pytest

import helpers
import pawsometracker_tpu as jax_pkg
import pawsometracker_tpu_torch as port
from pawsometracker_tpu.checkpoint import track_resumable as jax_resumable
from pawsometracker_tpu.io import decode as jax_decode
from pawsometracker_tpu_torch.io import decode as port_decode
from pawsometracker_tpu_torch.ops import roi_crop

FPS_CASES = {"24": 24.0, "25": 25.0, "30000/1001": 30000 / 1001, "59.94": 59.94}
CHECKPOINT_EVERY = 1.0
OFFSET_ATOL = 1e-3


def numbered(n, h=4, w=3):
    """``n`` frames whose bytes name their index (low byte, high byte)."""
    f = np.zeros((n, h, w), np.uint8)
    f[:, 0, 0] = np.arange(n) % 256
    f[:, 0, 1] = np.arange(n) // 256
    f[:, 1:, :] = (np.arange(n) * 7 % 251)[:, None, None]
    return f


def emitted(src, how):
    """Every frame the source emits, as copies: by ``read`` or by
    ``read_chunk`` of 5 (the prefetcher's way)."""
    out = []
    if how == "read":
        while (f := src.read()) is not None:
            out.append(np.array(f))
    else:
        while len(c := src.read_chunk(5)):
            out.extend(np.array(c))
    return np.array(out).reshape((-1,) + src.info.frame_shape)


def slice_starts(fps, n=4):
    """``track_resumable``'s slice starts from 0: float sums of its slice
    duration, as it adds them."""
    slice_dur = max(1, int(round(CHECKPOINT_EVERY * fps))) / fps
    t0, out = 0.0, []
    for _ in range(n):
        t0 = t0 + slice_dur
        out.append(t0)
    return slice_dur, out


# starts a little past and a little before frame 33 take its slot; before it, the input keep
# gate (not the emit clamp) decides the last frame of a stop 13.2 frames on
START_KINDS = ["k=0", "k=1", "k=7", "k=50", "k=33 + 0.3 slot", "k=33 - 0.3 slot", "slice 1",
               "slice 2", "slice 3", "slice 4"]
STOP_KINDS = ["inf", "a slice on", "13 frames on", "13.2 frames on"]


def start_of(kind, fps):
    if kind.startswith("slice"):
        return slice_starts(fps)[1][int(kind.split()[1]) - 1]
    if kind.endswith("slot"):
        return (33 + float(kind.split()[1] + kind.split()[2])) / fps
    return int(kind[2:]) / fps


def stop_of(kind, start, fps):
    if kind == "inf":
        return math.inf
    if kind == "a slice on":  # track_resumable's t1 = t0 + slice_dur
        return start + slice_starts(fps)[0]
    return start + float(kind.split()[0]) / fps


@pytest.mark.parametrize("stop_kind", STOP_KINDS)
@pytest.mark.parametrize("start_kind", START_KINDS)
@pytest.mark.parametrize("fps_name", list(FPS_CASES))
def test_on_grid_starts_serve_views_equal_to_jax(fps_name, start_kind, stop_kind):
    """At a start within less than half a slot of frame k0, a plain array at
    the output rate is served as read-only views from frame k0, and the frames
    emitted (by read and by read_chunk) equal the JAX package's, which walks
    the resampler from frame 0."""
    fps = FPS_CASES[fps_name]
    frames = numbered(320)
    start = start_of(start_kind, fps)
    stop = stop_of(stop_kind, start, fps)
    k0 = port_decode.view_origin(frames, start=start, fps=fps)
    assert k0 == round(start * fps)
    for how in ("read", "chunks"):
        src = port_decode.ArrayFrameSource(frames, start=start, stop=stop, fps=fps)
        ref = jax_decode.ArrayFrameSource(frames, start=start, stop=stop, fps=fps)
        assert src.serves_views and (k0 == 0) == ref.serves_views
        if how == "chunks":
            first = src.read_chunk(3)
            assert np.shares_memory(first, frames) and not first.flags.writeable
            assert int(first[0, 0, 0]) == k0 % 256
            got = np.concatenate([np.array(first), emitted(src, how)])
        else:
            got = emitted(src, how)
        want = emitted(ref, how)
        assert len(got) > 0
        np.testing.assert_array_equal(got, want)


WALK_KINDS = ["half-slot tie", "input_fps", "RGB", "lazy stack", "negative start"]


class LazyStack:
    """A frame stack that materializes one frame at a time (an h5py/zarr
    dataset's interface)."""

    def __init__(self, a):
        self._a, self.shape, self.dtype = a, a.shape, a.dtype

    def __getitem__(self, k):
        return np.array(self._a[k])


@pytest.mark.parametrize("kind", WALK_KINDS)
@pytest.mark.parametrize("fps_name", ["24", "30000/1001"])
def test_starts_the_rule_cannot_prove_walk_equal_to_jax(fps_name, kind):
    """A start on a half-slot tie, a resampled array, RGB, a lazy stack and a
    start before 0 are not served as views, and emit the JAX package's frames."""
    fps = FPS_CASES[fps_name]
    frames, kw = numbered(200), dict(start=21 / fps, fps=fps)
    if kind == "half-slot tie":
        kw["start"] = 21.5 / fps
    elif kind == "input_fps":
        kw["input_fps"] = fps * 1.25
    elif kind == "RGB":
        frames = np.repeat(frames[..., None], 3, axis=-1)
    elif kind == "lazy stack":
        frames = LazyStack(frames)
    else:
        kw["start"] = -4.0 / fps
    assert port_decode.view_origin(frames, start=kw["start"], fps=fps,
                                   input_fps=kw.get("input_fps")) is None
    src = port_decode.ArrayFrameSource(frames, stop=kw["start"] + 40 / fps, **kw)
    ref = jax_decode.ArrayFrameSource(frames, stop=kw["start"] + 40 / fps, **kw)
    assert not src.serves_views and not ref.serves_views
    np.testing.assert_array_equal(emitted(src, "chunks"), emitted(ref, "chunks"))


def test_input_fps_equal_to_fps_serves_views():
    frames = numbered(60)
    src = port_decode.ArrayFrameSource(frames, start=12 / 25, fps=25, input_fps=25.0)
    assert src.serves_views and port_decode.view_origin(frames, start=12 / 25, fps=25,
                                                         input_fps=25.0) == 12
    ref = jax_decode.ArrayFrameSource(frames, start=12 / 25, fps=25, input_fps=25.0)
    np.testing.assert_array_equal(emitted(src, "chunks"), emitted(ref, "chunks"))


def test_served_views_are_read_only_unlike_jax():
    """A deliberate divergence from the JAX package: its served chunks are
    writable views that alias the caller's array; the port's are read-only
    views of it, and the caller's array stays writable."""
    frames = numbered(20)
    ref = jax_decode.ArrayFrameSource(frames, fps=24).read_chunk(4)
    assert np.shares_memory(ref, frames) and ref.flags.writeable
    src = port_decode.ArrayFrameSource(frames, start=3 / 24, fps=24)
    chunk, frame = src.read_chunk(4), src.read()
    assert np.shares_memory(chunk, frames) and np.shares_memory(frame, frames)
    assert not chunk.flags.writeable and not frame.flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        chunk[0, 0, 0] = 1
    frames[3, 0, 0] = 200  # the caller's array stays writable, and the views see it
    assert chunk[0, 0, 0] == 200


def test_views_allowed_hook_forces_the_walk(monkeypatch):
    """The test hook: with views disallowed every source walks, and emits the
    same frames as the views."""
    frames = numbered(90)
    views = emitted(port_decode.ArrayFrameSource(frames, start=30 / 24, fps=24), "chunks")
    monkeypatch.setattr(port_decode.ArrayFrameSource, "views_allowed", False)
    walked = port_decode.ArrayFrameSource(frames, start=30 / 24, fps=24)
    assert not walked.serves_views
    np.testing.assert_array_equal(emitted(walked, "chunks"), views)


#: array layouts: the first three have columns that do not lie 1 byte apart
LAYOUTS = {
    "mirrored columns": lambda f: f[:, :, ::-1],
    "every other column": lambda f: f[:, :, ::2],
    "Fortran order": np.asfortranarray,
    "mirrored rows": lambda f: f[:, ::-1],
    "frames in reverse": lambda f: f[::-1],
}
WALKING_LAYOUTS = ("mirrored columns", "every other column", "Fortran order")


@pytest.mark.parametrize("start_k", [0, 9])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_view_origin_needs_one_byte_columns(layout, start_k):
    """The native copies read rows of 1-byte columns, so an array whose
    columns lie otherwise walks the resampler at any start; rows or frames in
    reverse order are still served as views. Either way the frames emitted
    equal the JAX package's."""
    frames = LAYOUTS[layout](numbered(80, 6, 5))
    start = start_k / 24
    k0 = port_decode.view_origin(frames, start=start, fps=24)
    assert k0 == (None if layout in WALKING_LAYOUTS else start_k)
    src = port_decode.ArrayFrameSource(frames, start=start, fps=24)
    ref = jax_decode.ArrayFrameSource(frames, start=start, fps=24)
    assert src.serves_views == (k0 is not None)
    np.testing.assert_array_equal(emitted(src, "chunks"), emitted(ref, "chunks"))


# ---- the entry points on arrays, against the JAX package --------------------------------


def spiral_frames(fps, seconds=5.0, seed=31):
    _, tra = helpers.build_trajectory(30, fps, (50, 50), np.random.default_rng(seed),
                                      seconds=seconds)
    return np.stack([helpers.render_frame(100, 100, ij, 10, True) for ij in tra])


def assert_same(got, want, subpixel=False):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].shape == want[1].shape
    if subpixel:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=OFFSET_ATOL)
    else:
        np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture
def served(monkeypatch):
    """Records whether each ArrayFrameSource the port opens serves views."""
    seen = []
    init = port_decode.ArrayFrameSource.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        seen.append(self.serves_views)

    monkeypatch.setattr(port_decode.ArrayFrameSource, "__init__", spy)
    return seen


@pytest.mark.parametrize("stream,subpixel,fps_name", [
    ("full", False, "24"), ("full", True, "24"), ("roi", False, "24"), ("roi", True, "24"),
    ("full", False, "30000/1001"), ("roi", False, "59.94")])
def test_track_resumable_on_arrays_equals_jax(tmp_path, served, stream, subpixel, fps_name):
    """track_resumable on an array in 1-second slices, interrupted after 2 and
    resumed: every slice is served as views (the JAX package walks each slice
    past the first from frame 0), and positions and ts equal the JAX
    package's uninterrupted run and the port's own track()."""
    fps = FPS_CASES[fps_name]
    frames = spiral_frames(fps, seconds=4.2)
    kw = dict(fps=fps, checkpoint_every=CHECKPOINT_EVERY, target_width=10, stream=stream,
              subpixel=subpixel)
    cp = str(tmp_path / "p.npz")
    port.track_resumable(frames, checkpoint_path=cp, start_location=port.IJ(50, 50),
                         _max_slices=2, device="cpu", **kw)
    assert not port.load_checkpoint(cp)["done"]
    got = port.track_resumable(frames, checkpoint_path=cp, device="cpu", **kw)
    assert len(served) == 5 and all(served)
    want = jax_resumable(frames, checkpoint_path=str(tmp_path / "j.npz"),
                         start_location=jax_pkg.IJ(50, 50), **kw)
    assert_same(got, want, subpixel)
    single = port.track(frames, start_location=port.IJ(50, 50), device="cpu",
                        **{k: v for k, v in kw.items() if k != "checkpoint_every"})
    assert_same(got, single)


def spiral_clip(n, seed):
    """The first ``n`` frames of a radius-25 spiral clip (tests/test_torch_batch.py's)."""
    _, tra = helpers.build_trajectory(25, 24, (50, 50), np.random.default_rng(seed))
    return np.stack([helpers.render_frame(100, 100, ij, 10, True) for ij in tra[:n]])


FULL_INPUTS = {"views from an on-grid start past 0": dict(start=17 / 24),
               "an input_fps array": dict(input_fps=30.0)}


@pytest.mark.parametrize("subpixel", [False, True], ids=["int", "subpixel"])
@pytest.mark.parametrize("inputs", list(FULL_INPUTS))
@pytest.mark.parametrize("entry", ["track", "track_batch", "track_multi"])
def test_full_frames_equal_jax(served, entry, inputs, subpixel):
    """stream="full" at a start past 0 (served as views) and on input_fps
    arrays (resampled): track, track_batch with a video that ends early, and
    track_multi equal the JAX package's."""
    from test_torch_multi import three_targets

    opts = dict(FULL_INPUTS[inputs])
    clips = [spiral_clip(70 - 10 * b, 1 + b) for b in range(3)]
    kw = dict(fps=24, target_width=10, chunk_size=16, stream="full", subpixel=subpixel)
    if entry == "track":
        got = port.track(clips[0], start_location=None, device="cpu", **kw, **opts)
        want = jax_pkg.track(clips[0], start_location=None, **kw, **opts)
        pairs = [(got, want)]
    elif entry == "track_batch":
        locs = [(50, 50), None, (50, 50)]
        got = port.track_batch(clips, start_location=[port.IJ(*p) if p else None for p in locs],
                               device="cpu", **kw, **opts)
        want = jax_pkg.track_batch(clips, start_location=[jax_pkg.IJ(*p) if p else None
                                                          for p in locs], **kw, **opts)
        pairs = list(zip(got, want))
        assert len(got[2][1]) < len(got[0][1])  # the third video ends early
    else:  # three targets, kept off the frame's near edges
        if "start" in opts:
            opts["start"] = 6 / 24
        frames, paths = three_targets(T=40)
        locs = paths[round(opts.get("start", 0.0) * 24)]
        got = port.track_multi(frames, [port.IJ(*p) for p in locs], device="cpu", **kw, **opts)
        want = jax_pkg.track_multi(frames, [jax_pkg.IJ(*p) for p in locs], **kw, **opts)
        pairs = [(got, want)]
    for g, w in pairs:
        assert_same(g, w, subpixel)
    assert served and all(served) == ("start" in opts)


@pytest.mark.parametrize("stream", ["full", "roi"])
@pytest.mark.parametrize("layout", [k for k in LAYOUTS if k != "every other column"])
def test_track_on_array_layouts_equals_jax(layout, stream):
    """track at a start past 0 on mirrored, Fortran-ordered and reversed
    arrays, on full frames and on ROI: positions and ts equal the JAX
    package's."""
    clip = LAYOUTS[layout](spiral_clip(60, 3))
    kw = dict(fps=24, target_width=10, chunk_size=16, stream=stream, start=7 / 24)
    got = port.track(clip, start_location=None, device="cpu", **kw)
    want = jax_pkg.track(clip, start_location=None, **kw)
    assert_same(got, want)


# ---- the staging ring behind the prefetcher ----------------------------------------------


class MockEvent:
    """A copy to the card that completes only when waited on."""

    def __init__(self):
        self.done = False

    def synchronize(self):
        self.done = True

    def query(self):
        return self.done


@pytest.mark.parametrize("source", ["views from frame 0", "views past 0", "resampled",
                                    "RGB"])
def test_prefetcher_never_hands_out_a_buffer_whose_copy_is_pending(source):
    """Each chunk the prefetcher yields lies in a buffer of the ring and holds
    the source's frames; the consumer marks it with a pending copy event and
    hands it straight back (sooner than the pipelines do, after the
    positions are in): no buffer is written again (by the copy of a view, or
    by the source itself) before that event has completed, and the ring
    stays as small as the flow."""
    frames = numbered(150, 6, 5)
    kw = dict(fps=24.0)
    if source == "views past 0":
        kw["start"] = 9 / 24
    elif source == "resampled":
        kw["input_fps"] = 30.0
    elif source == "RGB":
        frames = np.repeat(frames[..., None], 3, axis=-1)
    want = emitted(port_decode.ArrayFrameSource(frames, **kw), "chunks")
    src = port_decode.ArrayFrameSource(frames, **kw)
    last = {}  # buffer address -> the event of its last copy
    writes = []

    def guard(buf):
        event = last.get(buf.ctypes.data)
        writes.append(event is None or event.done)

    def copy(chunk, dst):
        guard(dst)
        np.copyto(dst, chunk)

    read_chunk = src.read_chunk

    def read_into(n, out=None):
        if not src.serves_views:
            guard(out)
        return read_chunk(n, out)

    src.read_chunk = read_into
    ring = port_decode.ChunkRing(copy=copy)
    pf = port_decode.ChunkPrefetcher(src, 8, max_frames=100, ring=ring)
    got = []
    try:
        for chunk in pf:
            assert ring.holds(chunk) and chunk.dtype == np.uint8
            assert not np.shares_memory(chunk, frames)
            got.extend(np.array(chunk))
            event = MockEvent()
            ring.copied(chunk, event)
            last[chunk.ctypes.data] = event
            pf.recycle(chunk)
    finally:
        pf.close()
    np.testing.assert_array_equal(np.array(got), want[:100])
    assert writes and all(writes)
    assert ring.made <= 5


def test_staging_ring_refuses_a_chunk_it_did_not_stage():
    """A chunk that lies in no buffer of the ring (a view of the caller's
    frames) is never pooled: recycling it hands nothing out to be written."""
    ring = port_decode.ChunkRing(copy=lambda src, dst: np.copyto(dst, src))
    frames = numbered(20)
    foreign = frames[:2]
    assert not ring.holds(foreign)
    ring.recycle(foreign)
    src = port_decode.ArrayFrameSource(frames, fps=24)
    chunk = ring.read(src, 4, 4)
    assert ring.holds(chunk) and ring.made == 1
    assert not np.shares_memory(chunk, frames)
    np.testing.assert_array_equal(chunk, frames[:4])


@pytest.mark.parametrize("views", [False, True], ids=["source buffers", "views"])
def test_plain_ring_recycles_source_buffers_and_passes_views(views):
    """Without a copy (the ROI and CPU paths) a view-serving source's chunks
    are the views themselves, never pooled; any other source writes into the
    ring's buffers, which come back with recycle and are reused."""
    frames = numbered(60)
    src = port_decode.ArrayFrameSource(frames, fps=24, input_fps=None if views else 30.0)
    want = emitted(port_decode.ArrayFrameSource(frames, fps=24,
                                                input_fps=None if views else 30.0), "chunks")
    pf = port_decode.ChunkPrefetcher(src, 8)
    got, seen = [], set()
    try:
        for chunk in pf:
            assert np.shares_memory(chunk, frames) == views
            assert pf.ring.holds(chunk) != views and chunk.dtype == np.uint8
            seen.add(chunk.ctypes.data)
            got.extend(np.array(chunk))
            pf.recycle(chunk)
    finally:
        pf.close()
    np.testing.assert_array_equal(np.array(got), want)
    assert pf.ring.made == (0 if views else len(seen)) and (views or len(seen) <= 4)


# ---- both packages' native decoders --------------------------------------------------------


@pytest.fixture(scope="module")
def ffv1(tmp_path_factory):
    """A 60-frame 24 fps FFV1 clip whose frames differ everywhere."""
    rng = np.random.default_rng(17)
    frames = rng.integers(0, 256, (60, 48, 64), dtype=np.uint8)
    return helpers.write_video(frames, str(tmp_path_factory.mktemp("dec") / "noise"), 24)


@pytest.mark.parametrize("start", [0.0, 10 / 24, 1.3])
@pytest.mark.parametrize("chunk", [7, 16])
def test_native_decoders_give_byte_equal_frames(ffv1, start, chunk):
    """The port's NativeFrameSource and the JAX package's decode the same
    FFV1 file to the same bytes, chunk by chunk, each into a buffer of the
    caller's (the port's into a staging ring buffer, as the full-frame engine
    has it write on the card), from start 0 and past it."""
    from pawsometracker_tpu.io import native_io as jax_native
    from pawsometracker_tpu_torch.io import native_io as port_native

    if not (port_native.native_available() and jax_native.native_available()):
        pytest.skip("the native libav decoder did not build here")
    ours = port_native.NativeFrameSource(ffv1, start=start, fps=24)
    theirs = jax_native.NativeFrameSource(ffv1, start=start, fps=24)
    ring = port_decode.ChunkRing(copy=lambda src, dst: np.copyto(dst, src))
    n = 0
    try:
        while True:
            got = ring.read(ours, chunk, chunk)
            want = theirs.read_chunk(chunk, out=np.empty((chunk,) + got.shape[1:], np.uint8))
            np.testing.assert_array_equal(got, want)
            if len(got) == 0:
                break
            assert ring.holds(got)  # decoded in place
            n += len(got)
            ring.recycle(got)
    finally:
        ours.close()
        theirs.close()
    assert n == 60 - round(start * 24)


# ---- no fallback -------------------------------------------------------------------------


def test_staging_copy_that_does_not_build_raises(monkeypatch):
    """On the card the staging copy is the native one; a library that does
    not build raises when the copier is made, before any frame moves."""
    def broken():
        raise RuntimeError("nvcc failed for roi_crop.cpp")

    monkeypatch.setattr(roi_crop, "_lib", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        roi_crop.frame_copier()


def test_staging_copy_that_is_refused_raises(monkeypatch):
    class Refusing:
        @staticmethod
        def roi_crop_lanes(*a):
            return 1

        @staticmethod
        def copy_frames(*a):
            return -1

    monkeypatch.setattr(roi_crop, "_lib", lambda: Refusing)
    frames = numbered(6)
    with pytest.raises(ValueError, match="refused"):
        roi_crop.copy_frames_native(frames, np.empty_like(frames))
