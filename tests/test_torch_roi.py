"""The port's speculative ROI pipeline on the CPU, against the JAX package.

The same seeded frames and FFV1 files go through the JAX package's
``track(stream="roi")`` and the port's ``track(stream="roi", device="cpu")``:
integer positions bit-equal, ``ts`` equal, subpixel offsets within
``atol=1e-3``, and positions equal to the port's own ``stream="full"`` run.
Also the single-video invariants of ``tests/test_roi_stream.py`` and
``tests/test_diag_fastpath.py``, held on the port: geometry, crops, every
depth and speculation mode, replays, rewinds at an offset, splits, frame
edges, diagnostics on the native retained ring, and the controller's units.
"""

import hashlib
import os

import numpy as np
import pytest

import pawsometracker_tpu as ref
import pawsometracker_tpu.api as ref_api
import pawsometracker_tpu.pipeline as ref_pipeline
import pawsometracker_tpu_torch as port
import pawsometracker_tpu_torch.api as port_api
import pawsometracker_tpu_torch.pipeline as pipeline
from pawsometracker_tpu.models.dog_tracker import make_spec as ref_make_spec
from pawsometracker_tpu_torch.io import native_io
from pawsometracker_tpu_torch.models.dog_tracker import make_spec
from pawsometracker_tpu_torch.ops.roi_crop import crop_with_fill as _crop_with_fill
from pawsometracker_tpu_torch.pipeline import (
    AUTO_DEPTH_MAX,
    SpeculativePipeline,
    _AUTO_DEPTH_MEMO,
    _Pending,
    auto_depth_cap,
    roi_geometry,
)

import helpers

cv2 = pytest.importorskip("cv2")

OFFSET_ATOL = 1e-3


def both(src, loc, **kw):
    """``(port, jax)`` results of ``track(src, start_location=loc, **kw)``;
    the port's on the CPU."""
    got = port.track(src, start_location=port.IJ(*loc), device="cpu", **kw)
    want = ref.track(src, start_location=ref.IJ(*loc), **kw)
    return got, want


def assert_same(got, want, subpixel=False):
    np.testing.assert_array_equal(got[0], want[0])
    if subpixel:
        np.testing.assert_array_equal(np.round(got[1]), np.round(want[1]))
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=OFFSET_ATOL)
    else:
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype


def port_full(src, loc, **kw):
    roi_only = ("stream", "roi_frames", "pipeline_depth", "speculate")
    kw = {k: v for k, v in kw.items() if k not in roi_only}
    return port.track(src, start_location=port.IJ(*loc), device="cpu", stream="full", **kw)


def spiral_video(tmp_path, seed, start=(50, 50), n=72, h=100, w=100):
    """An FFV1 file of the first ``n`` frames of a seeded spiral clip."""
    rng = np.random.default_rng(seed)
    _, tra = helpers.build_trajectory(28, 24, start, rng)
    return helpers.trajectory2video(tra[:n], str(tmp_path), 24, w, h, 10, True)


def triangle_frames(T=48, h=160, w=160, row0=40, col=80):
    """A target that reverses every 6 frames at 12 px a frame (inside the
    15-px window radius): velocity extrapolation across a reversal is as
    wrong as it gets, so predict mode replays."""
    frames = []
    for t in range(T):
        ph = t % 12
        tri = 12 * ph if ph < 6 else 12 * (12 - ph)
        frames.append(helpers.render_frame(h, w, (row0 + tri, col), 10, True))
    return np.stack(frames)


def erratic_frames(seed, T=48, h=160, w=160, start=(60, 60), step=12, lo=30, hi=130):
    rng = np.random.default_rng(seed)
    frames = []
    pos = np.array(start, np.int64)
    for _ in range(T):
        pos = np.clip(pos + rng.integers(-step, step + 1, 2), lo, hi)
        img = np.full((h, w), 128, np.uint8)
        cv2.circle(img, (int(pos[1]), int(pos[0])), 5, 0, -1)
        frames.append(img)
    return np.stack(frames)


def decoded(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return np.stack(out)


@pytest.fixture
def spy_single(monkeypatch):
    """Record (use_native_retained, keep_for_dia) of each port SingleVideoSource."""
    flags = []
    orig = pipeline.SingleVideoSource.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        flags.append((self.use_native_retained, self.keep_for_dia))

    monkeypatch.setattr(pipeline.SingleVideoSource, "__init__", spy)
    return flags


@pytest.fixture
def no_views(monkeypatch):
    """A native layer without zero-copy retained views: the prefetcher delivery."""
    orig = native_io.NativeFrameSource._finish_open

    def patched(self, lib, info, prefetch):
        orig(self, lib, info, prefetch)
        self.can_view_retained = False

    monkeypatch.setattr(native_io.NativeFrameSource, "_finish_open", patched)


@pytest.fixture
def memo():
    _AUTO_DEPTH_MEMO.clear()
    yield _AUTO_DEPTH_MEMO
    _AUTO_DEPTH_MEMO.clear()


# ---- geometry and crops ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["contain", "predict"])
def test_roi_geometry_matches_jax(mode):
    for shape, win, tw in (((1080, 1920), 41, 25), ((1080, 1920), 105, 60), ((100, 100), 21, 10)):
        spec, rspec = make_spec(shape, win, tw, True), ref_make_spec(shape, win, tw, True)
        for k in (1, 4, 8, 12, 16):
            for depth in (0, 1, 2, 3, 7):
                assert roi_geometry(spec, k, depth, mode) == ref_pipeline.roi_geometry(
                    rspec, k, depth, mode)
    spec = make_spec((1080, 1920), 41, 25, True)
    half = spec.kernel_len // 2
    ch, cw, (mi, mj) = roi_geometry(spec, 8)
    assert mi == 8 * 20 + half and ch == 2 * mi + 1 and cw == 2 * mj + 1
    assert roi_geometry(spec, 8, depth=1)[2][0] == 2 * 8 * 20 + half
    # halving K at depth 1 reproduces the synchronous crop size
    assert roi_geometry(spec, 4, depth=1)[:2] == roi_geometry(spec, 8, depth=0)[:2]
    # the bench shape's predict crop at K = 12, and the large target's
    assert roi_geometry(spec, 12, 7, "predict")[:2] == (185, 185)
    big = make_spec((1080, 1920), 105, 60, True)
    assert roi_geometry(big, 12, 7, "predict")[:2] == (461, 461)


def test_crop_with_fill():
    f = np.arange(100, dtype=np.uint8).reshape(10, 10)
    c = _crop_with_fill(f, (-2, 3), 6, 6, fill=7)
    assert c.shape == (6, 6)
    assert (c[:2] == 7).all()
    assert c[2, 0] == f[0, 3]
    c2 = _crop_with_fill(f, (8, 8), 6, 6, fill=9)
    assert c2[0, 0] == f[8, 8]
    assert (c2[2:] == 9).all() and (c2[:, 2:] == 9).all()
    for o in ((-2, 3), (8, 8), (-20, 4), (3, 3), (9, -5)):
        np.testing.assert_array_equal(_crop_with_fill(f, o, 6, 7, 5),
                                      ref_pipeline._crop_with_fill(f, o, 6, 7, 5))


def test_predict_margin_is_slim_and_k_independent():
    spec = make_spec((1080, 1920), 41, 25, True)
    half = spec.kernel_len // 2
    ch8, cw8, (mi8, _) = roi_geometry(spec, 8, 3, "predict")
    assert mi8 >= 20 + half  # the 1-frame progress floor
    assert mi8 < 8 * 20 + half  # slimmer than the synchronous bound
    assert roi_geometry(spec, 16, 3, "predict")[:2] == (ch8, cw8)
    assert roi_geometry(spec, 8, 7, "predict")[:2] == (ch8, cw8)


def test_auto_depth_cap_memory_bound(monkeypatch):
    monkeypatch.delenv("PAWS_RING_BUDGET_MB", raising=False)
    assert auto_depth_cap((1080, 1920), 8) == AUTO_DEPTH_MAX
    cap_4k = auto_depth_cap((2160, 3840), 8)
    assert 1 <= cap_4k < AUTO_DEPTH_MAX
    assert ((cap_4k + 2) * 8 + 8) * 2160 * 3840 <= 512e6
    for shape, k in (((1080, 1920), 12), ((2160, 3840), 12), ((4320, 7680), 8)):
        assert auto_depth_cap(shape, k) == ref_pipeline.auto_depth_cap(shape, k)
    monkeypatch.setenv("PAWS_RING_BUDGET_MB", "64")
    assert auto_depth_cap((1080, 1920), 8) < AUTO_DEPTH_MAX
    assert auto_depth_cap((1080, 1920), 8) == ref_pipeline.auto_depth_cap((1080, 1920), 8)


# ---- end to end against the JAX package ----------------------------------------------


#: two starts of the seed-21 spiral: one in the middle of the frame, one whose
#: path runs along the top and right edges (no exact ties on either)
STARTS = [(50, 50), (30, 70)]


@pytest.fixture(scope="module")
def matrix_files(tmp_path_factory):
    """Per start: the FFV1 file and the port's ``stream="full"`` positions."""
    out = {}
    for start in STARTS:
        f = spiral_video(tmp_path_factory.mktemp("spiral"), 21, start)
        out[start] = (f, port_full(f, start, fps=24, target_width=10)[1])
    return out


@pytest.mark.parametrize("start_ij", STARTS)
@pytest.mark.parametrize("depth", [0, 1, 2, "auto"])
@pytest.mark.parametrize("speculate", ["contain", "predict"])
def test_roi_matches_jax_and_full(matrix_files, spy_single, start_ij, depth, speculate):
    """An FFV1 file: predict mode at depth >= 1 rides the native retained
    ring, contain mode reads crops from the native decoder directly."""
    f, full = matrix_files[start_ij]
    got, want = both(f, start_ij, fps=24, target_width=10, stream="roi", roi_frames=4,
                     pipeline_depth=depth, speculate=speculate)
    assert_same(got, want)
    np.testing.assert_array_equal(got[1], full)
    retained = speculate == "predict" and depth != 0
    assert spy_single[-1] == (retained, False)


def test_predict_mispredict_replay():
    frames = triangle_frames()
    kw = dict(fps=24, target_width=10, window_size=31, stream="roi", roi_frames=4,
              pipeline_depth=2, speculate="predict")
    before = pipeline.replay_count
    got, want = both(frames, (40, 80), **kw)
    assert pipeline.replay_count > before  # the replay path ran
    assert_same(got, want)
    np.testing.assert_array_equal(got[1], port_full(frames, (40, 80), **kw)[1])


def test_pipelined_rewind_recrops_at_offset(tmp_path, monkeypatch, spy_single):
    """With lazy drains at depth 3 the controller re-dispatches a second
    rewind entry before draining the first, so the native ring must re-crop
    at the in-flight frame-count offset ``base``; a base-0 recrop would read
    the wrong frames, self-consistently enough to pass containment."""
    monkeypatch.setenv("PAWS_EAGER_DRAIN", "0")
    f = helpers.write_video(list(triangle_frames(T=60)), str(tmp_path / "jump"), 24)
    bases = []
    orig = pipeline.SingleVideoSource.recrop

    def spy(self, tokens, valid, origins, rbuf, timer, base, off):
        bases.append(int(base[0]))
        return orig(self, tokens, valid, origins, rbuf, timer, base, off)

    monkeypatch.setattr(pipeline.SingleVideoSource, "recrop", spy)
    kw = dict(fps=24, target_width=10, window_size=31, stream="roi", roi_frames=4,
              pipeline_depth=3, speculate="predict")
    before = pipeline.replay_count
    got, want = both(f, (40, 80), **kw)
    assert pipeline.replay_count > before
    assert any(b > 0 for b in bases), f"no offset recrop exercised: {bases}"
    assert spy_single[-1] == (True, False)  # on the native retained ring
    assert_same(got, want)
    np.testing.assert_array_equal(got[1], port_full(f, (40, 80), **kw)[1])


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_roi_near_edges(depth):
    """A target running into the top-left corner: clamps as on full frames.
    (Off the diagonal: a disc in the corner on it ties exactly, where the two
    packages differ by design.)"""
    frames = np.stack([helpers.render_frame(80, 80, (max(3, 30 - t), max(1, 30 - t)), 8, True)
                       for t in range(40)])
    kw = dict(fps=24, target_width=8, stream="roi", roi_frames=4, pipeline_depth=depth)
    got, want = both(frames, (30, 30), **kw)
    assert_same(got, want)
    np.testing.assert_array_equal(got[1], port_full(frames, (30, 30), **kw)[1])
    assert (got[1] >= 0).all()


def test_roi_subpixel_matches_jax_and_sync(tmp_path):
    f = spiral_video(tmp_path, 22)
    kw = dict(fps=24, target_width=10, subpixel=True, stream="roi", roi_frames=4)
    got, want = both(f, (50, 50), pipeline_depth=2, **kw)
    assert got[1].dtype == np.float64
    assert_same(got, want, subpixel=True)
    sync = port.track(f, start_location=port.IJ(50, 50), device="cpu", pipeline_depth=0, **kw)
    np.testing.assert_array_equal(got[1], sync[1])
    full = port_full(f, (50, 50), **kw)
    np.testing.assert_array_equal(got[1], full[1])


def test_roi_diagnostics_match_jax(tmp_path, spy_single):
    """The overlay frames of a pipelined ROI run decode equal to the JAX
    package's (same basename: the label is the file's name), frames 2..n."""
    f = spiral_video(tmp_path, 23)
    paths = []
    for name in ("port", "ref"):
        (tmp_path / name).mkdir()
        paths.append(str(tmp_path / name / "diag.mp4"))
    kw = dict(fps=24, target_width=10, stream="roi", roi_frames=4, pipeline_depth=2)
    got = port.track(f, start_location=port.IJ(50, 50), device="cpu", diagnostic_file=paths[0],
                     **kw)
    assert spy_single[-1] == (True, True)  # diagnostics rode the retained ring
    want = ref.track(f, start_location=ref.IJ(50, 50), diagnostic_file=paths[1], **kw)
    assert_same(got, want)
    ours, theirs = decoded(paths[0]), decoded(paths[1])
    assert ours.shape == (len(got[1]) - 1, 360, 640, 3)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("seed", range(6))
def test_roi_random_walk_property(seed):
    """Any motion the tracker can follow (steps up to the window radius, any
    direction) gives the full-frame positions in predict mode."""
    rng = np.random.default_rng(200 + seed)
    ij = np.array([80, 80])
    frames = []
    for _ in range(40):
        ij = np.clip(ij + rng.integers(-9, 10, size=2), 6, [153, 153])
        img = np.full((160, 160), 128, np.uint8)
        cv2.circle(img, (int(ij[1]), int(ij[0])), 4, 0, -1)
        frames.append(img)
    frames = np.stack(frames)
    kw = dict(fps=24, target_width=8, window_size=21, stream="roi", roi_frames=4,
              pipeline_depth=2)
    got, want = both(frames, (80, 80), **kw)
    assert_same(got, want)
    np.testing.assert_array_equal(got[1], port_full(frames, (80, 80), **kw)[1])


@pytest.mark.parametrize("shape,tw", [((160, 160), 4), ((160, 160), 10), ((120, 160), 3),
                                      ((100, 100), 10)])
def test_auto_stream_picks_roi_like_jax(monkeypatch, shape, tw):
    """``stream="auto"`` takes the ROI pipeline exactly when the JAX package
    does: when the crop is under half the frame."""
    picks = {}
    for name, mod in (("port", port_api), ("ref", ref_api)):
        orig = mod.run_roi_pipeline

        def spy(*a, _orig=orig, _name=name, **k):
            picks[_name] = True
            return _orig(*a, **k)

        monkeypatch.setattr(mod, "run_roi_pipeline", spy)
    h, w = shape
    frames = np.stack([helpers.render_frame(h, w, (h // 2 + t, w // 2 + t), tw, True)
                       for t in range(16)])
    got, want = both(frames, (h // 2, w // 2), fps=24, target_width=tw)
    assert_same(got, want)
    spec = make_spec(shape, port_api.guess_window_size(tw), tw, True)
    ch, cw, _ = roi_geometry(spec, 12, AUTO_DEPTH_MAX, "predict")
    assert picks.get("port", False) == picks.get("ref", False) == (ch * cw * 2 < h * w)


def test_auto_depth_identical_and_after_replay(memo):
    rng = np.random.default_rng(61)
    _, tra = helpers.build_trajectory(40, 24, (60, 60), rng)
    frames = np.stack([helpers.render_frame(140, 140, ij, 10, True) for ij in tra[:72]])
    kw = dict(fps=24, target_width=10, stream="roi", pipeline_depth="auto")
    got, want = both(frames, (60, 60), **kw)
    assert_same(got, want)
    np.testing.assert_array_equal(got[1], port_full(frames, (60, 60), **kw)[1])
    # a warm memo start gives the same positions
    assert memo
    np.testing.assert_array_equal(port.track(frames, start_location=port.IJ(60, 60),
                                             device="cpu", **kw)[1], got[1])
    # teleporting motion under auto depth: the replays reset the horizon
    tri = triangle_frames()
    kw = dict(fps=24, target_width=10, window_size=31, stream="roi", roi_frames=4,
              pipeline_depth="auto")
    before = pipeline.replay_count
    got, want = both(tri, (40, 80), **kw)
    assert pipeline.replay_count > before
    assert_same(got, want)
    np.testing.assert_array_equal(got[1], port_full(tri, (40, 80), **kw)[1])


def test_roi_eager_equals_lazy_drain(monkeypatch):
    rng = np.random.default_rng(78)
    _, tra = helpers.build_trajectory(28, 24, (50, 50), rng)
    frames = np.stack([helpers.render_frame(100, 100, ij, 10, True) for ij in tra[:60]])
    kw = dict(fps=24, start_location=port.IJ(50, 50), target_width=10, stream="roi",
              roi_frames=4, pipeline_depth=3, device="cpu")
    eager = port.track(frames, **kw)
    monkeypatch.setenv("PAWS_EAGER_DRAIN", "0")
    lazy = port.track(frames, **kw)
    np.testing.assert_array_equal(eager[1], lazy[1])
    np.testing.assert_array_equal(eager[0], lazy[0])


def test_fast_target_splits_and_stays_exact(monkeypatch):
    """A slack of 8 px makes even the exact-origin rewind chunks escape: the
    controller splits them down to the contained single frame."""
    monkeypatch.setenv("PAWS_PREDICT_SLACK", "8")
    frames = erratic_frames(7)
    splits = []
    orig = pipeline.SpeculativePipeline._split_exact

    def spy(self, ent):
        splits.append(int(ent.valid.max()))
        return orig(self, ent)

    monkeypatch.setattr(pipeline.SpeculativePipeline, "_split_exact", spy)
    kw = dict(fps=24, target_width=10, window_size=31, stream="roi", roi_frames=8,
              pipeline_depth=3, speculate="predict")
    before = pipeline.replay_count
    got, want = both(frames, (60, 60), **kw)
    assert pipeline.replay_count > before
    assert splits, "no exact rewind chunk was split"
    assert_same(got, want)
    np.testing.assert_array_equal(got[1], port_full(frames, (60, 60), **kw)[1])


def test_roi_ffv1_opencv_and_xla_engine(tmp_path):
    """The prefetcher delivery of a decoded file (OpenCV: no native ring) and
    the plain scan (``engine="xla"``) give the JAX package's positions."""
    f = spiral_video(tmp_path, 24, n=60)
    kw = dict(fps=24, target_width=10, stream="roi", roi_frames=4, pipeline_depth=2)
    got, want = both(f, (50, 50), backend="opencv", **kw)
    assert_same(got, want)
    xla = port.track(f, start_location=port.IJ(50, 50), device="cpu", engine="xla", **kw)
    np.testing.assert_array_equal(xla[1], got[1])


def test_roi_segments_and_progress():
    rng = np.random.default_rng(5)
    _, tra = helpers.build_trajectory(28, 24, (50, 50), rng)
    frames = np.stack([helpers.render_frame(100, 100, ij, 10, True) for ij in tra[:72]])
    kw = dict(fps=24, target_width=10, stream="roi", roi_frames=4, pipeline_depth=2)
    segs = [frames[:40], frames[39:]]
    got = port.track(segs, start_location=[port.IJ(50, 50), None], device="cpu", **kw)
    want = ref.track(segs, start_location=[ref.IJ(50, 50), None], **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    calls = []
    ts, ij = port.track(frames, start_location=port.IJ(50, 50), device="cpu",
                        progress=lambda d, t: calls.append((d, t)), **kw)
    dones = [d for d, _ in calls]
    assert dones == sorted(dones) and dones[-1] == len(ij) - 1
    assert all(t == calls[0][1] for _, t in calls)


def test_batch_and_multi_still_raise_on_roi():
    """track_batch and track_multi take stream="roi" (their ROI engines,
    tested in tests/test_torch_roi_lanes.py) and still raise on a bad ROI
    chunk length, as track does."""
    frames = np.stack([helpers.render_frame(60, 60, (30, 30), 10, True)] * 4)
    (ts, ij), = port.track_batch([frames], stream="roi", device="cpu")
    np.testing.assert_array_equal(ij, port.track(frames, stream="roi", device="cpu")[1])
    _, pos = port.track_multi(frames, [port.IJ(30, 30)], stream="roi", device="cpu")
    np.testing.assert_array_equal(pos[:, 0], port.track(frames, start_location=port.IJ(30, 30),
                                                        stream="roi", device="cpu")[1])
    for run in (lambda: port.track_batch([frames], stream="roi", roi_frames=0, device="cpu"),
                lambda: port.track_multi(frames, [port.IJ(30, 30)], stream="roi", roi_frames=0,
                                         device="cpu")):
        with pytest.raises(ValueError, match="roi_frames"):
            run()


# ---- the controller's units ----------------------------------------------------


def _pipe(**over):
    kw = dict(L=1, K=8, crop_shape=(61, 61), margin=(30, 30),
              spec=make_spec((200, 200), 21, 10, True), mode="predict", depth=1, engine=None,
              source=None, sink=None, timer=None)
    kw.update(over)
    return SpeculativePipeline(**kw)


def test_auto_depth_memo_warm_starts_same_geometry(memo):
    kw = dict(depth="auto")
    p1 = _pipe(**kw)
    assert p1.depth_cur == 1
    memo[p1._memo_key] = (5, 6)  # what a converged run records: depth, soft cap
    p2 = _pipe(**kw)
    assert p2.depth_cur == 5 and p2._depth_soft_cap == 6
    assert _pipe(auto_cap=2, **kw).depth_cur == 2  # never above this pipeline's cap
    assert _pipe(K=4, **kw).depth_cur == 1  # another geometry ramps from 1
    assert _pipe(depth=3).depth_cur == 3  # a fixed depth ignores the memo


def test_split_exact_one_frame_floor_raises():
    pipe = _pipe()
    ent = _Pending(None, np.zeros((1, 8, 2), np.int64), np.array([4]), None, None, exact=True)
    subs = pipe._split_exact(ent)
    assert [int(e.valid[0]) for e in subs] == [2, 2]
    assert [int(e.off[0]) for e in subs] == [0, 2]
    one = _Pending(None, np.zeros((1, 8, 2), np.int64), np.array([1]), None, None, exact=True)
    with pytest.raises(RuntimeError, match="1-frame exact rewind"):
        pipe._split_exact(one)


def test_replay_prepends_to_rewind_queue():
    pipe = _pipe()
    pipe.engine = type("E", (), {"reset": lambda self: None})()
    pipe.accel = np.zeros((1, 2))
    pipe._last_k = np.zeros(1, np.int64)
    later = _Pending(None, None, np.array([8]), None, None)
    pipe._rewind.append(later)
    e1 = _Pending(None, None, np.array([4]), None, None)
    e2 = _Pending(None, None, np.array([4]), None, None)
    pipe._replay([e1, e2])
    assert list(pipe._rewind) == [e1, e2, later]


def test_error_aware_depth_gating_unit(memo):
    p = _pipe(crop_shape=(81, 81), margin=(40, 40), depth="auto")
    slack = int(p._slack[0])
    assert slack == 40 - int(p.rh[0])
    valid = np.array([8])
    origins = np.zeros((1, 8, 2), np.int64)
    centered = origins + p.margin
    p.depth_cur, p._depth_soft_cap = 4, 7
    bad = centered.copy()
    bad[0, -1, 0] += int(0.9 * slack)
    p._update_depth_from_error(bad, origins, valid)
    assert p._depth_soft_cap == 3 and p.depth_cur <= 3
    p._clean_since_replay = 5
    mid = centered.copy()
    mid[0, 0, 1] += int(0.6 * slack)
    p._update_depth_from_error(mid, origins, valid)
    assert p._depth_soft_cap == 3 and p._clean_since_replay == 0
    for _ in range(p._relax_need + 1):
        p._update_depth_from_error(centered, origins, valid)
    assert p._depth_soft_cap == 3  # no blocked drain asked: no exploration
    p._cap_wanted = True
    for _ in range(p._relax_need):
        p._update_depth_from_error(centered, origins, valid)
    assert p._depth_soft_cap == 4 and p._cap_wanted is False
    need0 = p._relax_need
    p.depth_cur = p._depth_soft_cap
    p.engine = type("E", (), {"reset": lambda self: None})()
    p.accel = np.zeros((1, 2))
    p._last_k = np.zeros(1, np.int64)
    p._replay([])
    assert p._relax_need == min(2 * need0, 8 * p.CLEAN_RELAX_CHUNKS)


def test_coordinated_turn_aim_matches_jax(memo):
    """The turn model is exact on circles at a 40-frame horizon, decays to the
    linear prediction, and gives the JAX controller's origins."""
    spec, rspec = make_spec((2000, 2000), 21, 10, True), ref_make_spec((2000, 2000), 21, 10, True)
    kw = dict(L=1, K=8, crop_shape=(81, 81), margin=(40, 40), mode="predict", depth="auto",
              engine=None, source=None, sink=None, timer=None)
    p = SpeculativePipeline(spec=spec, **kw)
    ref_pipeline._AUTO_DEPTH_MEMO.clear()
    r = ref_pipeline.SpeculativePipeline(spec=rspec, **kw)
    R, w = 600.0, 0.0131
    center = np.array([1000.0, 1000.0])

    def pos(t):
        return center + R * np.array([np.sin(w * t), np.cos(w * t)])

    t0 = 100

    class _E:
        valid = np.array([40])

    for x in (p, r):
        x.P = np.round(pos(t0)).astype(np.int64)[None]
        x.vel = (R * w * np.array([np.cos(w * t0), -np.sin(w * t0)]))[None]
        x.accel = (-R * w * w * np.array([np.sin(w * t0), np.cos(w * t0)]))[None]
        x._vel_lag = np.zeros(1)
        x._pending.append(_E())
    origins = p._aim()
    np.testing.assert_array_equal(origins, r._aim())
    for i in range(8):
        assert np.abs(origins[0, i] + p.margin - pos(t0 + 40 + i)).max() < 4.0
    p._pending.clear()
    p.vel = np.array([[3.0, -2.0]])
    p.accel = np.zeros((1, 2))
    origins = p._aim()
    for i in range(8):
        np.testing.assert_allclose(origins[0, i] + p.margin, np.round(p.P[0] + p.vel[0] * i))


def test_default_k_respects_effective_mode(monkeypatch):
    """``pipeline_depth=0`` runs contain geometry even with the default
    ``speculate="predict"``: K = 8 there, and 12 only in effective predict mode."""
    seen = []
    orig = pipeline.roi_geometry

    def spy(spec, k_frames, depth=0, mode="contain"):
        seen.append((k_frames, mode))
        return orig(spec, k_frames, depth, mode)

    monkeypatch.setattr(port_api, "roi_geometry", spy)
    monkeypatch.setattr(pipeline, "roi_geometry", spy)
    frames = np.stack([helpers.render_frame(100, 100, (50, 50 + t), 10, True) for t in range(20)])
    kw = dict(fps=24, start_location=port.IJ(50, 50), target_width=10, stream="roi",
              device="cpu")
    port.track(frames, pipeline_depth=0, **kw)
    assert seen and all(k == 8 for k, m in seen if m == "contain"), seen
    assert not any(m == "predict" for _, m in seen), seen
    seen.clear()
    port.track(frames, pipeline_depth=2, **kw)
    assert any(k == 12 and m == "predict" for k, m in seen), seen
    for depth, spec_ in ((0, "predict"), (2, "predict"), (1, "contain"), (3, "contain")):
        assert port_api._resolve_roi_frames(None, depth, spec_) == \
            ref_api._resolve_roi_frames(None, depth, spec_)


def test_auto_ring_gate_matches_jax(tmp_path):
    f = spiral_video(tmp_path, 25, n=24)
    arr = np.zeros((4, 2160, 3840), np.uint8)
    for src in (f, arr):
        for k in (4, 12):
            assert port_api._auto_ring_gate(src, k, AUTO_DEPTH_MAX) == \
                ref_api._auto_ring_gate(src, k, AUTO_DEPTH_MAX)
    assert port_api._auto_ring_gate(arr, 12, AUTO_DEPTH_MAX) < AUTO_DEPTH_MAX
    assert port_api._auto_ring_gate(arr, 12, AUTO_DEPTH_MAX, zero_copy=True) == AUTO_DEPTH_MAX


# ---- diagnostics on the native retained ring (tests/test_diag_fastpath.py) --------


def test_dia_fast_path_byte_equal(tmp_path, spy_single, monkeypatch):
    """With a diagnostic file the pipeline keeps the native retained ring and
    overlays from zero-copy views; the positions equal a run without
    diagnostics and the overlay file equals the prefetcher delivery's."""
    f = spiral_video(tmp_path, 51, h=120, w=160)
    kw = dict(fps=24, start_location=port.IJ(50, 50), target_width=10, stream="roi",
              roi_frames=4, pipeline_depth=2, device="cpu")
    plain = port.track(f, **kw)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    fast, slow = str(tmp_path / "a" / "diag.mp4"), str(tmp_path / "b" / "diag.mp4")
    got = port.track(f, diagnostic_file=fast, **kw)
    assert spy_single[-1] == (True, True)
    np.testing.assert_array_equal(got[1], plain[1])
    assert decoded(fast).shape[:3] == (len(plain[1]) - 1, 360, 640)
    orig = native_io.NativeFrameSource._finish_open

    def patched(self, lib, info, prefetch):
        orig(self, lib, info, prefetch)
        self.can_view_retained = False

    monkeypatch.setattr(native_io.NativeFrameSource, "_finish_open", patched)
    got_slow = port.track(f, diagnostic_file=slow, **kw)
    assert spy_single[-1][0] is False
    np.testing.assert_array_equal(got_slow[1], plain[1])
    assert hashlib.sha256(open(fast, "rb").read()).hexdigest() == \
        hashlib.sha256(open(slow, "rb").read()).hexdigest()


def test_dia_fallback_when_views_unavailable(tmp_path, spy_single, no_views):
    f = spiral_video(tmp_path, 53, h=100, w=120)
    dia = str(tmp_path / "diag.mp4")
    ts, ij = port.track(f, fps=24, start_location=port.IJ(50, 50), target_width=10,
                        stream="roi", roi_frames=4, pipeline_depth=2, diagnostic_file=dia,
                        device="cpu")
    assert spy_single[-1][0] is False
    assert decoded(dia).shape[0] == len(ij) - 1
    np.testing.assert_array_equal(ij, port_full(f, (50, 50), fps=24, target_width=10)[1])


def test_dia_fast_path_replays_byte_equal(tmp_path, spy_single, monkeypatch):
    f = helpers.write_video(list(triangle_frames()), str(tmp_path / "jump"), 24)
    kw = dict(fps=24, target_width=10, window_size=31, stream="roi", roi_frames=4,
              pipeline_depth=2, speculate="predict")
    want = port_full(f, (40, 80), **kw)[1]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    fast, slow = str(tmp_path / "a" / "diag.mp4"), str(tmp_path / "b" / "diag.mp4")
    before = pipeline.replay_count
    got = port.track(f, start_location=port.IJ(40, 80), device="cpu", diagnostic_file=fast, **kw)
    assert pipeline.replay_count > before
    assert spy_single[-1] == (True, True)
    np.testing.assert_array_equal(got[1], want)
    orig = native_io.NativeFrameSource._finish_open

    def patched(self, lib, info, prefetch):
        orig(self, lib, info, prefetch)
        self.can_view_retained = False

    monkeypatch.setattr(native_io.NativeFrameSource, "_finish_open", patched)
    got_slow = port.track(f, start_location=port.IJ(40, 80), device="cpu",
                          diagnostic_file=slow, **kw)
    np.testing.assert_array_equal(got_slow[1], want)
    np.testing.assert_array_equal(decoded(fast), decoded(slow))
    assert os.path.getsize(fast) > 0
