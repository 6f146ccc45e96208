"""The port's ROI engines of ``track_batch`` and ``track_multi`` on the CPU,
against the JAX package.

The same seeded frames and FFV1 files go through the JAX package's
``track_batch``/``track_multi`` with ``stream="roi"`` and the port's with
``device="cpu"``: integer positions bit-equal, ``ts`` equal, subpixel offsets
within ``atol=1e-3``, overlay frames byte-equal, and positions equal to the
port's own ``stream="full"`` run. The cases are the batch and multi
invariants of ``tests/test_roi_stream.py``, ``tests/test_multi.py``,
``tests/test_array_input.py`` and ``tests/test_diag_fastpath.py``: every
depth, replays, splits and lanes with no frames under adversarial schedules,
mixed-resolution buckets, diagnostics with and without retained views; and
the units: the batched chain's carry, the engine's boxes and rebases, the
``stream="auto"`` rules and the ring gate.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pawsometracker_tpu as ref
import pawsometracker_tpu.api as ref_api
import pawsometracker_tpu.pipeline as ref_pipeline
import pawsometracker_tpu_torch as port
import pawsometracker_tpu_torch.api as port_api
import pawsometracker_tpu_torch.pipeline as pipeline
from pawsometracker_tpu.batch import track_batch as ref_track_batch
from pawsometracker_tpu.models.dog_tracker import make_spec as ref_make_spec
from pawsometracker_tpu.multi import track_multi as ref_track_multi
from pawsometracker_tpu.parallel.mesh import ShardedBatchTracker as RefTracker
from pawsometracker_tpu_torch.io import native_io
from pawsometracker_tpu_torch.io.decode import probe
from pawsometracker_tpu_torch.models.dog_tracker import make_spec
from pawsometracker_tpu_torch.parallel.mesh import ShardedBatchTracker
from pawsometracker_tpu_torch.pipeline import AUTO_DEPTH_MAX, chain_batch, last_rows

import helpers

cv2 = pytest.importorskip("cv2")

OFFSET_ATOL = 1e-3


def ij_locs(pkg, locs):
    return [pkg.IJ(*loc) for loc in locs]


def batch_both(files, locs, **kw):
    """``(port, jax)`` results of ``track_batch(files, start_location=locs,
    **kw)``; the port's on the CPU."""
    got = port.track_batch(files, start_location=ij_locs(port, locs), device="cpu", **kw)
    want = ref_track_batch(files, start_location=ij_locs(ref, locs), **kw)
    return got, want


def multi_both(src, locs, **kw):
    got = port.track_multi(src, ij_locs(port, locs), device="cpu", **kw)
    want = ref_track_multi(src, ij_locs(ref, locs), **kw)
    return got, want


def assert_same(got, want, subpixel=False, dtype=True):
    """One ``(ts, positions)`` pair equal to another: ``ts`` and integer
    positions exactly, subpixel positions within ``OFFSET_ATOL``. ``dtype``:
    the integer dtypes match too (as both packages give them: int64 from ROI
    streaming, int32 from full frames)."""
    np.testing.assert_array_equal(got[0], want[0])
    if subpixel:
        np.testing.assert_array_equal(np.round(got[1]), np.round(want[1]))
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=OFFSET_ATOL)
    else:
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype or not dtype


def assert_batch_same(got, want, subpixel=False, dtype=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g, w, subpixel, dtype)


def port_full_batch(files, locs, **kw):
    kw = {k: v for k, v in kw.items() if k not in ("stream", "roi_frames")}
    kw.setdefault("chunk_size", 16)
    return port.track_batch(files, start_location=ij_locs(port, locs), device="cpu",
                            stream="full", **kw)


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


def triangle_frames(T=48, h=200, w=200):
    """A disc that reverses every 6 frames at 12 px a frame: velocity
    extrapolation across a reversal is as wrong as it gets, so predict mode
    replays (tests/test_roi_stream.py:203)."""
    frames = []
    for t in range(T):
        ph = t % 12
        tri = 12 * ph if ph < 6 else 12 * (12 - ph)
        img = np.full((h, w), 128, np.uint8)
        cv2.circle(img, (100, 60 + tri), 5, 0, -1)
        frames.append(img)
    return np.stack(frames)


def two_target_frames(T=60, h=120, w=160):
    """Two discs on crossing straight paths (tests/test_multi.py:13)."""
    paths = [[(30 + t // 2, 30 + t) for t in range(T)], [(90 - t // 3, 130 - t) for t in range(T)]]
    frames = []
    for t in range(T):
        f = np.full((h, w), 128, np.uint8)
        for p in paths:
            cv2.circle(f, (p[t][1], p[t][0]), 5, 0, -1)
        frames.append(f)
    return np.stack(frames), paths


@pytest.fixture
def spy_sources(monkeypatch):
    """Record how the port's multi-lane sources deliver: ``("video",
    nat_retained)`` per PerVideoSource, ``("fanout", native, keep_for_dia)``
    per FanoutSource."""
    seen = []
    pv, fo = pipeline.PerVideoSource.__init__, pipeline.FanoutSource.__init__

    def spy_pv(self, *a, **k):
        pv(self, *a, **k)
        seen.append(("video", self.nat_retained))

    def spy_fo(self, *a, **k):
        fo(self, *a, **k)
        seen.append(("fanout", self.native, self.keep_for_dia))

    monkeypatch.setattr(pipeline.PerVideoSource, "__init__", spy_pv)
    monkeypatch.setattr(pipeline.FanoutSource, "__init__", spy_fo)
    return seen


@pytest.fixture
def views(request, monkeypatch):
    """``True``: the native layer's zero-copy views of retained frames;
    ``False``: a native layer without them (both packages then deliver
    through the prefetcher)."""
    from pawsometracker_tpu.io import native_io as ref_native_io

    if not native_io.native_available() or not hasattr(native_io._load(), "pawsio_retained_ptr"):
        pytest.skip("native decoder with retained-frame views unavailable")
    if not request.param:
        for mod in (native_io, ref_native_io):
            orig = mod.NativeFrameSource._finish_open

            def patched(self, lib, info, prefetch, _orig=orig):
                _orig(self, lib, info, prefetch)
                self.can_view_retained = False

            monkeypatch.setattr(mod.NativeFrameSource, "_finish_open", patched)
    return request.param


# ---- the batched chain and the engine's per-chunk arguments -----------------------


def test_chain_batch_carry_pins_zero_valid_lanes():
    """tests/test_roi_stream.py:738 on the port's chain: a lane with ks == 0
    (a split remainder, a short video past its end) keeps its carry, whatever
    the scan of its fill-only crops says; a lane with frames carries its last
    real row plus the origin. Scan and carry equal the JAX chain's."""
    spec = make_spec((40, 40), 9, 5, True)
    B, K = 3, 4
    rng = np.random.default_rng(3)
    frames = rng.integers(110, 146, (B, K, 40, 40)).astype(np.uint8)
    for b, t in ((0, 0), (0, 1), (0, 2), (0, 3), (2, 0), (2, 1)):
        cv2.circle(frames[b, t], (18 + 2 * t, 21 - t + b), 3, 20, -1)  # a dark disc to follow
    frames[1] = 128  # lane 1: pure fill (what a 0-valid lane's crop holds)
    carry0 = np.array([[20, 20], [7, 33], [12, 25]], np.int32)
    ks = np.array([K, 0, 2], np.int32)
    o0 = np.array([[0, 0], [0, 0], [3, -2]], np.int32)
    olast = np.array([[0, 0], [0, 0], [5, -1]], np.int32)
    deltas = np.zeros((B, K, 2), np.int32)
    lo = np.zeros((B, K, 2), np.int32)
    hi = np.full((B, K, 2), 39, np.int32)
    fills = np.full(B, 128, np.uint8)
    t = [torch.from_numpy(a) for a in (frames, carry0, ks, last_rows(ks, K).astype(np.int32),
                                       o0, olast, fills, deltas, lo, hi)]
    scan = ShardedBatchTracker(spec, device="cpu").scan_bounded
    out, carry = chain_batch(scan, *t)
    out, carry = out.numpy(), carry.numpy()
    assert (carry[0] == out[0, K - 1]).all()
    assert (carry[1] == [7, 33]).all()  # unchanged
    assert (carry[2] == out[2, 1] + olast[2]).all()
    chain = ref_pipeline.make_chained_batch(RefTracker(ref_make_spec((40, 40), 9, 5, True))
                                            .scan_bounded)
    want_out, want_carry = chain(frames, carry0, ks, o0, olast, fills, deltas, lo, hi)
    np.testing.assert_array_equal(out, np.asarray(want_out))
    np.testing.assert_array_equal(carry, np.asarray(want_carry))


def test_batched_engine_arguments_match_jax():
    """The per-lane boxes, rebases and last origins equal the JAX engine's,
    and the staged buffer's views hold them where the scan reads them."""
    rng = np.random.default_rng(4)
    L, K, ch, cw, frame = 3, 6, 41, 45, (120, 150)
    origins = rng.integers(-30, 140, (L, K, 2))
    ks = np.array([6, 0, 3])
    eng = pipeline._BatchedEngine(None, (ch, cw), frame, [128] * L, False, None,
                                  torch.device("cpu"))
    ref_eng = object.__new__(ref_pipeline._BatchedEngine)
    ref_eng.ch, ref_eng.cw = ch, cw
    ref_eng.frame_max = np.array([frame[0] - 1, frame[1] - 1])
    for got, want in zip(eng._bounds(origins), ref_eng._bounds(origins)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng._deltas(origins), ref_pipeline._BatchedEngine._deltas(origins))
    np.testing.assert_array_equal(eng._last_origin(origins, ks),
                                  ref_pipeline._BatchedEngine._last_origin(origins, ks))
    np.testing.assert_array_equal(last_rows(ks, K), [5, 6, 14])
    flat = np.arange(eng._n_args(L, K), dtype=np.int32)
    views = pipeline._batch_args(flat, L, K)
    seen = np.concatenate([np.ravel(v) for v in views])
    np.testing.assert_array_equal(seen, flat)  # the views tile the buffer in order
    assert all(v.flags["C_CONTIGUOUS"] for v in views)


# ---- track_batch on ROI against the JAX package --------------------------------------


@pytest.fixture(scope="module")
def spiral_file(tmp_path_factory):
    """tests/test_roi_stream.py:187's clip: a 100x100 FFV1 spiral from (40, 60)."""
    rng = np.random.default_rng(24)
    _, tra = helpers.build_trajectory(28, 24, (40, 60), rng)
    return helpers.trajectory2video(tra[:60], str(tmp_path_factory.mktemp("spiral")), 24, 100,
                                    100, 10, True)


@pytest.mark.parametrize("depth", [0, 2])
def test_batch_roi_matches_jax_and_single(spiral_file, spy_sources, depth):
    """tests/test_roi_stream.py:187: every lane equals the single-video
    track(). Depth 2 rides the native retained ring, depth 0 (contain mode)
    the prefetchers."""
    kw = dict(fps=24, target_width=10, stream="roi", roi_frames=4, pipeline_depth=depth)
    got, want = batch_both([spiral_file, spiral_file], [(40, 60)] * 2, **kw)
    assert_batch_same(got, want)
    assert spy_sources[-1] == ("video", depth != 0)
    single = port.track(spiral_file, start_location=port.IJ(40, 60), device="cpu", fps=24,
                        target_width=10, stream="full")
    for lane in got:
        assert_same(lane, single, dtype=False)


def test_batch_mispredict_replay(tmp_path, spy_sources):
    """tests/test_roi_stream.py:203: velocity-defeating motion replays every
    lane of the batch, on the native retained ring, and each lane still
    equals the full-frame run."""
    f = helpers.write_video(list(triangle_frames(T=36)), str(tmp_path / "tri"), 24)
    kw = dict(fps=24, target_width=10, window_size=31, stream="roi", roi_frames=4,
              pipeline_depth=2)
    before = pipeline.replay_count
    got, want = batch_both([f, f], [(60, 100)] * 2, **kw)
    assert pipeline.replay_count > before
    assert spy_sources[-1] == ("video", True)
    assert_batch_same(got, want)
    assert_batch_same(got, port_full_batch([f, f], [(60, 100)] * 2, **kw), dtype=False)


@pytest.mark.parametrize("depth,subpixel", [(1, False), ("auto", True)])
def test_batch_arrays_ragged_lanes_match_jax(depth, subpixel):
    """In-memory clips of 30, 17 and 23 frames (tests/test_array_input.py:264
    at other lengths): lanes end inside a chunk and then run on fill-only
    crops while the others continue; subpixel offsets within 1e-3."""
    clips = []
    for b, n in enumerate((30, 17, 23)):
        _, tra = helpers.build_trajectory(25, 24, (50, 50), np.random.default_rng(10 + b))
        clips.append(np.stack([helpers.render_frame(100, 100, ij, 10, True) for ij in tra[:n]]))
    clips[1][clips[1] == 128] = 100  # another fill in lane 1
    kw = dict(fps=24, target_width=10, stream="roi", roi_frames=4, pipeline_depth=depth,
              subpixel=subpixel)
    got, want = batch_both(clips, [(50, 50)] * 3, **kw)
    assert_batch_same(got, want, subpixel)
    assert_batch_same(got, port_full_batch(clips, [(50, 50)] * 3, **kw), subpixel, False)


def test_zero_copy_batch_matches_single():
    """tests/test_array_input.py:264 on ROI: two views of one array, each
    lane equal to track() of it, and to the JAX package's."""
    rng = np.random.default_rng(0)
    _, tra = helpers.build_trajectory(0.8 * 49, 24, (50, 50), rng, seconds=3.0)
    frames = np.stack([helpers.render_frame(100, 100, ij, 10, True) for ij in tra[:36]])
    snapshot = frames.copy()
    kw = dict(target_width=10, stream="roi")
    got, want = batch_both([frames, frames], [(50, 50)] * 2, **kw)
    assert_batch_same(got, want)
    single = port.track(frames, start_location=port.IJ(50, 50), target_width=10, device="cpu")
    for lane in got:
        assert_same(lane, single, dtype=False)
    np.testing.assert_array_equal(frames, snapshot)  # the views were never written


def test_batch_mixed_resolution_buckets_and_progress(tmp_path):
    """tests/test_roi_stream.py:226 on ROI: two resolutions and per-video
    target widths in one call run one ROI pipeline per bucket, results in
    input order; the progress over the batch only grows."""
    rng = np.random.default_rng(25)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    _, tra_a = helpers.build_trajectory(28, 24, (50, 50), rng)
    fa = helpers.trajectory2video(tra_a[:48], str(tmp_path / "a"), 24, 100, 100, 10, True)
    _, tra_b = helpers.build_trajectory(40, 24, (70, 90), rng)
    fb = helpers.trajectory2video(tra_b[:40], str(tmp_path / "b"), 24, 160, 140, 14, True)
    calls = []
    kw = dict(fps=24, target_width=[10, 14], stream="roi", roi_frames=4, pipeline_depth=2)
    got = port.track_batch([fa, fb], start_location=ij_locs(port, [(50, 50), (70, 90)]),
                           device="cpu", progress=lambda d, t: calls.append((d, t)), **kw)
    want = ref_track_batch([fa, fb], start_location=ij_locs(ref, [(50, 50), (70, 90)]), **kw)
    assert_batch_same(got, want)
    dones = [d for d, _ in calls]
    assert dones == sorted(dones) and dones[-1] == sum(len(ij) - 1 for _, ij in got)
    assert all(t == calls[0][1] for _, t in calls)


def test_auto_depth_batch_and_multi_match_jax(tmp_path):
    """tests/test_roi_stream.py:321: pipeline_depth="auto" on both entry
    points gives the JAX package's positions and the full-frame ones."""
    rng = np.random.default_rng(62)
    _, tra = helpers.build_trajectory(30, 24, (60, 60), rng)
    f = helpers.trajectory2video(tra[:40], str(tmp_path), 24, 140, 140, 10, True)
    kw = dict(fps=24, target_width=10, stream="roi", pipeline_depth="auto")
    got, want = batch_both([f, f], [(60, 60)] * 2, **kw)
    assert_batch_same(got, want)
    assert_batch_same(got, port_full_batch([f, f], [(60, 60)] * 2, **kw), dtype=False)
    got, want = multi_both(f, [(60, 60)], **kw)
    assert_same(got, want)
    single = port.track(f, start_location=port.IJ(60, 60), device="cpu", fps=24,
                        target_width=10, stream="full")
    np.testing.assert_array_equal(got[1][:, 0], single[1])


def test_batch_schedule_fuzz_bit_exact(tmp_path, monkeypatch):
    """tests/test_roi_stream.py:773: seeded coins replace the eager drain's
    readiness check and the auto depth's growth trigger, on erratic motion
    with an 8 px prediction slack, 4-frame chunks and lanes of 26 and 14
    frames: replays,
    splits and chunks in which one lane has no frames, in every
    interleaving, give the JAX package's positions. Then the prefetcher
    delivery of one file (OpenCV), where entries own their frames, so the
    replay order must hold too."""
    monkeypatch.setenv("PAWS_PREDICT_SLACK", "8")
    rng = np.random.default_rng(42)
    files, locs = [], []
    for b, T in enumerate((26, 14)):
        i, j = 50, 60
        path = str(tmp_path / f"v{b}.avi")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 24, (120, 100), isColor=False)
        locs.append((i, j))
        for _ in range(T):
            f = np.full((100, 120), 128, np.uint8)
            cv2.circle(f, (j, i), 4, 0, -1)
            vw.write(f)
            i = int(np.clip(i + rng.integers(-7, 8), 5, 94))
            j = int(np.clip(j + rng.integers(-7, 8), 5, 114))
        vw.release()
        files.append(path)
    kw = dict(target_width=8, fps=24, stream="roi", roi_frames=4)
    wants = ref_track_batch(files, start_location=ij_locs(ref, locs), **kw)
    fulls = port_full_batch(files, locs, **kw)
    assert_batch_same(wants, fulls, dtype=False)

    coin = None
    orig_ready = pipeline._RoiEngine.ready

    def coin_ready(self, handle):
        return orig_ready(handle) and bool(coin.random() < 0.5)

    def coin_drain(self):
        # _drain_one with the blocked-time growth trigger replaced by a coin
        entry = self._pending.popleft()
        pos_np, off_np = self.engine.to_host(entry.handle)
        if self.auto_depth and coin.random() < 0.3 and self.depth_cur < self.depth_max:
            self.depth_cur += 1
        if self.mode == "predict" and not self._contained(pos_np, entry.origins, entry.valid):
            head = self._split_exact(entry) if entry.exact else [entry]
            rest = list(self._pending)
            self._pending.clear()
            self._replay(head + rest)
            return
        self._accept(pos_np, off_np, entry)

    splits = []
    orig_split = pipeline.SpeculativePipeline._split_exact

    def spy_split(self, ent):
        splits.append(int(ent.valid.max()))
        return orig_split(self, ent)

    monkeypatch.setattr(pipeline._RoiEngine, "ready", coin_ready)
    monkeypatch.setattr(pipeline.SpeculativePipeline, "_drain_one", coin_drain)
    monkeypatch.setattr(pipeline.SpeculativePipeline, "_split_exact", spy_split)
    before = pipeline.replay_count
    for seed in range(2):
        coin = np.random.default_rng(seed)
        got = port.track_batch(files, start_location=ij_locs(port, locs), device="cpu", **kw)
        for lane, (g, w) in enumerate(zip(got, wants)):
            np.testing.assert_array_equal(g[1], w[1], err_msg=f"schedule seed {seed}, lane {lane}")
            np.testing.assert_array_equal(g[0], w[0])
    for seed in range(1):
        coin = np.random.default_rng(seed)
        _, ij = port.track(files[0], start_location=port.IJ(*locs[0]), backend="opencv",
                           device="cpu", **kw)
        np.testing.assert_array_equal(ij, wants[0][1], err_msg=f"opencv schedule seed {seed}")
    assert pipeline.replay_count > before  # the hard paths ran
    assert splits, "no exact rewind chunk was split"


# ---- track_multi on ROI against the JAX package --------------------------------------


@pytest.mark.parametrize("depth", [0, 2])
def test_multi_roi_matches_jax_and_full(tmp_path, spy_sources, depth):
    """tests/test_multi.py:51: three targets, per-target speculative crops in
    one batched launch a chunk, equal to the JAX package and to full frames,
    within 1 px of the drawn paths. The fan-out crops from the native ring at
    every depth, contain mode included."""
    T, h, w = 50, 360, 480
    paths = [[(80 + t, 90 + 2 * t) for t in range(T)],
             [(300 - 2 * t, 400 - 3 * t) for t in range(T)],
             [(180, 60 + 4 * t) for t in range(T)]]
    frames = []
    for t in range(T):
        f = np.full((h, w), 128, np.uint8)
        for p in paths:
            cv2.circle(f, (p[t][1], p[t][0]), 5, 0, -1)
        frames.append(f)
    f = helpers.write_video(frames, str(tmp_path / "three"), 24)
    locs = [p[0] for p in paths]
    kw = dict(fps=24, target_width=10, window_size=21, stream="roi", roi_frames=4,
              pipeline_depth=depth)
    got, want = multi_both(f, locs, **kw)
    assert_same(got, want)
    assert spy_sources[-1] == ("fanout", True, False)
    full = port.track_multi(f, ij_locs(port, locs), device="cpu", fps=24, target_width=10,
                            window_size=21, stream="full")
    assert_same(got, full, dtype=False)
    for k, p in enumerate(paths):
        err = np.linalg.norm(got[1][:, k, :] - np.asarray(p), axis=1)
        assert np.sqrt(np.mean(err ** 2)) < 1.0, f"target {k}"


def test_multi_roi_subpixel_and_replay_match_jax():
    """Two targets on an in-memory clip: subpixel offsets within 1e-3 of the
    JAX package's, and a reversing target that replays the fan-out."""
    frames, paths = two_target_frames(T=40)
    kw = dict(fps=24, target_width=10, stream="roi", roi_frames=4, pipeline_depth=2)
    locs = [paths[0][0], paths[1][0]]
    got, want = multi_both(frames, locs, subpixel=True, **kw)
    assert_same(got, want, subpixel=True)
    tri = triangle_frames(T=36)
    cv2.circle(tri[0], (40, 150), 5, 0, -1)
    for t in range(1, 36):  # a second, still target
        cv2.circle(tri[t], (40, 150), 5, 0, -1)
    before = pipeline.replay_count
    got, want = multi_both(tri, [(60, 100), (150, 40)], window_size=31, **kw)
    assert pipeline.replay_count > before
    assert_same(got, want)


def test_multi_roi_diagnostic_overlay_matches_jax(tmp_path):
    """tests/test_multi.py:148 on ROI: one shared 640x360 overlay with both
    targets' markers, frames 2..n, decoded equal to the JAX package's (same
    basename: the label is the file's name); positions as without it."""
    frames, paths = two_target_frames()
    f = helpers.write_video(list(frames), str(tmp_path / "two"), 24)
    locs = [paths[0][0], paths[1][0]]
    kw = dict(fps=24, target_width=10, chunk_size=16, stream="roi")
    plain = port.track_multi(f, ij_locs(port, locs), device="cpu", **kw)
    out = {}
    for name in ("port", "ref"):
        (tmp_path / name).mkdir()
        out[name] = str(tmp_path / name / "diag_roi.mp4")
    got = port.track_multi(f, ij_locs(port, locs), device="cpu", diagnostic_file=out["port"], **kw)
    want = ref_track_multi(f, ij_locs(ref, locs), diagnostic_file=out["ref"], **kw)
    assert_same(got, plain)
    assert_same(got, want)
    ours, theirs = decoded(out["port"]), decoded(out["ref"])
    assert ours.shape == (59, 360, 640, 3)
    np.testing.assert_array_equal(ours, theirs)


# ---- diagnostics with and without views of retained frames (test_diag_fastpath.py) --


@pytest.mark.parametrize("views", [True, False], indirect=True)
def test_multi_dia_fast_path(tmp_path, spy_sources, views):
    """tests/test_diag_fastpath.py:190: with views the fan-out keeps the
    native ring with diagnostics on; without them it takes the prefetcher.
    Either way positions equal a run without diagnostics and the overlay
    equals the JAX package's."""
    h, w, T = 160, 240, 40
    frames = []
    for t in range(T):
        img = np.full((h, w), 128, np.uint8)
        cv2.circle(img, (40 + 2 * t, 50), 5, 0, -1)
        cv2.circle(img, (180 - 2 * t, 110), 5, 0, -1)
        frames.append(img)
    f = helpers.write_video(frames, str(tmp_path / "two"), 24)
    locs = [(50, 40), (110, 180)]
    kw = dict(fps=24, target_width=10, stream="roi")
    plain = port.track_multi(f, ij_locs(port, locs), device="cpu", **kw)
    out = {}
    for name in ("port", "ref"):
        (tmp_path / name).mkdir()
        out[name] = str(tmp_path / name / "diag.mp4")
    got = port.track_multi(f, ij_locs(port, locs), device="cpu", diagnostic_file=out["port"], **kw)
    assert spy_sources[-1] == ("fanout", views, True)
    want = ref_track_multi(f, ij_locs(ref, locs), diagnostic_file=out["ref"], **kw)
    assert_same(got, plain)
    assert_same(got, want)
    np.testing.assert_array_equal(decoded(out["port"]), decoded(out["ref"]))


@pytest.mark.parametrize("views", [True, False], indirect=True)
def test_batch_dia_fast_path(tmp_path, spy_sources, views):
    """tests/test_diag_fastpath.py:222: per-video overlays ride the retained
    rings when the native layer serves views (nat_retained), the prefetchers
    when not; positions as without them, overlays equal the JAX package's."""
    rng = np.random.default_rng(52)
    _, tra = helpers.build_trajectory(24, 24, (40, 60), rng)
    f = helpers.trajectory2video(tra[:48], str(tmp_path), 24, 160, 120, 10, True)
    kw = dict(fps=24, target_width=10, stream="roi", roi_frames=4, pipeline_depth=2)
    plain = port.track_batch([f, f], start_location=port.IJ(40, 60), device="cpu", **kw)
    paths = {}
    for name in ("port", "ref"):
        (tmp_path / name).mkdir()
        paths[name] = [str(tmp_path / name / "d0.mp4"), str(tmp_path / name / "d1.mp4")]
    got = port.track_batch([f, f], start_location=port.IJ(40, 60), device="cpu",
                           diagnostic_files=paths["port"], **kw)
    assert spy_sources[-1] == ("video", views)
    want = ref_track_batch([f, f], start_location=ref.IJ(40, 60),
                           diagnostic_files=paths["ref"], **kw)
    assert_batch_same(got, plain)
    assert_batch_same(got, want)
    for p, r in zip(paths["port"], paths["ref"]):
        np.testing.assert_array_equal(decoded(p), decoded(r))


# ---- the stream="auto" rules and the ring gate -----------------------------------------


def _spy_roi_choices(monkeypatch):
    """Record, per package, whether each batch or multi call took ROI."""
    picks = []

    def wrap(mod, name, tag):
        orig = getattr(mod, name)

        def spy(*a, **k):
            picks.append(tag)
            return orig(*a, **k)

        monkeypatch.setattr(mod, name, spy)

    import pawsometracker_tpu_torch.batch as port_batch
    import pawsometracker_tpu_torch.multi as port_multi

    wrap(port_batch, "SpeculativePipeline", "port")
    wrap(port_multi, "run_multi_roi_pipeline", "port")
    # every ROI path of the JAX package builds its controller from the
    # module's name at call time
    wrap(ref_pipeline, "SpeculativePipeline", "ref")
    return picks


def discs_1080p(n_frames, centres, radius=12):
    frames = np.full((n_frames, 1080, 1920), 128, np.uint8)
    for f in frames:
        for i, j in centres:
            cv2.circle(f, (j, i), radius, 30, -1)
    return frames


@pytest.mark.parametrize("case", ["batch 1080p", "batch 100x100", "multi 1080p N=30",
                                  "multi 1080p N=31"])
def test_auto_stream_rule_matches_jax(monkeypatch, case):
    """stream="auto" takes ROI exactly where the JAX package does: a batch
    when one crop is under half the frame, multi when its N crops are. At
    1080p, target_width 25 and the 41x41 window the crop is 185x185 at any K
    up to the slack (K = 1 here, to keep the runs short), so 30 targets stay
    on ROI and 31 go back to full frames."""
    picks = _spy_roi_choices(monkeypatch)
    kw = dict(fps=24, target_width=25, window_size=41, roi_frames=1)
    if case.startswith("batch"):
        if case == "batch 1080p":
            clips, loc, roi = [discs_1080p(2, [(540, 960)]), discs_1080p(2, [(500, 900)])], \
                [(540, 960), (500, 900)], True
        else:
            clips = [np.stack([helpers.render_frame(100, 100, (50, 50 + t), 10, True)
                               for t in range(6)])] * 2
            loc, roi = [(50, 50)] * 2, False
        got, want = batch_both(clips, loc, chunk_size=4, **kw)
        assert_batch_same(got, want)
    else:
        n = int(case.split("=")[1])
        centres = [(100 + 140 * (k // 8), 150 + 220 * (k % 8)) for k in range(n)]
        frames = discs_1080p(2, centres)
        got, want = multi_both(frames, centres, chunk_size=2, **kw)
        assert_same(got, want)
        roi = n == 30
    assert sorted(picks) == (["port", "ref"] if roi else [])
    spec = make_spec((1080, 1920), 41, 25, True)
    ch, cw, _ = pipeline.roi_geometry(spec, 1, AUTO_DEPTH_MAX, "predict")
    assert (ch, cw) == pipeline.roi_geometry(spec, 12, AUTO_DEPTH_MAX, "predict")[:2] == (185, 185)
    assert 30 * ch * cw * 2 < 1080 * 1920 <= 31 * ch * cw * 2


def test_auto_ring_gate_lanes_and_info_match_jax(spiral_file):
    """``_auto_ring_gate(lanes=, info=)`` equals the JAX package's: the
    lanes share the budget, and a caller's probe stands in for the file (an
    empty probe leaves the gate as it is)."""
    from pawsometracker_tpu.io.decode import probe as ref_probe

    arr = np.zeros((1, 2160, 3840), np.uint8)
    hd = np.zeros((1, 1080, 1920), np.uint8)
    info, rinfo = probe(spiral_file), ref_probe(spiral_file)
    for lanes in (1, 4, 16):
        for k in (4, 12):
            for a in (arr, hd):
                assert port_api._auto_ring_gate(a, k, AUTO_DEPTH_MAX, lanes=lanes) == \
                    ref_api._auto_ring_gate(a, k, AUTO_DEPTH_MAX, lanes=lanes)
            assert port_api._auto_ring_gate(spiral_file, k, AUTO_DEPTH_MAX, lanes=lanes,
                                            info=info) == \
                ref_api._auto_ring_gate(spiral_file, k, AUTO_DEPTH_MAX, lanes=lanes, info=rinfo)
    assert port_api._auto_ring_gate(hd, 12, AUTO_DEPTH_MAX, lanes=16) < \
        port_api._auto_ring_gate(hd, 12, AUTO_DEPTH_MAX, lanes=1) == AUTO_DEPTH_MAX
    big, rbig = (dataclasses.replace(i, height=4320, width=7680) for i in (info, rinfo))
    assert port_api._auto_ring_gate(spiral_file, 12, AUTO_DEPTH_MAX, lanes=4, info=big) == \
        ref_api._auto_ring_gate(spiral_file, 12, AUTO_DEPTH_MAX, lanes=4, info=rbig) == 1
    empty = dataclasses.replace(info, height=0, width=0)
    assert port_api._auto_ring_gate(arr, 12, AUTO_DEPTH_MAX, info=empty) == AUTO_DEPTH_MAX
