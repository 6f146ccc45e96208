"""The port's ``track_multi(..., device="cpu")``, its multi-target tracker
forms and ``global_detect_peaks`` against the JAX package: positions and
timestamps equal, offsets within 1e-3, the shared N-marker overlay equal, and
the same loud failures."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pawsometracker_tpu as ref
import pawsometracker_tpu_torch as port
from pawsometracker_tpu.models.dog_tracker import make_spec as ref_make_spec
from pawsometracker_tpu.models.dog_tracker import tracker_fns as ref_tracker_fns
from pawsometracker_tpu.multi import track_multi as ref_track_multi
from pawsometracker_tpu.parallel.mesh import global_detect_peaks as ref_detect_peaks
from pawsometracker_tpu_torch.models.dog_tracker import make_spec, tracker_fns
from pawsometracker_tpu_torch.parallel.mesh import global_detect_peaks

from test_tracker_core import draw_blob

STARTS = [(22, 25), (75, 30), (50, 75)]


def three_targets(T=30, h=100, w=100, seed=0):
    """Three dark discs, at least 40 px apart, moving on 128-gray plus low
    noise (no exact response ties), and their paths."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    paths = [[(i0 + (t if s % 2 else -t) // 3, j0 + t // 2) for t in range(T)]
             for s, (i0, j0) in enumerate(STARTS)]
    frames = []
    for t in range(T):
        f = np.full((h, w), 128, np.uint8)
        for p in paths:
            cv2.circle(f, (p[t][1], p[t][0]), 5, 0, -1)
        frames.append(f)
    frames = np.stack(frames).astype(np.int16) + rng.integers(-2, 3, (T, h, w))
    return np.clip(frames, 0, 255).astype(np.uint8), np.array(paths).transpose(1, 0, 2)


def assert_multi_equal(got, want, subpixel=False):
    np.testing.assert_array_equal(got[0], want[0])
    if subpixel:
        np.testing.assert_array_equal(np.round(got[1]), np.round(want[1]))
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
    else:
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype


MATRIX = {
    "explicit IJ": dict(locs="ij"),
    "explicit xy": dict(locs="xy"),
    "n_targets": dict(n_targets=3),
    "n_targets + min_distance": dict(n_targets=2, min_distance=45),
    "subpixel": dict(locs="ij", subpixel=True),
    "subpixel + n_targets": dict(n_targets=3, subpixel=True),
    "start-stop, chunks": dict(locs="ij", start=0.25, stop=1.0, chunk_size=5),
}


def _kwargs(case, pkg, frames, paths):
    kw = dict(MATRIX[case])
    locs = kw.pop("locs", None)
    t0 = int(round(24 * kw.get("start", 0.0)))
    if locs == "ij":
        return [pkg.IJ(int(i), int(j)) for i, j in paths[t0]], kw
    if locs == "xy":
        return [(float(j), float(i)) for i, j in paths[t0]], kw
    return None, kw


@pytest.mark.parametrize("case", list(MATRIX))
def test_track_multi_matches_jax(case):
    frames, paths = three_targets()
    locs, kw = _kwargs(case, port, frames, paths)
    got = port.track_multi(frames, locs, fps=24, target_width=10, device="cpu", **kw)
    locs, kw = _kwargs(case, ref, frames, paths)
    want = ref_track_multi(frames, locs, fps=24, target_width=10, stream="full", **kw)
    assert_multi_equal(got, want, kw.get("subpixel", False))
    assert got[1].shape[1:] == (kw.get("n_targets", 3), 2)


def test_track_multi_stream_auto_matches_jax_auto():
    frames, paths = three_targets()
    locs = [port.IJ(int(i), int(j)) for i, j in paths[0]]
    got = port.track_multi(frames, locs, fps=24, target_width=10, device="cpu")
    want = ref_track_multi(frames, [ref.IJ(*ij) for ij in locs], fps=24, target_width=10)
    assert_multi_equal(got, want)


def test_each_target_equals_single_track_and_truth():
    frames, paths = three_targets()
    ts, pos = port.track_multi(frames, n_targets=3, fps=24, target_width=10, device="cpu")
    for n in range(3):
        ts1, ij1 = port.track(frames, fps=24, target_width=10, chunk_size=16, device="cpu",
                              start_location=port.IJ(*map(int, pos[0, n])))
        np.testing.assert_array_equal(ts, ts1)
        np.testing.assert_array_equal(pos[:, n], ij1)
        err = np.min([np.sqrt(np.mean(np.sum((pos[:, n] - paths[:, k]) ** 2, axis=1)))
                      for k in range(3)])
        assert err < 1.0


def test_shared_overlay_matches_jax(tmp_path):
    """One overlay with N markers and trails, byte-equal to the JAX
    package's (same basename: the label is the file's basename)."""
    cv2 = pytest.importorskip("cv2")
    frames, paths = three_targets(T=20)
    decoded = []
    for name, pkg, fn, extra in (("port", port, port.track_multi, {"device": "cpu"}),
                                 ("ref", ref, ref_track_multi, {"stream": "full"})):
        d = tmp_path / name
        d.mkdir()
        f = str(d / "diag.mp4")
        fn(frames, [pkg.IJ(int(i), int(j)) for i, j in paths[0]], fps=24, target_width=10,
           chunk_size=8, diagnostic_file=f, **extra)
        cap = cv2.VideoCapture(f)
        out = []
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            out.append(fr)
        cap.release()
        decoded.append(np.stack(out))
    assert decoded[0].shape == decoded[1].shape and decoded[0].shape[1:3] == (360, 640)
    np.testing.assert_array_equal(decoded[0], decoded[1])


def test_progress_callback():
    frames, paths = three_targets()
    calls = []
    ts, pos = port.track_multi(frames, n_targets=3, fps=24, target_width=10, chunk_size=8,
                               device="cpu", progress=lambda d, t: calls.append((d, t)))
    assert [d for d, _ in calls] == [8, 16, 24, 29] and all(t == 29 for _, t in calls)


def test_multi_forms_match_jax(rng):
    """snap_multi / scan_multi and their subpixel forms: the port's lanes read
    one frame stream; JAX vmaps the window step over targets."""
    h, w, T = 90, 100, 8
    frames = rng.integers(60, 200, size=(T, h, w)).astype(np.uint8)
    for t in range(T):
        frames[t, 40 + t - 4:40 + t + 4, 30 - 3:30 + 4] = 0
        frames[t, 20 - 4:20 + 4, 70 + t - 3:70 + t + 4] = 0
    pos0 = np.array([[40, 30], [20, 70], [70, 85]], np.int32)
    rf = ref_tracker_fns(ref_make_spec((h, w), 21, 8, True))
    pf = tracker_fns(make_spec((h, w), 21, 8, True), "cpu")
    a = [jnp.asarray(frames), jnp.asarray(pos0)]
    np.testing.assert_array_equal(pf.scan_multi(frames, pos0, 128).numpy(),
                                  np.asarray(rf.scan_multi(*a, np.uint8(128))))
    np.testing.assert_array_equal(pf.snap_multi(frames[0], pos0, 128).numpy(),
                                  np.asarray(rf.snap_multi(a[0][0], a[1], np.uint8(128))))
    for got, want in ((pf.scan_multi_sub(frames, pos0, 128), rf.scan_multi_sub(*a, np.uint8(128))),
                      (pf.snap_multi_sub(frames[0], pos0, 128),
                       rf.snap_multi_sub(a[0][0], a[1], np.uint8(128)))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-3)
    assert pf.scan_multi(frames, pos0, 128).shape == (T, 3, 2)


def test_global_detect_peaks_matches_jax():
    h, w = 100, 100
    frame = draw_blob(h, w, (30, 40), 5)
    for ij, r in (((70, 80), 4), ((20, 85), 6)):
        frame = np.minimum(frame, draw_blob(h, w, ij, r))
    for n, md in ((3, None), (2, 30), (1, None)):
        got = global_detect_peaks(make_spec((h, w), 21, 10, True), n, md)(frame, 128)
        want = ref_detect_peaks(ref_make_spec((h, w), 21, 10, True), n, md)(
            jnp.asarray(frame), np.uint8(128))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
    # suppression exhausts the frame: the last peak repeats, as in JAX
    got = global_detect_peaks(make_spec((h, w), 21, 10, True), 3, 500)(frame, 128)
    want = ref_detect_peaks(ref_make_spec((h, w), 21, 10, True), 3, 500)(
        jnp.asarray(frame), np.uint8(128))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len({tuple(p) for p in got.tolist()}) == 1


def test_loud_failures_match_jax():
    frames = np.full((5, 64, 96), 128, np.uint8)
    frames[:, 27:38, 43:54] = 0
    for args, kw, err in (((), {}, ValueError),
                          (([],), {}, ValueError),
                          (([port.IJ(10, 10), None],), {}, ValueError),
                          (([port.IJ(10, 10)],), {"n_targets": 3}, ValueError),
                          (([port.IJ(10, 10)],), {"min_distance": 40}, ValueError)):
        with pytest.raises(err):
            port.track_multi(frames, *args, device="cpu", **kw)
    with pytest.raises(ValueError, match="separable peaks"):
        port.track_multi(frames, n_targets=3, min_distance=200, target_width=10, device="cpu")
    with pytest.raises(ValueError, match="separable peaks"):
        ref_track_multi(frames, n_targets=3, min_distance=200, target_width=10)
    with pytest.raises(IOError):
        port.track_multi("/nonexistent_video.mp4", [port.IJ(10, 10)], device="cpu")


def test_stream_and_engine_rules():
    """stream="roi" gives the positions of stream="full"; the engine and
    stream choices are checked."""
    frames = np.full((5, 64, 96), 128, np.uint8)
    frames[:, 27:38, 43:54] = 0
    locs = [port.IJ(30, 40), port.IJ(34, 50)]
    roi = port.track_multi(frames, locs, stream="roi", device="cpu")
    full = port.track_multi(frames, locs, stream="full", device="cpu")
    np.testing.assert_array_equal(roi[0], full[0])
    np.testing.assert_array_equal(roi[1], full[1])
    for bad in (dict(stream="crops"), dict(stream="roi", roi_frames=0)):
        with pytest.raises(ValueError):
            port.track_multi(frames, locs, device="cpu", **bad)
    with pytest.raises(ValueError, match="must be one of"):
        port.track_multi(frames, [port.IJ(30, 40)], engine="cuda", device="cpu")


#: a 96-well plate at 1080p and 12.635 px/mm, its well pitch in pixels (ANSI/SLAS 4-2004's 9 mm)
PLATE_PITCH_PX = 9.0 * 12.635


def scaled_plate(rows=4, cols=6, H=480, W=960, n=8, seed=3):
    """A plate of ``rows x cols`` wells at the 96-well pitch, centred in an
    ``H x W`` frame, one disc a well wandering on a small spiral (the plate
    cell's traffic at a small size), drawn by the benchmark's own generator
    on the CPU."""
    from portbench import frames as bench_frames

    config = dict(height=H, width=W, fps=24, target_width=12, window_size=25,
                  darker_target=True, target_radius_px=6.0, target_level=30, noise_sigma=2.0)
    discs = [dict(start="autodetect", phase_deg=[3.75 * (r * cols + c)],
                  motion_params=dict(offset_px=[(r - (rows - 1) / 2) * PLATE_PITCH_PX,
                                                (c - (cols - 1) / 2) * PLATE_PITCH_PX]))
             for r in range(rows) for c in range(cols)]
    traffic = dict(motion="spiral", phase_jitter_deg=1.875, clip_sets=1,
                   motion_params=dict(loops=5, radius_px=20, jitter_px=1.0, start_box_px=4),
                   videos=[dict(frames=n, background=128, discs=discs)])
    sets = bench_frames.plan(config, traffic, seed)
    return bench_frames.render(config, sets, seed, "cpu")[0][0]


def test_scaled_plate_takes_full_frames_and_equals_reference_and_jax(caplog):
    """24 autodetected larvae, one a well of a 4 x 6 plate, in 480 x 960
    frames: by the stream rule their 24 crops of 105 x 105 (24 x 105^2 x 2 =
    529,200 pixels) are not under half the frame (460,800), so
    ``stream="auto"`` takes full frames, as the 96-well plate does at 1080p.
    Positions, their order and timestamps equal the benchmark's NumPy
    reference; integer positions equal the JAX package's."""
    from portbench.reference import multi as bench_multi
    from portbench.reference import tracker as bench_tracker

    clip = scaled_plate()
    kw = dict(n_targets=24, fps=24, target_width=12, window_size=25)
    with caplog.at_level(logging.DEBUG, logger="pawsometracker_tpu_torch"):
        ts, pos = port.track_multi(clip, device="cpu", **kw)
    [stats] = [r.paws_stats for r in caplog.records if hasattr(r, "paws_stats")]
    assert stats["stream"] == "full"
    assert stats["counts"] == {"multi.lanes": 24, "detect.rounds": 24,
                               "detect.kernel_launches": 0}
    assert pos.shape == (8, 24, 2)
    want = bench_multi.track(clip, [None] * 24, target_width=12, window=25)
    np.testing.assert_array_equal(pos, want)
    np.testing.assert_array_equal(ts, bench_tracker.timestamps(8, 24))
    assert_multi_equal((ts, pos), ref_track_multi(clip, **kw))


@pytest.mark.parametrize("lanes,stream", [(96, "full"), (80, "roi")])
def test_plate_stream_rule_at_1080p(lanes, stream):
    """The 96-well plate's geometry at 1080p and ``target_width`` 12: the
    predict-mode crop is 105 x 105 (window 25, 33 taps, the prediction's
    slack), so 96 lanes (2,116,800 pixels, twice their crops) take full
    frames and 80 (1,764,000) ROI crops, against the frame's 2,073,600."""
    from pawsometracker_tpu_torch.api import _auto_ring_gate, _resolve_roi_frames
    from pawsometracker_tpu_torch.multi import takes_roi
    from pawsometracker_tpu_torch.pipeline import AUTO_DEPTH_MAX, roi_geometry

    video = np.broadcast_to(np.uint8(128), (240, 1080, 1920))
    spec = make_spec((1080, 1920), 25, 12, True)
    assert spec.kernel_len == 33
    K = _resolve_roi_frames(None, AUTO_DEPTH_MAX, "predict")
    gate = _auto_ring_gate(video, K, AUTO_DEPTH_MAX)
    ch, cw, _ = roi_geometry(spec, K, gate, "predict")
    assert (ch, cw) == (105, 105)
    assert takes_roi("auto", lanes, spec, K, gate) == (stream == "roi")
    assert takes_roi("roi", lanes, spec, K, gate) and not takes_roi("full", lanes, spec, K, gate)
