"""The port's ``track(..., device="cpu")`` end to end: the golden spiral trace,
and positions and timestamps equal to the JAX package's ``track`` over a
matrix of keyword arguments, on in-memory frames and through an FFV1 file."""

import os

import numpy as np
import pytest

import pawsometracker_tpu as ref
import pawsometracker_tpu_torch as port

import helpers

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def clip(n=72, seed=0, h=100, w=100, tw=10, dark=True, start=(50, 50)):
    """The first ``n`` frames of the test harness's 10 s spiral clip."""
    rng = np.random.default_rng(seed)
    r = min(start[0], start[1], h - start[0], w - start[1])
    _, tra = helpers.build_trajectory(0.8 * r, 24, start, rng)
    tra = tra[:n]
    frames = np.stack([helpers.render_frame(h, w, ij, tw, dark) for ij in tra])
    return frames, np.array(tra)


def test_golden_spiral_trace_bit_exact():
    """The committed trace (tests/fixtures/trace_spiral.npy), reproduced on
    the in-memory frames of the seed-0 spiral clip."""
    golden = np.load(os.path.join(FIXTURES, "trace_spiral.npy"))
    frames, _ = clip(n=241)
    ts, ij = port.track(frames, fps=24, start_location=port.IJ(50, 50), target_width=10,
                        device="cpu")
    np.testing.assert_array_equal(np.asarray(ij, np.int32), golden)
    assert ts.shape == (golden.shape[0],)


MATRIX = {
    "ij": dict(start_location=(50, 50, "ij")),
    "auto": dict(start_location=None),
    "xy": dict(start_location=(47.0, 52.0)),
    "lighter": dict(start_location=(50, 50, "ij"), darker_target=False),
    "rect-window": dict(start_location=(50, 50, "ij"), window_size=(31, 21)),
    "subpixel": dict(start_location=(50, 50, "ij"), subpixel=True),
    "start-stop": dict(start_location="frame 12", start=0.5, stop=2.5),
    "chunks": dict(start_location=(50, 50, "ij"), chunk_size=16, pipeline_depth=0),
}


def _kwargs(case, pkg, truth):
    kw = dict(MATRIX[case])
    loc = kw.get("start_location")
    if isinstance(loc, tuple) and len(loc) == 3:
        kw["start_location"] = pkg.IJ(loc[0], loc[1])
    elif loc == "frame 12":  # where the target is at start=0.5 s
        kw["start_location"] = pkg.IJ(*map(int, truth[12]))
    return kw


@pytest.mark.parametrize("case", list(MATRIX))
def test_track_matches_jax(case):
    dark = MATRIX[case].get("darker_target", True)
    frames, truth = clip(dark=dark)
    got_ts, got = port.track(frames, fps=24, target_width=10, device="cpu",
                             **_kwargs(case, port, truth))
    want_ts, want = ref.track(frames, fps=24, target_width=10, **_kwargs(case, ref, truth))
    np.testing.assert_array_equal(got_ts, want_ts)
    if case == "subpixel":
        np.testing.assert_array_equal(np.round(got), np.round(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    t0 = 12 if "start" in MATRIX[case] else 0
    rmse = np.sqrt(np.mean(np.sum((got - truth[t0:t0 + len(got)]) ** 2, axis=1)))
    assert rmse < 1.0


def test_segments_match_jax():
    frames, _ = clip(n=96, seed=5)
    segs = [frames[:50], frames[49:]]
    got_ts, got = port.track(segs, fps=24, target_width=10,
                             start_location=[port.IJ(50, 50), None], device="cpu")
    want_ts, want = ref.track(segs, fps=24, target_width=10,
                              start_location=[ref.IJ(50, 50), None])
    np.testing.assert_array_equal(got_ts, want_ts)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="length mismatch"):
        port.track(segs, start=[0.0], device="cpu")


def test_ffv1_file_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    _, tra = helpers.build_trajectory(30, 24, (50, 50), rng)
    tra = tra[:72]
    f = helpers.trajectory2video(tra, str(tmp_path), 24, 100, 100, 10, True)
    got_ts, got = port.track(f, fps=24, start_location=port.IJ(50, 50), target_width=10,
                             device="cpu")
    want_ts, want = ref.track(f, fps=24, start_location=ref.IJ(50, 50), target_width=10)
    np.testing.assert_array_equal(got_ts, want_ts)
    np.testing.assert_array_equal(got, want)
    rmse = np.sqrt(np.mean(np.sum((got - np.array(tra[:len(got)])) ** 2, axis=1)))
    assert rmse < 1.0


def test_diagnostic_overlay_matches_jax(tmp_path):
    """Same positions, same overlay writer: the overlay videos decode to the
    same frames (same basename, since the label is the file's basename)."""
    cv2 = pytest.importorskip("cv2")
    frames, _ = clip(n=48, seed=3)
    paths = []
    for name, pkg, extra in (("port", port, {"device": "cpu"}), ("ref", ref, {})):
        d = tmp_path / name
        d.mkdir()
        paths.append(str(d / "diag.mp4"))
        pkg.track(frames, fps=24, target_width=10, start_location=pkg.IJ(50, 50),
                  diagnostic_file=paths[-1], **extra)
    decoded = []
    for p in paths:
        cap = cv2.VideoCapture(p)
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


def test_stream_choices():
    frames, _ = clip(n=24)
    roi = port.track(frames, start_location=port.IJ(50, 50), target_width=10, stream="roi",
                     device="cpu")
    a = port.track(frames, start_location=port.IJ(50, 50), target_width=10, stream="full",
                   device="cpu")
    np.testing.assert_array_equal(roi[1], a[1])
    np.testing.assert_array_equal(roi[0], a[0])
    b = port.track(frames, start_location=port.IJ(50, 50), target_width=10, stream="auto",
                   engine="xla", device="cpu")
    np.testing.assert_array_equal(a[1], b[1])
    for kw in ({"stream": "ROI"}, {"speculate": "contian"}, {"backend": "ffmpeg"},
               {"engine": "cuda"}):
        with pytest.raises(ValueError, match="must be one of"):
            port.track(frames, start_location=port.IJ(50, 50), target_width=10, device="cpu",
                       **kw)


def test_progress_callback():
    frames, _ = clip(n=48)
    calls = []
    ts, ij = port.track(frames, start_location=port.IJ(50, 50), target_width=10, chunk_size=16,
                        progress=lambda d, t: calls.append((d, t)), device="cpu")
    dones = [d for d, _ in calls]
    assert dones == sorted(dones) and dones[-1] == len(ij) - 1
    assert all(t == calls[0][1] for _, t in calls)


def test_depth_and_chunking_do_not_change_results():
    frames, _ = clip(n=48, seed=4)
    kw = dict(start_location=port.IJ(50, 50), target_width=10, device="cpu")
    want = port.track(frames, **kw)[1]
    for extra in (dict(chunk_size=7, pipeline_depth=0), dict(chunk_size=5, pipeline_depth=3),
                  dict(chunk_size=200)):
        np.testing.assert_array_equal(port.track(frames, **kw, **extra)[1], want)


def test_bad_inputs_raise():
    with pytest.raises(IOError):
        port.track("/nonexistent/video.mp4", device="cpu")
    frames, _ = clip(n=24)
    with pytest.raises(ValueError, match="no frames"):
        port.track(frames, start=1.0, stop=1.0, device="cpu")
