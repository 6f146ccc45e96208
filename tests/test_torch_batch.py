"""The port's ``track_batch(..., device="cpu")`` against the JAX package's:
positions and timestamps equal over a matrix of batches, every lane equal to
the port's own single-video ``track()``; and the single-device
``ShardedBatchTracker`` and ``global_detect_batch`` against JAX's. The batched
kernel configurations are held against Pallas in tests/test_torch_kernel.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pawsometracker_tpu as ref
import pawsometracker_tpu_torch as port
from pawsometracker_tpu.batch import track_batch as ref_track_batch
from pawsometracker_tpu.models.dog_tracker import make_spec as ref_make_spec
from pawsometracker_tpu.parallel.mesh import global_detect_batch as ref_detect_batch
from pawsometracker_tpu_torch.models.dog_tracker import make_spec
from pawsometracker_tpu_torch.parallel.mesh import ShardedBatchTracker, global_detect_batch

import helpers
from test_tracker_core import draw_blob


def clip(n, seed, h=100, w=100, tw=10, bg=128, start=(50, 50), r=25):
    """The first ``n`` frames of a spiral clip (``tests/helpers.py``) on a
    background of gray ``bg``, and its truth."""
    rng = np.random.default_rng(seed)
    _, tra = helpers.build_trajectory(r, 24, start, rng)
    tra = tra[:n]
    frames = np.stack([helpers.render_frame(h, w, ij, tw, True) for ij in tra])
    if bg != 128:
        frames[frames == 128] = bg
    return frames, np.array(tra)


def both(pkg_case):
    """(port kwargs, JAX kwargs): start locations given as ("ij", i, j),
    ("xy", x, y) or None, mapped to each package's kinds."""
    def conv(pkg, loc):
        if isinstance(loc, tuple) and loc[0] == "ij":
            return pkg.IJ(loc[1], loc[2])
        if isinstance(loc, tuple) and loc[0] == "xy":
            return (loc[1], loc[2])
        return loc

    out = []
    for pkg in (port, ref):
        kw = dict(pkg_case)
        loc = kw.get("start_location")
        kw["start_location"] = [conv(pkg, v) for v in loc] if isinstance(loc, list) else conv(pkg, loc)
        out.append(kw)
    return out


def assert_batches_equal(got, want, subpixel=False):
    assert len(got) == len(want)
    for (gt, gi), (wt, wi) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        if subpixel:
            np.testing.assert_array_equal(np.round(gi), np.round(wi))
            np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-3)
        else:
            np.testing.assert_array_equal(gi, wi)
            assert gi.dtype == wi.dtype


CLIPS = {
    "same": lambda: [clip(40, 1)[0], clip(40, 2)[0], clip(40, 3)[0]],
    # lengths 40, 23 and 33 with 16-frame chunks: the short lanes end inside a
    # chunk, and their padded steps must not move what the other lanes see
    "ragged": lambda: [clip(40, 1)[0], clip(23, 2)[0], clip(33, 3)[0]],
    "backgrounds": lambda: [clip(36, 4, bg=100)[0], clip(36, 5, bg=170)[0], clip(36, 6)[0]],
}

MATRIX = {
    "one IJ for all": ("ragged", dict(start_location=("ij", 50, 50))),
    "kinds per file": ("ragged", dict(start_location=[("ij", 50, 50), ("xy", 49.0, 51.0), None])),
    "auto lane": ("same", dict(start_location=[("ij", 50, 50), None, ("ij", 50, 50)])),
    "all auto": ("backgrounds", dict(start_location=None)),
    "backgrounds": ("backgrounds", dict(start_location=("ij", 50, 50))),
    "subpixel": ("ragged", dict(start_location=("ij", 50, 50), subpixel=True)),
    "subpixel + auto": ("same", dict(start_location=[None, ("ij", 50, 50), None], subpixel=True)),
    "start-stop": ("same", dict(start_location=("ij", 50, 50), start=[0.25, 0.0, 0.5],
                                stop=[1.5, 1.0, None])),
}


@pytest.mark.parametrize("case", list(MATRIX))
def test_track_batch_matches_jax(case):
    which, kw = MATRIX[case]
    clips = CLIPS[which]()
    pkw, rkw = both(kw)
    got = port.track_batch(clips, fps=24, target_width=10, chunk_size=16, device="cpu", **pkw)
    want = ref_track_batch(clips, fps=24, target_width=10, chunk_size=16, stream="full", **rkw)
    assert_batches_equal(got, want, kw.get("subpixel", False))


def test_track_batch_stream_auto_matches_jax_auto():
    """stream="auto" on both sides: the JAX package decides between its ROI
    and full-frame streaming; the port streams full frames. Same positions."""
    clips = CLIPS["ragged"]()
    got = port.track_batch(clips, fps=24, target_width=10, start_location=port.IJ(50, 50),
                           device="cpu")
    want = ref_track_batch(clips, fps=24, target_width=10, start_location=ref.IJ(50, 50))
    assert_batches_equal(got, want)


@pytest.mark.parametrize("widths", ["two resolutions", "per-file target_width"])
def test_track_batch_buckets_match_jax(widths):
    """One bucket per tracker configuration (resolution, target width),
    results in input order."""
    small = dict(h=80, w=96, start=(40, 48), r=20)
    if widths == "two resolutions":
        clips = [clip(30, 7)[0], clip(30, 8, **small)[0], clip(30, 9)[0]]
        locs, tws = [(50, 50), (40, 48), (50, 50)], [10, 10, 10]
    else:
        clips = [clip(30, 7)[0], clip(30, 10, tw=8, **small)[0], clip(30, 9, tw=8)[0]]
        locs, tws = [(50, 50), (40, 48), (50, 50)], [10, 8, 8]
    got = port.track_batch(clips, fps=24, target_width=tws, chunk_size=16, device="cpu",
                           start_location=[port.IJ(*ij) for ij in locs])
    want = ref_track_batch(clips, fps=24, target_width=tws, chunk_size=16, stream="full",
                           start_location=[ref.IJ(*ij) for ij in locs])
    assert_batches_equal(got, want)


def test_each_lane_equals_single_track():
    """The JAX package's invariant: each lane identical to a per-video track()."""
    clips = CLIPS["ragged"]()
    locs = [port.IJ(50, 50), None, (49.0, 51.0)]
    got = port.track_batch(clips, fps=24, target_width=10, chunk_size=16, start_location=locs,
                           device="cpu")
    for (ts, ij), frames, loc in zip(got, clips, locs):
        ts1, ij1 = port.track(frames, fps=24, target_width=10, chunk_size=16,
                              start_location=loc, device="cpu")
        np.testing.assert_array_equal(ts, ts1)
        np.testing.assert_array_equal(ij, ij1)


def test_track_batch_rmse_and_depths():
    """Positions within 1 px of the drawn truth, the same at every pipeline
    depth and chunk size."""
    data = [clip(30, 11), clip(21, 12), clip(30, 13)]
    clips = [d[0] for d in data]
    kw = dict(fps=24, target_width=10, start_location=port.IJ(50, 50), device="cpu")
    want = port.track_batch(clips, **kw, chunk_size=16)
    for (_, ij), (_, tra) in zip(want, data):
        assert len(ij) == len(tra)
        assert np.sqrt(np.mean(np.sum((ij - tra) ** 2, axis=1))) < 1.0
    for extra in (dict(chunk_size=7, pipeline_depth=0), dict(chunk_size=200, pipeline_depth=3)):
        for (_, a), (_, b) in zip(port.track_batch(clips, **kw, **extra), want):
            np.testing.assert_array_equal(a, b)


def test_array_mixed_with_file_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(14)
    _, tra = helpers.build_trajectory(25, 24, (50, 50), rng)
    f = helpers.trajectory2video(tra[:36], str(tmp_path), 24, 100, 100, 10, True)
    files = [f, clip(30, 15)[0]]
    got = port.track_batch(files, fps=24, target_width=10, start_location=port.IJ(50, 50),
                           device="cpu")
    want = ref_track_batch(files, fps=24, target_width=10, start_location=ref.IJ(50, 50))
    assert_batches_equal(got, want)


def test_per_lane_overlays_match_jax(tmp_path):
    """Same positions, same overlay writer: each lane's overlay decodes to the
    JAX package's frames (same basenames: the label is the file's basename)."""
    cv2 = pytest.importorskip("cv2")
    clips = [clip(24, 16)[0], clip(20, 17)[0]]
    paths = {}
    for name, pkg, fn, extra in (("port", port, port.track_batch, {"device": "cpu"}),
                                 ("ref", ref, ref_track_batch, {})):
        d = tmp_path / name
        d.mkdir()
        paths[name] = [str(d / "a.mp4"), None, str(d / "c.mp4")]
        fn(clips + [clips[0]], fps=24, target_width=10, start_location=pkg.IJ(50, 50),
           chunk_size=8, diagnostic_files=paths[name], **extra)
    for p, r in zip(paths["port"], paths["ref"]):
        if p is None:
            continue
        decoded = []
        for f in (p, r):
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


def test_progress_over_the_batch():
    clips = CLIPS["ragged"]()
    calls = []
    res = port.track_batch(clips, fps=24, target_width=10, chunk_size=16,
                           start_location=port.IJ(50, 50), device="cpu",
                           progress=lambda d, t: calls.append((d, t)))
    dones = [d for d, _ in calls]
    assert dones == sorted(dones) and dones[-1] == sum(len(ij) - 1 for _, ij in res)
    assert all(t == calls[0][1] for _, t in calls)


def test_opens_each_input_once(monkeypatch):
    """One probe per file for bucketing and one decode open: no re-probing."""
    import pawsometracker_tpu_torch.batch as batch_mod
    from pawsometracker_tpu_torch.io import decode as decode_mod

    calls = {"probe": 0, "open": 0}
    real_probe, real_open = decode_mod.probe, batch_mod.open_source

    def counting_probe(p):
        calls["probe"] += 1
        return real_probe(p)

    def counting_open(*a, **k):
        calls["open"] += 1
        return real_open(*a, **k)

    monkeypatch.setattr(decode_mod, "probe", counting_probe)
    monkeypatch.setattr(batch_mod, "open_source", counting_open)
    frames = clip(20, 18)[0]
    assert len(port.track_batch([frames] * 3, target_width=10, start_location=port.IJ(50, 50),
                                device="cpu")) == 3
    assert calls == {"probe": 3, "open": 3}


def test_stream_and_mesh_rules():
    """stream="roi" gives the positions of stream="full"; a mesh of two CPU
    entries gives the positions of mesh=None, and an object that is no mesh
    raises TypeError; the engine and stream choices are checked."""
    clips = [clip(20, 19)[0]] * 2
    kw = dict(target_width=10, start_location=port.IJ(50, 50))
    roi = port.track_batch(clips, stream="roi", device="cpu", **kw)
    full = port.track_batch(clips, stream="full", device="cpu", **kw)
    for (tr, ir), (tf, i_f) in zip(roi, full):
        np.testing.assert_array_equal(tr, tf)
        np.testing.assert_array_equal(ir, i_f)
    for bad in (dict(stream="crops"), dict(stream="roi", roi_frames=0)):
        with pytest.raises(ValueError):
            port.track_batch(clips, device="cpu", **bad, **kw)
    with pytest.raises(TypeError, match="mesh must be"):
        port.track_batch(clips, mesh=object(), device="cpu", **kw)
    a = port.track_batch(clips, mesh=None, device="cpu", **kw)
    two = port.track_batch(clips, mesh=port.make_mesh(devices=["cpu"] * 2), **kw)
    for (ta, ia), (tb, ib) in zip(a, two):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ia, ib)
    b = port.track_batch(clips, mesh="auto", engine="xla", device="cpu", **kw)
    for (ta, ia), (tb, ib) in zip(a, b):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ia, ib)
    with pytest.raises(ValueError, match="must be one of"):
        port.track_batch(clips, engine="cuda", device="cpu", **kw)
    assert port.track_batch([], device="cpu") == []


# ---- the single-device batch engine and the whole-frame detector -------------


def jx(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


def test_sharded_batch_tracker_snaps_match_jax(rng):
    """ShardedBatchTracker's snaps (the tracker's and the quarter-frame
    autodetect's, plain and subpixel) equal the JAX package's, and the same
    snaps over a CPU mesh equal the single-device ones; an object that is no
    mesh raises TypeError."""
    from pawsometracker_tpu.parallel.mesh import ShardedBatchTracker as RefTracker

    h, w, B = 90, 100, 3
    frames = rng.integers(60, 200, size=(B, h, w)).astype(np.uint8)
    for b, (i, j) in enumerate([(40, 50), (20, 80), (70, 30)]):
        frames[b, i - 4:i + 4, j - 3:j + 4] = 0
    fills = np.array([128, 100, 150], np.uint8)
    guesses = np.array([[42, 48], [18, 83], [44, 54]], np.int32)
    rt = RefTracker(ref_make_spec((h, w), 21, 8, True))
    pt = ShardedBatchTracker(make_spec((h, w), 21, 8, True), device="cpu")
    a = jx(frames, guesses, fills)
    np.testing.assert_array_equal(pt.snap(frames, guesses, fills).numpy(), np.asarray(rt.snap(*a)))
    np.testing.assert_array_equal(pt.snap_detect(frames, guesses, fills).numpy(),
                                  np.asarray(rt.snap_detect(*a)))
    for got, want in ((pt.snap_sub(frames, guesses, fills), rt.snap_sub(*a)),
                      (pt.snap_detect_sub(frames, guesses, fills), rt.snap_detect_sub(*a))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-3)
    placed = pt.shard_chunk(frames)
    assert isinstance(placed, torch.Tensor) and placed.device == torch.device("cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        ShardedBatchTracker(make_spec((h, w), 21, 8, True), mesh=object(), device="cpu")
    # B = 3 lanes on a 3-entry CPU mesh: each snap equals the single-device one
    mt = ShardedBatchTracker(make_spec((h, w), 21, 8, True),
                             mesh=port.make_mesh(devices=["cpu"] * 3))
    for name in ("snap", "snap_detect", "snap_sub", "snap_detect_sub"):
        got = getattr(mt, name)(frames, guesses, fills)
        want = getattr(pt, name)(frames, guesses, fills)
        for g, w_ in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(np.asarray(g), w_.numpy())


def test_global_detect_batch_matches_jax():
    h, w = 96, 100
    frames = np.stack([draw_blob(h, w, ij, 5, bg=bg) for ij, bg in
                       (((30, 40), 128), ((70, 85), 100), ((15, 20), 170))])
    fills = np.array([128, 100, 170], np.uint8)
    spec = make_spec((h, w), 21, 10, True)
    got = global_detect_batch(spec)(frames, fills)
    want = ref_detect_batch(ref_make_spec((h, w), 21, 10, True))(*jx(frames, fills))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[30, 40], [70, 85], [15, 20]])
