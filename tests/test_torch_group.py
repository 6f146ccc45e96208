"""The segmented scans and one launch a dispatch, on the CPU, against the JAX package.

The JAX package runs S chunk scans as one program under ``PAWS_DISPATCH_GROUP``
(``make_super_chain``, ``make_chained_batch``, ``make_super_chain_batch``,
``make_super_full`` in ``pawsometracker_tpu/pipeline.py``); the kernel layer's
segmented scans are their counterpart, and their plain versions run here. The
port's pipelines launch every dispatch at once and read no pin: the end-to-end
tests set the pin for the JAX package and hold the port to it. Integer positions
must be equal, ``ts`` equal, offsets within ``atol=1e-3``. The inputs hold no
exact ties (a dark disc on a flat background), where the JAX package's XLA scan
breaks ties its own way (ROADMAP "Exact ties"). Mirrors
``tests/test_roi_stream.py:384-527`` and ``tests/test_sharding.py:357``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pawsometracker_tpu as ref
import pawsometracker_tpu.api as ref_api
import pawsometracker_tpu.pipeline as ref_pipeline
import pawsometracker_tpu_torch as port
import pawsometracker_tpu_torch.pipeline as pipeline
from pawsometracker_tpu.batch import track_batch as ref_track_batch
from pawsometracker_tpu.models.dog_tracker import make_spec as ref_make_spec
from pawsometracker_tpu.models.dog_tracker import tracker_fns as ref_tracker_fns
from pawsometracker_tpu.multi import track_multi as ref_track_multi
from pawsometracker_tpu.parallel import mesh as ref_mesh
from pawsometracker_tpu.parallel.mesh import ShardedBatchTracker as RefTracker
from pawsometracker_tpu_torch.models.dog_tracker import make_spec, tracker_fns
from pawsometracker_tpu_torch.ops import roi_crop
from pawsometracker_tpu_torch.ops import tracker_kernel as tk
from pawsometracker_tpu_torch.parallel.mesh import ShardedBatchTracker, make_mesh
from pawsometracker_tpu_torch.utils.profiling import Timer

import helpers
from test_tracker_core import draw_blob

cv2 = pytest.importorskip("cv2")

OFFSET_ATOL = 1e-3


def assert_same(got, want, subpixel=False):
    np.testing.assert_array_equal(got[0], want[0])
    if subpixel:
        np.testing.assert_array_equal(np.round(got[1]), np.round(want[1]))
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=OFFSET_ATOL)
    else:
        np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture
def port_stats():
    """The ``paws_stats`` of each port call, in order."""
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            if hasattr(record, "paws_stats"):
                seen.append(record.paws_stats)

    log = logging.getLogger("pawsometracker_tpu_torch")
    handler, level = Keep(logging.DEBUG), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    yield seen
    log.removeHandler(handler)
    log.setLevel(level)


# ---- the plain segmented scans against the JAX super-programs ------------------------


def moving_blobs(rng, n, h, w, lanes=1, radius=3):
    """``[lanes, n, h, w]`` frames of a dark disc each, moving a few px a frame."""
    out = np.empty((lanes, n, h, w), np.uint8)
    for b in range(lanes):
        ij = rng.integers(12, [h - 12, w - 12])
        for t in range(n):
            ij = np.clip(ij + rng.integers(-3, 4, 2), 5, [h - 6, w - 6])
            out[b, t] = draw_blob(h, w, ij, radius)
    return out


def chain_case(seed, ks, K=6, ch=41, cw=41, h=120, w=120, off_crop=None):
    """S chunks of K crops a lane, cut as the ROI pipeline cuts them: a dark
    disc moves up to 3 px a frame through h x w frames (frame 0 is the
    start), and each real frame of a chunk is cropped (fill 128 outside the
    frame) at an origin that puts the disc within 3 px of the crop's centre;
    rows past a chunk's ``ks [S, lanes]`` real frames repeat its last crop at
    its last origin, and a lane with ks = 0 gets a crop of fill. With
    ``off_crop=b`` lane b's first crop lies so that its start is 2 rows below
    the crop and the disc of its first frame 1 row inside (past the far edge,
    where both packages clamp the window alike; the JAX package's
    ``dynamic_slice`` wraps a negative start). Returns ``(crops
    [S, lanes, K, ch, cw], origins [S, lanes, K, 2], starts [lanes, 2],
    boxes (lo, hi) [S, lanes, K, 2])``; the disc is always inside its windows,
    so no response ties."""
    rng = np.random.default_rng(seed)
    S, lanes = ks.shape
    c = np.array([ch // 2, cw // 2])
    crops = np.full((S, lanes, K, ch, cw), 128, np.uint8)
    origins = np.zeros((S, lanes, K, 2), np.int64)
    starts = np.zeros((lanes, 2), np.int64)
    for b in range(lanes):
        ij = rng.integers(30, [h - 30, w - 30])
        starts[b] = ij
        last = ij - c
        for s in range(S):
            for t in range(K):
                if t < ks[s, b]:
                    step = rng.integers(-3, 4, 2)
                    if off_crop == b and s == 0 and t == 0:
                        step = np.array([-3, 0])
                    ij = np.clip(ij + step, 8, [h - 9, w - 9])
                    o = ij - c + rng.integers(-3, 4, 2)
                    if off_crop == b and s == 0 and t == 0:
                        o = ij - [ch - 2, c[1]]
                    crops[s, b, t] = roi_crop.crop_with_fill(draw_blob(h, w, ij, 3), o, ch, cw,
                                                             128)
                    last = o
                elif t > 0:
                    crops[s, b, t] = crops[s, b, t - 1]
                origins[s, b, t] = last
    lo = np.maximum(-origins, 0)
    hi = np.minimum([ch - 1, cw - 1], [h - 1, w - 1] - origins)
    return crops, origins, starts, (lo.astype(np.int32), hi.astype(np.int32))


def assert_real_rows(got, want, ks, subpixel):
    """Positions equal (offsets within atol) on each lane's real rows of each
    segment: pad rows and a lane with no real frame scan repeated or fill
    crops, whose rows the pipelines discard."""
    for s in range(ks.shape[0]):
        for b in range(ks.shape[1]):
            k = int(ks[s, b])
            g = (got[0][s], got[1][s]) if subpixel else (got[s],)
            w = (want[s][0], want[s][1]) if subpixel else (want[s],)
            if ks.shape[1] > 1 or g[0].dim() == 3:
                g = tuple(x[b] for x in g)
                w = tuple(np.asarray(x)[b] for x in w)
            np.testing.assert_array_equal(g[0][:k].numpy(), np.asarray(w[0])[:k])
            if subpixel:
                np.testing.assert_allclose(g[1][:k].numpy(), np.asarray(w[1])[:k], rtol=0,
                                           atol=OFFSET_ATOL)


SHORT_KS = [6, 3, 6, 1]  # segments of 6 steps: full, short, full, one real step


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("subpixel", [False, True])
def test_single_segments_match_make_super_chain(S, subpixel):
    """dog_scan_segments' plain version equals JAX make_super_chain over its XLA
    scan: each segment from the last one's row max(ks-1, 0), short segments
    included, rebased by deltas[s][0] as the single engine builds it."""
    K, ch, cw = 6, 41, 41
    ks = np.array(SHORT_KS[:S], np.int64)[:, None]
    crops, origins, starts, (lo, hi) = chain_case(10 + S, ks)
    crops, o, lo, hi = crops[:, 0], origins[:, 0], lo[:, 0], hi[:, 0]
    pre_origin = starts[0] - [ch // 2, cw // 2]  # the chunk before the group
    deltas = np.empty_like(o)
    for s in range(S):
        prev_last = pre_origin if s == 0 else o[s - 1, max(int(ks[s - 1, 0]) - 1, 0)]
        deltas[s] = pipeline._SingleEngine._deltas(o[s], prev_last)
    deltas = deltas.astype(np.int32)
    prev_k = 3
    prev = np.zeros((K, 2), np.int32)
    prev[prev_k - 1] = starts[0] - pre_origin
    spec, rspec = make_spec((ch, cw), 15, 6, True), ref_make_spec((ch, cw), 15, 6, True)
    fns = ref_tracker_fns(rspec)
    sup = ref_pipeline.make_super_chain(fns.scan_sub if subpixel else fns.scan_bounded, S,
                                        subpixel)
    want = sup(tuple(jnp.asarray(c) for c in crops), jnp.asarray(prev), np.int32(prev_k),
               ks[:, 0].astype(np.int32), deltas, np.uint8(128), lo, hi)
    got = tracker_fns(spec, "cpu").scan_bounded_super(
        crops, torch.from_numpy(prev[prev_k - 1]), 128, deltas, lo, hi, ks[:, 0],
        subpixel=subpixel)
    assert_real_rows(got, want, ks, subpixel)


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("subpixel", [False, True])
def test_batch_segments_match_make_super_chain_batch(S, subpixel):
    """dog_scan_batch_segments' plain version with a carry equals JAX
    make_super_chain_batch (S = 1: make_chained_batch) over the vmapped XLA
    scan, on real rows and on the carry: short segments, lane 1 with no real
    frame in segment 1 (its carry holds), and lane 2's start outside its
    first crop."""
    B, ch, cw = 3, 41, 41
    ks = np.tile(np.array(SHORT_KS[:S], np.int64)[:, None], (1, B))
    if S > 1:
        ks[1, 1] = 0
    crops, o, starts, (lo, hi) = chain_case(20 + S, ks, off_crop=2)
    deltas = np.stack([pipeline._BatchedEngine._deltas(o[s]) for s in range(S)]).astype(np.int32)
    origin0 = o[:, :, 0].astype(np.int32)
    origin_last = np.stack([pipeline._BatchedEngine._last_origin(o[s], ks[s])
                            for s in range(S)]).astype(np.int32)
    carry = starts.astype(np.int32)
    assert (carry[2] - origin0[0, 2])[0] > ch - 1  # outside the crop
    kss = ks.astype(np.int32)
    fills = np.full(B, 128, np.uint8)
    spec, rspec = make_spec((ch, cw), 15, 6, True), ref_make_spec((ch, cw), 15, 6, True)
    scan = RefTracker(rspec).scan_sub if subpixel else RefTracker(rspec).scan_bounded
    got, got_carry = tracker_fns(spec, "cpu").scan_bounded_batch_super(
        crops, carry, fills, deltas, lo, hi, kss, origin0, origin_last, subpixel=subpixel)
    if S == 1:
        out, want_carry = ref_pipeline.make_chained_batch(scan)(
            crops[0], carry, kss[0], origin0[0], origin_last[0], fills, deltas[0], lo[0], hi[0])
        outs = [out]
    else:
        outs, want_carry = ref_pipeline.make_super_chain_batch(scan, S, subpixel)(
            tuple(jnp.asarray(c) for c in crops), carry, kss, origin0, origin_last, deltas,
            fills, lo, hi)
    np.testing.assert_array_equal(got_carry.numpy(), np.asarray(want_carry))
    assert_real_rows(got, outs, ks, subpixel)
    # the carry lands in carry_out, which may be the carry itself
    c = torch.from_numpy(carry.copy())
    _, same = tracker_fns(spec, "cpu").scan_bounded_batch_super(
        crops, c, fills, deltas, lo, hi, kss, origin0, origin_last, carry_out=c,
        subpixel=subpixel)
    assert same is c
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_carry))


def test_batch_segments_carry_equals_chain_batch():
    """With S = 1 the segmented launch's carry is chain_batch's: the engines'
    kernel carry and the tensor-op form of the same rule agree."""
    B, K = 3, 6
    ks = np.array([[6, 0, 2]])
    crops, o, starts, (lo, hi) = chain_case(5, ks)
    spec = make_spec((41, 41), 15, 6, True)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in dict(
        crops=crops[0], carry=starts.astype(np.int32), ks=ks[0].astype(np.int32),
        o0=o[0, :, 0].astype(np.int32),
        olast=pipeline._BatchedEngine._last_origin(o[0], ks[0]).astype(np.int32),
        fills=np.full(B, 128, np.uint8),
        deltas=pipeline._BatchedEngine._deltas(o[0]).astype(np.int32), lo=lo[0],
        hi=hi[0]).items()}
    tracker = ShardedBatchTracker(spec, device="cpu")
    out, want = pipeline.chain_batch(tracker.scan_bounded, t["crops"], t["carry"], t["ks"],
                                     torch.from_numpy(pipeline.last_rows(ks[0], K)), t["o0"],
                                     t["olast"], t["fills"], t["deltas"], t["lo"], t["hi"])
    got, got_carry = tracker_fns(spec, "cpu").scan_bounded_batch_super(
        t["crops"][None], t["carry"], t["fills"], t["deltas"][None], t["lo"][None],
        t["hi"][None], t["ks"][None], t["o0"][None], t["olast"][None])
    np.testing.assert_array_equal(got[0].numpy(), out.numpy())
    np.testing.assert_array_equal(got_carry.numpy(), want.numpy())


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("subpixel", [False, True])
def test_full_segments_match_make_super_full(S, subpixel):
    """scan_super's plain version equals JAX make_super_full: whole frames,
    each segment from the last one's last step (with subpixel, JAX's
    full-frame subpixel scan)."""
    rng = np.random.default_rng(30 + S)
    T, h, w = 5, 48, 56
    spec, rspec = make_spec((h, w), 15, 6, True), ref_make_spec((h, w), 15, 6, True)
    path = [np.array([24, 28])]
    for _ in range(S * T):
        path.append(np.clip(path[-1] + rng.integers(-3, 4, 2), 6, [h - 7, w - 7]))
    frames = np.stack([draw_blob(h, w, ij, 3) for ij in path[1:]]).reshape(S, T, h, w)
    prev = np.zeros((T, 2), np.int32)
    prev[-1] = path[0]
    scan = ref_api._full_scan_sub(rspec) if subpixel else ref_tracker_fns(rspec).scan
    want = ref_pipeline.make_super_full(scan, S, subpixel)(
        tuple(jnp.asarray(f) for f in frames), jnp.asarray(prev), np.uint8(128))
    got = tracker_fns(spec, "cpu").scan_super(frames, prev[-1], 128, subpixel=subpixel)
    assert_real_rows(got, want, np.full((S, 1), T), subpixel)


def test_segment_wrappers_dispatch_and_check():
    """A CPU tensor takes the plain version and counts no launch; the CUDA
    wrappers refuse CPU tensors; the checks name what is wrong. With one
    segment the segmented scan is the chunk scan."""
    rng = np.random.default_rng(6)
    spec = make_spec((40, 40), 9, 6, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True)
    frames = torch.from_numpy(moving_blobs(rng, 8, 40, 40, lanes=2).reshape(2, 2, 4, 40, 40))
    p0 = torch.tensor([[20, 20], [18, 22]], dtype=torch.int32)
    fl = torch.tensor([128, 128], dtype=torch.uint8)
    before = tk.launches
    got = tk.dog_scan_batch_segments(frames.transpose(0, 1).contiguous(), p0, fl, **kw)
    assert tk.launches == before
    one = tk.dog_scan_segments(frames[0, :1], p0[0], 128, **kw)
    np.testing.assert_array_equal(one[0].numpy(), tk.dog_scan(frames[0, 0], p0[0], 128,
                                                              **kw).numpy())
    assert got.shape == (2, 2, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tk.dog_scan_segments_cuda(frames[0], p0[0], 128, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tk.dog_scan_batch_segments_cuda(frames, p0, fl, **kw)
    with pytest.raises(ValueError, match="uint8"):
        tk.dog_scan_segments(frames[0].float(), p0[0], 128, **kw)
    z = torch.zeros((2, 2, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="ks, origin0 and origin_last"):
        tk.dog_scan_batch_segments(frames, None, fl, carry=p0, **kw)
    with pytest.raises(ValueError, match="together"):
        tk.dog_scan_batch_segments(frames, p0, fl, deltas=z, **kw)
    with pytest.raises(ValueError, match="ks must have shape"):
        tk.dog_scan_segments(frames[0], p0[0], 128, ks=torch.zeros(3, dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tk.dog_scan_segments(frames[0].to("meta"), p0[0].to("meta"), 128, **kw)
    assert tk._config_name(True, True, batched=True, segmented=True) == \
        "batched bounded+subpixel, segmented"


# ---- the pipelines, against the JAX package under a pin ----------------------------


def walk_video(tmp_path, seed, T=44, h=160, w=160):
    """tests/test_roi_stream.py:384's clip: near-radius random steps."""
    rng = np.random.default_rng(seed)
    ij = np.array([80, 80])
    frames = []
    for _ in range(T):
        ij = np.clip(ij + rng.integers(-9, 10, size=2), 6, [h - 7, w - 7])
        img = np.full((h, w), 128, np.uint8)
        cv2.circle(img, (int(ij[1]), int(ij[0])), 4, 0, -1)
        frames.append(img)
    return helpers.write_video(frames, str(tmp_path / "walk"), 24)


def assert_one_launch_a_dispatch(st):
    """A ROI call's record: one chunk launch a dispatch, and no group size."""
    assert st["stream"] == "roi" and st["groups"] == st["dispatches"] and "group" not in st


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("subpixel", [False, True])
def test_roi_group_matches_jax_and_full(tmp_path, monkeypatch, port_stats, group, subpixel):
    """track(stream="roi") equals the JAX package's under PAWS_DISPATCH_GROUP
    and the port's stream="full", and the port, which reads no pin, launches
    once a dispatch."""
    f = walk_video(tmp_path, 300 + group)
    kw = dict(fps=24, target_width=8, window_size=21, subpixel=subpixel)
    _, full = port.track(f, start_location=port.IJ(80, 80), stream="full", device="cpu", **kw)
    monkeypatch.setenv("PAWS_DISPATCH_GROUP", str(group))
    roi = dict(stream="roi", roi_frames=4, pipeline_depth=3, **kw)
    got = port.track(f, start_location=port.IJ(80, 80), device="cpu", **roi)
    want = ref.track(f, start_location=ref.IJ(80, 80), **roi)
    assert_same(got, want, subpixel)
    assert_same(got, (got[0], full), subpixel)
    assert_one_launch_a_dispatch(port_stats[-1])


def test_roi_group_replay_matches(tmp_path, monkeypatch, port_stats):
    """Velocity-defeating motion, the JAX package at pin 3: replays reset the
    chain, and the positions stay the JAX package's and full-frame's."""
    h, w = 200, 200
    frames = []
    for t in range(48):
        ph = t % 12
        tri = 12 * ph if ph < 6 else 12 * (12 - ph)
        img = np.full((h, w), 128, np.uint8)
        cv2.circle(img, (100, 60 + tri), 5, 0, -1)
        frames.append(img)
    f = helpers.write_video(frames, str(tmp_path / "jump"), 24)
    kw = dict(fps=24, target_width=10, window_size=31)
    _, full = port.track(f, start_location=port.IJ(60, 100), stream="full", device="cpu", **kw)
    monkeypatch.setenv("PAWS_DISPATCH_GROUP", "3")
    before = pipeline.replay_count
    roi = dict(stream="roi", roi_frames=4, pipeline_depth="auto", **kw)
    got = port.track(f, start_location=port.IJ(60, 100), device="cpu", **roi)
    want = ref.track(f, start_location=ref.IJ(60, 100), **roi)
    assert_same(got, want)
    np.testing.assert_array_equal(got[1], full)
    assert pipeline.replay_count > before and port_stats[-1]["replays"] > 0
    assert_one_launch_a_dispatch(port_stats[-1])


@pytest.mark.parametrize("subpixel", [False, True])
def test_full_stream_group_matches_jax(tmp_path, monkeypatch, port_stats, subpixel):
    """Full-frame streaming with 4-frame chunks equals the JAX package's at
    pin 3 and the port's depth-0 run; the port launches once a chunk."""
    rng = np.random.default_rng(310)
    _, tra = helpers.build_trajectory(30, 24, (60, 60), rng)
    f = helpers.trajectory2video(tra, str(tmp_path), 24, 140, 140, 10, True)
    kw = dict(fps=24, target_width=10, stream="full", subpixel=subpixel)
    base = port.track(f, start_location=port.IJ(60, 60), pipeline_depth=0, device="cpu", **kw)
    monkeypatch.setenv("PAWS_DISPATCH_GROUP", "3")
    got = port.track(f, start_location=port.IJ(60, 60), pipeline_depth=3, chunk_size=4,
                     device="cpu", **kw)
    want = ref.track(f, start_location=ref.IJ(60, 60), pipeline_depth=3, chunk_size=4, **kw)
    assert_same(got, want, subpixel)
    assert_same(got, base, subpixel)
    assert port_stats[-1]["groups"] == -(-(len(got[1]) - 1) // 4)


def test_batch_and_multi_roi_group_match_jax(tmp_path, monkeypatch, port_stats):
    """track_batch and track_multi on ROI equal the JAX package's at pin 3:
    two videos of their own length, and two discs of one video; the port
    launches once a dispatch."""
    rng = np.random.default_rng(320)
    _, tra = helpers.build_trajectory(30, 24, (60, 60), rng)
    f = helpers.trajectory2video(tra, str(tmp_path), 24, 140, 140, 10, True)
    _, tra2 = helpers.build_trajectory(25, 24, (70, 70), rng)
    (tmp_path / "b").mkdir()
    f2 = helpers.trajectory2video(tra2[:50], str(tmp_path / "b"), 24, 140, 140, 10, True)
    two, shifted = [], np.asarray(tra2[:60]) + [0, 10]
    for a, b in zip(tra[:60], shifted):
        img = np.full((140, 140), 128, np.uint8)
        for ij in (a, b):
            cv2.circle(img, (int(ij[1]), int(ij[0])), 5, 0, -1)
        two.append(img)
    fm = helpers.write_video(two, str(tmp_path / "two"), 24)
    locs = [tuple(int(v) for v in tra[0]), tuple(int(v) for v in shifted[0])]
    kw = dict(fps=24, target_width=10, stream="roi", roi_frames=4, pipeline_depth=3)
    monkeypatch.setenv("PAWS_DISPATCH_GROUP", "3")
    got = port.track_batch([f, f2], start_location=port.IJ(60, 60), device="cpu", **kw)
    assert_one_launch_a_dispatch(port_stats[-1])
    want = ref_track_batch([f, f2], start_location=ref.IJ(60, 60), **kw)
    for g, w in zip(got, want):
        assert_same(g, w)
    mgot = port.track_multi(fm, [port.IJ(*x) for x in locs], device="cpu", **kw)
    assert_one_launch_a_dispatch(port_stats[-1])
    mwant = ref_track_multi(fm, [ref.IJ(*x) for x in locs], **kw)
    assert_same(mgot, mwant)


@pytest.mark.parametrize("subpixel", [False, True])
def test_track_batch_mesh_group_matches_jax(tmp_path, monkeypatch, port_stats, subpixel):
    """tests/test_sharding.py:357 on the port: track_batch on ROI over an
    8-entry CPU mesh (data 4 x space 2) equals JAX's at pin 3 over its 8
    virtual devices, and the port's mesh=None run; one launch a data shard a
    dispatch, each shard's staged segmented scan at S = 1."""
    import os

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual CPU devices"
    rng = np.random.default_rng(33)
    files = []
    for b in range(4):
        _, tra = helpers.build_trajectory(20, 24, (50, 50), rng)
        f = helpers.trajectory2video(tra[:40], str(tmp_path), 24, 100, 100, 10, True)
        f2 = str(tmp_path / f"grp{b}.avi")
        os.rename(f, f2)
        files.append(f2)
    kw = dict(target_width=10, stream="roi", roi_frames=4, pipeline_depth=3, subpixel=subpixel)
    plain = port.track_batch(files, start_location=port.IJ(50, 50), device="cpu", **kw)
    monkeypatch.setenv("PAWS_DISPATCH_GROUP", "3")
    got = port.track_batch(files, start_location=port.IJ(50, 50),
                           mesh=make_mesh(devices=["cpu"] * 8, space=2), **kw)
    st = port_stats[-1]
    want = ref_track_batch(files, start_location=ref.IJ(50, 50),
                           mesh=ref_mesh.make_mesh(8, space=2), **kw)
    for g, w, p in zip(got, want, plain):
        assert_same(g, w, subpixel)
        assert_same(g, p, subpixel)
    assert st["shards"] == 4
    assert_one_launch_a_dispatch(st)


# ---- the engines: one launch a dispatch ---------------------------------------------


def _engines():
    """A single, a batched and a full-frame engine on the CPU."""
    spec = make_spec((61, 61), 21, 10, True)
    fns = tracker_fns(spec, "cpu")
    tracker = ShardedBatchTracker(spec, device="cpu")
    cpu = torch.device("cpu")
    return {
        "single": lambda: pipeline._SingleEngine(fns.scan_bounded, (61, 61), (200, 200), 128,
                                                 False, Timer(), cpu,
                                                 segments=fns.scan_bounded_super),
        "batched": lambda: pipeline._BatchedEngine(tracker.scan_bounded, (61, 61), (200, 200),
                                                   [128, 128], False, Timer(), cpu,
                                                   segments=fns.scan_bounded_batch_super),
        "full": lambda: pipeline._FullFrameEngine(
            tracker_fns(make_spec((200, 200), 21, 10, True), "cpu").scan, np.array([50, 50]),
            128, False, Timer(), cpu),
    }


def _box(o, crop=61, frame=200):
    """The clamp box ``(lo, hi)`` of crops of ``crop`` px at origins ``o``."""
    return np.maximum(-o, 0), np.minimum([crop - 1, crop - 1], [frame - 1, frame - 1] - o)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("kind", ["single", "batched", "full"])
def test_dispatch_launches_at_once(kind):
    """After reset(), each of five dispatches is one launch: ``groups`` rises
    by one with it and its handle is ready. Each handle's to_host gives its
    chunk's positions: the plain chunk scan chained from the previous chunk's
    last real step (a short chunk, and a lane with none, included)."""
    rng = np.random.default_rng(9)
    n, K = 5, 4
    eng = _engines()[kind]()
    eng.reset()
    if kind == "full":
        frames = moving_blobs(rng, n * K - 2, 200, 200)[0]
        chunks = [frames[i * K:(i + 1) * K] for i in range(n)]
        handles = []
        for i, chunk in enumerate(chunks):
            handles.append(eng.dispatch([chunk], K))
            assert eng.groups == i + 1 and eng.ready(handles[-1])
        scan = tracker_fns(make_spec((200, 200), 21, 10, True), "cpu").scan
        pos = torch.tensor([50, 50], dtype=torch.int32)
        for chunk, h in zip(chunks, handles):
            padded = np.concatenate([chunk] + [chunk[-1:]] * (K - len(chunk)))
            want = scan(torch.from_numpy(padded), pos, 128)
            np.testing.assert_array_equal(eng.to_host(h)[0], want.numpy())
            pos = want[len(chunk) - 1]
        return
    L = 1 if kind == "single" else 2
    crops = np.ascontiguousarray(
        moving_blobs(rng, n * K, 61, 61, lanes=L).reshape(L, n, K, 61, 61).swapaxes(0, 1))
    origins = (np.arange(n * K * L).reshape(n, L, K, 1) + np.array([20, 30])).astype(np.int64)
    valid = np.full((n, L), K, np.int64)
    valid[2] = 2  # a short chunk
    if L > 1:
        valid[3, 1] = 0  # a lane with no real frame
    P = np.array([[50, 60], [70, 80]][:L])
    handles = []
    for i in range(n):
        handles.append(eng.dispatch(crops[i].copy(), origins[i], P, valid[i]))
        assert eng.groups == i + 1 and eng.ready(handles[-1])
    got = [eng.to_host(h)[0] for h in handles]
    if kind == "single":
        scan = tracker_fns(make_spec((61, 61), 21, 10, True), "cpu").scan_bounded
        pos0, prev_o = _i32(P[0] - origins[0, 0, 0]), origins[0, 0, 0]
        for i in range(n):
            o, k = origins[i, 0], int(valid[i, 0])
            lo, hi = _box(o)
            want = scan(torch.from_numpy(crops[i, 0]), pos0, 128,
                        _i32(pipeline._SingleEngine._deltas(o, prev_o)), _i32(lo), _i32(hi))
            np.testing.assert_array_equal(got[i][0], want.numpy())
            pos0, prev_o = want[k - 1], o[k - 1]
        return
    tracker = ShardedBatchTracker(make_spec((61, 61), 21, 10, True), device="cpu")
    carry = _i32(P)
    fills = torch.full((L,), 128, dtype=torch.uint8)
    for i in range(n):
        o, ks = origins[i], valid[i]
        lo, hi = _box(o)
        want, carry = pipeline.chain_batch(
            tracker.scan_bounded, torch.from_numpy(crops[i]), carry, _i32(ks),
            torch.from_numpy(pipeline.last_rows(ks, K)), _i32(o[:, 0]),
            _i32(pipeline._BatchedEngine._last_origin(o, ks)), fills,
            _i32(pipeline._BatchedEngine._deltas(o)), _i32(lo), _i32(hi))
        np.testing.assert_array_equal(got[i], want.numpy())


def test_auto_depth_memo_carries_the_group(monkeypatch):
    """The memo holds ``(depth, soft cap)`` a run ended at, and no group size:
    a later run of the same geometry warm-starts both, whatever
    PAWS_DISPATCH_GROUP says, and records them again."""
    spec = make_spec((200, 200), 21, 10, True)

    class Eng:
        def reset(self):
            pass

    class Src:
        def acquire(self, *a):
            return None

    pipeline._AUTO_DEPTH_MEMO.clear()
    try:
        kw = dict(L=1, K=8, crop_shape=(61, 61), margin=(30, 30), spec=spec, mode="predict",
                  depth="auto", source=Src(), sink=None, timer=Timer())
        p = pipeline.SpeculativePipeline(engine=Eng(), **kw)
        p.run(np.array([[50, 50]]), 10)
        assert pipeline._AUTO_DEPTH_MEMO[p._memo_key] == (1, pipeline.AUTO_DEPTH_MAX)
        pipeline._AUTO_DEPTH_MEMO[p._memo_key] = (5, 6)
        monkeypatch.setenv("PAWS_DISPATCH_GROUP", "2")
        p2 = pipeline.SpeculativePipeline(engine=Eng(), **kw)
        assert (p2.depth_cur, p2._depth_soft_cap) == (5, 6)
        p2.run(np.array([[50, 50]]), 10)
        assert pipeline._AUTO_DEPTH_MEMO[p._memo_key] == (5, 6)
    finally:
        pipeline._AUTO_DEPTH_MEMO.clear()
