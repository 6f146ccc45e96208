"""The port's host work on the ROI path against the JAX package and the code
it replaced: the per-call timestamp grid, the mode of frame 1, the chunk
crops, and the segmented scan staged once over an engine's buffers.

- The grid: ``ts`` of ``track``, ``track_batch`` (uneven lengths, a video
  ending early), ``track_multi`` and ``track_resumable`` equal the JAX
  package's bit for bit (``np.array_equal``), at n = 1, k = n, k < n, the
  default 24-hour stop and a non-zero start; :func:`grid_prefix` equals
  ``np.linspace(...)[:k]`` on random grids.
- The mode: ``mode_u8_host`` equals the JAX package's on random frames and on
  frames whose 2-4 tied modes C order and column-major order rank apart.
- The crops: the chunk crop equals the JAX package's ``_crop_with_fill`` a
  frame at a time at every edge and corner of the frame and wholly outside
  it, for K = 1 and 12 and both 1080p crop sizes; the card's cropper is the
  native one, which raises when it cannot build.
- The checks: bad arguments to the public segmented wrappers raise their
  ``ValueError`` as before; a :class:`StagedScan` checks its buffers once,
  when made, and its runs equal the plain segmented scans on the same views,
  as an engine's device slot lays them out.
"""

import numpy as np
import pytest
import torch

import pawsometracker_tpu as ref
import pawsometracker_tpu.pipeline as ref_pipeline
import pawsometracker_tpu_torch as port
from pawsometracker_tpu.batch import track_batch as ref_track_batch
from pawsometracker_tpu.checkpoint import track_resumable as ref_track_resumable
from pawsometracker_tpu.multi import track_multi as ref_track_multi
from pawsometracker_tpu.ops.filters import mode_u8_host as ref_mode_u8_host
from pawsometracker_tpu_torch import pipeline
from pawsometracker_tpu_torch.api import DEFAULT_MAX_DURATION_SECONDS, grid_prefix
from pawsometracker_tpu_torch.models.dog_tracker import make_spec, tracker_fns
from pawsometracker_tpu_torch.ops import roi_crop
from pawsometracker_tpu_torch.ops import tracker_kernel as tk
from pawsometracker_tpu_torch.ops.filters import mode_u8_host

H, W = 48, 64
KW = dict(fps=24, target_width=6, window_size=15)


def disc_clip(n, start=(20, 20), step=(1, 1), bg=128):
    """A dark anisotropic blob moving ``step`` a frame from ``start`` (a
    fraction of a pixel off the grid, so that no two windows tie) on ``bg``,
    ``n`` frames of H x W."""
    yy, xx = np.mgrid[:H, :W]
    frames = np.empty((n, H, W), np.uint8)
    for t in range(n):
        i, j = start[0] + step[0] * t + 0.3, start[1] + step[1] * t + 0.2
        blob = np.exp(-((yy - i) ** 2 / 8.0 + (xx - j) ** 2 / 5.0))
        frames[t] = np.round(bg - 90 * blob)
    return frames


# ---- the timestamp grid ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_grid_prefix_equals_linspace(seed):
    """Random grids (start, stop, fps) and prefixes k = 1, n/2, n - 1, n: the
    prefix equals ``np.linspace(start, stop, n)[:k]`` bit for bit, the
    24-hour default stop and n = 1 included."""
    rng = np.random.default_rng(seed)
    cases = [(0.0, DEFAULT_MAX_DURATION_SECONDS, 24.0), (5.0, 5.0 + 1 / 24, 24.0),
             (0.0, 1 / 30, 30.0)]
    for _ in range(300):
        start = float(rng.choice([0.0, rng.uniform(0, 3600)]))
        cases.append((start, start + float(rng.uniform(0.04, 2000)),
                      float(rng.choice([24, 25, 30, 29.97, 60, rng.uniform(1, 240)]))))
    for start, stop, fps in cases:
        n = int(np.round(fps * (stop - start)))
        if n < 1:
            continue
        for k in {1, max(n // 2, 1), max(n - 1, 1), n}:
            want = np.linspace(start, stop, n)[:k]
            got = grid_prefix(start, stop, n, k)
            assert got.dtype == want.dtype and np.array_equal(got, want), (start, stop, fps, k)


def test_grid_prefix_past_n_goes_on_by_the_same_rule():
    """Past n the prefix goes on by numpy's rule without the pinned end (the
    grid ``track_resumable`` relabels its slices on)."""
    start, stop, n = 2.0, 3.0, 25
    step = (stop - start) / (n - 1)
    np.testing.assert_array_equal(grid_prefix(start, stop, n, 30), start + step * np.arange(30))
    np.testing.assert_array_equal(grid_prefix(start, stop, 1, 3), [start] * 3)


# (start, stop) of each case on a 12-frame clip: the default 24-hour stop (k < n), a stop
# the clip reaches (k = n, the pinned end), one frame (n = 1), and a non-zero start
GRID_CASES = {"default stop": (None, None), "k = n": (None, 8 / 24), "n = 1": (None, 1 / 24),
              "non-zero start": (2 / 24, None), "start and k = n": (1 / 24, 7 / 24)}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_track_ts_equal_jax(case):
    """``track``'s ``ts`` (and positions) equal the JAX package's bit for bit."""
    start, stop = GRID_CASES[case]
    clip = disc_clip(12)
    kw = dict(KW, start_location=(20, 20), start=start, stop=stop)
    ts, ij = port.track(clip, device="cpu", **kw)
    ts_r, ij_r = ref.track(clip, **kw)
    assert ts.dtype == ts_r.dtype and np.array_equal(ts, ts_r)
    np.testing.assert_array_equal(ij, ij_r)
    if case == "k = n":
        assert ts[-1] == 8 / 24 and len(ts) == 8


@pytest.mark.parametrize("case", ["default stop", "per-video starts and stops"])
def test_track_batch_ts_equal_jax(case):
    """``track_batch`` of videos of uneven lengths, one ending early: each
    video's ``ts`` equal the JAX package's bit for bit."""
    clips = [disc_clip(12), disc_clip(7, start=(25, 30)), disc_clip(10, start=(22, 18))]
    locs = [(20, 20), (30, 25), (18, 22)]
    kw = dict(KW)
    if case != "default stop":
        kw.update(start=[0.0, 1 / 24, 0.0], stop=[12 / 24, None, 6 / 24])
    got = port.track_batch(clips, start_location=locs, device="cpu", **kw)
    want = ref_track_batch(clips, start_location=locs, **kw)
    assert [len(ts) for ts, _ in got] == [len(ts) for ts, _ in want]
    for (ts, ij), (ts_r, ij_r) in zip(got, want):
        assert np.array_equal(ts, ts_r)
        np.testing.assert_array_equal(ij, ij_r)


@pytest.mark.parametrize("case", ["default stop", "k = n", "non-zero start"])
def test_track_multi_ts_equal_jax(case):
    """``track_multi``'s ``ts`` equal the JAX package's bit for bit."""
    start, stop = GRID_CASES[case]
    clip = np.minimum(disc_clip(12), disc_clip(12, start=(30, 45), step=(0, -1)))
    kw = dict(KW, start=0.0 if start is None else start, stop=stop)
    locs = [(20, 20), (45, 30)]
    ts, ij = port.track_multi(clip, locs, device="cpu", **kw)
    ts_r, ij_r = ref_track_multi(clip, locs, **kw)
    assert np.array_equal(ts, ts_r)
    np.testing.assert_array_equal(ij, ij_r)


def test_track_resumable_ts_equal_an_uninterrupted_run(tmp_path):
    """``track_resumable`` in 3-frame slices, interrupted and resumed: its
    ``ts`` equal one uninterrupted ``track()``'s and the JAX package's
    ``track_resumable``'s bit for bit, at the default stop and at a stop the
    clip reaches."""
    clip = disc_clip(12)
    for stop in (None, 10 / 24):
        kw = dict(KW, start_location=(20, 20), stop=stop, checkpoint_every=3 / 24)
        cp = str(tmp_path / f"port{stop}.npz")
        port.track_resumable(clip, checkpoint_path=cp, _max_slices=2, device="cpu", **kw)
        ts, ij = port.track_resumable(clip, checkpoint_path=cp, device="cpu", **kw)
        ts_r, ij_r = ref_track_resumable(clip, checkpoint_path=str(tmp_path / f"jax{stop}.npz"),
                                         **kw)
        ts_1, ij_1 = port.track(clip, stop=stop, start_location=(20, 20), device="cpu", **KW)
        assert np.array_equal(ts, ts_r) and np.array_equal(ts, ts_1)
        np.testing.assert_array_equal(ij, ij_r)
        np.testing.assert_array_equal(ij, ij_1)


# ---- the mode of frame 1 --------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (5, 3), (37, 53), (1080, 1920)])
def test_mode_equals_jax_on_random_frames(shape):
    """Random frames of even and odd sizes, one of them 1080p and near-flat."""
    rng = np.random.default_rng(shape[0])
    frames = [rng.integers(0, 256, shape, dtype=np.uint8),
              np.where(rng.random(shape) < 0.9, 128, rng.integers(0, 256, shape)).astype(np.uint8)]
    for x in frames:
        assert mode_u8_host(x) == ref_mode_u8_host(x)


def tied_frame(rng, shape, m):
    """A frame whose ``m`` most common values tie, each on cells drawn at
    random, the rest of the frame distinct enough to stay below them; drawn
    again until C order and column-major order pick different winners."""
    while True:
        n = shape[0] * shape[1]
        c = n // (m + 4)
        vals = rng.choice(256, m, replace=False)
        rest = np.setdiff1d(np.arange(256), vals)
        flat = np.concatenate([np.repeat(vals, c), rng.choice(rest, n - m * c)])
        counts = np.bincount(flat, minlength=256)
        if counts[rest].max() >= c:
            continue
        frame = rng.permutation(flat).astype(np.uint8).reshape(shape)

        def winner(scan):  # the value whose c-th occurrence comes first in ``scan``
            return min(vals, key=lambda v: np.flatnonzero(scan == v)[c - 1])

        if winner(frame.ravel()) != winner(frame.ravel(order="F")):
            return frame


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("shape", [(6, 9), (31, 17), (120, 160)])
def test_mode_equals_jax_on_tied_frames(m, shape):
    """2-4 tied modes placed so that C order and column-major order rank them
    apart: the column-major winner (StatsBase's), as the JAX package's."""
    rng = np.random.default_rng(m * 1000 + shape[0])
    for _ in range(3):
        x = tied_frame(rng, shape, m)
        assert mode_u8_host(x) == ref_mode_u8_host(x)


# ---- the crops ------------------------------------------------------------------------


#: crop origins at every edge and corner of a 1080p frame, and wholly outside it
ORIGINS = {"inside": (400, 700), "top": (-60, 700), "bottom": (1000, 700), "left": (400, -90),
           "right": (400, 1850), "top-left": (-30, -40), "top-right": (-30, 1800),
           "bottom-left": (990, -12), "bottom-right": (1020, 1890), "above": (-600, 900),
           "right of": (300, 2500), "below-left": (1200, -700)}


@pytest.fixture(scope="module")
def frames_1080p():
    return np.random.default_rng(7).integers(0, 256, (14, 1080, 1920), dtype=np.uint8)


@pytest.mark.parametrize("crop", [185, 461])
@pytest.mark.parametrize("K", [1, 12])
def test_chunk_crop_equals_jax_crop(frames_1080p, crop, K):
    """Every lane of a chunk, one a named origin (moving a pixel a frame), with
    its own fill and frame count (none, short, full): each real frame equals
    the JAX package's ``_crop_with_fill``, the rest repeat the last crop, and
    a lane with none holds its fill."""
    names = list(ORIGINS)
    L = len(names)
    origins = np.array([[np.add(ORIGINS[n], (i, -i)) for i in range(K)] for n in names])
    fills = np.arange(L, dtype=np.uint8) * 20 + 5
    counts = [K if b % 3 else b % (K + 1) for b in range(L)]
    chunks = [frames_1080p[b % 2:] for b in range(L)]
    out = np.full((L, K, crop, crop), 3, np.uint8)
    roi_crop.crop_lanes_plain(chunks, counts, origins, fills, out)
    for b, k in enumerate(counts):
        if k == 0:
            assert (out[b] == fills[b]).all()
            continue
        for i in range(K):
            want = ref_pipeline._crop_with_fill(chunks[b][min(i, k - 1)],
                                                origins[b][min(i, k - 1)], crop, crop,
                                                int(fills[b]))
            np.testing.assert_array_equal(out[b, i], want, err_msg=f"{names[b]} frame {i}")


@pytest.mark.parametrize("where", list(ORIGINS))
def test_crop_with_fill_equals_jax(frames_1080p, where):
    """One frame at each named origin, both crop sizes and a non-square one,
    into a fresh array and into a dirty buffer."""
    for ch, cw in ((185, 185), (461, 461), (33, 700)):
        want = ref_pipeline._crop_with_fill(frames_1080p[0], ORIGINS[where], ch, cw, 77)
        np.testing.assert_array_equal(
            roi_crop.crop_with_fill(frames_1080p[0], ORIGINS[where], ch, cw, 77), want)
        dirty = np.full((ch, cw), 201, np.uint8)
        roi_crop.crop_with_fill(frames_1080p[0], ORIGINS[where], ch, cw, 77, out=dirty)
        np.testing.assert_array_equal(dirty, want)


def test_lane_cropper_is_native_on_the_card_and_raises_without_it(monkeypatch):
    """The CPU takes the numpy crop; a card takes the native one, and a native
    library that does not build raises there instead of handing over."""
    assert roi_crop.lane_cropper(torch.device("cpu")) is roi_crop.crop_lanes_plain

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(roi_crop, "_lib", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        roi_crop.lane_cropper(torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="nvcc"):
        roi_crop.crop_lanes_native([np.zeros((1, 8, 8), np.uint8)], [1], np.zeros((1, 1, 2)),
                                   [0], np.zeros((1, 1, 4, 4), np.uint8))


# ---- the checks: the public wrappers, and the staged scan checked once ---------------


SPEC = make_spec((41, 41), (15, 15), 6, True)
SKW = dict(radii=SPEC.radii, sigma=SPEC.sigma, darker_target=True)


def seg_inputs(S=3, B=2, K=4):
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(np.stack([disc_clip(K, start=(20 + 2 * b, 20 + s))[:, :41, :41]
                                        for s in range(S) for b in range(B)])
                              .reshape(S, B, K, 41, 41))
    box = {"deltas": torch.from_numpy(rng.integers(-2, 3, (S, B, K, 2)).astype(np.int32)),
           "lo": torch.zeros((S, B, K, 2), dtype=torch.int32),
           "hi": torch.full((S, B, K, 2), 40, dtype=torch.int32),
           "ks": torch.tensor([[K, 2], [K, 0], [3, K]][:S], dtype=torch.int32),
           "origin0": torch.zeros((S, B, 2), dtype=torch.int32),
           "origin_last": torch.ones((S, B, 2), dtype=torch.int32)}
    return frames, box


@pytest.mark.parametrize("bad,match", [
    ("frames float", "frames must be uint8"), ("deltas short", "deltas must have shape"),
    ("ks lanes", "ks must have shape"), ("carry without origins", "a carry needs"),
    ("fills", "fills must have shape"), ("lo alone", "given together")])
def test_public_segment_wrappers_keep_their_checks(bad, match):
    """Bad arguments through the public segmented wrapper raise the same
    ``ValueError`` as before the engines' staged scans."""
    frames, box = seg_inputs()
    fills = torch.tensor([128, 100], dtype=torch.uint8)
    carry = torch.zeros((2, 2), dtype=torch.int32)
    kw = dict(box, carry=carry)
    if bad == "frames float":
        frames = frames.float()
    elif bad == "deltas short":
        kw["deltas"] = box["deltas"][:, :, :2]
    elif bad == "ks lanes":
        kw["ks"] = box["ks"][:, :1]
    elif bad == "carry without origins":
        kw["origin0"] = None
    elif bad == "fills":
        fills = fills[:1]
    elif bad == "lo alone":
        kw["deltas"] = kw["hi"] = None
    with pytest.raises(ValueError, match=match):
        tk.dog_scan_batch_segments(frames, None, fills, **SKW, **kw)


def test_staged_scan_checks_its_buffers_once():
    """A staged scan whose shapes the wrapper refuses, or whose arguments do
    not share one segment stride, raises when it is made; a run past the
    buffers' room (an engine's device slot holds one chunk) raises."""
    frames, box = seg_inputs()
    fills = torch.tensor([128, 100], dtype=torch.uint8)
    fns = tracker_fns(SPEC, "cpu")
    stage = fns.scan_bounded_batch_super.stage
    with pytest.raises(ValueError, match="deltas must have shape"):
        stage(frames, fills, box["deltas"][:, :1], box["lo"], box["hi"], box["ks"],
              box["origin0"], box["origin_last"])
    with pytest.raises(ValueError, match="one segment stride"):
        stage(frames, fills, box["deltas"], box["lo"], box["hi"], box["ks"], box["origin0"],
              box["origin_last"])
    eng = pipeline._BatchedEngine(None, (41, 41), (200, 200), [128, 100], False, None,
                                  torch.device("cpu"), segments=fns.scan_bounded_batch_super)
    staged = eng._new_group(4).staged[0]
    with pytest.raises(ValueError, match=r"S must lie in \[1, 1\]"):
        staged.run(2, carry=torch.zeros((2, 2), dtype=torch.int32),
                   carry_out=torch.zeros((2, 2), dtype=torch.int32))


@pytest.mark.parametrize("cap", [1, 3])
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("kind", ["single", "batched"])
def test_engine_group_staged_scan_equals_plain(kind, subpixel, cap):
    """``cap`` chunks in one buffer a row a chunk, laid out as a ROI engine's
    device slot (crops, then the int32 arguments): with ``cap`` 1 the
    engine's own slot made on the CPU, else a ``[cap, row]`` buffer and its
    staged scan made at the kernel layer. The staged scan, run for every S up
    to the buffer's room, equals the plain segmented scans on the same views,
    and the views read back what a row holds where the slot's layout put it."""
    K, crop = 4, 41
    fns = tracker_fns(SPEC, "cpu")
    cpu = torch.device("cpu")
    if kind == "single":
        eng = pipeline._SingleEngine(fns.scan_bounded, (crop, crop), (200, 200), 128, subpixel,
                                     None, cpu, segments=fns.scan_bounded_super)
    else:
        eng = pipeline._BatchedEngine(None, (crop, crop), (200, 200), [128, 100], subpixel, None,
                                      cpu, segments=fns.scan_bounded_batch_super)
    L = eng.lanes[0]
    n_args = eng._n_args(L, K)
    if cap == 1:
        group = eng._new_group(K)
        rows, views = [group.rows[0]], group.frames[0]
        staged, start = group.staged[0], group.starts[0]
    else:
        n, at = pipeline._crop_bytes((L, K, crop, crop))
        raw = torch.empty((cap, at + 4 * n_args), dtype=torch.uint8)
        rows, views = list(raw.unbind(0)), raw[:, :n].view(cap, L, K, crop, crop)
        args = raw[:, at:].view(torch.int32)
        if kind == "single":
            a = pipeline._single_args(args, K)
            staged = fns.scan_bounded_super.stage(views[:, 0], 128, a.deltas, a.lo, a.hi, a.ks,
                                                  subpixel=subpixel)
            start = a.start[0]
        else:
            a = pipeline._batch_args(args, L, K)
            staged = fns.scan_bounded_batch_super.stage(views, eng.fills[0], a.deltas, a.lo, a.hi,
                                                        a.ks, a.origin0, a.origin_last,
                                                        subpixel=subpixel)
            start = a.seed[0]
    frames, box = seg_inputs(cap, L, K)
    assert rows[0].numel() == pipeline._crop_bytes((L, K, crop, crop))[1] + 4 * n_args
    for s in range(cap):  # each row as one copy of a slot's buffer would fill it
        n, at = pipeline._crop_bytes((L, K, crop, crop))
        flat = np.zeros(n_args, np.int32)
        a = (pipeline._single_args(flat, K) if kind == "single"
             else pipeline._batch_args(flat, L, K))
        a.deltas[...], a.lo[...], a.hi[...] = (
            (box[k][s, 0] if kind == "single" else box[k][s]).numpy()
            for k in ("deltas", "lo", "hi"))
        a.ks[...] = (box["ks"][s, 0] if kind == "single" else box["ks"][s]).numpy()
        if kind == "single":
            a.start[...] = (20, 20)
        else:
            a.origin0[...] = box["origin0"][s].numpy()
            a.origin_last[...] = box["origin_last"][s].numpy()
            a.seed[...] = [(20, 20), (22, 20)]
        row = np.zeros(rows[s].numel(), np.uint8)
        row[:n] = frames[s].numpy().reshape(-1)
        row[at:] = flat.view(np.uint8)
        rows[s].copy_(torch.from_numpy(row))
    np.testing.assert_array_equal(views.numpy(), frames.numpy())
    for S in range(1, cap + 1):
        if kind == "single":
            got = staged.run(S, pos0=start)
            want = tk.dog_scan_segments_plain(frames[:S, 0], torch.tensor([20, 20]), 128,
                                              deltas=box["deltas"][:S, 0], lo=box["lo"][:S, 0],
                                              hi=box["hi"][:S, 0],
                                              ks=None if S == 1 else box["ks"][:S, 0],
                                              subpixel=subpixel, **SKW)
        else:
            np.testing.assert_array_equal(start.numpy(), [(20, 20), (22, 20)])
            carry = start.clone()
            got = staged.run(S, carry=start, carry_out=carry)
            want, want_carry = tk.dog_scan_batch_segments_plain(
                frames[:S], None, torch.tensor([128, 100], dtype=torch.uint8),
                carry=torch.tensor([(20, 20), (22, 20)], dtype=torch.int32),
                **{k: v[:S] for k, v in box.items()}, subpixel=subpixel, **SKW)
            np.testing.assert_array_equal(carry.numpy(), want_carry.numpy())
        for g, w in zip(*((got, want) if subpixel else ((got,), (want,)))):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
