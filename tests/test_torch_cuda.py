"""Card-only tests of the port's CUDA kernel: each is marked ``cuda`` and skips
itself without a card. This file imports no JAX, so it runs on a machine
with the card and without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import json
import logging

import numpy as np
import pytest
import torch

from pawsometracker_tpu_torch import IJ, track
from pawsometracker_tpu_torch.models.dog_tracker import make_spec, tracker_fns
from pawsometracker_tpu_torch.ops import tracker_kernel as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def ellipse_frames(h, w, path, ry=5, rx=4):
    """Dark anisotropic blobs on 128-gray along ``path``."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.full((len(path), h, w), 128, np.uint8)
    for t, (i, j) in enumerate(path):
        frames[t][((yy - i) / ry) ** 2 + ((xx - j) / rx) ** 2 <= 1.0] = 0
    return frames


def check(card, frames, p0, spec_radii, sigma, subpixel=False, bounds=None, fill=128,
          kernel=None):
    """One chain through the kernel equals the plain version bit for bit;
    ``kernel`` names the kernel the launch must take. ``frames`` is a numpy
    array or a card tensor."""
    kw = dict(radii=spec_radii, sigma=sigma, darker_target=True)
    fr = frames if torch.is_tensor(frames) else torch.from_numpy(frames).to(card)
    pos0 = torch.tensor(p0, dtype=torch.int32, device=card)
    b = {} if bounds is None else {k: torch.from_numpy(v.astype(np.int32)).to(card)
                                   for k, v in bounds.items()}
    before, before_k = tk.launches, tk.launches_by_kernel[kernel]
    got = tk.dog_scan(fr, pos0, fill, subpixel=subpixel, **kw, **b)
    assert tk.launches == before + 1
    if kernel is not None:
        assert tk.launches_by_kernel[kernel] == before_k + 1
    want = tk.dog_scan_plain(fr, pos0, fill, subpixel=subpixel, **kw, **b)
    torch.cuda.synchronize()
    if subpixel:
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])  # same arithmetic: bit for bit
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("cfg", ["unbounded", "bounded", "bounded+subpixel", "unbounded+subpixel"])
def test_kernel_equals_plain(card, cfg):
    h, w, T = 120, 150, 24
    path = [(40 + t, 50 + 2 * t) for t in range(T)]
    spec = make_spec((h, w), 21, 10, True)
    rng = np.random.default_rng(0)
    bounds = None
    if cfg.startswith("bounded"):
        bounds = {"deltas": rng.integers(-2, 3, (T, 2)), "lo": rng.integers(0, 6, (T, 2)),
                  "hi": np.array([h - 1, w - 1]) - rng.integers(0, 6, (T, 2))}
    check(card, ellipse_frames(h, w, path), path[0], spec.radii, spec.sigma,
          subpixel=cfg.endswith("subpixel"), bounds=bounds)


@pytest.mark.parametrize("window", [(151, 301), (65, 129), (1, 1), (3, 200)])
def test_tiled_windows_equal_plain(card, monkeypatch, window):
    """Windows that do not fit one CTA whole (151x301, 65x129) take
    dog_scan_tiled by the shape rule (one cluster a lane); the others take
    dog_scan, which also runs 65x129 over a cluster of its CTAs. On every
    kernel that takes the window (the shape rule's, then the other in its
    place) a 6-step chain equals the plain version."""
    h, w, T = 200, 360, 6
    spec = make_spec((h, w), window, 10, True)
    kernels = tk.kernels_for(spec.radii, spec.kernel_len, tk._smem_limit(0))
    assert (kernels[0] == "dog_scan_tiled") == (window in ((151, 301), (65, 129)))
    assert ("dog_scan" in kernels) == (window != (151, 301))
    frames = ellipse_frames(h, w, [(90 + 2 * t, 170 - 3 * t) for t in range(T)])
    for kernel in kernels:
        if kernel != kernels[0]:
            monkeypatch.setattr(tk, "kernel_for", lambda radii, L, limit: kernel)
        check(card, frames, (100, 180), spec.radii, spec.sigma, kernel=kernel)
        check(card, frames, (100, 180), spec.radii, spec.sigma, subpixel=True, kernel=kernel)


# ---- dog_scan_tiled: one thread-block cluster a lane ----------------------------


@pytest.fixture
def tiled(card, monkeypatch):
    """Send every launch to dog_scan_tiled, whatever the window, so that small
    windows (and a cheap plain version) exercise its tiles and clusters."""
    monkeypatch.setattr(tk, "kernel_for", lambda radii, L, limit: "dog_scan_tiled")
    monkeypatch.setattr(tk, "tiled_cluster", None)
    return card


def random_bounds(rng, shape, h, w):
    return {"deltas": rng.integers(-3, 4, shape), "lo": rng.integers(0, 8, shape),
            "hi": np.array([h - 1, w - 1]) - rng.integers(0, 8, shape)}


TILED_CFGS = ["unbounded", "bounded", "bounded+subpixel", "unbounded+subpixel"]


@pytest.mark.parametrize("cfg", TILED_CFGS)
@pytest.mark.parametrize("lanes", ["one chain", "4 lanes, own frames", "4 lanes, shared frames"])
def test_tiled_chains_equal_plain(tiled, cfg, lanes):
    """T = 12 chains through dog_scan_tiled in every configuration: a 41x61
    window over 7x63 tiles, 6 tiles over a cluster of 6 CTAs."""
    h, w, T, B = 150, 190, 12, 4
    spec = make_spec((h, w), (41, 61), 10, True)
    plan = tk.tile_plan(spec.radii, spec.kernel_len, tk._smem_limit(0), cfg.endswith("subpixel"))
    assert plan.cluster == 6 and plan.tile == (7, 63)
    rng = np.random.default_rng(7)
    sub = cfg.endswith("subpixel")
    paths = [[(50 + 8 * b + 2 * t, 60 + 10 * b + 3 * t) for t in range(T)] for b in range(B)]
    if lanes == "one chain":
        bounds = random_bounds(rng, (T, 2), h, w) if cfg.startswith("bounded") else None
        check(tiled, ellipse_frames(h, w, paths[0]), paths[0][0], spec.radii, spec.sigma,
              subpixel=sub, bounds=bounds, kernel="dog_scan_tiled")
        return
    bounds = random_bounds(rng, (B, T, 2), h, w) if cfg.startswith("bounded") else None
    if lanes == "4 lanes, own frames":
        frames = np.stack([ellipse_frames(h, w, p) for p in paths])
        frames[2] = np.where(frames[2] == 128, 90, frames[2])  # another background
    else:
        frames = np.minimum.reduce([ellipse_frames(h, w, p) for p in paths])
    starts = [p[0] for p in paths]
    starts[3] = (-20, w + 15)  # a lane starting off the frame
    check_batch(tiled, frames, starts, [128, 128, 90, 128], spec.radii, spec.sigma,
                subpixel=sub, bounds=bounds)


@pytest.mark.parametrize("window,cluster", [((7, 7), None), ((3, 40), None), ((21, 21), 16),
                                            ((21, 21), 8), ((35, 49), 2)])
def test_tiled_one_tile_and_fewer_tiles_than_cluster(tiled, window, cluster, monkeypatch):
    """A window of one tile (a cluster of 1), and clusters larger than the
    tile count (CTAs that own no tile still join every barrier) or smaller
    (CTAs that own several tiles)."""
    h, w, T = 90, 110, 8
    spec = make_spec((h, w), window, 10, True)
    monkeypatch.setattr(tk, "tiled_cluster", cluster)
    plan = tk._tiled_plan(spec.radii, spec.kernel_len, tk._smem_limit(0), True, 0)
    nt = plan.tiles[0] * plan.tiles[1]
    if cluster is None:
        assert nt == 1 and plan.cluster == 1
    else:
        assert plan.cluster == cluster
    path = [(40 + t, 50 - 2 * t) for t in range(T)]
    frames = ellipse_frames(h, w, path)
    check(tiled, frames, path[0], spec.radii, spec.sigma, kernel="dog_scan_tiled")
    check(tiled, frames, path[0], spec.radii, spec.sigma, subpixel=True, kernel="dog_scan_tiled")


def test_tiled_clusters_in_waves(tiled, monkeypatch):
    """More lanes than the clusters of 16 CTAs the card runs at once, so the
    clusters run in waves; lanes read one frame stream, from random starts."""
    h, w, T = 100, 120, 3
    spec = make_spec((h, w), 41, 10, True)
    monkeypatch.setattr(tk, "tiled_cluster", 16)
    plan = tk._tiled_plan(spec.radii, spec.kernel_len, tk._smem_limit(0), False, 0)
    at_once = tk._active_clusters(plan.cluster, plan.smem, 0)
    assert at_once >= 1
    B = at_once + 5
    rng = np.random.default_rng(8)
    frames = ellipse_frames(h, w, [(50 + t, 60 - t) for t in range(T)])
    starts = np.stack([rng.integers(-10, h + 10, B), rng.integers(-10, w + 10, B)], 1)
    check_batch(tiled, frames, starts, rng.integers(0, 256, B), spec.radii, spec.sigma)


@pytest.mark.parametrize("shape", [(90, 201), (120, 1920)])
def test_tiled_unaligned_widths_equal_plain(tiled, shape):
    """A frame width that is not a multiple of 16, and a 16-aligned width read
    at a lane base that is not 16-byte aligned: each patch row is read at its
    own offset."""
    h, w = shape
    T = 5
    path = [(h // 2 + 2 * t, w // 2 - 3 * t) for t in range(T)]
    spec = make_spec((h, w), (29, 45), 10, True)
    frames = ellipse_frames(h, w, path)
    if w % 16 == 0:
        flat = torch.zeros(frames.size + 3, dtype=torch.uint8, device=tiled)
        flat[3:] = torch.from_numpy(frames.reshape(-1)).to(tiled)
        frames = flat[3:].view(T, h, w)
        assert frames.data_ptr() % 16 != 0
    check(tiled, frames, path[0], spec.radii, spec.sigma, kernel="dog_scan_tiled")
    check(tiled, frames, path[0], spec.radii, spec.sigma, subpixel=True, kernel="dog_scan_tiled")


@pytest.mark.parametrize("cluster", [None, 3, 16])
@pytest.mark.parametrize("field", ["flat", "plateaus"])
def test_tiled_ties_across_ctas_equal_plain(tiled, field, cluster, monkeypatch):
    """A flat field (every window cell ties) and integer plateaus (ties within
    and across tiles owned by different CTAs): the cluster's maximum is the
    first in column-major order, as the plain version's."""
    h, w, T = 100, 130, 6
    spec = make_spec((h, w), (35, 49), 10, True)
    monkeypatch.setattr(tk, "tiled_cluster", cluster)
    if field == "flat":
        frames = np.full((T, h, w), 128, np.uint8)
    else:
        rng = np.random.default_rng(9)
        blocks = rng.integers(0, 2, (T, h // 10 + 1, w // 10 + 1)).astype(np.uint8) * 60 + 100
        frames = np.ascontiguousarray(blocks.repeat(10, 1).repeat(10, 2)[:, :h, :w])
    check(tiled, frames, (50, 65), spec.radii, spec.sigma, kernel="dog_scan_tiled")
    check(tiled, frames, (50, 65), spec.radii, spec.sigma, subpixel=True,
          kernel="dog_scan_tiled")
    check_batch(tiled, frames, [(50, 65), (10, 10), (90, 120)], [128, 100, 128], spec.radii,
                spec.sigma)


def test_tiled_launch_that_cannot_run_raises(tiled, monkeypatch):
    """A cluster the kernel does not take raises; nothing runs in its place."""
    spec = make_spec((60, 60), 21, 10, True)
    monkeypatch.setattr(tk, "tiled_cluster", tk.MAX_CLUSTER + 1)
    fr = torch.zeros((2, 60, 60), dtype=torch.uint8, device=tiled)
    before = tk.launches
    with pytest.raises(RuntimeError, match="dog_scan_tiled"):
        tk.dog_scan(fr, torch.tensor([30, 30], dtype=torch.int32, device=tiled), 0,
                    radii=spec.radii, sigma=spec.sigma, darker_target=True)
    assert tk.launches == before


# ---- dog_scan_tiled's step: the first tile's copy, CTAs sized to their passes, the exchange
# by st.async -------------------------------------------------------------------------------


def large_spec(shape):
    """The large target's default window: target_width=60, 105x105, L = 149."""
    from pawsometracker_tpu_torch.ops.dog_kernel import guess_window_size

    return make_spec(shape, guess_window_size(60), 60, True)


CROP_EDGE_STARTS = {
    "top left corner": (0, 0), "top right corner": (0, 460), "bottom left corner": (460, 0),
    "bottom right corner": (460, 460), "top edge": (0, 230), "bottom edge": (460, 230),
    "left edge": (230, 0), "right edge": (230, 460), "off the crop, above left": (-40, -70),
    "off the crop, below right": (500, 520),
}


@pytest.mark.parametrize("where", list(CROP_EDGE_STARTS))
def test_tiled_first_tiles_off_each_edge_equal_plain(card, where):
    """A 461x461 crop at the large target's window (15 CTAs, one 7-row tile
    each): starts on each side and corner
    and off the crop, a disc there, so that every step's first tiles run off
    the crop (the copy's edge path), where cells take the fill; unbounded, and
    bounded+subpixel with random deltas."""
    h = w = 461
    T = 5
    spec = large_spec((h, w))
    plan = tk._tiled_plan(spec.radii, spec.kernel_len, tk._smem_limit(0), True, 0)
    assert tk.kernel_for(spec.radii, spec.kernel_len, tk._smem_limit(0)) == "dog_scan_tiled"
    assert plan.cluster == 15
    p0 = CROP_EDGE_STARTS[where]
    i0, j0 = min(max(p0[0], 0), h - 1), min(max(p0[1], 0), w - 1)
    frames = ellipse_frames(h, w, [(i0, j0)] * T, ry=26, rx=22)
    rng = np.random.default_rng(11)
    bounds = {"deltas": rng.integers(-3, 4, (T, 2)), "lo": np.zeros((T, 2)),
              "hi": np.tile([h - 1, w - 1], (T, 1))}
    check(card, frames, p0, spec.radii, spec.sigma, fill=77, kernel="dog_scan_tiled")
    check(card, frames, p0, spec.radii, spec.sigma, subpixel=True, bounds=bounds, fill=77,
          kernel="dog_scan_tiled")


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("field", ["disc", "flat (ties across CTAs)"])
def test_tiled_forced_clusters_at_the_large_window_equal_plain(card, monkeypatch, cluster, field):
    """The large target's window on its 461x461 crop under forced clusters of
    1, 2, 8 and 16 CTAs (its 15 tiles on one CTA, 8 or 2 a CTA, or one CTA
    owning none), on a disc and on a flat field whose exact ties span the
    CTAs: one chain bounded+subpixel, and 2 lanes, bit for bit."""
    h = w = 461
    T = 4
    spec = large_spec((h, w))
    monkeypatch.setattr(tk, "tiled_cluster", cluster)
    assert tk._tiled_plan(spec.radii, spec.kernel_len, tk._smem_limit(0), True, 0).cluster \
        == cluster
    if field == "disc":
        path = [(230 + 3 * t, 230 - 2 * t) for t in range(T)]
        frames = ellipse_frames(h, w, path, ry=26, rx=22)
    else:
        frames = np.full((T, h, w), 128, np.uint8)
    rng = np.random.default_rng(13)
    check(card, frames, (230, 230), spec.radii, spec.sigma, subpixel=True,
          bounds=random_bounds(rng, (T, 2), h, w), kernel="dog_scan_tiled")
    check_batch(card, frames, [(230, 230), (100, 380)], [128, 90], spec.radii, spec.sigma)


@pytest.mark.parametrize("row", [6, 7, 13, 14, 34, 35])
def test_tiled_subpixel_max_on_tile_boundary_equal_plain(tiled, monkeypatch, row):
    """A disc whose maximum lies on window row 6, 7, 13, 14, 34 or 35 of a
    41x41 window cut in 7-row tiles, so the neighbour above or below is read
    from another CTA's response slot; shades below and beside the disc make
    both offsets nonzero: offsets bit for bit, under the plan's cluster and
    forced clusters of 2 and 16."""
    h, w, T = 130, 130, 3
    spec = make_spec((h, w), 41, 10, True)
    p = (65, 65)
    ci, cj = p[0] - spec.radii[0] + row, p[1] + 3
    frames = ellipse_frames(h, w, [(ci, cj)] * T, ry=4, rx=3)
    frames[:, ci + 5, cj - 2:cj + 3] = 70
    frames[:, ci - 1:ci + 2, cj + 4] = 70
    first, off = tk.dog_scan_plain(torch.from_numpy(frames[:1]).to(tiled),
                                   torch.tensor(p, dtype=torch.int32, device=tiled), 128,
                                   radii=spec.radii, sigma=spec.sigma, darker_target=True,
                                   subpixel=True)
    assert tuple(first[0].tolist()) == (ci, cj) and bool((off[0].abs() > 0.1).all())
    for cluster in (None, 2, 16):
        monkeypatch.setattr(tk, "tiled_cluster", cluster)
        check(tiled, frames, p, spec.radii, spec.sigma, subpixel=True, kernel="dog_scan_tiled")


def test_tiled_batch_fill_only_lane_equal_plain(card):
    """B = 4 on the large target's 461x461 crops, lane 2 pure fill (a video
    past its end, as the batch ROI engine launches it), bounded and
    bounded+subpixel."""
    h = w = 461
    T, B = 4, 4
    spec = large_spec((h, w))
    paths = [[(200 + 20 * b + 3 * t, 260 - 15 * b - 2 * t) for t in range(T)] for b in range(B)]
    frames = np.stack([ellipse_frames(h, w, p, ry=26, rx=22) for p in paths])
    frames[2] = 100
    rng = np.random.default_rng(14)
    for sub in (False, True):
        check_batch(card, frames, [p[0] for p in paths], [128, 128, 100, 128], spec.radii,
                    spec.sigma, subpixel=sub, bounds=random_bounds(rng, (B, T, 2), h, w))


def test_tiled_batched_snap_equal_plain(card):
    """The quarter-frame autodetect snap (271x481 window, L = 65: 39 tiles of
    7x483 over 13 CTAs, three a CTA) on 4 lanes of 1080p frames
    with their own discs and fills, and with subpixel offsets."""
    from pawsometracker_tpu_torch.models.dog_tracker import autodetect_spec

    h, w, B = 1080, 1920, 4
    spec = autodetect_spec(make_spec((h, w), 41, 25, True))
    plan = tk._tiled_plan(spec.radii, spec.kernel_len, tk._smem_limit(0), False, 0)
    assert plan.slots == 3
    frames = np.stack([ellipse_frames(h, w, [(400 + 80 * b, 700 + 150 * b)], ry=12, rx=12)
                       for b in range(B)])
    frames[1] = np.where(frames[1] == 128, 100, frames[1])
    centre = [(h // 2 - 1, w // 2 - 1)] * B
    check_batch(card, frames, centre, [128, 100, 128, 128], spec.radii, spec.sigma)
    check_batch(card, frames, centre, [128, 100, 128, 128], spec.radii, spec.sigma,
                subpixel=True)


@pytest.mark.parametrize("shape", [(1080, 1918), (360, 641), "lane base + 5"])
def test_tiled_large_window_unaligned_frames_equal_plain(card, shape):
    """Frames 1918 and 641 wide, and 480-wide frames at a base 5 bytes past a
    16-byte boundary (each patch row read at its own offset, the per-row
    variant), at the large target's window: unbounded+subpixel and bounded,
    a disc moving."""
    h, w = (200, 480) if shape == "lane base + 5" else shape
    T = 4
    spec = large_spec((h, w))
    path = [(h // 2 + 3 * t, w // 2 - 2 * t) for t in range(T)]
    frames = ellipse_frames(h, w, path, ry=26, rx=22)
    if shape == "lane base + 5":
        flat = torch.zeros(frames.size + 5, dtype=torch.uint8, device=card)
        flat[5:] = torch.from_numpy(frames.reshape(-1)).to(card)
        frames = flat[5:].view(T, h, w)
        assert frames.data_ptr() % 16 != 0
    rng = np.random.default_rng(15)
    check(card, frames, path[0], spec.radii, spec.sigma, subpixel=True, kernel="dog_scan_tiled")
    check(card, frames, path[0], spec.radii, spec.sigma, bounds=random_bounds(rng, (T, 2), h, w),
          kernel="dog_scan_tiled")


@pytest.mark.parametrize("carry", [False, True])
def test_tiled_segments_rebase_equal_plain(card, carry):
    """Segments at the large window on 461x461 crops, S = 3 of T = 4: the ks
    rule with a short segment (the next start one the chain holds) and a
    segment of one step, or 2 lanes with the absolute carry and origins that
    jump up to 90 px between segments, so each segment's first patch lies
    across the rebase; bounded+subpixel, bit for bit, one launch each."""
    h = w = 461
    S, T, B = 3, 4, 2
    spec = large_spec((h, w))
    rng = np.random.default_rng(16)
    paths = [[(230 + 2 * t, 200 + 40 * b + 3 * t) for t in range(S * T)] for b in range(B)]
    frames = np.stack([ellipse_frames(h, w, p, ry=26, rx=22) for p in paths])
    frames = np.ascontiguousarray(np.moveaxis(frames.reshape(B, S, T, h, w), 0, 1))
    fr = torch.from_numpy(frames).to(card)
    box = {k: torch.from_numpy(v.astype(np.int32)).to(card)
           for k, v in random_bounds(rng, (S, B, T, 2), h, w).items()}
    ks = torch.tensor([[T, T], [2, 3], [1, T]], dtype=torch.int32, device=card)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True, subpixel=True)
    before = tk.launches_by_kernel["dog_scan_tiled"]
    if carry:
        origin0 = torch.from_numpy(rng.integers(-90, 91, (S, B, 2)).astype(np.int32)).to(card)
        origin_last = torch.from_numpy(rng.integers(-90, 91, (S, B, 2)).astype(np.int32)).to(
            card)
        c = torch.tensor([[230, 200], [230, 240]], dtype=torch.int32, device=card) + origin0[0]
        fills = torch.tensor([128, 90], dtype=torch.uint8, device=card)
        seg = dict(ks=ks, origin0=origin0, origin_last=origin_last, **box, **kw)
        got, got_c = tk.dog_scan_batch_segments(fr, None, fills, carry=c, **seg)
        want, want_c = tk.dog_scan_batch_segments_plain(fr, None, fills, carry=c, **seg)
        assert torch.equal(got_c, want_c)
    else:
        one = {k: v[:, 0].contiguous() for k, v in box.items()}
        p0 = torch.tensor([230, 200], dtype=torch.int32, device=card)
        got = tk.dog_scan_segments(fr[:, 0], p0, 128, ks=ks[:, 0].contiguous(), **one, **kw)
        want = tk.dog_scan_segments_plain(fr[:, 0], p0, 128, ks=ks[:, 0].contiguous(), **one,
                                          **kw)
    torch.cuda.synchronize()
    _assert_same_out(got, want, True)
    assert tk.launches_by_kernel["dog_scan_tiled"] == before + 1


def test_flat_field_ties(card):
    spec = make_spec((90, 90), 21, 10, True)
    frames = np.full((12, 90, 90), 128, np.uint8)
    check(card, frames, (45, 45), spec.radii, spec.sigma)


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    spec = make_spec((40, 40), 9, 6, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True)
    fr = torch.zeros((3, 40, 40), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="int32"):
        tk.dog_scan(fr, torch.tensor([5, 5], device=card), 0, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tk.dog_scan(fr, torch.tensor([[5, 5], [5, 5]], dtype=torch.int32, device=card)[:, 0],
                    0, **kw)
    with pytest.raises(ValueError, match="pos0 is on"):
        tk.dog_scan(fr, torch.tensor([5, 5], dtype=torch.int32), 0, **kw)


def test_track_on_card_equals_cpu(card):
    h, w, n = 100, 100, 80
    path = [(50 + round(20 * np.sin(t / 12)), 50 + round(20 * np.cos(t / 12)) - 20)
            for t in range(n)]
    frames = ellipse_frames(h, w, path)
    kw = dict(fps=24, target_width=10, start_location=IJ(*path[0]), chunk_size=16)
    tk.reset_launches()
    ts, ij = track(frames, **kw)
    assert tk.launches == 1 + -(-(n - 1) // 16)
    ts_c, ij_c = track(frames, **kw, device="cpu")
    np.testing.assert_array_equal(ts, ts_c)
    np.testing.assert_array_equal(ij, ij_c)
    ts_s, ij_s = track(frames, **kw, subpixel=True)
    np.testing.assert_array_equal(ij_s, track(frames, **kw, subpixel=True, device="cpu")[1])


def check_batch(card, frames, p0, fills, spec_radii, sigma, subpixel=False, bounds=None):
    """The batched launch equals the loop over lanes of the plain version."""
    kw = dict(radii=spec_radii, sigma=sigma, darker_target=True)
    fr = torch.from_numpy(frames).to(card)
    pos0 = torch.tensor(p0, dtype=torch.int32, device=card)
    fl = torch.tensor(fills, dtype=torch.uint8, device=card)
    b = {} if bounds is None else {k: torch.from_numpy(v.astype(np.int32)).to(card)
                                   for k, v in bounds.items()}
    before = tk.launches
    got = tk.dog_scan_batch(fr, pos0, fl, subpixel=subpixel, **kw, **b)
    assert tk.launches == before + 1
    want = tk.dog_scan_batch_plain(fr, pos0, fl, subpixel=subpixel, **kw, **b)
    torch.cuda.synchronize()
    if subpixel:
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("cfg", ["unbounded", "bounded", "bounded+subpixel", "unbounded+subpixel"])
def test_batched_kernel_equals_plain(card, cfg):
    h, w, T, B = 100, 130, 16, 3
    paths = [[(30 + 10 * b + t, 40 + 2 * t + 5 * b) for t in range(T)] for b in range(B)]
    frames = np.stack([ellipse_frames(h, w, p) for p in paths])
    frames[1] = np.where(frames[1] == 128, 90, frames[1])  # another background per lane
    spec = make_spec((h, w), 21, 10, True)
    rng = np.random.default_rng(1)
    bounds = None
    if cfg.startswith("bounded"):
        bounds = {"deltas": rng.integers(-2, 3, (B, T, 2)), "lo": rng.integers(0, 6, (B, T, 2)),
                  "hi": np.array([h - 1, w - 1]) - rng.integers(0, 6, (B, T, 2))}
    check_batch(card, frames, [p[0] for p in paths], [128, 90, 128], spec.radii, spec.sigma,
                subpixel=cfg.endswith("subpixel"), bounds=bounds)


def test_shared_frames_kernel_equals_plain(card):
    """Lanes that read one frame stream (lane stride 0): N targets of one video."""
    h, w, T = 120, 150, 16
    paths = [[(30 + t, 30 + t) for t in range(T)], [(80, 100 - t) for t in range(T)]]
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.full((T, h, w), 128, np.uint8)
    for p in paths:
        for t, (i, j) in enumerate(p):
            frames[t][((yy - i) / 5) ** 2 + ((xx - j) / 4) ** 2 <= 1.0] = 0
    spec = make_spec((h, w), 21, 10, True)
    starts = [p[0] for p in paths] + [(60, 75)]
    check_batch(card, frames, starts, [128, 128, 128], spec.radii, spec.sigma)
    check_batch(card, frames, starts, [128, 128, 128], spec.radii, spec.sigma, subpixel=True)


def test_one_lane_batch_equals_unbatched(card):
    h, w, T = 90, 110, 12
    path = [(40 + t, 50 - t) for t in range(T)]
    spec = make_spec((h, w), 21, 10, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True)
    fr = torch.from_numpy(ellipse_frames(h, w, path)).to(card)
    p0 = torch.tensor(path[0], dtype=torch.int32, device=card)
    one = tk.dog_scan(fr, p0, 128, **kw)
    batched = tk.dog_scan_batch(fr[None], p0[None], torch.tensor([128], dtype=torch.uint8,
                                                                  device=card), **kw)
    assert torch.equal(batched[0], one)


def test_track_batch_and_multi_on_card_equal_cpu(card):
    from pawsometracker_tpu_torch import track_batch, track_multi

    h, w, n = 100, 100, 50
    clips = [ellipse_frames(h, w, [(50 + round(15 * np.sin(t / 9 + b)),
                                     50 + round(15 * np.cos(t / 9 + b))) for t in range(n - 8 * b)])
             for b in range(3)]
    kw = dict(fps=24, target_width=10, chunk_size=16, start_location=[IJ(50, 65), None,
                                                                      IJ(64, 44)])
    tk.reset_launches()
    got = track_batch(clips, **kw)
    assert tk.launches == 2 + -(-(n - 1) // 16)  # both snaps (one lane auto), then the scans
    want = track_batch(clips, **kw, device="cpu")
    for (ts, ij), (ts_c, ij_c) in zip(got, want):
        np.testing.assert_array_equal(ts, ts_c)
        np.testing.assert_array_equal(ij, ij_c)
    got = track_batch(clips, **kw, subpixel=True)
    want = track_batch(clips, **kw, subpixel=True, device="cpu")
    for (_, ij), (_, ij_c) in zip(got, want):
        np.testing.assert_array_equal(ij, ij_c)
    two = np.minimum(clips[0][:len(clips[2])], clips[2])  # lanes 0 and 2 in one video
    mk = dict(fps=24, target_width=10, chunk_size=16)
    locs = [IJ(50, 65), IJ(64, 44)]
    for extra in ({}, {"subpixel": True}):
        ts, pos = track_multi(two, locs, **mk, **extra)
        ts_c, pos_c = track_multi(two, locs, **mk, **extra, device="cpu")
        np.testing.assert_array_equal(ts, ts_c)
        np.testing.assert_array_equal(pos, pos_c)


def test_frame_response_card_equals_cpu(card):
    """The whole-frame DoG response (direct taps, a multiply and a separate
    add each) gives the same bits on the card and the CPU, so the detectors
    pick the same peaks, ties included."""
    from pawsometracker_tpu_torch.parallel.mesh import _batch_frame_response, global_detect_peaks

    spec = make_spec((120, 150), 21, 10, True)
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, size=(2, 120, 150)).astype(np.uint8)
    response = _batch_frame_response(spec)
    got = response(torch.from_numpy(frames).to(card), [128, 90])
    want = response(torch.from_numpy(frames), [128, 90])
    assert torch.equal(got.cpu(), want)
    peaks = global_detect_peaks(spec, 3)
    assert torch.equal(peaks(torch.from_numpy(frames[0]).to(card), 128).cpu(),
                       peaks(torch.from_numpy(frames[0]), 128))


def syncs_in(fn):
    """``fn()``'s result and the host synchronisations that it made, as
    PyTorch's sync debug mode reports them."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in seen)


def test_detection_rounds_read_nothing_back(card):
    """The rounds of suppression stay on the card: detecting 24 peaks makes as
    few host synchronisations as detecting 2, and the peaks, exhausted rounds
    included, are the CPU's."""
    from pawsometracker_tpu_torch.parallel.mesh import global_detect_peaks

    spec = make_spec((240, 360), 21, 10, True)
    frame = np.full((240, 360), 128, np.uint8)
    for r in range(4):
        for c in range(6):
            frame[30 + 60 * r:36 + 60 * r, 30 + 60 * c:36 + 60 * c] = 20
    on_card = torch.from_numpy(frame).to(card)
    counts = {}
    for n in (2, 24, 400):
        peaks = global_detect_peaks(spec, n)
        peaks(on_card, 128)  # warm: the first launches may load modules
        got, counts[n] = syncs_in(lambda: peaks(on_card, 128))
        assert torch.equal(got.cpu(), peaks(torch.from_numpy(frame), 128))
    assert counts[24] == counts[2] and counts[400] == counts[2], counts


# ---- csrc/detect.cu: the whole-frame response and the rounds of suppression ----------


def detect_case(card, h, w, target_width, seed=4):
    """Random uint8 frames ``[2, h, w]`` with two dark squares, their spec's
    sigma and L, and the frames on the card."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(2, h, w)).astype(np.uint8)
    frames[:, 5:17, 9:21] = 0
    spec = make_spec((h, w), 21, target_width, True)
    return spec, frames, torch.from_numpy(frames).to(card)


def column_partials(resp, rows=32):
    """``[P, W]`` values and first rows of each column's maximum over each
    32-row tile of ``resp [H, W]``, as the response kernel writes them."""
    H = resp.shape[0]
    tiles = [resp[r:r + rows] for r in range(0, H, rows)]
    vals = torch.stack([t.max(dim=0).values for t in tiles])
    first = torch.stack([torch.argmax((t == t.max(dim=0).values).to(torch.uint8), dim=0) + r
                         for t, r in zip(tiles, range(0, H, rows))])
    return vals, first.to(torch.int32)


@pytest.mark.parametrize("target_width,L", [(12, 33), (25, 65), (60, 149)])
@pytest.mark.parametrize("shape", [(75, 203), (64, 128), (33, 7)])
def test_detect_response_equals_plain(card, target_width, L, shape):
    """The response kernel gives the plain version's bits at L = 33, 65 and
    149, on frames whose sizes are and are not multiples of the tile: from
    uint8 frames on their fills (the pad fused in), from padded float32 slabs,
    and from a slab that is a row range of a larger one. Its partials are each
    column's maximum over each 32-row tile and the first row holding it."""
    from pawsometracker_tpu_torch.ops import detect_kernel as dk

    spec, frames, dev_frames = detect_case(card, *shape, target_width)
    assert spec.kernel_len == L
    sig, fills = spec.sigma, [128, 90]
    want = dk.correlate_plain(dk.pad_plain(dev_frames, fills, L), sig, True)
    before = dk.launches
    got, part = dk.frame_response(dev_frames, fills, sig, True)
    assert dk.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), dk.correlate_plain(dk.pad_plain(torch.from_numpy(frames),
                                                                  fills, L), sig, True))
    vals, first = column_partials(want[0])
    assert torch.equal(part[0, ..., 0], vals)
    assert torch.equal(part[0, ..., 1].contiguous().view(torch.int32), first)
    x = dk.pad_plain(dev_frames, torch.tensor(fills, dtype=torch.uint8, device=card), L)
    assert torch.equal(dk.correlate(x, sig, True), want)
    h = shape[0]
    r0, r1 = h // 3, h // 3 + max(1, h // 4)
    assert torch.equal(dk.correlate(x[:, r0:r1 + L - 1], sig, True), want[:, r0:r1])
    assert torch.equal(dk.frame_response(dev_frames[1:], [90], sig, True)[0], want[1:])


def test_detect_response_refuses_what_it_cannot_take(card):
    """Too many taps for a tile in shared memory, or a slab too small for one
    output, raise; nothing runs in their place."""
    from pawsometracker_tpu_torch.ops import detect_kernel as dk

    frame = torch.zeros((1, 40, 40), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        dk.frame_response(frame, [0], make_spec((40, 40), 21, 100, True).sigma, True)
    with pytest.raises(ValueError, match="holds no output"):
        dk.correlate(torch.zeros((1, 20, 40), device=card), 4.0, True)


@pytest.mark.parametrize("fills", [
    torch.tensor([128], dtype=torch.uint8), torch.tensor([128, 90, 100], dtype=torch.uint8),
    torch.tensor([127.5, 128.0]), torch.tensor([128, 90], dtype=torch.int64),
])
def test_detect_response_refuses_card_fills_it_cannot_read(card, fills):
    """A fills tensor already on the card must hold one uint8 a frame: one of
    the wrong length (which the kernel would read past) or of another dtype
    (which it would cut to uint8) raises, in the kernel's wrapper and in the
    plain pad alike, and nothing is launched."""
    from pawsometracker_tpu_torch.ops import detect_kernel as dk

    spec, _, dev_frames = detect_case(card, 64, 128, 12)
    fills = fills.to(card)
    before = dk.launches
    with pytest.raises(ValueError, match="fills on the card"):
        dk.frame_response(dev_frames, fills, spec.sigma, True)
    with pytest.raises(ValueError, match="fills on the card"):
        dk.pad_plain(dev_frames, fills, spec.kernel_len)
    assert dk.launches == before


def rounds_frames():
    """Frames whose peaks test the rounds: name -> (uint8 frame, fill, n, min_distance)."""
    plateau = np.full((90, 130), 128, np.uint8)  # a flat response: every cell ties
    twins = np.full((120, 160), 128, np.uint8)
    for i, j in ((30, 40), (30, 100), (80, 40), (80, 100)):  # four equal blobs
        twins[i - 3:i + 3, j - 3:j + 3] = 20
    corners = np.full((100, 150), 128, np.uint8)
    for i, j in ((0, 0), (0, 146), (96, 0), (96, 146), (0, 70), (50, 0), (96, 75), (48, 146)):
        corners[i:i + 4, j:j + 4] = 10 + i // 8 + j // 16
    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, size=(150, 210)).astype(np.uint8)
    return {"tied plateau": (plateau, 128, 6, None),
            "four tied blobs": (twins, 128, 4, 11),
            "exhausted": (twins, 128, 30, 25),
            "corners and edges": (corners, 128, 8, 9),
            "min_distance beyond the frame": (twins, 128, 5, 500),
            "min_distance 0": (noise, 128, 40, 0),
            "noise, N = 1": (noise, 100, 1, None),
            "noise, N = 96": (noise, 100, 96, 7),
            "noise, N = 400": (noise, 100, 400, 3)}


@pytest.mark.parametrize("name", list(rounds_frames()))
def test_detect_rounds_equal_plain(card, name):
    """The rounds kernel's peaks are the plain rounds': on the card and on the
    CPU, ties (the first column-major maximum wins), exhausted suppression
    (the last peak repeats), discs clipped at the frame's edges and corners,
    a disc larger than the frame, and N from 1 to 400, in one launch."""
    from pawsometracker_tpu_torch.ops import detect_kernel as dk
    from pawsometracker_tpu_torch.parallel.mesh import global_detect_peaks

    frame, fill, n, md = rounds_frames()[name]
    spec = make_spec(frame.shape, 21, 10, True)
    on_card = torch.from_numpy(frame).to(card)
    resp = dk.frame_response(on_card[None], [fill], spec.sigma, True)[0][0]
    r2 = float(md if md is not None else 21) ** 2
    want = dk.suppress_plain(resp, n, r2)
    resp2, part = dk.frame_response(on_card[None], [fill], spec.sigma, True)
    before = dk.launches
    got = dk.suppress(resp2[0], part[0], n, r2)
    assert dk.launches == before + 1
    assert torch.equal(got, want), (got.tolist()[:8], want.tolist()[:8])
    cpu = global_detect_peaks(spec, n, md)(torch.from_numpy(frame), fill)
    assert torch.equal(global_detect_peaks(spec, n, md)(on_card, fill).cpu(), cpu)


def test_detect_rounds_on_tied_random_responses(card):
    """Integer-valued responses full of ties, -inf cells, odd sizes and disc
    radii around whole and half pixels, from a disc of one cell to one larger
    than the frame: the rounds kernel, started from the partials of each
    32-row tile (which it keeps up to date), gives the plain rounds' peaks."""
    from pawsometracker_tpu_torch.ops import detect_kernel as dk

    rng = np.random.default_rng(11)
    for trial in range(24):
        h, w = int(rng.integers(1, 140)), int(rng.integers(1, 300))
        resp = torch.from_numpy(rng.integers(-2, 3, size=(h, w)).astype(np.float32))
        resp[torch.from_numpy(rng.random((h, w)) < 0.1)] = -torch.inf
        resp = resp.to(card)
        vals, first = column_partials(resp)
        part = torch.stack([vals, first.view(torch.float32)], dim=-1).contiguous()
        md = float(rng.choice([0, 1, 1.5, 2, 4.5, 9, 40, 400]))
        n = int(rng.integers(1, 120))
        want = dk.suppress_plain(resp.clone(), n, md ** 2)  # a 1-row copy is resp itself
        got = dk.suppress(resp.clone(), part, n, md ** 2)
        assert torch.equal(got, want), (trial, h, w, md, n)


def test_plate_frame_peaks_equal_the_reference(card):
    """Frame 1 of the plate cell's traffic (96 discs at 1080p, made by the
    benchmark's generator on the card): the kernels' 96 peaks equal
    ``portbench/reference/multi.py::peaks(frame_response(...))``, and the
    response is the reference's to the bit."""
    from portbench import frames as bench_frames
    from portbench.reference import multi as bench_multi
    from portbench.reference import tracker as bench_tracker
    from pawsometracker_tpu_torch.ops import detect_kernel as dk
    from pawsometracker_tpu_torch.parallel.mesh import global_detect_peaks

    with open("portbench/configs/plate96-larvae1080-tw12.json") as f:
        config = json.load(f)
    with open("portbench/traffic/multi96-plate-full-1080.json") as f:
        traffic = json.load(f)
    traffic["clip_sets"] = 1
    for v in traffic["videos"]:
        v["frames"] = 1
    frame = bench_frames.render(config, bench_frames.plan(config, traffic, 2**31 + 7), 2**31 + 7,
                                card)[0][0][0]
    fill = bench_tracker.mode_u8(frame)
    g, direction, _ = bench_tracker.taps(config["target_width"], config["darker_target"])
    want_resp = bench_multi.frame_response(frame, fill, g, direction)
    want = bench_multi.peaks(want_resp, 96, 25)
    spec = make_spec(frame.shape, config["window_size"], config["target_width"], True)
    on_card = torch.from_numpy(frame).to(card)
    resp = dk.frame_response(on_card[None], [fill], spec.sigma, True)[0][0]
    assert np.array_equal(resp.cpu().numpy().view(np.uint32), want_resp.view(np.uint32))
    got = global_detect_peaks(spec, 96)(on_card, fill).cpu().numpy()
    assert [tuple(p) for p in got.tolist()] == [tuple(p) for p in want]


@pytest.mark.parametrize("target_width", [12, 25])
def test_space_sharded_detection_on_card_equals_unsharded(card, target_width):
    """global_detect_batch over space = 2 and 4 shards of cuda:0 (each shard's
    padded slab through the response kernel) equals the unsharded detector
    (the kernel on the uint8 frames) and the CPU's, at 270 x 481."""
    from pawsometracker_tpu_torch import make_mesh
    from pawsometracker_tpu_torch.parallel.mesh import global_detect_batch

    rng = np.random.default_rng(9)
    frames = rng.integers(100, 140, size=(2, 270, 481)).astype(np.uint8)
    frames[0, 100:110, 300:310] = 0
    frames[1, 200:206, 17:23] = 0
    fills = np.array([120, 128], np.uint8)
    spec = make_spec((270, 481), 21, target_width, True)
    want = global_detect_batch(spec)(frames, fills).numpy()
    on_card = torch.from_numpy(frames).to(card)
    np.testing.assert_array_equal(global_detect_batch(spec)(on_card, fills).cpu().numpy(), want)
    for space in (2, 4):
        mesh = make_mesh(devices=["cuda:0"] * space, space=space)
        np.testing.assert_array_equal(np.asarray(global_detect_batch(spec, mesh)(on_card, fills)),
                                      want)


def test_detection_launches_are_constant(card, caplog):
    """A detection is two kernel launches whatever its N: 2, 24 and 400 peaks
    add the same ``detect_kernel.launches``, and an autodetecting
    ``track_multi`` on the card reports them as ``detect.kernel_launches``."""
    from pawsometracker_tpu_torch import track_multi
    from pawsometracker_tpu_torch.ops import detect_kernel as dk
    from pawsometracker_tpu_torch.parallel.mesh import global_detect_peaks

    spec = make_spec((240, 360), 21, 10, True)
    frame = np.full((240, 360), 128, np.uint8)
    for r in range(4):
        for c in range(6):
            frame[30 + 60 * r:36 + 60 * r, 30 + 60 * c:36 + 60 * c] = 20
    on_card = torch.from_numpy(frame).to(card)
    added = {}
    for n in (2, 24, 400):
        before = dk.launches
        global_detect_peaks(spec, n)(on_card, 128).cpu()
        added[n] = dk.launches - before
    assert added == {2: 2, 24: 2, 400: 2}
    clip = np.repeat(frame[None], 5, axis=0)
    with caplog.at_level(logging.DEBUG, logger="pawsometracker_tpu_torch"):
        track_multi(clip, n_targets=24, target_width=10, stream="full")
    [stats] = [r.paws_stats for r in caplog.records if hasattr(r, "paws_stats")]
    assert stats["counts"] == {"multi.lanes": 24, "detect.rounds": 24,
                               "detect.kernel_launches": 2}


# ---- dog_scan's prefetched superset, at the frame's edges and beyond ----------


EDGE_STARTS = {
    "off the frame, top left": (-30, -45),
    "off the frame, bottom right": (120, 160),
    "top left corner": (0, 0),
    "top right corner": (0, 117),
    "bottom left corner": (89, 0),
    "bottom right corner": (89, 117),
    "top edge": (0, 60),
    "left edge": (45, 0),
    "bottom edge": (89, 60),
    "right edge": (45, 117),
}


@pytest.mark.parametrize("where", list(EDGE_STARTS))
def test_edges_and_off_frame_starts_equal_plain(card, where):
    """Starts off the frame and on each edge and corner of a 90x118 frame (a
    width that is not a multiple of 16): the superset of the next patch runs
    off the frame, where its cells take the fill."""
    h, w, T = 90, 118, 10
    p0 = EDGE_STARTS[where]
    i0, j0 = min(max(p0[0], 0), h - 1), min(max(p0[1], 0), w - 1)
    path = [(min(max(i0 + (t if i0 < h // 2 else -t), 0), h - 1),
             min(max(j0 + (t if j0 < w // 2 else -t), 0), w - 1)) for t in range(T)]
    spec = make_spec((h, w), 21, 10, True)
    frames = ellipse_frames(h, w, path)
    rng = np.random.default_rng(3)
    bounds = {"deltas": rng.integers(-3, 4, (T, 2)), "lo": np.zeros((T, 2)),
              "hi": np.tile([h - 1, w - 1], (T, 1))}
    check(card, frames, p0, spec.radii, spec.sigma, fill=77, kernel="dog_scan")
    check(card, frames, p0, spec.radii, spec.sigma, subpixel=True, bounds=bounds, fill=77,
          kernel="dog_scan")


@pytest.mark.parametrize("subpixel", [False, True])
def test_far_bounded_box_and_large_deltas_equal_plain(card, subpixel):
    """A clamp box far from the carried position and deltas up to the window
    radius: the next patch lies anywhere in the superset, not near p."""
    h, w, T = 160, 200, 16
    spec = make_spec((h, w), 21, 10, True)
    ri, rj = spec.radii
    rng = np.random.default_rng(4)
    path = [(40 + 3 * t, 150 - 4 * t) for t in range(T)]
    lo = np.stack([rng.integers(100, 140, T), rng.integers(0, 30, T)], 1)
    bounds = {"deltas": np.stack([rng.integers(-ri, ri + 1, T), rng.integers(-rj, rj + 1, T)], 1),
              "lo": lo, "hi": lo + rng.integers(0, 20, (T, 2))}
    check(card, ellipse_frames(h, w, path), (20, 180), spec.radii, spec.sigma,
          subpixel=subpixel, bounds=bounds, kernel="dog_scan")


@pytest.mark.parametrize("shape", [(1080, 1918), (360, 641), (120, 1920)])
def test_unaligned_widths_equal_plain(card, shape):
    """Frame widths that are not a multiple of 16 (each row of the superset
    starts at its own offset), and a 16-aligned width read at a lane base that
    is not 16-byte aligned."""
    h, w = shape
    T = 4
    path = [(h // 2 + 3 * t, w // 2 - 5 * t) for t in range(T)]
    spec = make_spec((h, w), 41, 25, True)
    frames = ellipse_frames(h, w, path, ry=12, rx=12)
    if w % 16 == 0:
        flat = torch.zeros(frames.size + 1, dtype=torch.uint8, device=card)
        flat[1:] = torch.from_numpy(frames.reshape(-1)).to(card)
        frames = flat[1:].view(T, h, w)  # data_ptr one byte past an aligned allocation
        assert frames.data_ptr() % 16 != 0
    check(card, frames, path[0], spec.radii, spec.sigma, kernel="dog_scan")
    check(card, frames, path[0], spec.radii, spec.sigma, subpixel=True, kernel="dog_scan")


@pytest.mark.parametrize("window", [(21, 21), (15, 41), (41, 9)])
@pytest.mark.parametrize("target_width", [5, 10, 25, 40])
def test_windows_and_kernel_lengths_equal_plain(card, window, target_width):
    """Non-square windows and several kernel lengths L (17 to 129 taps): the
    register-blocked passes' remainder taps and partial blocks."""
    h, w, T = 200, 256, 6
    spec = make_spec((h, w), window, target_width, True)
    path = [(100 + 2 * t, 128 - 3 * t) for t in range(T)]
    r = max(2, target_width // 2)
    frames = ellipse_frames(h, w, path, ry=r, rx=max(2, r - 1))
    kernel = tk.kernel_for(spec.radii, spec.kernel_len, tk._smem_limit(0))
    check(card, frames, path[0], spec.radii, spec.sigma, kernel=kernel)
    check(card, frames, path[0], spec.radii, spec.sigma, subpixel=True, kernel=kernel)


@pytest.mark.parametrize("field", ["blobs", "flat (ties)"])
def test_one_step_140_lanes_on_shared_frames_equal_plain(card, field):
    """T = 1 and B = 140 lanes (more than the card's 132 SMs, so the CTAs run in
    waves) reading one frame stream (lane stride 0), each prefetching nothing;
    then 140 lanes of their own 3-frame clips, on a flat field where every
    window cell ties."""
    h, w, B = 120, 150, 140
    rng = np.random.default_rng(5)
    spec = make_spec((h, w), 21, 10, True)
    if field == "flat (ties)":
        shared = np.full((1, h, w), 128, np.uint8)
        own = np.full((B, 3, h, w), 128, np.uint8)
    else:
        shared = ellipse_frames(h, w, [(60, 75)])
        own = np.stack([ellipse_frames(h, w, [(40 + b % 40, 50 + b % 50)] * 3) for b in range(B)])
    starts = np.stack([rng.integers(-10, h + 10, B), rng.integers(-10, w + 10, B)], 1)
    fills = rng.integers(0, 256, B)
    check_batch(card, shared, starts, fills, spec.radii, spec.sigma)
    check_batch(card, shared, starts, fills, spec.radii, spec.sigma, subpixel=True)
    check_batch(card, own, starts, fills, spec.radii, spec.sigma)


# ---- dog_scan as one thread-block cluster a lane, under forced cluster sizes ---------


def scan_clusters(radii, L):
    """The cluster sizes the dog_scan tests force: 1 (the whole window on one
    CTA), 2, 6 and the largest the card schedules at this window (up to 16,
    CTAs past the window's row blocks owning no row)."""
    limit = tk._smem_limit(0)
    fits = [c for c in range(1, tk.MAX_CLUSTER + 1)
            if tk.scan_plan(radii, L, c).smem <= limit
            and tk._scan_active_clusters(tuple(radii), L, c, 0) > 0]
    assert fits
    return sorted({c for c in (1, 2, 6) if c in fits} | {max(fits)})


def equal_under_clusters(monkeypatch, spec, run, run_plain, subpixel):
    """``run()`` (one dog_scan launch) equals ``run_plain()`` bit for bit under
    each forced cluster size of :func:`scan_clusters` and the card's own pick."""
    want = run_plain()
    for c in scan_clusters(spec.radii, spec.kernel_len) + [None]:
        monkeypatch.setattr(tk, "scan_cluster", c)
        before = tk.launches_by_kernel["dog_scan"]
        got = run()
        torch.cuda.synchronize()
        assert tk.launches_by_kernel["dog_scan"] == before + 1
        if subpixel:
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"C={c}"
        else:
            assert torch.equal(got, want), f"C={c}"


CLUSTER_CFGS = ["unbounded", "bounded", "bounded+subpixel", "unbounded+subpixel"]


@pytest.mark.parametrize("cfg", CLUSTER_CFGS)
@pytest.mark.parametrize("lanes", [1, 4, 16])
def test_dog_scan_clusters_equal_plain(card, monkeypatch, cfg, lanes):
    """A 41x41 window (six row blocks) over 12-step chains, one lane or 4 or
    16 with their own frames and fills, each start moving the chain across
    the blocks: positions and offsets bit for bit under C = 1, 2, 6 and the
    largest that schedules."""
    h, w, T = 130, 150, 12
    spec = make_spec((h, w), 41, 10, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True)
    sub = cfg.endswith("subpixel")
    rng = np.random.default_rng(60 + lanes)
    paths = [[(40 + (b * 7) % 50 + 3 * t, 50 + (b * 11) % 50 + 2 * t) for t in range(T)]
             for b in range(lanes)]
    frames = np.stack([ellipse_frames(h, w, p) for p in paths])
    fills = rng.integers(60, 200, lanes)
    for b in range(1, lanes, 2):
        frames[b] = np.where(frames[b] == 128, fills[b], frames[b])
    fr = torch.from_numpy(frames).to(card)
    pos0 = torch.tensor([p[0] for p in paths], dtype=torch.int32, device=card)
    fl = torch.from_numpy(fills.astype(np.uint8)).to(card)
    b = {}
    if cfg.startswith("bounded"):
        b = {k: torch.from_numpy(v.astype(np.int32)).to(card)
             for k, v in random_bounds(rng, (lanes, T, 2), h, w).items()}
    if lanes == 1:
        one = {k: v[0] for k, v in b.items()}
        equal_under_clusters(
            monkeypatch, spec, lambda: tk.dog_scan(fr[0], pos0[0], int(fills[0]), subpixel=sub,
                                                   **kw, **one),
            lambda: tk.dog_scan_plain(fr[0], pos0[0], int(fills[0]), subpixel=sub, **kw, **one),
            sub)
    else:
        equal_under_clusters(
            monkeypatch, spec, lambda: tk.dog_scan_batch(fr, pos0, fl, subpixel=sub, **kw, **b),
            lambda: tk.dog_scan_batch_plain(fr, pos0, fl, subpixel=sub, **kw, **b), sub)


@pytest.mark.parametrize("subpixel", [False, True])
def test_dog_scan_clusters_140_lanes_one_step_shared_frames(card, monkeypatch, subpixel):
    """T = 1 and 140 lanes reading one frame stream (lane stride 0) from random
    starts on and off the frame: the clusters run in waves, and each lane's
    CTAs prefetch nothing."""
    h, w, B = 120, 150, 140
    rng = np.random.default_rng(61)
    spec = make_spec((h, w), 41, 10, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True)
    fr = torch.from_numpy(ellipse_frames(h, w, [(60, 75)])).to(card)
    pos0 = torch.from_numpy(np.stack([rng.integers(-10, h + 10, B), rng.integers(-10, w + 10, B)],
                                     1).astype(np.int32)).to(card)
    fl = torch.from_numpy(rng.integers(0, 256, B).astype(np.uint8)).to(card)
    equal_under_clusters(
        monkeypatch, spec, lambda: tk.dog_scan_batch(fr, pos0, fl, subpixel=subpixel, **kw),
        lambda: tk.dog_scan_batch_plain(fr, pos0, fl, subpixel=subpixel, **kw), subpixel)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_dog_scan_cluster_segments_equal_plain(card, monkeypatch, S, carry):
    """S segments of one launch under each forced cluster size: 4 lanes with
    the absolute carry (a lane with ks = 0 keeps it, one starting below its
    crop), or one lane by the ks rule with short segments; bounded, with
    subpixel offsets."""
    h, w, T, B = 100, 120, 6, 4
    spec = make_spec((h, w), 41, 10, True)
    rng = np.random.default_rng(62 + S)
    paths = [[(40 + 2 * t * (b % 2), 20 + 25 * b + 2 * t) for t in range(S * T)]
             for b in range(B)]
    frames = np.stack([ellipse_frames(h, w, p) for p in paths])
    frames = np.ascontiguousarray(np.moveaxis(frames.reshape(B, S, T, h, w), 0, 1))
    fr = torch.from_numpy(frames).to(card)
    box = {k: torch.from_numpy(v.astype(np.int32)).to(card)
           for k, v in random_bounds(rng, (S, B, T, 2), h, w).items()}
    ks_np = np.tile(np.array([T, 3, T, 1][:S])[:, None], (1, B))
    if S > 1:
        ks_np[1, 1] = 0
    ks = torch.from_numpy(ks_np.astype(np.int32)).to(card)
    fills = torch.tensor([128, 100, 160, 128], dtype=torch.uint8, device=card)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True, subpixel=True)
    if carry:
        origin0 = torch.from_numpy(rng.integers(-20, 20, (S, B, 2)).astype(np.int32)).to(card)
        origin_last = torch.from_numpy(rng.integers(-20, 20, (S, B, 2)).astype(np.int32)).to(card)
        c0 = torch.tensor([[40, 20], [40, 45], [40, 70], [h + 30, 95]], dtype=torch.int32,
                          device=card) + origin0[0]
        seg = dict(ks=ks, origin0=origin0, origin_last=origin_last, **box, **kw)
        want = tk.dog_scan_batch_segments_plain(fr, None, fills, carry=c0, **seg)
        for c in scan_clusters(spec.radii, spec.kernel_len) + [None]:
            monkeypatch.setattr(tk, "scan_cluster", c)
            got = tk.dog_scan_batch_segments(fr, None, fills, carry=c0.clone(), kernel="dog_scan",
                                             **seg)
            torch.cuda.synchronize()
            assert torch.equal(got[1], want[1]), f"C={c}: carry"
            _assert_same_out(got[0], want[0], True)
        return
    one = {k: v[:, 0].contiguous() for k, v in box.items()}
    pos0 = torch.tensor(paths[0][0], dtype=torch.int32, device=card)
    equal_under_clusters(
        monkeypatch, spec,
        lambda: tk.dog_scan_segments(fr[:, 0], pos0, 128, ks=ks[:, 0].contiguous(),
                                     kernel="dog_scan", **one, **kw),
        lambda: tk.dog_scan_segments_plain(fr[:, 0], pos0, 128, ks=ks[:, 0].contiguous(), **one,
                                           **kw), True)


@pytest.mark.parametrize("shape", [(70, 1918), (90, 641), (80, 1920)])
def test_dog_scan_cluster_unaligned_widths_equal_plain(card, monkeypatch, shape):
    """Widths 1918 and 641 (each row of a CTA's superset at its own offset),
    and a 16-aligned width read at a lane base that is not 16-byte aligned,
    under each forced cluster size, with subpixel offsets."""
    h, w = shape
    T = 5
    path = [(h // 2 + 3 * t, w // 2 - 5 * t) for t in range(T)]
    spec = make_spec((h, w), 41, 10, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True, subpixel=True)
    fr = torch.from_numpy(ellipse_frames(h, w, path)).to(card)
    if w % 16 == 0:
        flat = torch.zeros(fr.numel() + 3, dtype=torch.uint8, device=card)
        flat[3:] = fr.reshape(-1)
        fr = flat[3:].view(T, h, w)
        assert fr.data_ptr() % 16 != 0
    pos0 = torch.tensor(path[0], dtype=torch.int32, device=card)
    equal_under_clusters(monkeypatch, spec, lambda: tk.dog_scan(fr, pos0, 90, **kw),
                         lambda: tk.dog_scan_plain(fr, pos0, 90, **kw), True)


def test_dog_scan_cluster_off_frame_starts_equal_plain(card, monkeypatch):
    """Starts off every side and corner of the frame, 8 lanes in one launch:
    each CTA's rows of the patch run off the frame, where they take the fill."""
    h, w, T = 90, 118, 6
    spec = make_spec((h, w), 41, 10, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True, subpixel=True)
    starts = [(-30, -45), (120, 160), (-8, 50), (50, -4), (103, 50), (50, 130), (-25, 140),
              (100, -20)]
    fr = torch.from_numpy(ellipse_frames(h, w, [(45 + t, 60 - t) for t in range(T)])).to(card)
    pos0 = torch.tensor(starts, dtype=torch.int32, device=card)
    fl = torch.tensor([77, 0, 255, 128, 77, 30, 200, 128], dtype=torch.uint8, device=card)
    equal_under_clusters(monkeypatch, spec, lambda: tk.dog_scan_batch(fr, pos0, fl, **kw),
                         lambda: tk.dog_scan_batch_plain(fr, pos0, fl, **kw), True)


def periodic_rows(h, w, phase, period=9):
    """128-gray with a dark 3x4 mark every ``period`` rows in columns 57-60:
    patches ``period`` rows apart are equal, so a window's maximum ties
    exactly across row blocks."""
    f = np.full((h, w), 128, np.uint8)
    rows = (np.arange(h) - phase) % period < 3
    f[rows, 57:61] = 40
    return f


@pytest.mark.parametrize("field", ["flat", "ties 9 rows apart, first in block 1",
                                   "ties 9 rows apart, first on row 6"])
def test_dog_scan_ties_across_cta_blocks_equal_plain(card, monkeypatch, field):
    """Exact ties that fall in different CTAs' row blocks: a flat field (every
    window cell ties), and marks repeating every 9 rows, whose equal maxima
    lie in every block of a 41x41 window (at step 0 the first in column-major
    order on window row 7 or 8, in the second CTA's block at C = 6, or on row 6,
    the last of the first block): the cluster's maximum is the first in
    column-major order, as the plain version's, under every cluster size."""
    h, w, T = 160, 120, 6
    spec = make_spec((h, w), 41, 10, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True)
    phase = {"flat": None, "ties 9 rows apart, first in block 1": 3,
             "ties 9 rows apart, first on row 6": 2}[field]
    frame = np.full((h, w), 128, np.uint8) if phase is None else periodic_rows(h, w, phase)
    fr = torch.from_numpy(np.repeat(frame[None], T, 0)).to(card)
    pos0 = torch.tensor([80, 60], dtype=torch.int32, device=card)
    first = tk.dog_scan_plain(fr[:1], pos0, 128, **kw)[0].cpu().numpy()
    if phase is not None:  # window row of step 0's maximum: 60 + (row - 20)
        assert first[0] - (80 - spec.radii[0]) == {3: 7, 2: 6}[phase]
    for sub in (False, True):
        equal_under_clusters(monkeypatch, spec,
                             lambda: tk.dog_scan(fr, pos0, 128, subpixel=sub, **kw),
                             lambda: tk.dog_scan_plain(fr, pos0, 128, subpixel=sub, **kw), sub)
    fl = torch.tensor([128, 90, 128], dtype=torch.uint8, device=card)
    starts = torch.tensor([[80, 60], [70, 55], [95, 64]], dtype=torch.int32, device=card)
    equal_under_clusters(monkeypatch, spec, lambda: tk.dog_scan_batch(fr, starts, fl, **kw),
                         lambda: tk.dog_scan_batch_plain(fr, starts, fl, **kw), False)


@pytest.mark.parametrize("row", [6, 7, 13, 14, 34, 35])
def test_dog_scan_subpixel_max_on_block_boundary_equal_plain(card, monkeypatch, row):
    """A disc whose maximum lies on window row 6, 7, 13, 14, 34 or 35, next to
    a row block boundary, so at C = 6 the neighbour above or below is read
    from another CTA's responses; shades below and beside the disc make both
    offsets nonzero: offsets bit for bit, under every cluster size."""
    h, w, T = 130, 130, 3
    spec = make_spec((h, w), 41, 10, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True, subpixel=True)
    p = (65, 65)
    ci, cj = p[0] - spec.radii[0] + row, p[1] + 3
    frames = ellipse_frames(h, w, [(ci, cj)] * T, ry=4, rx=3)
    frames[:, ci + 5, cj - 2:cj + 3] = 70
    frames[:, ci - 1:ci + 2, cj + 4] = 70
    fr = torch.from_numpy(frames).to(card)
    pos0 = torch.tensor(p, dtype=torch.int32, device=card)
    first, off = tk.dog_scan_plain(fr[:1], pos0, 128, **kw)
    assert tuple(first[0].tolist()) == (ci, cj) and bool((off[0].abs() > 0.1).all())
    equal_under_clusters(monkeypatch, spec, lambda: tk.dog_scan(fr, pos0, 128, **kw),
                         lambda: tk.dog_scan_plain(fr, pos0, 128, **kw), True)


def test_dog_scan_forced_cluster_that_cannot_run_raises(card, monkeypatch):
    """A cluster above the largest the kernel takes raises; nothing runs in its
    place."""
    spec = make_spec((60, 60), 21, 10, True)
    monkeypatch.setattr(tk, "scan_cluster", tk.MAX_CLUSTER + 1)
    fr = torch.zeros((2, 60, 60), dtype=torch.uint8, device=card)
    before = tk.launches
    with pytest.raises(RuntimeError, match="dog_scan"):
        tk.dog_scan(fr, torch.tensor([30, 30], dtype=torch.int32, device=card), 0,
                    radii=spec.radii, sigma=spec.sigma, darker_target=True, kernel="dog_scan")
    assert tk.launches == before


# ---- the speculative ROI pipeline on the card --------------------------------------


def _roi_stats(caplog):
    """The stats the last track() logged (``paws_stats`` on its debug record)."""
    recs = [r for r in caplog.records if hasattr(r, "paws_stats")]
    assert recs, "track() logged no stats"
    return recs[-1].paws_stats


def _roi_clip(T=48, h=160, w=160, erratic=False):
    """A disc of radius 4 on 128-gray: a smooth arc, or an erratic walk of
    near-radius steps (which defeats the velocity prediction)."""
    rng = np.random.default_rng(11)
    if erratic:
        path = [np.array([80, 80])]
        for _ in range(T - 1):
            path.append(np.clip(path[-1] + rng.integers(-9, 10, 2), 12, [h - 13, w - 13]))
    else:
        path = [np.array([80 + 40 * np.sin(t / 12), 80 + 40 * np.cos(t / 12)]).round()
                for t in range(T)]
    path = [tuple(int(v) for v in p) for p in path]
    return ellipse_frames(h, w, path, ry=4, rx=4), path


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("depth", [0, 2, "auto"])
def test_roi_on_card_equals_cpu(card, caplog, subpixel, depth):
    """track(stream="roi") on the card: positions (offsets within 1e-3) equal to
    the device="cpu" run and to stream="full"; every chunk launch is the
    bounded configuration, one a dispatch, and the plain version never runs."""
    caplog.set_level(logging.DEBUG, logger="pawsometracker_tpu_torch")
    frames, path = _roi_clip()
    kw = dict(fps=24, start_location=IJ(*path[0]), target_width=8, window_size=21,
              subpixel=subpixel, pipeline_depth=depth, roi_frames=4)
    tk.reset_launches()
    ts, ij = track(frames, stream="roi", **kw)
    stats = _roi_stats(caplog)
    cfg = "bounded+subpixel" if subpixel else "bounded"
    assert stats["stream"] == "roi" and stats["dispatches"] > 0
    assert tk.launches == 1 + stats["dispatches"]
    assert tk.launches_by_config[f"dog_scan: {cfg}"] == stats["dispatches"]
    ts_c, ij_c = track(frames, stream="roi", device="cpu", **kw)
    ts_f, ij_f = track(frames, stream="full", **kw)
    np.testing.assert_array_equal(ts, ts_c)
    for other in (ij_c, ij_f):
        if subpixel:
            np.testing.assert_allclose(ij, other, rtol=0, atol=1e-3)
        else:
            np.testing.assert_array_equal(ij, other)


def test_roi_mispredict_replays_on_card(card, caplog, monkeypatch):
    """An erratic path with a slim prediction slack: the pipeline replays (and
    splits) on the card and still gives the CPU run's positions."""
    from pawsometracker_tpu_torch import pipeline

    caplog.set_level(logging.DEBUG, logger="pawsometracker_tpu_torch")
    monkeypatch.setenv("PAWS_PREDICT_SLACK", "8")
    frames, path = _roi_clip(erratic=True)
    kw = dict(fps=24, start_location=IJ(*path[0]), target_width=8, window_size=21,
              stream="roi", roi_frames=8, pipeline_depth=3)
    before = pipeline.replay_count
    tk.reset_launches()
    _, ij = track(frames, **kw)
    stats = _roi_stats(caplog)
    assert pipeline.replay_count > before and stats["replays"] > 0
    assert tk.launches == 1 + stats["dispatches"]
    np.testing.assert_array_equal(ij, track(frames, device="cpu", **kw)[1])


def test_roi_buffers_wait_for_copy_and_scan(card, monkeypatch):
    """A pool of 2 crop buffers at depth 3, with the side stream's copies and
    the scans both held back by sleeps on the card, through replays: a buffer
    refilled before its copy or its scan had finished would change the
    positions."""
    from pawsometracker_tpu_torch import pipeline

    monkeypatch.setenv("PAWS_PREDICT_SLACK", "8")
    init, stage = pipeline.SpeculativePipeline.__init__, pipeline._SingleEngine._stage

    def small_pool(self, *a, **k):
        init(self, *a, **k)
        self._pool_max = 2
        del self._free[2:]

    def slow_stage(self, buf, args):
        if self._cuda:  # (the device="cpu" run below has no streams)
            with torch.cuda.stream(self._copy_stream):
                torch.cuda._sleep(200_000)  # the copy lags the host
            torch.cuda._sleep(200_000)  # and so does the scan
        return stage(self, buf, args)

    monkeypatch.setattr(pipeline.SpeculativePipeline, "__init__", small_pool)
    monkeypatch.setattr(pipeline._SingleEngine, "_stage", slow_stage)
    frames, path = _roi_clip(erratic=True)
    kw = dict(fps=24, start_location=IJ(*path[0]), target_width=8, window_size=21,
              stream="roi", roi_frames=4, pipeline_depth=3)
    before = pipeline.replay_count
    _, ij = track(frames, **kw)
    assert pipeline.replay_count > before
    np.testing.assert_array_equal(ij, track(frames, device="cpu", **kw)[1])


def test_roi_large_target_takes_tiled_bounded(card, caplog):
    """At a window too large for dog_scan (151x151 with L = 77: 22 row blocks,
    two a CTA, over the shared memory a CTA may use) every ROI chunk launch is
    dog_scan_tiled's bounded configuration."""
    caplog.set_level(logging.DEBUG, logger="pawsometracker_tpu_torch")
    frames, path = _roi_clip(T=12, h=400, w=400)
    kw = dict(fps=24, start_location=IJ(*path[0]), target_width=30, window_size=(151, 151),
              stream="roi", roi_frames=4, pipeline_depth=1)
    spec = make_spec((400, 400), (151, 151), 30, True)
    assert tk.kernels_for(spec.radii, spec.kernel_len, tk._smem_limit(0)) == ("dog_scan_tiled",)
    tk.reset_launches()
    _, ij = track(frames, **kw)
    stats = _roi_stats(caplog)
    assert tk.launches_by_config["dog_scan_tiled: bounded"] == stats["dispatches"]
    assert tk.launches == 1 + stats["dispatches"]
    np.testing.assert_array_equal(ij, track(frames, device="cpu", **kw)[1])


# ---- the batch and multi ROI engines on the card ----------------------------------


def _lane_clips():
    """Four lanes for track_batch on ROI: the smooth arc, the same arc ending
    after 24 frames, the erratic walk, and the arc mirrored left to right on
    another background; with their start locations."""
    smooth, path = _roi_clip()
    short, short_path = _roi_clip(T=24)
    erratic, erratic_path = _roi_clip(erratic=True)
    mirrored = np.ascontiguousarray(smooth[:, :, ::-1])
    mirrored[mirrored == 128] = 100
    w = smooth.shape[2]
    return ([smooth, short, erratic, mirrored],
            [IJ(*path[0]), IJ(*short_path[0]), IJ(*erratic_path[0]),
             IJ(path[0][0], w - 1 - path[0][1])])


def _two_targets(T=48, h=160, w=160):
    """Two discs in one clip, each on an arc of radius 25, one above the
    other (never nearer than 20 rows)."""
    paths = [[(int(round(c + 25 * np.sin(t / 12 + c))), int(round(80 + 25 * np.cos(t / 12 + c))))
              for t in range(T)] for c in (50, 120)]
    frames = np.minimum(ellipse_frames(h, w, paths[0], ry=4, rx=4),
                        ellipse_frames(h, w, paths[1], ry=4, rx=4))
    return frames, [IJ(*p[0]) for p in paths]


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("depth", [0, 2, "auto"])
def test_batch_and_multi_roi_on_card_equal_cpu(card, caplog, subpixel, depth):
    """track_batch and track_multi on ROI on the card: positions (offsets
    within 1e-3) equal to the device="cpu" run; one snap, then every chunk one
    batched bounded launch (the segmented form, which keeps the chain's carry),
    and the plain version never runs."""
    from pawsometracker_tpu_torch import track_batch, track_multi

    caplog.set_level(logging.DEBUG, logger="pawsometracker_tpu_torch")
    cfg = ("batched bounded+subpixel" if subpixel else "batched bounded") + ", segmented"
    kw = dict(fps=24, target_width=8, window_size=21, subpixel=subpixel, pipeline_depth=depth,
              roi_frames=4, stream="roi")
    clips, locs = _lane_clips()
    frames, targets = _two_targets()
    for run, args in ((track_batch, (clips[:2],)), (track_multi, (frames, targets))):
        extra = {"start_location": locs[:2]} if run is track_batch else {}
        tk.reset_launches()
        got = run(*args, **extra, **kw)
        stats = _roi_stats(caplog)
        assert stats["stream"] == "roi" and stats["dispatches"] > 0
        assert tk.launches == 1 + stats["dispatches"]
        assert tk.launches_by_config[f"dog_scan: {cfg}"] == stats["dispatches"]
        want = run(*args, **extra, **kw, device="cpu")
        pairs = list(zip(got, want)) if run is track_batch else [(got, want)]
        for (ts, ij), (ts_c, ij_c) in pairs:
            np.testing.assert_array_equal(ts, ts_c)
            if subpixel:
                np.testing.assert_allclose(ij, ij_c, rtol=0, atol=1e-3)
            else:
                np.testing.assert_array_equal(ij, ij_c)


def test_batch_roi_short_and_erratic_lanes_on_card(card, caplog, monkeypatch):
    """Four lanes, one ending after 24 frames (then fill-only crops while the
    others go on) and one erratic under an 8 px prediction slack: the batch
    replays on the card and still gives the CPU run's positions, each lane
    equal to track() of its video."""
    from pawsometracker_tpu_torch import pipeline, track_batch

    caplog.set_level(logging.DEBUG, logger="pawsometracker_tpu_torch")
    monkeypatch.setenv("PAWS_PREDICT_SLACK", "8")
    clips, locs = _lane_clips()
    kw = dict(fps=24, target_width=8, window_size=21, stream="roi", roi_frames=8,
              pipeline_depth=3)
    before = pipeline.replay_count
    tk.reset_launches()
    got = track_batch(clips, start_location=locs, **kw)
    stats = _roi_stats(caplog)
    assert pipeline.replay_count > before and stats["replays"] > 0
    assert tk.launches == 1 + stats["dispatches"]
    assert [len(ij) for _, ij in got] == [48, 24, 48, 48]
    for (ts, ij), (ts_c, ij_c), clip, loc in zip(got, track_batch(clips, start_location=locs,
                                                                  device="cpu", **kw),
                                                 clips, locs):
        np.testing.assert_array_equal(ts, ts_c)
        np.testing.assert_array_equal(ij, ij_c)
        np.testing.assert_array_equal(ij, track(clip, start_location=loc, fps=24, target_width=8,
                                                window_size=21, stream="full")[1])


def test_batch_roi_buffers_wait_for_copy_and_scan(card, monkeypatch):
    """test_roi_buffers_wait_for_copy_and_scan at B = 4 with a short lane: a
    pool of 2 crop buffers at depth 3, copies and scans held back by sleeps
    on the card, through replays."""
    from pawsometracker_tpu_torch import pipeline, track_batch

    monkeypatch.setenv("PAWS_PREDICT_SLACK", "8")
    init, stage = pipeline.SpeculativePipeline.__init__, pipeline._BatchedEngine._stage

    def small_pool(self, *a, **k):
        init(self, *a, **k)
        self._pool_max = 2
        del self._free[2:]

    def slow_stage(self, buf, args):
        if self._cuda:  # (the device="cpu" run below has no streams)
            with torch.cuda.stream(self._copy_stream):
                torch.cuda._sleep(200_000)  # the copy lags the host
            torch.cuda._sleep(200_000)  # and so does the scan
        return stage(self, buf, args)

    monkeypatch.setattr(pipeline.SpeculativePipeline, "__init__", small_pool)
    monkeypatch.setattr(pipeline._BatchedEngine, "_stage", slow_stage)
    clips, locs = _lane_clips()
    kw = dict(fps=24, target_width=8, window_size=21, stream="roi", roi_frames=4,
              pipeline_depth=3, start_location=locs)
    before = pipeline.replay_count
    got = track_batch(clips, **kw)
    assert pipeline.replay_count > before
    for (_, ij), (_, ij_c) in zip(got, track_batch(clips, device="cpu", **kw)):
        np.testing.assert_array_equal(ij, ij_c)


def forbid_plain(monkeypatch):
    """Make a run of the plain chunk scans on the card fail, except inside the
    engine chooser's probe, where the plain version is the oracle the kernels
    are held to."""
    from pawsometracker_tpu_torch.models import dog_tracker

    def forbid(real):
        def run(*a, **k):
            if not tk.is_probing():
                raise AssertionError("the plain version ran on the card's path")
            return real(*a, **k)
        return run

    for mod in (tk, dog_tracker):
        for name in ("dog_scan_plain", "dog_scan_batch_plain"):
            monkeypatch.setattr(mod, name, forbid(getattr(mod, name)))


@pytest.mark.parametrize("subpixel", [False, True])
def test_track_resumable_on_card_equals_track(card, caplog, tmp_path, monkeypatch, subpixel):
    """track_resumable on a 1080p array at stream="auto" (the ROI pipeline),
    interrupted after 2 of 4 slices and resumed: positions (offsets within
    1e-3) and timestamps equal to one uninterrupted track() on the card; each
    slice launches its snap and one bounded launch a dispatch, and the plain
    version never runs outside the engine chooser's probe."""
    from pawsometracker_tpu_torch import load_checkpoint, track_resumable

    forbid_plain(monkeypatch)
    caplog.set_level(logging.DEBUG, logger="pawsometracker_tpu_torch")
    n, h, w = 96, 1080, 1920
    path = [(540 + round(200 * np.sin(t / 40)), 960 + round(200 * np.cos(t / 40)))
            for t in range(n)]
    frames = np.full((n, h, w), 128, np.uint8)
    yy, xx = np.mgrid[-12:13, -12:13]
    for t, (i, j) in enumerate(path):
        frames[t, i - 12:i + 13, j - 12:j + 13][yy ** 2 + xx ** 2 <= 144] = 30
    kw = dict(fps=24, target_width=25, window_size=41, subpixel=subpixel)
    ts, ij = track(frames, start_location=IJ(*path[0]), **kw)
    cp = str(tmp_path / "cp.npz")
    tk.reset_launches()
    caplog.clear()
    track_resumable(frames, checkpoint_path=cp, checkpoint_every=1.0,
                    start_location=IJ(*path[0]), _max_slices=2, **kw)
    assert not load_checkpoint(cp)["done"]
    ts_r, ij_r = track_resumable(frames, checkpoint_path=cp, checkpoint_every=1.0, **kw)
    stats = [r.paws_stats for r in caplog.records if hasattr(r, "paws_stats")]
    assert len(stats) == 4 and all(s["stream"] == "roi" for s in stats)
    assert tk.launches == sum(1 + s["dispatches"] for s in stats)
    np.testing.assert_array_equal(ts_r, ts)
    if subpixel:
        np.testing.assert_allclose(ij_r, ij, rtol=0, atol=1e-3)
    else:
        np.testing.assert_array_equal(ij_r, ij)
    assert load_checkpoint(cp)["done"]


# ---- track_batch over a device mesh ---------------------------------------------


def _mesh(name):
    """A mesh of the card(s) by name: every card, 2 or 4 shards on cuda:0,
    or the first two cards; None where the machine has too few cards."""
    from pawsometracker_tpu_torch import make_mesh

    n = torch.cuda.device_count()
    if name == "all cards":
        return make_mesh() if 4 % n == 0 else None
    if name == "two cards":
        return make_mesh(2) if n >= 2 else None
    return make_mesh(devices=["cuda:0"] * int(name.split("x")[1]))


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("stream", ["full", "roi"])
@pytest.mark.parametrize("mesh_name", ["all cards", "cuda:0 x2", "cuda:0 x4", "two cards"])
def test_track_batch_mesh_on_card_equals_none(card, caplog, monkeypatch, mesh_name, stream,
                                              subpixel):
    """track_batch over a mesh of the card(s) equals mesh=None, offsets
    included, with one launch a data shard for each launch of mesh=None (the
    snap, then each chunk or dispatch), and never the plain version outside the
    engine chooser's probe (a mesh shard's batch is a geometry of its own)."""
    from pawsometracker_tpu_torch import track_batch

    mesh = _mesh(mesh_name)
    if mesh is None:
        pytest.skip(f"{mesh_name}: {torch.cuda.device_count()} card(s) on this machine")
    caplog.set_level(logging.DEBUG, logger="pawsometracker_tpu_torch")
    clips, locs = _lane_clips()
    kw = dict(fps=24, target_width=8, window_size=21, stream=stream, subpixel=subpixel,
              start_location=locs, chunk_size=16, roi_frames=4)
    want = track_batch(clips, **kw)
    forbid_plain(monkeypatch)
    caplog.clear()
    tk.reset_launches()
    got = track_batch(clips, mesh=mesh, **kw)
    torch.cuda.synchronize()
    stats = _roi_stats(caplog)
    shards = mesh.shape["data"]
    assert stats["shards"] == shards and stats["stream"] == stream
    chunks = stats["dispatches"] if stream == "roi" else -(-47 // 16)
    assert tk.launches == shards * (1 + chunks)
    for (ts, ij), (ts_w, ij_w) in zip(got, want):
        np.testing.assert_array_equal(ts, ts_w)
        np.testing.assert_array_equal(ij, ij_w)


def test_sharded_pallas_bounded_on_card_equals_plain(card):
    """sharded_pallas_bounded on 2 and 4 shards of cuda:0 equals its plain
    version (interpret=True) and the unsharded batched launch, one launch a
    shard; the space-sharded whole-frame detector equals the unsharded one."""
    from pawsometracker_tpu_torch import make_mesh
    from pawsometracker_tpu_torch.parallel.mesh import global_detect_batch, sharded_pallas_bounded

    h, w, B, T = 120, 150, 4, 12
    paths = [[(40 + t, 30 + 20 * b + 2 * t) for t in range(T)] for b in range(B)]
    frames = torch.from_numpy(np.stack([ellipse_frames(h, w, p) for p in paths])).to(card)
    pos0 = torch.tensor([p[0] for p in paths], dtype=torch.int32, device=card)
    fills = torch.full((B,), 128, dtype=torch.uint8, device=card)
    rng = np.random.default_rng(8)
    b = {k: torch.from_numpy(v.astype(np.int32)).to(card) for k, v in
         random_bounds(rng, (B, T, 2), h, w).items()}
    spec = make_spec((h, w), 21, 10, True)
    for n in (2, 4):
        mesh = make_mesh(devices=["cuda:0"] * n)
        for sub in (False, True):
            before = tk.launches
            got = sharded_pallas_bounded(spec, mesh, subpixel=sub)(
                frames, pos0, fills, b["deltas"], b["lo"], b["hi"])
            assert tk.launches == before + n
            plain = sharded_pallas_bounded(spec, mesh, interpret=True, subpixel=sub)(
                frames, pos0, fills, b["deltas"], b["lo"], b["hi"])
            assert tk.launches == before + n
            got, plain = (got, plain) if sub else ((got,), (plain,))
            for g, p in zip(got, plain):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(p))
        frames0 = frames[:, 0].contiguous()
        space = make_mesh(devices=["cuda:0"] * n, space=2)
        np.testing.assert_array_equal(
            np.asarray(global_detect_batch(spec, space)(frames0, fills)),
            global_detect_batch(spec)(frames0, fills).cpu().numpy())


# ---- segments: S chained chunk scans a launch (group dispatch) ------------------------


def _segment_case(card, S, B, subpixel, rng):
    """S segments of T = 6 steps of B lanes on 90x110 frames, window 21: a
    disc a lane moving 2 px a step, random rebases and boxes, short segments
    (ks 3 and 1) and, for B > 1, a lane with no real step in segment 1; and
    the spec keywords."""
    T = 6
    h, w, spec = 90, 110, make_spec((90, 110), 21, 8, True)
    paths = [[(40 + 2 * t * (b % 2), 30 + 25 * b + 2 * t) for t in range(S * T)]
             for b in range(B)]
    frames = np.stack([ellipse_frames(h, w, p) for p in paths])  # [B, S*T, h, w]
    frames = np.ascontiguousarray(np.moveaxis(frames.reshape(B, S, T, h, w), 0, 1))
    b = random_bounds(rng, (S, B, T, 2), h, w)
    ks = np.tile(np.array([T, 3, T, 1][:S])[:, None], (1, B))
    if S > 1 and B > 1:
        ks[1, 1] = 0
    args = {k: torch.from_numpy(v.astype(np.int32)).to(card) for k, v in b.items()}
    args["ks"] = torch.from_numpy(ks.astype(np.int32)).to(card)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True, subpixel=subpixel)
    return torch.from_numpy(frames).to(card), args, kw, (h, w)


def _assert_same_out(got, want, subpixel):
    if subpixel:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("kernel", ["dog_scan", "dog_scan_tiled"])
def test_segments_equal_plain(card, monkeypatch, kernel, S, subpixel):
    """One segmented launch of each kernel equals its plain version bit for
    bit, in each chain across segments: one lane from the last row of each
    segment's real steps (ks, with short segments), 4 lanes with an absolute
    carry (a lane with ks = 0 keeps it; a start off the crop; the carry
    written over itself), 4 lanes on shared frames by the ks rule, and whole
    frames from the last step (no ks). dog_scan_tiled takes the window as
    the tiled fixture sends it there: 3 CTAs a lane."""
    if kernel == "dog_scan_tiled":
        monkeypatch.setattr(tk, "kernel_for", lambda radii, L, limit: "dog_scan_tiled")
        monkeypatch.setattr(tk, "tiled_cluster", None)
    rng = np.random.default_rng(40 + S)
    frames, a, kw, (h, w) = _segment_case(card, S, 4, subpixel, rng)
    fills = torch.tensor([128, 100, 160, 128], dtype=torch.uint8, device=card)
    box = dict(deltas=a["deltas"], lo=a["lo"], hi=a["hi"])
    before, before_k = tk.launches, tk.launches_by_kernel[kernel]
    # one lane, the ks rule
    pos0 = torch.tensor([40, 30], dtype=torch.int32, device=card)
    one = {k: v[:, 0].contiguous() for k, v in box.items()}
    got = tk.dog_scan_segments(frames[:, 0], pos0, 128, ks=a["ks"][:, 0].contiguous(), **one,
                               **kw)
    want = tk.dog_scan_segments_plain(frames[:, 0], pos0, 128, ks=a["ks"][:, 0].contiguous(),
                                      **one, **kw)
    _assert_same_out(got, want, subpixel)
    # 4 lanes, the absolute carry; lane 3 starts below its crop
    origin0 = torch.from_numpy(rng.integers(-20, 20, (S, 4, 2)).astype(np.int32)).to(card)
    origin_last = torch.from_numpy(rng.integers(-20, 20, (S, 4, 2)).astype(np.int32)).to(card)
    carry = torch.tensor([[40, 30], [40, 55], [40, 80], [h + 30, 105]], dtype=torch.int32,
                         device=card) + origin0[0]
    seg = dict(ks=a["ks"], origin0=origin0, origin_last=origin_last, **box, **kw)
    got, got_c = tk.dog_scan_batch_segments(frames, None, fills, carry=carry, **seg)
    want, want_c = tk.dog_scan_batch_segments_plain(frames, None, fills, carry=carry, **seg)
    _assert_same_out(got, want, subpixel)
    assert torch.equal(got_c, want_c)
    c = carry.clone()
    _, same = tk.dog_scan_batch_segments(frames, None, fills, carry=c, carry_out=c, **seg)
    assert same is c and torch.equal(c, want_c)
    # 4 lanes on shared frames (lane stride 0), the ks rule
    p4 = carry - origin0[0]
    shared = frames[:, 0].contiguous()
    got = tk.dog_scan_batch_segments(shared, p4, fills, ks=a["ks"], **box, **kw)
    want = tk.dog_scan_batch_segments_plain(shared, p4, fills, ks=a["ks"], **box, **kw)
    _assert_same_out(got, want, subpixel)
    # whole frames, unbounded: each segment from the last step
    got = tk.dog_scan_segments(frames[:, 1], pos0, 100, **kw)
    want = tk.dog_scan_segments_plain(frames[:, 1], pos0, 100, **kw)
    _assert_same_out(got, want, subpixel)
    torch.cuda.synchronize()
    assert tk.launches == before + 5 and tk.launches_by_kernel[kernel] == before_k + 5


def test_segments_equal_chunk_by_chunk(card):
    """S chunk launches chained on the host and one segmented launch give the
    same positions (the ks rule and the carry rule), so a group is the same
    work as its chunks."""
    rng = np.random.default_rng(9)
    S = 3
    frames, a, kw, _ = _segment_case(card, S, 4, False, rng)
    fills = torch.full((4,), 128, dtype=torch.uint8, device=card)
    origin0 = torch.from_numpy(rng.integers(-20, 20, (S, 4, 2)).astype(np.int32)).to(card)
    origin_last = torch.from_numpy(rng.integers(-20, 20, (S, 4, 2)).astype(np.int32)).to(card)
    carry = torch.tensor([[40, 30], [40, 55], [40, 80], [40, 105]], dtype=torch.int32,
                         device=card) + origin0[0]
    got, got_c = tk.dog_scan_batch_segments(frames, None, fills, carry=carry, ks=a["ks"],
                                            origin0=origin0, origin_last=origin_last,
                                            deltas=a["deltas"], lo=a["lo"], hi=a["hi"], **kw)
    c = carry
    for s in range(S):
        out, c = tk.dog_scan_batch_segments(frames[s:s + 1], None, fills, carry=c,
                                            ks=a["ks"][s:s + 1], origin0=origin0[s:s + 1],
                                            origin_last=origin_last[s:s + 1],
                                            deltas=a["deltas"][s:s + 1], lo=a["lo"][s:s + 1],
                                            hi=a["hi"][s:s + 1], **kw)
        assert torch.equal(out[0], got[s])
    assert torch.equal(c, got_c)


def test_carry_in_launch_equals_chain_batch(card, monkeypatch):
    """With S = 1 the batched launch's own carry equals chain_batch's tensor
    ops on the card, and track_batch on ROI never runs chain_batch there."""
    from pawsometracker_tpu_torch import pipeline, track_batch
    from pawsometracker_tpu_torch.parallel.mesh import ShardedBatchTracker

    rng = np.random.default_rng(12)
    frames, a, kw, _ = _segment_case(card, 1, 4, False, rng)
    spec = make_spec((90, 110), 21, 8, True)
    tracker = ShardedBatchTracker(spec, device=card)
    fills = torch.full((4,), 128, dtype=torch.uint8, device=card)
    ks = torch.tensor([6, 0, 2, 1], dtype=torch.int32, device=card)
    o0 = torch.from_numpy(rng.integers(-20, 20, (4, 2)).astype(np.int32)).to(card)
    olast = torch.from_numpy(rng.integers(-20, 20, (4, 2)).astype(np.int32)).to(card)
    carry = torch.tensor([[40, 30], [40, 55], [40, 80], [40, 105]], dtype=torch.int32,
                         device=card) + o0
    out, want = pipeline.chain_batch(tracker.scan_bounded, frames[0], carry, ks,
                                     torch.from_numpy(pipeline.last_rows(ks.cpu(), 6)).to(card),
                                     o0, olast, fills, a["deltas"][0], a["lo"][0], a["hi"][0])
    got, got_c = tracker_fns(spec, card).scan_bounded_batch_super(
        frames, carry, fills, a["deltas"], a["lo"], a["hi"], ks[None], o0[None], olast[None])
    assert torch.equal(got[0], out) and torch.equal(got_c, want)

    def no_chain(*args, **kwargs):
        raise AssertionError("chain_batch ran on the card's path")

    monkeypatch.setattr(pipeline, "chain_batch", no_chain)
    clips, locs = _lane_clips()
    got = track_batch(clips, fps=24, target_width=8, window_size=21, stream="roi", roi_frames=4,
                      start_location=locs)
    want = track_batch(clips, fps=24, target_width=8, window_size=21, stream="full",
                       start_location=locs)
    for (_, ij), (_, ij_w) in zip(got, want):
        np.testing.assert_array_equal(ij, ij_w)


@pytest.mark.parametrize("pin", ["2", "4"])
def test_entry_points_group_on_card(card, caplog, monkeypatch, pin):
    """With PAWS_DISPATCH_GROUP set (the JAX package's pin, which the port
    does not read) each entry point on the card equals its run without it
    (offsets included), launches the snap plus one launch a dispatch (once a
    shard under a mesh), and never runs a plain version: track on ROI and on
    full frames, track_batch on ROI (and over 4 shards of cuda:0),
    track_multi on ROI."""
    from pawsometracker_tpu_torch import make_mesh, track_batch, track_multi
    from pawsometracker_tpu_torch.models import dog_tracker

    caplog.set_level(logging.DEBUG, logger="pawsometracker_tpu_torch")
    frames, path = _roi_clip()
    clips, locs = _lane_clips()
    two, targets = _two_targets()
    common = dict(fps=24, target_width=8, window_size=21, roi_frames=4, pipeline_depth=3)
    runs = {
        "track roi": lambda **k: track(frames, start_location=IJ(*path[0]), stream="roi",
                                       **common, **k),
        "track full": lambda **k: track(frames, start_location=IJ(*path[0]), stream="full",
                                        chunk_size=4, **common, **k),
        "track_batch roi": lambda **k: track_batch(clips, start_location=locs, stream="roi",
                                                   **common, **k),
        "track_batch roi x4": lambda **k: track_batch(
            clips, start_location=locs, stream="roi", mesh=make_mesh(devices=["cuda:0"] * 4),
            **common, **k),
        "track_multi roi": lambda **k: track_multi(two, targets, stream="roi", **common, **k),
    }

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on the card's path")

    for name, run in runs.items():
        for subpixel in (False, True):
            monkeypatch.delenv("PAWS_DISPATCH_GROUP", raising=False)
            want = run(subpixel=subpixel)
            with monkeypatch.context() as m:
                m.setenv("PAWS_DISPATCH_GROUP", pin)
                for mod in (tk, dog_tracker):
                    for fn in ("dog_scan_plain", "dog_scan_batch_plain", "dog_scan_segments_plain",
                               "dog_scan_batch_segments_plain"):
                        m.setattr(mod, fn, no_plain, raising=False)
                caplog.clear()
                tk.reset_launches()
                got = run(subpixel=subpixel)
                torch.cuda.synchronize()
                stats = _roi_stats(caplog)
            shards = stats.get("shards", 1)
            snaps = 1
            if name == "track full":  # one launch a chunk
                dispatches = -(-(len(frames) - 1) // 4)
                assert stats["groups"] == dispatches
            else:
                dispatches = stats["dispatches"]
                assert stats["groups"] == dispatches and "group" not in stats
            assert tk.launches == shards * (snaps + dispatches), name
            pairs = list(zip(got, want)) if name.startswith("track_batch") else [(got, want)]
            for (ts, ij), (ts_w, ij_w) in pairs:
                np.testing.assert_array_equal(ts, ts_w)
                if subpixel:
                    np.testing.assert_allclose(ij, ij_w, rtol=0, atol=1e-3)
                else:
                    np.testing.assert_array_equal(ij, ij_w)


# ---- the measured engine choice: either kernel by name, off-frame starts, the chooser ----


def _textured_lanes(B, T, h, w, seed):
    """B lanes of T frames: a dark disc of radius 8 a lane moving 3 px a step
    on 128-gray with faint blobs and noise; and each lane's path."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    paths = [[(h // 2 - 10 + 5 * b + 3 * t, w // 2 - 20 + 3 * t) for t in range(T)]
             for b in range(B)]
    frames = np.empty((B, T, h, w), np.uint8)
    for b in range(B):
        base = 128.0 + rng.normal(0, 3, (h, w))
        for i, j, d in zip(rng.uniform(0, h, 40), rng.uniform(0, w, 40), rng.uniform(5, 30, 40)):
            base -= d * np.exp(-((yy - i) ** 2 + (xx - j) ** 2) / 18.0)
        for t, (i, j) in enumerate(paths[b]):
            img = base.copy()
            img[(yy - i) ** 2 + (xx - j) ** 2 <= 64] = 30
            frames[b, t] = np.clip(np.round(img), 0, 255)
    return frames, paths


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("window,crop", [(41, 185), (77, 241)])
def test_either_kernel_by_name_equals_plain(card, window, crop, lanes, S, subpixel):
    """Windows that both kernels take (41x41 on the bench shape's 185x185 ROI
    crop, and 77x77 at the same L = 65): each named kernel's bounded scan
    equals the plain version bit for bit, launching that kernel, for one lane
    and 4, one chunk and 2 chained segments (the batched chain's carry in the
    launch). The shape rule takes dog_scan at 41x41 and dog_scan_tiled at
    77x77 (too large for one CTA whole); dog_scan_tiled runs here on
    one-register-block tiles (7 rows) over a cluster of 6 and 11 CTAs."""
    T, h = 12, crop
    spec = make_spec((h, h), window, 25, True)
    limit = tk._smem_limit(0)
    assert tk.kernels_for(spec.radii, spec.kernel_len, limit) == (
        tk.KERNELS if window == 41 else tk.KERNELS[::-1])
    assert tk.tile_plan(spec.radii, spec.kernel_len, limit, subpixel).tiles == (
        {41: 6, 77: 11}[window], 1)
    rng = np.random.default_rng(window + 10 * lanes + S)
    frames, paths = _textured_lanes(lanes, S * T, h, h, window)
    frames = np.ascontiguousarray(np.moveaxis(frames.reshape(lanes, S, T, h, h), 0, 1))
    b = random_bounds(rng, (S, lanes, T, 2), h, h)
    arg = {k: torch.from_numpy(v.astype(np.int32)).to(card) for k, v in b.items()}
    fr = torch.from_numpy(frames).to(card)
    fills = torch.tensor([128, 100, 160, 128][:lanes], dtype=torch.uint8, device=card)
    starts = torch.tensor([p[0] for p in paths], dtype=torch.int32, device=card)
    ks = torch.full((S, lanes), T, dtype=torch.int32, device=card)
    origin0 = torch.from_numpy(rng.integers(-8, 8, (S, lanes, 2)).astype(np.int32)).to(card)
    origin_last = torch.from_numpy(rng.integers(-8, 8, (S, lanes, 2)).astype(np.int32)).to(card)

    def run(fns):
        if S == 1 and lanes == 1:
            scan = fns.scan_sub if subpixel else fns.scan_bounded
            return scan(fr[0, 0], starts[0], 128, arg["deltas"][0, 0], arg["lo"][0, 0],
                        arg["hi"][0, 0])
        if S == 1:
            scan = fns.scan_sub_batch if subpixel else fns.scan_bounded_batch
            return scan(fr[0], starts, fills, arg["deltas"][0], arg["lo"][0], arg["hi"][0])
        if lanes == 1:
            return fns.scan_bounded_super(fr[:, 0], starts[0], 128, arg["deltas"][:, 0],
                                          arg["lo"][:, 0], arg["hi"][:, 0], ks[:, 0],
                                          subpixel=subpixel)
        return fns.scan_bounded_batch_super(fr, starts + origin0[0], fills, arg["deltas"],
                                            arg["lo"], arg["hi"], ks, origin0, origin_last,
                                            subpixel=subpixel)

    want = run(tracker_fns(spec, card, "xla"))
    for kernel in tk.KERNELS:
        before = tk.launches_by_kernel[kernel]
        got = run(tracker_fns(spec, card, "pallas", kernel=kernel))
        torch.cuda.synchronize()
        assert tk.launches_by_kernel[kernel] == before + 1
        if S > 1 and lanes > 1:
            (got, got_c), (w_out, want_c) = got, want
            assert torch.equal(got_c, want_c)
        else:
            w_out = want
        _assert_same_out(got, w_out, subpixel)


OFF_FRAME_STARTS = [(-1, 50), (-3, 50), (-8, 50), (50, -4), (-5, -5), (103, 50), (50, 104)]


@pytest.mark.parametrize("kernel", ["dog_scan", "dog_scan_tiled"])
def test_off_frame_starts_equal_plain(card, kernel):
    """Both kernels follow the port's rule for a start off the frame (the
    patch read at the start clamped into the frame, the argmax mapped back
    from the start as given): the plain version's positions at the starts of
    tests/test_torch_offframe.py, on its disc clip and on textured frames,
    one lane (unbounded and bounded) and all starts as lanes of one launch."""
    h = w = 100
    spec = make_spec((h, w), 21, 10, True)
    yy, xx = np.mgrid[:h, :w]
    disc = np.full((4, h, w), 128, np.uint8)
    for t in range(4):
        disc[t][(yy - 8) ** 2 + (xx - 50 - t) ** 2 <= 36] = 30
    textured = _textured_lanes(1, 4, h, w, 3)[0][0]
    fns, plain = tracker_fns(spec, card, "pallas", kernel=kernel), tracker_fns(spec, card, "xla")
    rng = np.random.default_rng(4)
    b = {k: torch.from_numpy(v.astype(np.int32)).to(card)
         for k, v in random_bounds(rng, (4, 2), h, w).items()}
    for frames in (disc, textured):
        fr = torch.from_numpy(frames).to(card)
        for start in OFF_FRAME_STARTS:
            p0 = torch.tensor(start, dtype=torch.int32, device=card)
            assert torch.equal(fns.scan(fr, p0, 128), plain.scan(fr, p0, 128)), start
            bounded = (fr, p0, 128, b["deltas"], b["lo"], b["hi"])
            assert torch.equal(fns.scan_bounded(*bounded), plain.scan_bounded(*bounded)), start
            _assert_same_out(fns.scan_sub(*bounded), plain.scan_sub(*bounded), True)
        starts = torch.tensor(OFF_FRAME_STARTS, dtype=torch.int32, device=card)
        fills = torch.full((len(OFF_FRAME_STARTS),), 128, dtype=torch.uint8, device=card)
        assert torch.equal(fns.scan_multi(fr, starts, 128), plain.scan_multi(fr, starts, 128))
        lanes = fr[None].expand(len(OFF_FRAME_STARTS), -1, -1, -1).contiguous()
        assert torch.equal(fns.scan_batch(lanes, starts, fills), plain.scan_batch(lanes, starts,
                                                                                  fills))


def test_chooser_on_card(card, tmp_path, monkeypatch):
    """pick_bounded_engine on the bench shape's ROI geometry (185x185 crop,
    41x41 window, K = 12), one chain with and without subpixel and 4 lanes:
    both kernels measured and pinned to the plain version on the three probe
    inputs; the probe's launches counted apart from the launch counts; the
    decision kept for the process and in the file, which a fresh session
    reads without measuring; and the ROI path of track() launching the chosen
    kernel, equal to engine="pallas"."""
    from pawsometracker_tpu_torch import pipeline

    monkeypatch.setenv("PAWSOMETRACKER_CACHE", str(tmp_path))
    monkeypatch.setattr(pipeline, "_session_engine_cache", {})
    spec = make_spec((185, 185), 41, 25, True)
    tk.reset_launches()
    picks = [pipeline.pick_bounded_engine(spec, 12, 128), pipeline.pick_bounded_engine(
        spec, 12, 128, subpixel=True), pipeline.pick_bounded_engine_batch(spec, 12, 4, 128)]
    assert tk.launches == 0
    # each kernel: a warm-up and 3 timed runs on the blob, one run on each tie input
    assert dict(tk.probe_launches) == {"dog_scan": 3 * 6, "dog_scan_tiled": 3 * 6}
    for eng, info in picks:
        assert eng == "pallas" and info["parity"] and info["tie_parity"], info
        assert info["kernel"] in tk.KERNELS and info["default"] == "dog_scan", info
        assert info["dog_scan_ms"] > 0 and info["dog_scan_tiled_ms"] > 0 and info["xla_ms"] > 0
    assert pipeline.pick_bounded_engine(spec, 12, 128) == picks[0]
    monkeypatch.setattr(pipeline, "_session_engine_cache", {})
    assert pipeline.pick_bounded_engine(spec, 12, 128) == picks[0]
    assert sum(tk.probe_launches.values()) == 36  # nothing measured again
    with open(tmp_path / "engine_cache_torch.json") as f:
        assert len(json.load(f)) == 3


def test_roi_auto_launches_the_chosen_kernel(card, caplog, tmp_path, monkeypatch):
    """track() on ROI with engine="auto" launches the kernel the chooser chose
    for its crop, once a dispatch, and equals engine="pallas" (the shape
    rule) and the CPU run; the chooser's probe adds no launch to the counts."""
    from pawsometracker_tpu_torch import pipeline

    monkeypatch.setenv("PAWSOMETRACKER_CACHE", str(tmp_path))
    monkeypatch.setattr(pipeline, "_session_engine_cache", {})
    caplog.set_level(logging.DEBUG, logger="pawsometracker_tpu_torch")
    frames, path = _roi_clip()
    kw = dict(fps=24, start_location=IJ(*path[0]), target_width=8, window_size=21,
              stream="roi", roi_frames=4, pipeline_depth=2)
    tk.reset_launches()
    _, ij = track(frames, **kw)
    stats = _roi_stats(caplog)
    [info] = pipeline._session_engine_cache.values()
    assert sum(tk.probe_launches.values()) > 0
    assert tk.launches == 1 + stats["dispatches"]
    assert tk.launches_by_config[f"{info['kernel']}: bounded"] == stats["dispatches"]
    np.testing.assert_array_equal(ij, track(frames, engine="pallas", **kw)[1])
    np.testing.assert_array_equal(ij, track(frames, device="cpu", **kw)[1])


# ---- the ROI path's host work: the native crop and the staged scans ------------------


#: crop origins at every edge and corner of a 1080p frame, and wholly outside it
CROP_ORIGINS = {"inside": (400, 700), "top": (-60, 700), "bottom": (1000, 700),
                "left": (400, -90), "right": (400, 1850), "top-left": (-30, -40),
                "top-right": (-30, 1800), "bottom-left": (990, -12),
                "bottom-right": (1020, 1890), "outside": (-600, 2500), "below": (1200, 30)}


@pytest.mark.parametrize("crop", [185, 461])
@pytest.mark.parametrize("K", [1, 12])
def test_native_crop_equals_numpy(card, crop, K):
    """The native chunk crop (csrc/roi_crop.cpp) equals the numpy one on the
    same frames, origins and fills, byte for byte: lanes with every count
    (none, short, full), origins at every edge and corner and wholly outside
    the frame, frames as views of one array and as copies, on one thread and
    on the pool's."""
    from pawsometracker_tpu_torch.ops import roi_crop

    rng = np.random.default_rng(crop + K)
    frames = rng.integers(0, 256, (K + 3, 1080, 1920), dtype=np.uint8)
    names = list(CROP_ORIGINS)
    L = len(names)
    origins = np.array([[np.add(CROP_ORIGINS[n], (i, -2 * i)) for i in range(K)] for n in names])
    counts = [(b % (K + 1)) if b % 3 else K for b in range(L)]
    fills = rng.integers(0, 256, L, dtype=np.uint8)
    chunks = [frames[b % 3:] if b % 2 else np.ascontiguousarray(frames[b % 3:b % 3 + K])
              for b in range(L)]
    want = np.empty((L, K, crop, crop), np.uint8)
    roi_crop.crop_lanes_plain(chunks, counts, origins, fills, want)
    for threads in (1, roi_crop.THREADS, 8):
        got = np.full((L, K, crop, crop), 7, np.uint8)
        before = roi_crop.native_calls
        roi_crop.crop_lanes_native(chunks, counts, origins, fills, got, threads=threads)
        assert roi_crop.native_calls == before + 1
        np.testing.assert_array_equal(got, want)


def _staged_buffers(dev, cap, lanes, K, crop, rng):
    """A device group's buffer as the ROI engines lay it out (crops, then the
    int32 arguments in one row a segment), filled with blobs and the boxes of
    each crop."""
    from pawsometracker_tpu_torch import pipeline

    n_args = (6 * lanes * K + 7 * lanes) if lanes > 1 else 6 * K + 4
    n, at = pipeline._crop_bytes((lanes, K, crop, crop))
    raw = torch.empty((cap, at + 4 * n_args), dtype=torch.uint8, device=dev)
    frames = raw[:, :n].view(cap, lanes, K, crop, crop)
    args = raw[:, at:].view(torch.int32)
    args.zero_()
    frames.copy_(torch.from_numpy(ellipse_frames(crop, crop, [
        (int(crop // 2 + 9 * np.sin(t)), int(crop // 2 + 9 * np.cos(t)))
        for t in range(cap * lanes * K)]).reshape(cap, lanes, K, crop, crop)))
    return frames, args


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("lanes", [1, 4])
def test_staged_scan_equals_the_wrapper(card, subpixel, lanes):
    """The ROI engines' staged scan (StagedScan, checked once over a device
    group's buffers) launches what the public segmented wrappers launch on the
    same views, for every S up to the group's room: equal positions and
    offsets, equal carry, and the same launch counts by configuration."""
    from pawsometracker_tpu_torch import pipeline

    rng = np.random.default_rng(lanes)
    cap, K, crop = 4, 12, 185
    spec = make_spec((crop, crop), (41, 41), 25, True)
    fns = tracker_fns(spec, card, "pallas")
    frames, args = _staged_buffers(card, cap, lanes, K, crop, rng)
    if lanes == 1:
        a = pipeline._single_args(args, K)
        a.hi[...] = crop - 1
        a.ks[...] = torch.tensor([12, 5, 12, 9], dtype=torch.int32)
        staged = fns.scan_bounded_super.stage(frames[:, 0], 128, a.deltas, a.lo, a.hi, a.ks,
                                              subpixel=subpixel)
        pos0 = torch.tensor([90, 95], dtype=torch.int32, device=card)
        for S in range(1, cap + 1):
            tk.reset_launches()
            got = staged.run(S, pos0=pos0)
            got = tuple(g.clone() for g in got) if subpixel else got.clone()
            counts = dict(tk.launches_by_config)
            tk.reset_launches()
            if S == 1:
                want = fns.scan_sub(frames[0, 0], pos0, 128, a.deltas[0], a.lo[0], a.hi[0]) \
                    if subpixel else fns.scan_bounded(frames[0, 0], pos0, 128, a.deltas[0],
                                                      a.lo[0], a.hi[0])
                want = tuple(w[None] for w in want) if subpixel else want[None]
            else:
                want = fns.scan_bounded_super(frames[:S, 0], pos0, 128, a.deltas[:S], a.lo[:S],
                                              a.hi[:S], a.ks[:S], subpixel=subpixel)
            assert counts == dict(tk.launches_by_config)
            for g, w in zip(*((got, want) if subpixel else ((got,), (want,)))):
                np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
        return
    a = pipeline._batch_args(args, lanes, K)
    a.hi[...] = crop - 1
    a.ks[...] = torch.from_numpy(rng.integers(0, K + 1, (cap, lanes)).astype(np.int32))
    a.origin0[...] = torch.from_numpy(rng.integers(-5, 5, (cap, lanes, 2)).astype(np.int32))
    a.origin_last[...] = a.origin0
    fills = torch.tensor([128, 100, 160, 128], dtype=torch.uint8, device=card)
    staged = fns.scan_bounded_batch_super.stage(frames, fills, a.deltas, a.lo, a.hi, a.ks,
                                                a.origin0, a.origin_last, subpixel=subpixel)
    for S in range(1, cap + 1):
        carry = torch.tensor([[90, 95]] * lanes, dtype=torch.int32, device=card)
        carry_w = carry.clone()
        tk.reset_launches()
        got = staged.run(S, carry=carry, carry_out=carry)
        got = tuple(g.clone() for g in got) if subpixel else got.clone()
        counts = dict(tk.launches_by_config)
        tk.reset_launches()
        want, _ = fns.scan_bounded_batch_super(frames[:S], carry_w, fills, a.deltas[:S],
                                               a.lo[:S], a.hi[:S], a.ks[:S], a.origin0[:S],
                                               a.origin_last[:S], carry_out=carry_w,
                                               subpixel=subpixel)
        assert counts == dict(tk.launches_by_config)
        np.testing.assert_array_equal(carry.cpu().numpy(), carry_w.cpu().numpy())
        for g, w in zip(*((got, want) if subpixel else ((got,), (want,)))):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def test_staged_scan_refuses_buffers_the_kernel_does_not_take(card):
    """The staged scan checks its buffers once, when it is made: arguments
    that are not views of one buffer with one segment stride, or of another
    type, raise the wrapper's ValueError there."""
    cap, K, crop = 2, 12, 61
    spec = make_spec((crop, crop), (21, 21), 10, True)
    fns = tracker_fns(spec, card, "pallas")
    frames = torch.full((cap, K, crop, crop), 128, dtype=torch.uint8, device=card)
    box = torch.zeros((cap, K, 2), dtype=torch.int32, device=card)
    ks = torch.full((cap,), K, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="one buffer"):
        fns.scan_bounded_super.stage(frames, 128, box, box.clone(), box.clone(), ks)
    with pytest.raises(ValueError, match="int32"):
        fns.scan_bounded_super.stage(frames, 128, box.float(), box, box, ks)
    with pytest.raises(ValueError, match="shape"):
        fns.scan_bounded_super.stage(frames, 128, box[:, :5], box, box, ks)


@pytest.mark.parametrize("entry", ["track", "track_batch", "track_multi"])
def test_roi_paths_equal_full_on_card(card, caplog, entry):
    """Each ROI path on the card (the native crop, the one-copy staging and
    the staged scans) gives the positions of stream="full": the chunks are
    cropped natively, one call a chunk, and every chunk is one launch."""
    from pawsometracker_tpu_torch import track_batch, track_multi
    from pawsometracker_tpu_torch.ops import roi_crop

    caplog.set_level(logging.DEBUG, logger="pawsometracker_tpu_torch")
    kw = dict(fps=24, target_width=8, window_size=21, roi_frames=4, pipeline_depth=2)
    clips, locs = _lane_clips()
    frames, targets = _two_targets()
    run = {"track": lambda **k: track(clips[0], start_location=locs[0], **kw, **k),
           "track_batch": lambda **k: track_batch(clips, start_location=locs, **kw, **k),
           "track_multi": lambda **k: track_multi(frames, targets, **kw, **k)}[entry]
    before = roi_crop.native_calls
    tk.reset_launches()
    got = run(stream="roi")
    stats = _roi_stats(caplog)
    assert stats["stream"] == "roi"
    assert tk.launches == 1 + stats["dispatches"]
    assert roi_crop.native_calls - before >= stats["dispatches"]
    want = run(stream="full")
    pairs = list(zip(got, want)) if entry == "track_batch" else [(got, want)]
    for (ts, ij), (ts_f, ij_f) in pairs:
        np.testing.assert_array_equal(ts, ts_f)
        np.testing.assert_array_equal(ij, ij_f)


def test_native_crop_from_threads_at_once(card):
    """Eight Python threads, more than the card machine's cores left to the
    pool, each cutting 4-lane 461x461 chunks (so each call takes the pool)
    60 times at once: every chunk equals the numpy crop, and every thread
    ends within its time."""
    import threading

    from pawsometracker_tpu_torch.ops import roi_crop

    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (16, 1080, 1920), dtype=np.uint8)
    failures, done = [], []

    def cut(seed):
        r = np.random.default_rng(seed)
        out = np.empty((4, 12, 461, 461), np.uint8)
        want = np.empty_like(out)
        for _ in range(60):
            origins = r.integers(-500, 1900, (4, 12, 2))
            counts = r.integers(0, 13, 4)
            fills = r.integers(0, 256, 4).astype(np.uint8)
            chunks = [frames[b:] for b in range(4)]
            roi_crop.crop_lanes_native(chunks, counts, origins, fills, out)
            roi_crop.crop_lanes_plain(chunks, counts, origins, fills, want)
            if not np.array_equal(out, want):
                failures.append(seed)
        done.append(seed)

    threads = [threading.Thread(target=cut, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and sorted(done) == list(range(8))
    assert not failures


# ---- full frames staged through the prefetcher's pinned rings ----------------------------


def _full_clip(n, h=120, w=160, phase=0.0):
    return ellipse_frames(h, w, [(60 + round(25 * np.sin(t / 9 + phase)),
                                  80 + round(40 * np.cos(t / 9 + phase))) for t in range(n)])


FULL_INPUTS = {
    "views from frame 0": dict(),
    "views from an on-grid start past 0": dict(start=19 / 24),
    "a resampled array (written into the ring)": dict(input_fps=30.0),
    "an RGB array (written into the ring)": dict(rgb=True),
}


@pytest.mark.parametrize("inputs", list(FULL_INPUTS))
@pytest.mark.parametrize("entry", ["track", "track_batch", "track_multi"])
def test_staged_full_frames_equal_cpu(card, monkeypatch, entry, inputs):
    """stream="full" on the card, every chunk staged by the prefetcher into
    its pinned ring (views copied in natively, decoded or resampled frames
    written there by the source), the short last chunk padded on the card:
    positions and ts equal to device="cpu", with the plain version never run.
    track_batch has a video that ends early."""
    from pawsometracker_tpu_torch import track_batch, track_multi
    from pawsometracker_tpu_torch.ops import roi_crop

    opts = dict(FULL_INPUTS[inputs])
    rgb = opts.pop("rgb", False)
    clips = [_full_clip(75 - 20 * b, phase=b) for b in range(3)]
    if rgb:
        clips = [np.repeat(c[..., None], 3, axis=-1) for c in clips]
    kw = dict(fps=24, target_width=10, chunk_size=16, stream="full", **opts)
    if entry == "track":
        call = lambda **k: track(clips[0], start_location=None, **kw, **k)  # noqa: E731
    elif entry == "track_batch":
        call = lambda **k: track_batch(clips, start_location=None, **kw, **k)  # noqa: E731
    else:
        two = np.minimum(clips[0], np.roll(clips[0], 40, axis=2))
        call = lambda **k: track_multi(two, n_targets=2, **kw, **k)  # noqa: E731
    want = call(device="cpu")
    forbid_plain(monkeypatch)
    before = roi_crop.copy_calls
    got = call()
    views = not rgb and "input_fps" not in opts
    assert (roi_crop.copy_calls > before) == views
    for (ts, ij), (ts_c, ij_c) in zip(*((g,) if entry != "track_batch" else g
                                        for g in (got, want))):
        np.testing.assert_array_equal(ts, ts_c)
        np.testing.assert_array_equal(ij, ij_c)


ARRAY_LAYOUTS = {
    "mirrored columns": lambda f: f[:, :, ::-1],
    "Fortran order": np.asfortranarray,
    "mirrored rows": lambda f: f[:, ::-1],
    "frames in reverse": lambda f: f[::-1],
}


@pytest.mark.parametrize("start", [0.0, 19 / 24], ids=["start 0", "start past 0"])
@pytest.mark.parametrize("layout", list(ARRAY_LAYOUTS))
@pytest.mark.parametrize("stream", ["full", "roi"])
@pytest.mark.parametrize("entry", ["track", "track_batch"])
def test_array_layouts_equal_cpu(card, entry, stream, layout, start):
    """Arrays whose columns do not lie 1 byte apart (mirrored, Fortran-ordered)
    walk the resampler into the rings or the ROI crops' buffers; arrays with
    rows or frames in reverse order are served as views that the native copy
    and crop read with their strides. Each equals device="cpu"."""
    from pawsometracker_tpu_torch import track_batch

    clips = [ARRAY_LAYOUTS[layout](_full_clip(60 - 15 * b, phase=b)) for b in range(2)]
    kw = dict(fps=24, target_width=10, chunk_size=16, stream=stream, start=start,
              start_location=None)
    if entry == "track":
        got, want = [track(clips[0], **kw)], [track(clips[0], device="cpu", **kw)]
    else:
        got, want = track_batch(clips, **kw), track_batch(clips, device="cpu", **kw)
    for (ts, ij), (ts_c, ij_c) in zip(got, want):
        np.testing.assert_array_equal(ts, ts_c)
        np.testing.assert_array_equal(ij, ij_c)


#: the staging copy's sources, cut from a [70, H, W] array ``f``, a wider one
#: ``w`` and a flat buffer ``b``, each with the form it takes
H, W = 1080, 1920
FRAME_COPY_SOURCES = {
    "64 of a contiguous array": (lambda f, w, b: f[3:67], "block"),
    "one frame": (lambda f, w, b: f[5:6], "block"),
    "rows apart, 64 frames": (lambda f, w, b: f[2:66, :, :1918], "rows"),
    "rows apart, cut": (lambda f, w, b: f[4:20, 7:1000, 1:], "rows"),
    "frames apart": (lambda f, w, b: f[::2], "frames"),
    "frames in reverse": (lambda f, w, b: f[66:2:-1], "frames"),
    "mirrored rows": (lambda f, w, b: f[:, ::-1], "rows"),
    "1 byte off, column 1 of a wider array": (lambda f, w, b: w[:, :, 1:], "rows"),
    "1 byte off, a flat buffer": (lambda f, w, b: b[1:1 + 48 * H * W].reshape(48, H, W), "block"),
    "width 1917": (lambda f, w, b: b[3:3 + 48 * H * 1917].reshape(48, H, 1917), "block"),
    "width 1000, rows apart": (lambda f, w, b: f[:, :, 500:1500], "rows"),
    "k 1, mirrored rows": (lambda f, w, b: f[9:10, ::-1], "rows"),
    "k 48": (lambda f, w, b: f[10:58], "block"),
    "k 64, mirrored rows": (lambda f, w, b: f[3:67, ::-1], "rows"),
}


@pytest.fixture(scope="module")
def copy_sources():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 256, (70, H, W), dtype=np.uint8),
            rng.integers(0, 256, (48, H, W + 5), dtype=np.uint8),
            rng.integers(0, 256, 48 * H * W + 64, dtype=np.uint8))


@pytest.mark.parametrize("threads", ["1", "pool"])
@pytest.mark.parametrize("source", list(FRAME_COPY_SOURCES))
def test_native_frame_copy_equals_numpy(card, copy_sources, source, threads):
    """The staging copy (csrc/roi_crop.cpp's copy_frames) equals the frames
    it copies, on one thread and on the pool's, in the form the strides
    allow (the counter records it), into a destination that is a view of a
    larger buffer at an odd offset, whose guard bytes stay untouched."""
    from pawsometracker_tpu_torch.ops import roi_crop

    cut, form = FRAME_COPY_SOURCES[source]
    src = cut(*copy_sources)
    guard = 3
    big = np.full(src.size + guard + 64, 7, np.uint8)
    dst = big[guard:guard + src.size].reshape(src.shape)
    before, forms = roi_crop.copy_calls, dict(roi_crop.copy_forms)
    got = roi_crop.copy_frames_native(src, dst, threads=1 if threads == "1" else roi_crop.THREADS)
    assert got == form
    assert roi_crop.copy_calls == before + 1
    assert roi_crop.copy_forms == {**forms, form: forms[form] + 1}
    np.testing.assert_array_equal(dst, src)
    assert (big[:guard] == 7).all() and (big[guard + src.size:] == 7).all()


class _Refusing:
    """A native library whose crop and staging copy refuse every call."""

    class roi_crop_lanes:  # noqa: N801  (the C function's name)
        def __new__(cls, *a):
            return 1

    class copy_frames:  # noqa: N801  (the C function's name)
        def __new__(cls, *a):
            return -1


@pytest.mark.parametrize("entry", ["track", "track_batch"])
def test_staging_copy_that_fails_raises_on_card(card, monkeypatch, entry):
    """No fallback: a native staging copy that the library refuses raises
    from the call; it never gives way to numpy's copy on the card."""
    from pawsometracker_tpu_torch import track_batch
    from pawsometracker_tpu_torch.ops import roi_crop

    monkeypatch.setattr(roi_crop, "_lib", lambda: _Refusing)
    clips = [_full_clip(40), _full_clip(40, phase=1.0)]
    kw = dict(fps=24, target_width=10, chunk_size=16, stream="full", start_location=None)
    with pytest.raises(ValueError, match="refused"):
        if entry == "track":
            track(clips[0], **kw)
        else:
            track_batch(clips, **kw)


def test_staging_buffers_wait_for_their_copy_on_card(card, monkeypatch):
    """A slow side stream (every staged copy held back by a sleep on the card)
    and a pipeline 3 deep: a ring buffer refilled before its copy to the card
    had completed would change the positions."""
    from pawsometracker_tpu_torch import pipeline

    stage = pipeline._FullFrameEngine._stage

    def slow_stage(self, chunks, T):
        if self._cuda:
            with torch.cuda.stream(self._copy_stream):
                torch.cuda._sleep(400_000)
        return stage(self, chunks, T)

    monkeypatch.setattr(pipeline._FullFrameEngine, "_stage", slow_stage)
    frames = _full_clip(150)
    kw = dict(fps=24, target_width=10, chunk_size=8, stream="full", pipeline_depth=3,
              start_location=None)
    np.testing.assert_array_equal(track(frames, **kw)[1], track(frames, device="cpu", **kw)[1])


def test_spans_are_on_the_device_traces_clock(card):
    """In 100 of 100 tries a kernel launched inside a span starts, on the
    device trace a profiler session of CUDA activity gives (the benchmark's),
    after the span's start and less than 1 ms after its end: the spans'
    ``time.time_ns()`` is the trace's clock, with no offset to calibrate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pawsometracker_tpu_torch.utils.profiling import Timer

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timer = Timer()
        for i in range(100):
            with timer.span("launch", i=i):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
        timer.finish(stats := {})
    spans = sorted((s for s in stats["spans"] if s.name == "launch"), key=lambda s: s.attrs["i"])

    def start_ns(e):
        return int(e.start_ns()) if hasattr(e, "start_ns") else int(e.start_us()) * 1000

    kernels = sorted(start_ns(e) for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
    assert len(spans) == len(kernels) == 100
    late = [k - s.end_ns for s, k in zip(spans, kernels)]
    assert all(s.start_ns <= k for s, k in zip(spans, kernels))
    assert max(late) < 1_000_000, max(late)
