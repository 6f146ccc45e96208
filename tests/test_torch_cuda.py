"""Card-only tests of the port's CUDA kernel: each is marked ``cuda`` and skips
itself without a card. This file imports no JAX, so it runs on a machine
with the card and without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from pawsometracker_tpu_torch import IJ, track
from pawsometracker_tpu_torch.models.dog_tracker import make_spec
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


def check(card, frames, p0, spec_radii, sigma, subpixel=False, bounds=None, fill=128):
    kw = dict(radii=spec_radii, sigma=sigma, darker_target=True)
    fr = torch.from_numpy(frames).to(card)
    pos0 = torch.tensor(p0, dtype=torch.int32, device=card)
    b = {} if bounds is None else {k: torch.from_numpy(v.astype(np.int32)).to(card)
                                   for k, v in bounds.items()}
    before = tk.launches
    got = tk.dog_scan(fr, pos0, fill, subpixel=subpixel, **kw, **b)
    assert tk.launches == before + 1
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
def test_tiled_windows_equal_plain(card, window):
    """Windows larger than one output tile (64x128) are walked in tiles."""
    h, w = 200, 360
    spec = make_spec((h, w), window, 10, True)
    frames = ellipse_frames(h, w, [(90, 170)])
    check(card, frames, (100, 180), spec.radii, spec.sigma)
    check(card, frames, (100, 180), spec.radii, spec.sigma, subpixel=True)


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
