"""The DoG tracker written out plainly in NumPy: the benchmark's reference.

It follows the upstream tracker (PawsomeTracker.jl, ``src/PawsomeTracker.jl``):
``target_width`` is the FWHM of the centre Gaussian; the filter is the
difference of two unit-sum truncated Gaussians, the surround's sigma
``sqrt(2)`` times the centre's, on ``4*ceil(sigma_surround)+1`` taps, negated
for a target darker than the background; frame 1 is snapped from the start
guess (a quarter-frame window about the frame centre when there is no start
location); every later frame takes, in a window about the last position, the
first maximum of the response in column-major order, clamped to the frame.
Cells outside the frame take the mode of frame 1, ties going to the value
whose last counted occurrence comes first in column-major order.

Arithmetic: each response value is the float32 sum of the taps' products in
tap order, rows first, then columns, each product added with one rounding
(a fused multiply-add), which decides ties. :func:`response_f32` emulates
that exactly in float64 (a frozen copy of the rounding-to-odd FMA). It costs
some 20 ms a window, so :func:`track` first computes every window in float64
by banded matrix products (error far below 1e-9 of the values) and keeps that
argmax wherever no other cell of the window comes within the float32 sums'
proven error bound of the maximum; only the other windows are emulated.

This module imports NumPy alone: nothing of the measured program.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["FWHM_TO_SIGMA", "taps", "default_window", "mode_u8", "extract_patches",
           "response_f32", "response_f64", "argmax_colmajor", "fma_f32", "track",
           "timestamps", "MAX_DURATION_S"]

FWHM_TO_SIGMA = 2.0 * math.sqrt(2.0 * math.log(2.0))
#: the upstream default stop: 24 hours less a millisecond
MAX_DURATION_S = 86399.999
#: float32 unit roundoff
U32 = 2.0 ** -24


def _gaussian_1d(sigma: float, length: int) -> np.ndarray:
    half = length // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def taps(target_width: float, darker_target: bool):
    """``(taps float32 [2, L] = centre, surround; direction; L)``."""
    sigma = target_width / FWHM_TO_SIGMA
    surround = sigma * math.sqrt(2.0)
    L = 4 * math.ceil(surround) + 1
    g = np.stack([_gaussian_1d(sigma, L), _gaussian_1d(surround, L)]).astype(np.float32)
    return g, (-1.0 if darker_target else 1.0), L


def default_window(target_width: float) -> int:
    """The upstream default window edge: ``4*ceil(sigma)+1`` of the centre sigma."""
    return 4 * math.ceil(target_width / FWHM_TO_SIGMA) + 1


def mode_u8(frame: np.ndarray) -> int:
    """Most common value of a uint8 frame; on a tie, the value whose
    ``count``-th occurrence comes first in column-major order."""
    flat = np.asarray(frame, np.uint8).ravel(order="F")
    counts = np.bincount(flat, minlength=256)
    tied = np.flatnonzero(counts == counts.max())
    if tied.size == 1:
        return int(tied[0])
    k = int(counts.max())
    firsts = [int(np.flatnonzero(flat == v)[k - 1]) for v in tied]
    return int(tied[int(np.argmin(firsts))])


def extract_patches(frames, pos: np.ndarray, radii, L: int, fills) -> np.ndarray:
    """``uint8 [B, ph, pw]``: lane b's patch of ``frames[b]`` (``[H, W]``)
    about ``pos[b]``, the window plus the taps' apron; cells outside the
    frame take ``fills[b]``. The position is clamped to the frame first."""
    ri, rj = int(radii[0]), int(radii[1])
    ph, pw = 2 * ri + L, 2 * rj + L
    out = np.empty((len(frames), ph, pw), np.uint8)
    for b, f in enumerate(frames):
        H, W = f.shape
        i0 = min(max(int(pos[b, 0]), 0), H - 1) - ri - L // 2
        j0 = min(max(int(pos[b, 1]), 0), W - 1) - rj - L // 2
        if i0 >= 0 and j0 >= 0 and i0 + ph <= H and j0 + pw <= W:
            out[b] = f[i0:i0 + ph, j0:j0 + pw]
            continue
        out[b] = fills[b]
        a, c = max(i0, 0), max(j0, 0)
        e, g = min(i0 + ph, H), min(j0 + pw, W)
        if a < e and c < g:
            out[b, a - i0:e - i0, c - j0:g - j0] = f[a:e, c:g]
    return out


def fma_f32(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``fma(a, b, acc)`` rounded once to float32. ``a`` and ``b`` are float64
    arrays holding float32 values, so their product is exact; the sum is
    rounded to odd in float64 (TwoSum, then the last bit forced to 1 where
    inexact), and rounding that to float32 is the correctly rounded result."""
    p = a * b
    c = acc.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(np.int64)
    even = (bits & 1) == 0
    away = (err > 0) == (s > 0)
    step = np.where(away, 1, -1) * ((err != 0) & even)
    return (bits + step).view(np.float64).astype(np.float32)


def response_f32(patches: np.ndarray, g: np.ndarray, direction: float) -> np.ndarray:
    """The response ``float32 [B, wh, ww]`` of ``patches [B, ph, pw]`` as the
    tracker sums it: each value a sequential float32 FMA over the taps from
    tap 0, the row pass (down the patch) first, then the column pass."""
    B, ph, pw = patches.shape
    L = g.shape[1]
    wh, ww = ph - L + 1, pw - L + 1
    g64 = g.astype(np.float64)
    p = patches.astype(np.float64)[:, None]  # [B, 1, ph, pw]
    rows = np.zeros((B, 2, wh, pw), np.float32)
    for k in range(L):
        rows = fma_f32(rows, g64[None, :, k, None, None], p[:, :, k:k + wh, :])
    r64 = rows.astype(np.float64)
    out = np.zeros((B, 2, wh, ww), np.float32)
    for k in range(L):
        out = fma_f32(out, g64[None, :, k, None, None], r64[:, :, :, k:k + ww])
    return (out[:, 0] - out[:, 1]) * np.float32(direction)


def _bands(g: np.ndarray, n_in: int) -> np.ndarray:
    """``float64 [2, n_in - L + 1, n_in]``: row i holds the taps at i..i+L-1."""
    L = g.shape[1]
    n_out = n_in - L + 1
    band = np.zeros((2, n_out, n_in))
    for i in range(n_out):
        band[:, i, i:i + L] = g
    return band


def response_f64(patches: np.ndarray, g: np.ndarray, direction: float, bands=None):
    """``(response float64 [B, wh, ww], bound [B, wh, ww])``: the response
    by banded matrix products in float64, and a bound on how far the float32
    FMA sums of :func:`response_f32` can lie from it. Both passes add
    nonnegative terms (pixels and Gaussian taps), so each float32 sum of n
    products lies within ``gamma_n`` of its value, the two passes within
    ``gamma_2L`` (Higham, Accuracy and Stability, 3.1); the difference adds
    one rounding. The bound takes twice that, plus a relative 1e-9 for the
    float64 products' own error."""
    B, ph, pw = patches.shape
    L = g.shape[1]
    band_r, band_c = bands if bands is not None else (_bands(g, ph), _bands(g, pw))
    p = patches.astype(np.float64)[:, None]
    sums = band_r[None] @ p @ band_c[None].transpose(0, 1, 3, 2)  # [B, 2, wh, ww]
    resp = direction * (sums[:, 0] - sums[:, 1])
    n = 2 * L + 1
    gamma = n * U32 / (1.0 - n * U32)
    mag = sums[:, 0] + sums[:, 1]
    return resp, 2.0 * gamma * mag + 1e-9 * (mag + 1.0)


def argmax_colmajor(resp: np.ndarray) -> np.ndarray:
    """``int64 [B, 2]``: the first maximum of each ``resp[b]`` in
    column-major order, as (row, col)."""
    B, wh, ww = resp.shape
    k = np.argmax(resp.transpose(0, 2, 1).reshape(B, -1), axis=1)
    return np.stack([k % wh, k // wh], axis=1)


class _Windows:
    """The argmax of windows of one size: float64 first, the float32
    emulation where the bound leaves more than one candidate."""

    def __init__(self, g, direction, radii, L):
        self.g, self.direction, self.radii, self.L = g, direction, radii, L
        ph, pw = 2 * radii[0] + L, 2 * radii[1] + L
        self.bands = (_bands(g, ph), _bands(g, pw))
        self.emulated = 0  # windows that needed the float32 emulation

    def argmax(self, patches: np.ndarray) -> np.ndarray:
        resp, bound = response_f64(patches, self.g, self.direction, self.bands)
        idx = argmax_colmajor(resp)
        for b in range(len(patches)):
            i, j = idx[b]
            floor = resp[b, i, j] - bound[b, i, j]
            near = resp[b] + bound[b] >= floor
            if np.count_nonzero(near) > 1:
                self.emulated += 1
                idx[b] = argmax_colmajor(
                    response_f32(patches[b:b + 1], self.g, self.direction))[0]
        return idx


def track(clips, starts, *, target_width: float, window: int, darker_target: bool = True,
          windows=None):
    """Track every clip from its start. ``clips``: ``uint8 [n_b, H, W]`` arrays;
    ``starts[b]``: ``None`` (autodetect about the frame centre) or a guess
    ``(row, col)``. Returns ``(positions, stats)``: ``int64 [n_b, 2]`` per
    clip, and how many windows took the float32 emulation. ``windows``
    replaces :class:`_Windows` (``(g, direction, radii, L) -> object with
    argmax(patches)``), as the lower-precision control does."""
    g, direction, L = taps(target_width, darker_target)
    make = windows or _Windows
    radii = (window // 2, window // 2)
    wins = {radii: make(g, direction, radii, L)}  # by window radii
    fills = [mode_u8(c[0]) for c in clips]
    out = [np.empty((len(c), 2), np.int64) for c in clips]
    pos = np.empty((len(clips), 2), np.int64)
    for b, c in enumerate(clips):  # frame 1: the snap
        H, W = c.shape[1:]
        if starts[b] is None:
            guess, r = np.array([H // 2 - 1, W // 2 - 1]), (H // 4 // 2, W // 4 // 2)
        else:
            guess, r = np.asarray(starts[b], np.int64), radii
        if r not in wins:
            wins[r] = make(g, direction, r, L)
        idx = wins[r].argmax(extract_patches([c[0]], guess[None], r, L, [fills[b]]))[0]
        pos[b] = out[b][0] = np.clip(guess - np.asarray(r) + idx, 0, [H - 1, W - 1])
    for t in range(1, max(len(c) for c in clips)):
        lanes = [b for b, c in enumerate(clips) if t < len(c)]
        frames = [clips[b][t] for b in lanes]
        p = pos[lanes]
        idx = wins[radii].argmax(extract_patches(frames, p, radii, L, [fills[b] for b in lanes]))
        top = np.array([[f.shape[0] - 1, f.shape[1] - 1] for f in frames])
        pos[lanes] = np.clip(p - np.asarray(radii) + idx, 0, top)
        for b in lanes:
            out[b][t] = pos[b]
    return out, {"emulated_windows": sum(getattr(w, "emulated", 0) for w in wins.values())}


def timestamps(n_frames: int, fps: float, start: float = 0.0,
               stop: float = MAX_DURATION_S) -> np.ndarray:
    """The times of the first ``n_frames`` tracked frames: the grid of
    ``round(fps * (stop - start))`` points from ``start`` to ``stop``, as
    ``numpy.linspace`` spaces it."""
    n = int(np.round(fps * (stop - start)))
    return np.linspace(start, stop, n)[:n_frames]
