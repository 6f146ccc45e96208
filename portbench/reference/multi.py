"""Several animals in one arena, written out plainly in NumPy: the reference
of the port's ``track_multi``.

It follows the port's stated semantics (``multi.py``,
``parallel/mesh.py::global_detect_peaks``). Without start locations, frame 1
is padded on every side by half the taps with its mode (the fill) and its
whole-frame response computed as direct taps, each tap a float32 multiply
followed by a separate float32 add, the row pass first, then the column
pass, for the centre and the surround; the response is their difference
times the direction. N peaks are taken strongest first, each the first
maximum in column-major order, and a disc of radius ``min_distance`` (the
window's edge by default) about each is set to minus infinity; a round that
finds only minus infinity repeats the last peak, and repeated peaks are
refused, as ``track_multi`` refuses them. Each target is then one lane of
:func:`.tracker.track` from its peak or its given start: the snap in its
window on frame 1, then a window a frame.

This module imports NumPy alone: nothing of the measured program.
"""

from __future__ import annotations

import numpy as np

from . import tracker


def frame_response(frame: np.ndarray, fill: int, g: np.ndarray, direction: float) -> np.ndarray:
    """``float32 [H, W]``: the whole-frame response of ``frame`` on ``fill``,
    each tap a float32 multiply and a separate float32 add, rows first."""
    L = g.shape[1]
    half = L // 2
    H, W = frame.shape
    x = np.full((H + 2 * half, W + 2 * half), fill, np.float32)
    x[half:half + H, half:half + W] = frame
    sums = []
    for gk in g:  # the centre, then the surround
        rows = np.zeros((H, x.shape[1]), np.float32)
        tmp = np.empty_like(rows)
        for k in range(L):
            rows += np.multiply(x[k:k + H], gk[k], out=tmp)
        cols = np.zeros((H, W), np.float32)
        tmp = np.empty_like(cols)
        for k in range(L):
            cols += np.multiply(rows[:, k:k + W], gk[k], out=tmp)
        sums.append(cols)
    return np.float32(direction) * (sums[0] - sums[1])


def peaks(resp: np.ndarray, n: int, min_distance: float) -> list:
    """The ``n`` strongest peaks of ``resp`` as ``(row, col)``, each
    suppressing a disc of radius ``min_distance`` about it; raises where the
    suppression leaves fewer than ``n`` distinct peaks."""
    resp = resp.copy()
    H, W = resp.shape
    ii, jj = np.arange(H)[:, None], np.arange(W)[None, :]
    r2 = np.float32(float(min_distance) ** 2)
    out = []
    for k in range(n):
        i, j = (int(x) for x in tracker.argmax_colmajor(resp[None])[0])
        if k > 0 and not np.isfinite(resp[i, j]):
            i, j = out[-1]
        out.append((i, j))
        resp[((ii - i) ** 2 + (jj - j) ** 2).astype(np.float32) <= r2] = -np.inf
    if len(set(out)) < n:
        raise ValueError(f"fewer than {n} separable peaks in frame 1")
    return out


def track(clip, starts, *, target_width: float, window: int, darker_target: bool = True,
          min_distance: float | None = None, windows=None) -> np.ndarray:
    """``int64 [n, N, 2]``: N targets tracked through ``clip`` (``uint8 [n, H,
    W]``). ``starts``: one ``(row, col)`` a target, or all ``None`` to
    autodetect N. ``windows`` as :func:`.tracker.track`'s."""
    if all(s is None for s in starts):
        g, direction, _ = tracker.taps(target_width, darker_target)
        resp = frame_response(clip[0], tracker.mode_u8(clip[0]), g, direction)
        edge = 2 * (window // 2) + 1
        starts = peaks(resp, len(starts), edge if min_distance is None else min_distance)
    elif any(s is None for s in starts):
        raise ValueError("every target needs its start, or none does")
    pos, _ = tracker.track([clip] * len(starts), list(starts), target_width=target_width,
                           window=window, darker_target=darker_target, windows=windows)
    return np.stack(pos, axis=1)
