"""The upstream test suite's trajectory: an Archimedean spiral with jitter.

PawsomeTracker.jl's tests (``test/test-basic-test.jl:19-41``) move their
disc along a spiral of ``loops`` turns that starts at the start location and
ends ``radius_px`` from it, sampled at equal steps of arc length, with
Gaussian jitter of ``jitter_px`` (``randn(2)``: 1 px) added to every point.

``params``: ``loops``, ``radius_px``, ``jitter_px`` and ``start_box_px``:
the spiral starts at the frame centre plus an offset drawn uniformly within
``±start_box_px`` on each axis. ``phase`` turns the whole spiral about its
start. Frame t's centre is ``(row, col)`` = start + r(θ)·(sin, cos)(θ +
phase) + jitter, with r = bθ and θ where the arc length reaches
t/(n−1) of the whole.
"""

from __future__ import annotations

import numpy as np


def _arc(theta, b):
    """Arc length of r = bθ from 0 to θ."""
    return b / 2 * (theta * np.sqrt(1 + theta * theta) + np.arcsinh(theta))


def centres(n: int, frame_shape, params: dict, phase: float, rng) -> np.ndarray:
    """``float64 [n, 2]``: the (row, col) of the disc's centre in each of n
    frames, the start offset and the jitter drawn from ``rng``."""
    H, W = frame_shape
    top = 2 * np.pi * float(params["loops"])
    b = float(params["radius_px"]) / top
    box = float(params["start_box_px"])
    start = np.array([H / 2, W / 2]) + rng.uniform(-box, box, 2)
    want = np.linspace(0.0, _arc(top, b), n)
    theta = np.sqrt(2 * want / b)  # r = bθ's length ~ bθ²/2; Newton from there
    theta = np.minimum(theta, top)
    for _ in range(50):
        step = (_arc(theta, b) - want) / (b * np.sqrt(1 + theta * theta))
        theta = np.clip(theta - step, 0.0, top)
    r = b * theta
    path = start + np.stack([r * np.sin(theta + phase), r * np.cos(theta + phase)], axis=1)
    return path + rng.standard_normal((n, 2)) * float(params["jitter_px"])
