"""Circular motion: the disc's centre on a circle about the frame centre.

``params``: ``radius_px`` (the circle's radius) and ``frames_per_turn``.
Frame t is at angle ``2*pi*t/frames_per_turn + phase``, row
``H/2 + radius*sin``, column ``W/2 + radius*cos``: a continuous path, so the
centre lies between pixels as a real animal's does.
"""

from __future__ import annotations

import numpy as np


def centres(n: int, frame_shape, params: dict, phase: float, rng=None) -> np.ndarray:
    """``float64 [n, 2]``: the (row, col) of the disc's centre in each of n
    frames. The path is smooth and fixed by ``phase``; ``rng`` is unused."""
    H, W = frame_shape
    ang = 2 * np.pi * np.arange(n) / float(params["frames_per_turn"]) + phase
    r = float(params["radius_px"])
    return np.stack([H / 2 + r * np.sin(ang), W / 2 + r * np.cos(ang)], axis=1)
