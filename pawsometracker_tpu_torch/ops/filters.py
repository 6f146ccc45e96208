"""Filtering primitives in plain PyTorch.

The building blocks of the tracker step, as the JAX package has them in
``pawsometracker_tpu/ops/filters.py``: the separable valid correlation, the
column-major first maximum and the StatsBase mode. They make up the plain
version of the tracker scan (``engine="xla"``, and every scan on the CPU),
which the CUDA kernel in :mod:`.tracker_kernel` is held against.

The correlation is written as direct taps, each output a sequential float32
FMA over the L taps from tap 0, rows first, then columns: the order the CUDA
kernel uses. Summation order decides argmax ties, so the plain version has to
sum as the kernel does. It is also what the JAX package's banded matmuls
compute on the CPU where XLA runs them as a sequential FMA over the band (its
Eigen path, at 41x41 windows for one); a library matmul here (MKL, cuBLAS)
sums in an order of its own.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "fma_f32",
    "separable_correlate_valid",
    "argmax_colmajor",
    "mode_u8",
    "mode_u8_host",
]


def fma_f32(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fma(a, b, acc)`` of float32 values, rounded once to float32, as the
    CUDA ``__fmaf_rn`` computes it. ``a`` and ``b`` are float64 tensors that
    hold float32 values, so their product is exact; the sum is rounded to odd
    in float64 (TwoSum, then the last bit forced to 1 where inexact), and
    rounding that to float32 gives the correctly rounded result, because
    float64 carries more than 24 + 2 bits."""
    p = a * b
    c = acc.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # p + c == s + err exactly
    bits = s.view(torch.int64)
    even = (bits & 1) == 0
    away = (err > 0) == (s > 0)  # the exact sum lies further from zero than s
    step = torch.where(away, 1, -1) * ((err != 0) & even)
    return (bits + step).view(torch.float64).to(torch.float32)


def _taps64(g: torch.Tensor) -> torch.Tensor:
    # float32 taps, as the kernel reads them, held exactly in float64
    return torch.atleast_2d(g).to(torch.float32).to(torch.float64)[:, :, None, None]


def separable_correlate_valid(patch: torch.Tensor, g_row: torch.Tensor,
                              g_col: torch.Tensor) -> torch.Tensor:
    """Valid correlation of ``patch [Ph, Pw]`` with the rank-1 kernel
    ``outer(g_row, g_col)`` -> float32 ``[Ph-Lr+1, Pw-Lc+1]``. Taps ``[F, L]``
    give F correlations at once -> ``[F, ...]``. The row pass runs first,
    then the column pass; each output is a sequential float32 FMA over its
    taps from tap 0, bit for bit the CUDA kernel's arithmetic."""
    gr, gc = _taps64(g_row), _taps64(g_col)
    p = patch.to(torch.float64)
    Lr, Lc = gr.shape[1], gc.shape[1]
    wh, ww = p.shape[0] - Lr + 1, p.shape[1] - Lc + 1
    rows = torch.zeros((gr.shape[0], wh, p.shape[1]), dtype=torch.float32, device=p.device)
    for k in range(Lr):
        rows = fma_f32(rows, gr[:, k], p[None, k:k + wh, :])
    r64 = rows.to(torch.float64)
    out = torch.zeros((max(gr.shape[0], gc.shape[0]), wh, ww), dtype=torch.float32,
                      device=p.device)
    for k in range(Lc):
        out = fma_f32(out, gc[:, k], r64[:, :, k:k + ww])
    return out if g_row.dim() > 1 or g_col.dim() > 1 else out[0]


def argmax_colmajor(x: torch.Tensor) -> torch.Tensor:
    """First-maximum index of a 2-D tensor in column-major scan order, as
    ``int32[2] = (row, col)`` (Julia's ``findmax`` tie-break): the argmax of
    the transpose, whose first maximum PyTorch returns like numpy."""
    rows = x.shape[0]
    k = torch.argmax(x.transpose(0, 1).reshape(-1))
    return torch.stack([k % rows, k // rows]).to(torch.int32)


def mode_u8(frame: torch.Tensor) -> torch.Tensor:
    """Most common byte of a uint8 frame, with StatsBase tie semantics: on an
    equal count the value whose last counted occurrence comes first in
    column-major scan order wins (see :func:`mode_u8_host`)."""
    flat = frame.transpose(0, 1).reshape(-1).to(torch.int64)
    n = flat.shape[0]
    counts = torch.bincount(flat, minlength=256)
    cmax = counts.max()
    order = torch.argsort(flat, stable=True)
    sorted_vals = flat[order]
    starts = torch.cumsum(counts, 0) - counts
    occ = torch.arange(n, device=flat.device) - starts[sorted_vals] + 1
    winner = torch.where(occ == cmax, order, torch.full_like(order, n)).min()
    return flat[winner].to(torch.uint8)


def _counts_u8(flat: np.ndarray) -> np.ndarray:
    """``np.bincount(flat, minlength=256)`` of a 1-D uint8 array, counted two
    bytes at a time: the bytes as uint16 pairs go into 65536 bins, and each
    bin adds to the counts of both its bytes. Half the elements to bin, and
    on a near-flat frame half the increments of one counter in a row."""
    counts = np.zeros(256, np.int64)
    if flat.size % 2:
        counts[flat[-1]] += 1
        flat = flat[:-1]
    pairs = np.bincount(flat.view(np.uint16), minlength=65536).reshape(256, 256)
    return counts + pairs.sum(axis=0) + pairs.sum(axis=1)


def mode_u8_host(frame: np.ndarray) -> int:
    """Host-side mode of a uint8 frame (StatsBase tie semantics, see mode_u8).
    The counts do not depend on the scan order, so they are taken over the
    frame as it lies; only a tie scans it in column-major order."""
    frame = np.asarray(frame, dtype=np.uint8)
    counts = _counts_u8(np.ascontiguousarray(frame).reshape(-1))
    cmax = int(counts.max())
    tied = np.flatnonzero(counts == cmax)
    if tied.size == 1:
        return int(tied[0])
    # Tie: first value to reach cmax = earliest cmax-th occurrence in scan order.
    flat = frame.ravel(order="F")
    best_v = best_pos = None
    for v in tied:
        pos = int(np.flatnonzero(flat == v)[cmax - 1])
        if best_pos is None or pos < best_pos:
            best_v, best_pos = int(v), pos
    return best_v
