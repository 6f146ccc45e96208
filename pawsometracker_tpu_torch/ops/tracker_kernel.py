"""The DoG tracker scan: hand-written CUDA kernel, its wrapper and its plain version.

:func:`dog_scan` runs the tracker recurrence over a chunk of frames, the
counterpart of the JAX package's Pallas kernel
(``pawsometracker_tpu/ops/pallas_tracker.py::_scan_fn_cached``) in its
unbatched configurations:

- unbounded: ``(frames [T,H,W] u8, pos0 [2] i32, fill) -> positions [T,2] i32``;
- bounded: plus per-step ``deltas, lo, hi [T,2] i32`` (carry rebase and clamp box);
- either with ``subpixel=True``: plus per-step parabolic offsets ``[T,2] f32``.

On a CUDA tensor it launches one of the two kernels of ``csrc/dog_scan.cu``
(the step loop inside the kernel, see the note there) or raises; it never
falls back. Both run one thread-block cluster a lane. Which kernel runs is the
caller's ``kernel=`` (one of :data:`KERNELS`), else a matter of shape
(:func:`kernel_for`): ``dog_scan`` (the window's row blocks split over the
cluster's CTAs, each prefetching its rows of the next patch, :func:`scan_plan`)
when the whole window would fit one CTA's shared memory, ``dog_scan_tiled``
(the window's tiles spread over the CTAs, each tile's patch loaded in the
step, :func:`tile_plan`) for larger windows: the quarter-frame autodetect
snap, and every chunk scan from ``target_width`` 36 up at the default window.
``dog_scan_tiled`` takes any window, and ``dog_scan`` any whose row blocks
fit a cluster's CTAs, so up to ``target_width`` 63 both run; the ROI
pipelines choose between them by measurement
(``pipeline.pick_bounded_engine``). On a CPU
tensor it runs :func:`dog_scan_plain`, a Python loop over steps of the :mod:`.filters`
ops, which is also what both kernels are held against on the card; there
``kernel=`` is checked and has nothing to choose. :data:`launches` counts
kernel launches (and only those); launches inside :func:`probing` (the engine
chooser's measurement) count in :data:`probe_launches` instead.

:func:`dog_scan_segments` and :func:`dog_scan_batch_segments` run S chunk
scans a lane in one launch, chained as the JAX package's group dispatch chains
them (``make_super_chain``, ``make_chained_batch``, ``make_super_chain_batch``,
``make_super_full`` in ``pawsometracker_tpu/pipeline.py``); their plain
versions are loops of :func:`dog_scan_plain` and :func:`dog_scan_batch_plain`
with the same rule between segments.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from .dog_kernel import dog_kernel_separable
from .filters import argmax_colmajor, separable_correlate_valid

__all__ = ["dog_scan", "dog_scan_plain", "dog_scan_cuda", "dog_scan_batch",
           "dog_scan_batch_plain", "dog_scan_batch_cuda", "dog_scan_segments",
           "dog_scan_segments_plain", "dog_scan_segments_cuda", "dog_scan_batch_segments",
           "dog_scan_batch_segments_plain", "dog_scan_batch_segments_cuda", "launches",
           "launches_by_config", "launches_by_kernel", "reset_launches", "kernel_for",
           "kernels_for", "check_kernel", "probing", "is_probing", "probe_launches",
           "tile_plan", "TilePlan", "scan_plan", "ScanPlan", "KERNELS", "MAX_CLUSTER",
           "StagedScan"]

#: kernel launches since import (or the last :func:`reset_launches`)
launches = 0
#: the same count by kernel and configuration, as ``"<kernel>: <configuration>"``: the
#: kernel one of :data:`KERNELS`, the configuration ``unbounded`` or ``bounded``, either
#: with ``+subpixel``, each also with a ``batched`` prefix and a ``, segmented`` suffix
#: (:func:`_config_name`)
launches_by_config: Counter = Counter()
#: the same count by kernel
launches_by_kernel: Counter = Counter()
#: launches inside :func:`probing` (the engine chooser's measurement), by kernel; they are
#: not in the counts above
probe_launches: Counter = Counter()
_probing = 0

#: the kernels of csrc/dog_scan.cu, each with its own entry point
KERNELS = ("dog_scan", "dog_scan_tiled")
#: outputs per thread of the kernels' register-blocked passes, and rows of one row block
#: (kR in the source): dog_scan's CTAs own whole blocks, dog_scan_tiled's tiles are multiples
SCAN_R = 7
#: largest thread-block cluster of either kernel (above 8 a non-portable size)
MAX_CLUSTER = 16
#: most threads of one CTA of either kernel (kThreads in the source)
MAX_THREADS = 640
#: when set, dog_scan_tiled launches clusters of exactly this many CTAs (timing and tests);
#: None lets :func:`tile_plan` and the card pick
tiled_cluster: int | None = None
#: when set, dog_scan launches clusters of exactly this many CTAs (timing and tests; 1 is the
#: whole window on one CTA); None lets :func:`scan_plan` and the card pick
scan_cluster: int | None = None


def reset_launches() -> None:
    """Set the launch counts to 0."""
    global launches
    launches = 0
    launches_by_config.clear()
    launches_by_kernel.clear()
    probe_launches.clear()


@contextlib.contextmanager
def probing():
    """Count the launches made inside in :data:`probe_launches`, not in
    :data:`launches`: the engine chooser times and checks the kernels with
    them, and they are no part of the work the caller asked for."""
    global _probing
    _probing += 1
    try:
        yield
    finally:
        _probing -= 1


def is_probing() -> bool:
    """Whether the calling code runs inside :func:`probing`."""
    return _probing > 0


def _config_name(bounded: bool, subpixel: bool, batched: bool = False,
                 segmented: bool = False) -> str:
    """Configuration name used in the launch counts and reports."""
    return (("batched " if batched else "") + ("bounded" if bounded else "unbounded")
            + ("+subpixel" if subpixel else "") + (", segmented" if segmented else ""))


@functools.lru_cache(maxsize=64)
def _taps(sigma: float, darker_target: bool, device: torch.device):
    """``(taps [2L] f32 = centre then surround, direction, L)`` on ``device``,
    cached so a launch never waits on a host-to-device copy of the taps."""
    gc, gs, direction, L = dog_kernel_separable(sigma, darker_target)
    taps = np.concatenate([gc, gs]).astype(np.float32)
    return torch.from_numpy(taps).to(device), float(direction), int(L)


def _check_args(frames, pos0, deltas, lo, hi):
    if frames.dtype != torch.uint8 or frames.dim() != 3:
        raise ValueError(f"frames must be uint8 [T, H, W], got {frames.dtype} {tuple(frames.shape)}")
    if pos0.shape != (2,):
        raise ValueError(f"pos0 must have shape (2,), got {tuple(pos0.shape)}")
    bounded = deltas is not None
    if bounded != (lo is not None) or bounded != (hi is not None):
        raise ValueError("deltas, lo and hi are given together or not at all")
    if bounded:
        T = frames.shape[0]
        for name, a in (("deltas", deltas), ("lo", lo), ("hi", hi)):
            if tuple(a.shape) != (T, 2):
                raise ValueError(f"{name} must have shape ({T}, 2), got {tuple(a.shape)}")
            if a.device != frames.device:
                raise ValueError(f"{name} is on {a.device}, frames on {frames.device}")
    if pos0.device != frames.device:
        raise ValueError(f"pos0 is on {pos0.device}, frames on {frames.device}")
    return bounded


def _check_batch_args(frames, pos0, fills, deltas, lo, hi):
    if frames.dtype != torch.uint8 or frames.dim() not in (3, 4):
        raise ValueError(f"frames must be uint8 [B, T, H, W] or shared [T, H, W], got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    if pos0.dim() != 2 or pos0.shape[1] != 2:
        raise ValueError(f"pos0 must have shape (B, 2), got {tuple(pos0.shape)}")
    B = pos0.shape[0]
    T = frames.shape[-3]
    if frames.dim() == 4 and frames.shape[0] != B:
        raise ValueError(f"frames has {frames.shape[0]} lanes, pos0 {B}")
    if tuple(fills.shape) != (B,):
        raise ValueError(f"fills must have shape ({B},), got {tuple(fills.shape)}")
    bounded = deltas is not None
    if bounded != (lo is not None) or bounded != (hi is not None):
        raise ValueError("deltas, lo and hi are given together or not at all")
    for name, a in (("pos0", pos0), ("fills", fills), ("deltas", deltas), ("lo", lo), ("hi", hi)):
        if a is None:
            continue
        if name in ("deltas", "lo", "hi") and tuple(a.shape) != (B, T, 2):
            raise ValueError(f"{name} must have shape ({B}, {T}, 2), got {tuple(a.shape)}")
        if a.device != frames.device:
            raise ValueError(f"{name} is on {a.device}, frames on {frames.device}")
    return bounded, B, T


def dog_scan(frames: torch.Tensor, pos0: torch.Tensor, fill: int, *, radii, sigma: float,
             darker_target: bool, deltas=None, lo=None, hi=None, subpixel: bool = False,
             kernel=None):
    """Track through ``frames [T, H, W]`` u8 from ``pos0`` (row, col).

    Returns positions ``int32 [T, 2]``, and with ``subpixel`` also offsets
    ``float32 [T, 2]``. A CUDA tensor launches the kernel (``kernel``, one of
    :data:`KERNELS`, or the shape rule's without one); a CPU tensor runs the
    plain version; any other device raises."""
    check_kernel(kernel)
    if frames.is_cuda:
        return dog_scan_cuda(frames, pos0, fill, radii=radii, sigma=sigma,
                             darker_target=darker_target, deltas=deltas, lo=lo, hi=hi,
                             subpixel=subpixel, kernel=kernel)
    if frames.device.type == "cpu":
        return dog_scan_plain(frames, pos0, fill, radii=radii, sigma=sigma,
                              darker_target=darker_target, deltas=deltas, lo=lo, hi=hi,
                              subpixel=subpixel)
    raise ValueError(f"dog_scan runs on CUDA or CPU tensors, got {frames.device}")


def dog_scan_plain(frames: torch.Tensor, pos0: torch.Tensor, fill: int, *, radii, sigma: float,
                   darker_target: bool, deltas=None, lo=None, hi=None, subpixel: bool = False):
    """The plain PyTorch version of :func:`dog_scan`, on any device: one
    step per frame of the :mod:`.filters` ops (the two separable
    correlations, the column-major argmax) and the clamp, written with tensor
    ops only (no host round trip per step). Its arithmetic is the kernel's,
    so the two agree bit for bit, ties included."""
    bounded = _check_args(frames, pos0, deltas, lo, hi)
    dev = frames.device
    T, H, W = frames.shape
    taps, direction, L = _taps(float(sigma), bool(darker_target), dev)
    g2 = taps.view(2, L)  # centre, surround
    ri, rj = int(radii[0]), int(radii[1])
    wh, ww = 2 * ri + 1, 2 * rj + 1
    ph, pw = wh + L - 1, ww + L - 1
    pad = torch.tensor([ri + L // 2, rj + L // 2], dtype=torch.int64, device=dev)
    r = torch.tensor([ri, rj], dtype=torch.int64, device=dev)
    top = torch.tensor([H - 1, W - 1], dtype=torch.int64, device=dev)
    zero = torch.zeros(2, dtype=torch.int64, device=dev)
    ar_h = torch.arange(ph, device=dev)
    ar_w = torch.arange(pw, device=dev)
    fill_t = torch.tensor(int(fill), dtype=torch.uint8, device=dev)

    pos = pos0.to(torch.int64)
    out_pos = torch.empty((T, 2), dtype=torch.int32, device=dev)
    out_off = torch.empty((T, 2), dtype=torch.float32, device=dev) if subpixel else None
    for t in range(T):
        p = pos + deltas[t].to(torch.int64) if bounded else pos
        c = torch.minimum(torch.maximum(p, zero), top) - pad  # entry clamp, frame coords
        rows, cols = c[0] + ar_h, c[1] + ar_w
        inside = ((rows >= 0) & (rows < H))[:, None] & ((cols >= 0) & (cols < W))[None, :]
        patch = frames[t][rows.clamp(0, H - 1)[:, None], cols.clamp(0, W - 1)[None, :]]
        patch = torch.where(inside, patch, fill_t)
        rc, rs = separable_correlate_valid(patch, g2, g2)
        resp = direction * (rc - rs)
        idx = argmax_colmajor(resp).to(torch.int64)
        new = p - r + idx
        if bounded:
            new = torch.minimum(torch.maximum(new, lo[t].to(torch.int64)), hi[t].to(torch.int64))
        else:
            new = torch.minimum(torch.maximum(new, zero), top)
        out_pos[t] = new.to(torch.int32)
        if subpixel:
            out_off[t] = _parabolic_offset(resp, idx)
        pos = new
    return (out_pos, out_off) if subpixel else out_pos


def _parabolic_offset(resp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-axis quadratic peak interpolation in [-0.5, 0.5]; 0 at the window
    edge or where the response is not locally concave."""
    wh, ww = resp.shape
    i0, j0 = idx[0], idx[1]
    c = resp[i0, j0]

    def axis_off(i, n, minus, plus):
        denom = minus - 2.0 * c + plus
        interior = (i > 0) & (i < n - 1) & (denom < 0)
        safe = torch.where(denom < 0, denom, torch.full_like(denom, -1.0))
        return torch.where(interior, 0.5 * (minus - plus) / safe, torch.zeros_like(denom))

    rm = resp[(i0 - 1).clamp(0, wh - 1), j0]
    rp = resp[(i0 + 1).clamp(0, wh - 1), j0]
    cm = resp[i0, (j0 - 1).clamp(0, ww - 1)]
    cp = resp[i0, (j0 + 1).clamp(0, ww - 1)]
    return torch.stack([axis_off(i0, wh, rm, rp), axis_off(j0, ww, cm, cp)]).to(torch.float32)


def dog_scan_batch(frames: torch.Tensor, pos0: torch.Tensor, fills: torch.Tensor, *, radii,
                   sigma: float, darker_target: bool, deltas=None, lo=None, hi=None,
                   subpixel: bool = False, kernel=None):
    """Track B chains in one call: lane b through ``frames[b]`` (``frames
    [B, T, H, W]``), or every lane through the same ``frames [T, H, W]``, from
    ``pos0[b]`` with fill ``fills[b]`` (and ``deltas``/``lo``/``hi [B, T, 2]``
    when bounded).

    Returns positions ``int32 [B, T, 2]``, and with ``subpixel`` also offsets
    ``float32 [B, T, 2]``. A CUDA tensor launches the kernel (``kernel`` as
    in :func:`dog_scan`); a CPU tensor runs the plain version; any other
    device raises."""
    check_kernel(kernel)
    if frames.is_cuda:
        return dog_scan_batch_cuda(frames, pos0, fills, radii=radii, sigma=sigma,
                                   darker_target=darker_target, deltas=deltas, lo=lo, hi=hi,
                                   subpixel=subpixel, kernel=kernel)
    if frames.device.type == "cpu":
        return dog_scan_batch_plain(frames, pos0, fills, radii=radii, sigma=sigma,
                                    darker_target=darker_target, deltas=deltas, lo=lo, hi=hi,
                                    subpixel=subpixel)
    raise ValueError(f"dog_scan_batch runs on CUDA or CPU tensors, got {frames.device}")


def dog_scan_batch_plain(frames: torch.Tensor, pos0: torch.Tensor, fills: torch.Tensor, *,
                         radii, sigma: float, darker_target: bool, deltas=None, lo=None,
                         hi=None, subpixel: bool = False):
    """The plain PyTorch version of :func:`dog_scan_batch`, on any device: a
    loop over lanes of :func:`dog_scan_plain`, so each lane's arithmetic is
    the kernel's bit for bit."""
    bounded, B, T = _check_batch_args(frames, pos0, fills, deltas, lo, hi)
    dev = frames.device
    out_pos = torch.empty((B, T, 2), dtype=torch.int32, device=dev)
    out_off = torch.empty((B, T, 2), dtype=torch.float32, device=dev) if subpixel else None
    for b in range(B):
        box = dict(deltas=deltas[b], lo=lo[b], hi=hi[b]) if bounded else {}
        out = dog_scan_plain(frames if frames.dim() == 3 else frames[b], pos0[b], int(fills[b]),
                             radii=radii, sigma=sigma, darker_target=darker_target,
                             subpixel=subpixel, **box)
        if subpixel:
            out_pos[b], out_off[b] = out
        else:
            out_pos[b] = out
    return (out_pos, out_off) if subpixel else out_pos


def kernel_for(radii, L: int, smem_limit: int) -> str:
    """The kernel a window of ``radii`` with L taps launches: ``dog_scan`` when
    its whole window fits one CTA's ``smem_limit`` bytes of shared memory
    (:func:`scan_plan` with one CTA), else ``dog_scan_tiled``. Above that
    ``dog_scan`` still runs, its row blocks split over a cluster, but each
    CTA's copy of the next patch spans the superset's full width and
    ``2ri + L`` rows of slack, and ``dog_scan_tiled`` is as fast or faster
    there on an H100 (PERF.md)."""
    return KERNELS[0] if scan_plan(radii, L, 1).smem <= smem_limit else KERNELS[1]


def kernels_for(radii, L: int, smem_limit: int) -> tuple:
    """The kernels that can run a window of ``radii`` with L taps, the shape
    rule's (:func:`kernel_for`) first: ``dog_scan_tiled`` takes any window,
    ``dog_scan`` those whose fewest-blocks plan (:func:`scan_plan`) fits
    ``smem_limit``."""
    first = kernel_for(radii, L, smem_limit)
    if first == KERNELS[0]:
        return KERNELS
    return (first,) if scan_plan(radii, L).smem > smem_limit else (first, KERNELS[0])


def check_kernel(kernel) -> None:
    """Raise unless ``kernel`` is None (the shape rule) or one of :data:`KERNELS`."""
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"kernel must be None or one of {KERNELS}, got {kernel!r}")


def _pick_kernel(kernel, radii, L: int, smem_limit: int) -> str:
    """The kernel a launch takes: ``kernel``, checked against the window, or
    the shape rule's without one."""
    if kernel is None:
        return kernel_for(radii, L, smem_limit)
    check_kernel(kernel)
    if kernel not in kernels_for(radii, L, smem_limit):
        raise ValueError(f"dog_scan does not take a {2 * int(radii[0]) + 1}x"
                         f"{2 * int(radii[1]) + 1} window with {L} taps: it needs "
                         f"{scan_plan(radii, L).smem} bytes of shared memory a CTA, the card "
                         f"has {smem_limit} a block")
    return kernel


class ScanPlan(NamedTuple):
    """One ``dog_scan`` launch (mirror of ``scan_layout`` in csrc/dog_scan.cu):
    ``cluster`` CTAs a lane, each owning at most ``slots`` row blocks of
    ``SCAN_R`` output rows (CTA r the blocks ``[r * slots, (r + 1) * slots)``),
    with ``threads`` threads and ``smem`` bytes of dynamic shared memory."""

    cluster: int
    slots: int
    threads: int
    smem: int


def scan_plan(radii, L: int, cluster: int | None = None) -> ScanPlan:
    """The ``dog_scan`` launch of a window of ``radii`` with L taps over
    ``cluster`` CTAs a lane; None takes the fewest CTAs that give each the
    fewest row blocks (one a CTA up to :data:`MAX_CLUSTER` blocks)."""
    ri, rj = int(radii[0]), int(radii[1])
    wh, ww = 2 * ri + 1, 2 * rj + 1
    nbv = -(-wh // SCAN_R)
    if cluster is None:
        cluster = -(-nbv // -(-nbv // min(MAX_CLUSTER, nbv)))
    slots = -(-nbv // int(cluster))
    return ScanPlan(int(cluster), slots, _scan_threads(L, ri, rj, slots),
                    _scan_smem_bytes(L, ri, rj, slots))


def scan_plans(radii, L: int, smem_limit: int) -> list:
    """Every ``dog_scan`` launch of a window that fits ``smem_limit`` bytes a
    CTA, one for each count of row blocks a CTA (fewest first), each with the
    fewest CTAs that give it, at most :data:`MAX_CLUSTER`. Empty when the
    window does not fit even one block a CTA."""
    nbv = -(-(2 * int(radii[0]) + 1) // SCAN_R)
    plans, seen = [], set()
    for c in range(min(MAX_CLUSTER, nbv), 0, -1):
        slots = -(-nbv // c)
        if slots in seen:
            continue
        seen.add(slots)
        plan = scan_plan(radii, L, -(-nbv // slots))
        if plan.smem <= smem_limit:
            plans.append(plan)
    return plans


def _scan_threads(L: int, ri: int, rj: int, slots: int) -> int:
    # mirror of scan_layout in csrc/dog_scan.cu: a CTA's row-pass or column-pass items, or a
    # quarter of its copy's 16-byte chunks
    ww = 2 * rj + 1
    chunks = (2 * ri + slots * SCAN_R + L) * ((4 * rj + L + 30) // 16)
    items = max(slots * (ww + L - 1), slots * SCAN_R * -(-ww // SCAN_R), chunks // 4)
    return min(MAX_THREADS, 32 * -(-items // 32))


def _scan_smem_bytes(L: int, ri: int, rj: int, slots: int) -> int:
    # mirror of scan_layout in csrc/dog_scan.cu: a CTA of `slots` row blocks
    ww = 2 * rj + 1
    nbh = -(-ww // SCAN_R)
    brows = 2 * ri + slots * SCAN_R + L
    pitch = 16 * ((4 * rj + L + 30) // 16)
    pitch2 = (nbh * SCAN_R + L) | 1
    band = slots * SCAN_R
    return 2 * brows * pitch + 8 * band * pitch2 + 8 * L + 8 * band * ww + 8 * brows


def _scan_plan(radii, L: int, smem_limit: int, lanes: int, device_index: int) -> ScanPlan:
    """:func:`scan_plan` for the card and B = ``lanes``: of :func:`scan_plans`,
    the one whose lanes finish first by ``cudaOccupancyMaxActiveClusters``
    (waves of the clusters the card runs at once, times the row blocks a CTA;
    ties to fewer blocks a CTA), or :data:`scan_cluster` when set. Raises when
    none can be scheduled."""
    return _scan_plan_cached((int(radii[0]), int(radii[1])), int(L), int(smem_limit),
                             int(lanes), int(device_index), scan_cluster)


@functools.lru_cache(maxsize=256)
def _scan_plan_cached(radii, L, smem_limit, lanes, device_index, forced):
    if forced is not None:
        plan = scan_plan(radii, L, forced)
        if (1 <= plan.cluster <= MAX_CLUSTER and plan.smem <= smem_limit
                and _scan_active_clusters(radii, L, plan.cluster, device_index) > 0):
            return plan
    else:
        best = None
        for plan in scan_plans(radii, L, smem_limit):
            n = _scan_active_clusters(radii, L, plan.cluster, device_index)
            if n > 0:
                cost = -(-lanes // n) * plan.slots
                if best is None or cost < best[0]:
                    best = (cost, plan)
        if best is not None:
            return best[1]
        plan = scan_plan(radii, L)
    raise RuntimeError(f"dog_scan: the card cannot run a cluster of {plan.cluster} CTAs with "
                       f"{plan.smem} bytes of shared memory and {plan.threads} threads each")


@functools.lru_cache(maxsize=256)
def _scan_active_clusters(radii, L: int, cluster: int, device_index: int) -> int:
    """Clusters of ``dog_scan`` with ``cluster`` CTAs a lane that the card runs at once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().dog_scan_active_clusters(int(L), int(radii[0]), int(radii[1]), int(cluster),
                                              ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"dog_scan: occupancy query failed: "
                           f"{_lib().dog_scan_error_string(err).decode()}")
    return n.value


class TilePlan(NamedTuple):
    """How ``dog_scan_tiled`` covers a window: one cluster of ``cluster`` CTAs
    a lane, output tiles of ``tile`` (rows, cols) on a ``tiles`` (rows, cols)
    grid, CTA r owning tiles r, r + C, ... (at most ``slots``), ``smem`` bytes
    of dynamic shared memory a CTA, and ``work``: the taps computed over the
    window's direct taps (the column tiles' aprons recomputed by the row pass)."""

    cluster: int
    tile: tuple
    tiles: tuple
    slots: int
    smem: int
    work: float


def tile_plan(radii, L: int, smem_limit: int, subpixel: bool = False,
              max_cluster: int = MAX_CLUSTER, cluster: int | None = None) -> TilePlan:
    """The tiles and cluster of one ``dog_scan_tiled`` launch (mirror of the
    kernel's indexing in csrc/dog_scan.cu). Tiles are one register block of
    rows (``SCAN_R``) by the window's width, or by the fewest column tiles
    (widths a multiple of ``SCAN_R``) whose working set fits ``smem_limit``,
    so that few apron columns are recomputed. C is the fewest CTAs that give
    no CTA more tiles than spreading them over ``max_cluster`` CTAs would, or
    exactly ``cluster`` when given (it may exceed the tile count)."""
    wh, ww = 2 * int(radii[0]) + 1, 2 * int(radii[1]) + 1
    th = SCAN_R
    ntr = -(-wh // th)
    for split in range(1, -(-ww // SCAN_R) + 1):
        per = -(-ww // split)  # columns a tile, rounded up to whole register blocks
        tw = SCAN_R * -(-per // SCAN_R)
        ntc = -(-ww // tw)
        nt = ntr * ntc
        if cluster is not None:
            c, slots = int(cluster), -(-nt // int(cluster))
        else:
            slots = -(-nt // min(max_cluster, MAX_CLUSTER, nt))
            c = -(-nt // slots)
        smem = _tiled_smem_bytes(L, th, tw, slots if subpixel else 0)
        if smem <= smem_limit:
            work = nt * th * (2 * tw + L - 1) / (wh * (2 * ww + L - 1))
            return TilePlan(c, (th, tw), (ntr, ntc), slots, smem, work)
    raise ValueError(f"a DoG kernel of length {L} does not fit the card's {smem_limit} bytes "
                     f"of shared memory per block")


#: bytes of the exchange's (key, index) pairs a CTA: 2 parities x 16 CTAs x 20 warps x 8
TILED_PAIRS_BYTES = 16 * MAX_CLUSTER * (MAX_THREADS // 32)


def _tiled_smem_bytes(L: int, th: int, tw: int, resp_slots: int) -> int:
    # mirror of tiled_layout in csrc/dog_scan.cu
    brows, pitch, pitch2 = th + L, 16 * ((tw + L + 29) // 16), (tw + L) | 1
    return (brows * pitch + 8 * th * pitch2 + 8 * L + TILED_PAIRS_BYTES
            + 8 * resp_slots * th * tw + 4 * brows)


def _tiled_plan(radii, L: int, smem_limit: int, subpixel: bool, device_index: int) -> TilePlan:
    """:func:`tile_plan` for the card: the largest cluster the card can
    schedule at this shared-memory size (``cudaOccupancyMaxActiveClusters``),
    or :data:`tiled_cluster` when set. Raises when no cluster fits."""
    return _tiled_plan_cached((int(radii[0]), int(radii[1])), int(L), int(smem_limit),
                              bool(subpixel), int(device_index), tiled_cluster)


@functools.lru_cache(maxsize=256)
def _tiled_plan_cached(radii, L, smem_limit, subpixel, device_index, forced):
    max_cluster = MAX_CLUSTER
    while True:
        plan = tile_plan(radii, L, smem_limit, subpixel, max_cluster, forced)
        if _active_clusters(plan.cluster, plan.smem, device_index) > 0:
            return plan
        if forced is not None or plan.cluster == 1:
            raise RuntimeError(f"dog_scan_tiled: the card cannot run a cluster of {plan.cluster}"
                               f" CTAs with {plan.smem} bytes of shared memory each")
        max_cluster = plan.cluster - 1


def _active_clusters(cluster: int, smem: int, device_index: int) -> int:
    """Clusters of ``cluster`` CTAs with ``smem`` bytes each that the card runs at once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().dog_scan_tiled_active_clusters(cluster, smem, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"dog_scan_tiled: occupancy query failed: "
                           f"{_lib().dog_scan_error_string(err).decode()}")
    return n.value


@functools.lru_cache(maxsize=1)
def _lib():
    from ._build import kernel_library

    return _bind(kernel_library("dog_scan"))


def _bind(lib):
    """Declare the C interface of a library built from ``csrc/dog_scan.cu``."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    common = [vp, i64, i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, i32, i32, i32,
              ctypes.c_float, vp, vp,
              i32, i64, i64, vp, vp, vp, vp, vp]  # the segments
    lib.dog_scan_launch.argtypes = common + [i32, vp]
    lib.dog_scan_launch.restype = i32
    lib.dog_scan_active_clusters.argtypes = [i32, i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.dog_scan_active_clusters.restype = i32
    lib.dog_scan_tiled_launch.argtypes = common + [i32, i32, i32, vp]
    lib.dog_scan_tiled_launch.restype = i32
    lib.dog_scan_tiled_active_clusters.argtypes = [i32, ctypes.c_longlong,
                                                   ctypes.POINTER(ctypes.c_int)]
    lib.dog_scan_tiled_active_clusters.restype = i32
    lib.dog_scan_error_string.argtypes = [i32]
    lib.dog_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def _smem_limit(device_index: int) -> int:
    props = torch.cuda.get_device_properties(device_index)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))


def _ptr(a):
    return None if a is None else a.data_ptr()


@functools.lru_cache(maxsize=1024)
def _fill_tensor(fill: int, device: torch.device) -> torch.Tensor:
    """One lane's fill as a uint8 ``[1]`` tensor on ``device``, made once per
    value, so an unbatched launch never waits on a host-to-device copy."""
    return torch.full((1,), int(fill), dtype=torch.uint8, device=device)


def _check_cuda(tensors: dict):
    for name, a in tensors.items():
        if a is None:
            continue
        if not a.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {a.device}")
        want = torch.uint8 if name in ("frames", "fills") else torch.int32
        if a.dtype != want:
            raise ValueError(f"{name} must be {str(want).replace('torch.', '')}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class _Segments(NamedTuple):
    """A launch's segments (``Segments`` in csrc/dog_scan.cu): S chunk scans a
    lane, segment s's frames ``frame_stride`` bytes and its int32 arguments
    ``arg_stride`` elements after segment s-1's, and the chain between them."""

    S: int = 1
    frame_stride: int = 0
    arg_stride: int = 0
    ks: object = None
    origin0: object = None
    origin_last: object = None
    carry_in: object = None
    carry_out: object = None


def _launch(frames, lane_stride: int, B: int, T: int, pos0, fills, deltas, lo, hi, radii,
            sigma, darker_target, subpixel, config: str, seg: _Segments = _Segments(),
            kernel=None):
    """Launch ``kernel`` (None: the one :func:`kernel_for` picks) for B lanes
    of ``seg.S`` segments of T steps on the current stream; returns ``out_pos
    [S,B,T,2]`` (and ``out_off``). Counts the launch (in :data:`probe_launches`
    inside :func:`probing`)."""
    H, W = frames.shape[-2:]
    dev = frames.device
    out_pos = torch.empty((seg.S, B, T, 2), dtype=torch.int32, device=dev)
    out_off = (torch.empty((seg.S, B, T, 2), dtype=torch.float32, device=dev) if subpixel
               else None)
    if B == 0 or T == 0:
        return out_pos, out_off
    taps, direction, L = _taps(float(sigma), bool(darker_target), dev)
    limit = _smem_limit(dev.index if dev.index is not None else 0)
    kernel = _pick_kernel(kernel, radii, L, limit)
    lib = _lib()
    args = (frames.data_ptr(), lane_stride, B, T, H, W, _ptr(pos0), fills.data_ptr(),
            _ptr(deltas), _ptr(lo), _ptr(hi), taps.data_ptr(), L, int(radii[0]), int(radii[1]),
            direction, out_pos.data_ptr(), _ptr(out_off), seg.S, seg.frame_stride,
            seg.arg_stride, _ptr(seg.ks), _ptr(seg.origin0), _ptr(seg.origin_last),
            _ptr(seg.carry_in), _ptr(seg.carry_out))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "dog_scan":
            plan = _scan_plan(radii, L, limit, B, dev.index or 0)
            err = lib.dog_scan_launch(*args, plan.cluster, stream)
        else:
            plan = _tiled_plan(radii, L, limit, subpixel, dev.index or 0)
            err = lib.dog_scan_tiled_launch(*args, *plan.tile, plan.cluster, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: {lib.dog_scan_error_string(err).decode()}")
    _count(kernel, config)
    return out_pos, out_off


def _count(kernel: str, config: str) -> None:
    """Count one launch of ``kernel`` in ``config`` (in :data:`probe_launches`
    inside :func:`probing`)."""
    global launches
    if _probing:
        probe_launches[kernel] += 1
        return
    launches += 1
    launches_by_kernel[kernel] += 1
    launches_by_config[f"{kernel}: {config}"] += 1


def dog_scan_cuda(frames: torch.Tensor, pos0: torch.Tensor, fill: int, *, radii, sigma: float,
                  darker_target: bool, deltas=None, lo=None, hi=None, subpixel: bool = False,
                  kernel=None):
    """Launch a kernel of ``csrc/dog_scan.cu`` (``kernel``, or the shape
    rule's) for one chain (one lane) on the current stream for CUDA tensors
    (int32 ``pos0``/``deltas``/``lo``/``hi``, contiguous). Raises on anything
    the kernel does not take (``"dog_scan"`` on a window too large for it)
    and on a failed launch."""
    bounded = _check_args(frames, pos0, deltas, lo, hi)
    _check_cuda(dict(frames=frames, pos0=pos0, deltas=deltas, lo=lo, hi=hi))
    T = frames.shape[0]
    out_pos, out_off = _launch(frames, 0, 1, T, pos0, _fill_tensor(int(fill), frames.device),
                               deltas, lo, hi, radii, sigma, darker_target, subpixel,
                               _config_name(bounded, subpixel), kernel=kernel)
    return (out_pos[0, 0], out_off[0, 0]) if subpixel else out_pos[0, 0]


def dog_scan_batch_cuda(frames: torch.Tensor, pos0: torch.Tensor, fills: torch.Tensor, *, radii,
                        sigma: float, darker_target: bool, deltas=None, lo=None, hi=None,
                        subpixel: bool = False, kernel=None):
    """Launch a kernel of ``csrc/dog_scan.cu`` (``kernel`` as in
    :func:`dog_scan_cuda`) for B lanes on the current stream for CUDA tensors (uint8 ``fills``, int32 ``pos0``/``deltas``/``lo``/``hi``,
    contiguous). Shared ``frames [T, H, W]`` launch with a lane stride of 0.
    Raises on anything the kernel does not take and on a failed launch."""
    bounded, B, T = _check_batch_args(frames, pos0, fills, deltas, lo, hi)
    _check_cuda(dict(frames=frames, pos0=pos0, fills=fills, deltas=deltas, lo=lo, hi=hi))
    lane_stride = 0 if frames.dim() == 3 else frames.stride(0)
    out_pos, out_off = _launch(frames, lane_stride, B, T, pos0, fills, deltas, lo, hi, radii,
                               sigma, darker_target, subpixel,
                               _config_name(bounded, subpixel, batched=True), kernel=kernel)
    return (out_pos[0], out_off[0]) if subpixel else out_pos[0]


# ---- segments: S chained chunk scans a lane in one launch ------------------------------


def _check_segment_args(frames, pos0, fills, deltas, lo, hi, ks, origin0, origin_last, carry,
                        carry_out, batched: bool):
    """Shapes, types and devices of a segmented scan; returns ``(bounded, S,
    B, T)``. ``fills`` is None for one lane."""
    dims = (4, 5) if batched else (4,)
    if frames.dtype != torch.uint8 or frames.dim() not in dims:
        want = "[S, B, T, H, W] or shared [S, T, H, W]" if batched else "[S, T, H, W]"
        raise ValueError(f"frames must be uint8 {want}, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    S, T = frames.shape[0], frames.shape[-3]
    lane = (2,) if not batched else None
    if carry is not None:
        if not batched:
            raise ValueError("a carry chains batched segments only")
        if origin0 is None or origin_last is None or ks is None:
            raise ValueError("a carry needs ks, origin0 and origin_last")
        if carry.dim() != 2 or carry.shape[1] != 2:
            raise ValueError(f"carry must have shape (B, 2), got {tuple(carry.shape)}")
        B = carry.shape[0]
    else:
        if origin0 is not None or origin_last is not None or carry_out is not None:
            raise ValueError("origin0, origin_last and carry_out come with a carry")
        if pos0 is None:
            raise ValueError("pos0 is needed without a carry")
        if batched and (pos0.dim() != 2 or pos0.shape[1] != 2):
            raise ValueError(f"pos0 must have shape (B, 2), got {tuple(pos0.shape)}")
        if not batched and tuple(pos0.shape) != lane:
            raise ValueError(f"pos0 must have shape (2,), got {tuple(pos0.shape)}")
        B = pos0.shape[0] if batched else 1
    if batched:
        if frames.dim() == 5 and frames.shape[1] != B:
            raise ValueError(f"frames has {frames.shape[1]} lanes, the chain {B}")
        if tuple(fills.shape) != (B,):
            raise ValueError(f"fills must have shape ({B},), got {tuple(fills.shape)}")
    bounded = deltas is not None
    if bounded != (lo is not None) or bounded != (hi is not None):
        raise ValueError("deltas, lo and hi are given together or not at all")
    lanes = (B,) if batched else ()
    want = {"deltas": (S,) + lanes + (T, 2), "lo": (S,) + lanes + (T, 2),
            "hi": (S,) + lanes + (T, 2), "ks": (S,) + lanes, "origin0": (S, B, 2),
            "origin_last": (S, B, 2), "pos0": None, "fills": None, "carry": (B, 2),
            "carry_out": (B, 2)}
    for name, a in (("deltas", deltas), ("lo", lo), ("hi", hi), ("ks", ks),
                    ("origin0", origin0), ("origin_last", origin_last), ("pos0", pos0),
                    ("fills", fills), ("carry", carry), ("carry_out", carry_out)):
        if a is None:
            continue
        if want[name] is not None and tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got {tuple(a.shape)}")
        if a.device != frames.device:
            raise ValueError(f"{name} is on {a.device}, frames on {frames.device}")
    return bounded, S, B, T


def dog_scan_segments(frames: torch.Tensor, pos0: torch.Tensor, fill: int, *, radii,
                      sigma: float, darker_target: bool, deltas=None, lo=None, hi=None, ks=None,
                      subpixel: bool = False, kernel=None):
    """S chained scans of one lane: segment s tracks through ``frames[s]``
    (``frames [S, T, H, W]`` u8, with ``deltas``/``lo``/``hi [S, T, 2]`` when
    bounded). Segment 0 starts from ``pos0``; segment s > 0 from segment s-1's
    position at step ``max(ks[s-1] - 1, 0)`` (``ks [S]``, each chunk's real
    steps: the JAX package's ``make_super_chain``), or its last step without
    ``ks`` (``make_super_full``); ``deltas[s][0]`` rebases it.

    Returns positions ``int32 [S, T, 2]``, and with ``subpixel`` offsets
    ``float32 [S, T, 2]``. A CUDA tensor launches the kernel once (``kernel``
    as in :func:`dog_scan`); a CPU tensor runs the plain version; any other
    device raises."""
    check_kernel(kernel)
    args = dict(radii=radii, sigma=sigma, darker_target=darker_target, deltas=deltas, lo=lo,
                hi=hi, ks=ks, subpixel=subpixel)
    if frames.is_cuda:
        return dog_scan_segments_cuda(frames, pos0, fill, kernel=kernel, **args)
    if frames.device.type == "cpu":
        return dog_scan_segments_plain(frames, pos0, fill, **args)
    raise ValueError(f"dog_scan_segments runs on CUDA or CPU tensors, got {frames.device}")


def _row(pos, ks, T: int):
    """Per lane, the row ``max(min(ks, T) - 1, 0)`` of ``pos [..., T, 2]``."""
    idx = (ks.to(torch.int64).clamp(max=T) - 1).clamp(min=0)
    if pos.dim() == 2:
        return pos[idx]
    return pos[torch.arange(pos.shape[0], device=pos.device), idx]


def dog_scan_segments_plain(frames: torch.Tensor, pos0: torch.Tensor, fill: int, *, radii,
                            sigma: float, darker_target: bool, deltas=None, lo=None, hi=None,
                            ks=None, subpixel: bool = False):
    """The plain PyTorch version of :func:`dog_scan_segments`, on any device:
    :func:`dog_scan_plain` a segment, chained by the same rule."""
    bounded, S, _, T = _check_segment_args(frames, pos0, None, deltas, lo, hi, ks, None, None,
                                           None, None, batched=False)
    outs, p = [], pos0
    for s in range(S):
        box = dict(deltas=deltas[s], lo=lo[s], hi=hi[s]) if bounded else {}
        out = dog_scan_plain(frames[s], p, fill, radii=radii, sigma=sigma,
                             darker_target=darker_target, subpixel=subpixel, **box)
        pos = out[0] if subpixel else out
        p = pos[-1] if ks is None else _row(pos, ks[s], T)
        outs.append(out)
    if subpixel:
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    return torch.stack(outs)


def dog_scan_batch_segments(frames: torch.Tensor, pos0, fills: torch.Tensor, *, radii,
                            sigma: float, darker_target: bool, deltas=None, lo=None, hi=None,
                            ks=None, origin0=None, origin_last=None, carry=None, carry_out=None,
                            subpixel: bool = False, kernel=None):
    """S chained scans of B lanes: segment s of lane b tracks through
    ``frames[s, b]`` (``frames [S, B, T, H, W]``, or every lane through
    ``frames[s]`` of a shared ``[S, T, H, W]``) with fill ``fills[b]``, and
    ``deltas``/``lo``/``hi [S, B, T, 2]`` when bounded.

    The chain between segments, as the JAX package's:

    - with ``carry [B, 2]`` (absolute positions; ``ks [S, B]``, ``origin0``
      and ``origin_last [S, B, 2]``; ``pos0`` unused): segment s starts at
      ``carry - origin0[s]``, and after it ``carry = pos[s, b, ks-1] +
      origin_last[s, b]`` where ``ks[s, b] > 0`` (``make_super_chain_batch``;
      S = 1 is ``make_chained_batch``). The carry after the last segment goes
      to ``carry_out`` (a new tensor when None; it may be ``carry`` itself)
      and the call returns ``(positions, carry_out)``;
    - without: from ``pos0 [B, 2]``, each next segment from the last one's
      step ``max(ks-1, 0)`` (``ks [S, B]``) or its last step.

    Positions are ``int32 [S, B, T, 2]`` (with ``subpixel``, a pair with
    offsets ``float32 [S, B, T, 2]``). A CUDA tensor launches the kernel once
    (``kernel`` as in :func:`dog_scan`); a CPU tensor runs the plain version;
    any other device raises."""
    check_kernel(kernel)
    args = dict(radii=radii, sigma=sigma, darker_target=darker_target, deltas=deltas, lo=lo,
                hi=hi, ks=ks, origin0=origin0, origin_last=origin_last, carry=carry,
                carry_out=carry_out, subpixel=subpixel)
    if frames.is_cuda:
        return dog_scan_batch_segments_cuda(frames, pos0, fills, kernel=kernel, **args)
    if frames.device.type == "cpu":
        return dog_scan_batch_segments_plain(frames, pos0, fills, **args)
    raise ValueError(f"dog_scan_batch_segments runs on CUDA or CPU tensors, got "
                     f"{frames.device}")


def dog_scan_batch_segments_plain(frames: torch.Tensor, pos0, fills: torch.Tensor, *, radii,
                                  sigma: float, darker_target: bool, deltas=None, lo=None,
                                  hi=None, ks=None, origin0=None, origin_last=None, carry=None,
                                  carry_out=None, subpixel: bool = False):
    """The plain PyTorch version of :func:`dog_scan_batch_segments`, on any
    device: :func:`dog_scan_batch_plain` a segment, chained by the same rule."""
    bounded, S, B, T = _check_segment_args(frames, pos0, fills, deltas, lo, hi, ks, origin0,
                                           origin_last, carry, carry_out, batched=True)
    c = None if carry is None else carry.clone()
    outs, p = [], pos0
    for s in range(S):
        if c is not None:
            p = c - origin0[s]
        box = dict(deltas=deltas[s], lo=lo[s], hi=hi[s]) if bounded else {}
        out = dog_scan_batch_plain(frames[s], p, fills, radii=radii, sigma=sigma,
                                   darker_target=darker_target, subpixel=subpixel, **box)
        pos = out[0] if subpixel else out
        if c is not None:
            c = torch.where((ks[s] > 0)[:, None], _row(pos, ks[s], T) + origin_last[s], c)
        else:
            p = pos[:, -1] if ks is None else _row(pos, ks[s], T)
        outs.append(out)
    out = ((torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])) if subpixel
           else torch.stack(outs))
    if c is None:
        return out
    if carry_out is None:
        return out, c
    carry_out.copy_(c)
    return out, carry_out


def _shared_stride(named: dict, S: int):
    """The int32 per-segment arguments ``named`` as views with one segment
    stride, and that stride: as given where every one's segment 0 is
    contiguous and they share ``stride(0)`` (views of one buffer, as the
    pipelines stage them), else packed into one new ``[S, n]`` buffer."""
    present = {k: a for k, a in named.items() if a is not None}
    if not present or (S == 1 and all(a[0].is_contiguous() for a in present.values())):
        return named, 0
    strides = {a.stride(0) for a in present.values()}
    if len(strides) == 1 and all(a[0].is_contiguous() for a in present.values()):
        return named, strides.pop()
    flat = torch.cat([a.reshape(S, -1) for a in present.values()], dim=1).contiguous()
    out, at = dict(named), 0
    for k, a in present.items():
        n = a[0].numel()
        out[k] = flat[:, at:at + n].view(a.shape)
        at += n
    return out, flat.stride(0)


def _segments_launch(frames, lane_stride, B, pos0, fills, args: dict, carry, carry_out, radii,
                     sigma, darker_target, subpixel, config, kernel=None):
    """Launch a segmented scan: ``args`` holds the per-segment int32 tensors."""
    S, T = frames.shape[0], frames.shape[-3]
    if not frames[0].is_contiguous():
        raise ValueError("frames must be contiguous within a segment")
    a, arg_stride = _shared_stride(args, S)
    seg = _Segments(S, frames.stride(0) if S > 1 else 0, arg_stride, a["ks"], a["origin0"],
                    a["origin_last"], carry, carry_out)
    return _launch(frames, lane_stride, B, T, pos0, fills, a["deltas"], a["lo"], a["hi"], radii,
                   sigma, darker_target, subpixel, config, seg, kernel=kernel)


def dog_scan_segments_cuda(frames: torch.Tensor, pos0: torch.Tensor, fill: int, *, radii,
                           sigma: float, darker_target: bool, deltas=None, lo=None, hi=None,
                           ks=None, subpixel: bool = False, kernel=None):
    """Launch a kernel of ``csrc/dog_scan.cu`` (``kernel`` as in
    :func:`dog_scan_cuda`) once for S chained scans of one lane (:func:`dog_scan_segments`) on the current stream, for CUDA tensors
    (int32 ``pos0``/``deltas``/``lo``/``hi``/``ks``, each segment contiguous).
    Raises on anything the kernel does not take and on a failed launch."""
    bounded, S, _, T = _check_segment_args(frames, pos0, None, deltas, lo, hi, ks, None, None,
                                           None, None, batched=False)
    named = dict(deltas=deltas, lo=lo, hi=hi, ks=ks, origin0=None, origin_last=None)
    _check_cuda(dict(frames=frames[0], pos0=pos0, **{k: v if v is None else v[0]
                                                     for k, v in named.items()}))
    out_pos, out_off = _segments_launch(
        frames, 0, 1, pos0, _fill_tensor(int(fill), frames.device), named, None, None, radii,
        sigma, darker_target, subpixel, _config_name(bounded, subpixel, segmented=True),
        kernel=kernel)
    return (out_pos[:, 0], out_off[:, 0]) if subpixel else out_pos[:, 0]


def dog_scan_batch_segments_cuda(frames: torch.Tensor, pos0, fills: torch.Tensor, *, radii,
                                 sigma: float, darker_target: bool, deltas=None, lo=None,
                                 hi=None, ks=None, origin0=None, origin_last=None, carry=None,
                                 carry_out=None, subpixel: bool = False, kernel=None):
    """Launch a kernel of ``csrc/dog_scan.cu`` (``kernel`` as in
    :func:`dog_scan_cuda`) once for S chained scans of B lanes (:func:`dog_scan_batch_segments`) on the current stream, for CUDA
    tensors (uint8 ``fills``; int32 ``pos0``, ``carry``, ``carry_out`` and
    the per-segment arguments, each segment contiguous). The kernel reads
    ``carry`` before it writes ``carry_out``, so the two may be one tensor.
    Raises on anything the kernel does not take and on a failed launch."""
    bounded, S, B, T = _check_segment_args(frames, pos0, fills, deltas, lo, hi, ks, origin0,
                                           origin_last, carry, carry_out, batched=True)
    named = dict(deltas=deltas, lo=lo, hi=hi, ks=ks, origin0=origin0, origin_last=origin_last)
    if carry is not None and carry_out is None:
        carry_out = torch.empty((B, 2), dtype=torch.int32, device=frames.device)
    _check_cuda(dict(frames=frames[0], fills=fills, pos0=pos0, carry=carry, carry_out=carry_out,
                     **{k: v if v is None else v[0] for k, v in named.items()}))
    lane_stride = 0 if frames.dim() == 4 else frames.stride(1)
    out_pos, out_off = _segments_launch(
        frames, lane_stride, B, None if carry is not None else pos0, fills, named, carry,
        carry_out, radii, sigma, darker_target, subpixel,
        _config_name(bounded, subpixel, batched=True, segmented=True), kernel=kernel)
    out = (out_pos, out_off) if subpixel else out_pos
    return out if carry is None else (out, carry_out)


class StagedScan:
    """S chained chunk scans (:func:`dog_scan_segments` of one lane, or
    :func:`dog_scan_batch_segments` of B lanes with the carry) over buffers
    that stay put from launch to launch, as the ROI engines' device groups do:
    ``frames [cap, (B,) T, H, W]`` u8 and the int32 per-segment arguments,
    views of one buffer that share one segment stride. The wrapper's checks
    (shapes, types, devices, layout) run once, here, over all ``cap``
    segments, and so do the kernel's choice, the taps and the outputs'
    allocation; :meth:`run` launches the first S segments with them, one
    ctypes call. On the CPU, and with ``plain=True`` (``engine="xla"``),
    :meth:`run` calls the plain version on the same views.

    One lane: ``fill`` an int; ``run(S, pos0=[2])``, where S = 1 launches the
    unsegmented chunk scan, as :func:`dog_scan` does, and S > 1 segment s > 0
    from segment s-1's row ``max(ks-1, 0)``. B lanes: ``fill`` a uint8
    ``[B]`` tensor, ``origin0``/``origin_last [cap, B, 2]``; ``run(S,
    carry=[B, 2], carry_out=[B, 2])``. ``kernel`` as in :func:`dog_scan`."""

    def __init__(self, frames, fill, *, deltas, lo, hi, ks, origin0=None, origin_last=None,
                 radii, sigma: float, darker_target: bool, subpixel: bool = False, kernel=None,
                 plain: bool = False):
        check_kernel(kernel)
        self.batched = origin0 is not None
        dev = frames.device
        self.device = dev
        self.subpixel = bool(subpixel)
        self.plain = bool(plain) or not frames.is_cuda
        self.fill = fill
        self.cap = frames.shape[0]
        self.args = dict(deltas=deltas, lo=lo, hi=hi, ks=ks, origin0=origin0,
                         origin_last=origin_last)
        self.frames = frames
        self.kw = dict(radii=radii, sigma=sigma, darker_target=darker_target,
                       subpixel=self.subpixel)
        if self.batched:
            fills = fill
            B = fills.shape[0]
            chain = torch.zeros((B, 2), dtype=torch.int32, device=dev)
            _, S, B, T = _check_segment_args(frames, None, fills, deltas, lo, hi, ks, origin0,
                                             origin_last, chain, chain, batched=True)
        else:
            fills = _fill_tensor(int(fill), dev)
            chain = torch.zeros(2, dtype=torch.int32, device=dev)
            _, S, B, T = _check_segment_args(frames, chain, None, deltas, lo, hi, ks, None,
                                             None, None, None, batched=False)
        self.lanes = B
        # the views of every S, made once
        self._frames = [frames[:n] for n in range(1, S + 1)]
        self._args = [{k: None if v is None else v[:n] for k, v in self.args.items()}
                      for n in range(1, S + 1)]
        if not self.plain:
            _check_cuda(dict(frames=frames[0], fills=fills, pos0=chain,
                             **{k: v if v is None else v[0] for k, v in self.args.items()}))
        # the layout the launch reads: each segment contiguous, the arguments
        # one segment stride apart (a stride of one segment is never read)
        present = [v for v in self.args.values() if v is not None]
        strides = {v.stride(0) for v in present}
        if (not frames[0].is_contiguous() or not all(v[0].is_contiguous() for v in present)
                or (S > 1 and len(strides) != 1)):
            raise ValueError("the staged buffers must hold each segment contiguous, the "
                             "per-segment arguments views of one buffer with one segment stride")
        if self.plain:
            return
        self._arg_stride = strides.pop()
        self._frame_stride = frames.stride(0)
        taps, direction, L = _taps(float(sigma), bool(darker_target), dev)
        self._taps = taps  # kept alive: the launches read it
        self._index = dev.index if dev.index is not None else 0
        self._limit = _smem_limit(self._index)
        self.kernel = _pick_kernel(kernel, radii, L, self._limit)
        self._L, self._radii = L, (int(radii[0]), int(radii[1]))
        self._out_pos = torch.empty((S, B, T, 2), dtype=torch.int32, device=dev)
        self._out_off = (torch.empty((S, B, T, 2), dtype=torch.float32, device=dev)
                         if self.subpixel else None)
        out = [(self._out_pos[:n], None if self._out_off is None else self._out_off[:n])
               for n in range(1, S + 1)]
        self._out = [(p, o) if self.batched else (p[:, 0], None if o is None else o[:, 0])
                     for p, o in out]
        H, W = frames.shape[-2:]
        lane_stride = frames.stride(1) if self.batched and frames.dim() == 5 else 0
        a = self.args
        # the launch's arguments (csrc/dog_scan.cu's common interface) but for
        # the chain's start, the segment count and the two strides
        self._head = (frames.data_ptr(), lane_stride, B, T, H, W)
        self._mid = (fills.data_ptr(), a["deltas"].data_ptr(), a["lo"].data_ptr(),
                     a["hi"].data_ptr(), taps.data_ptr(), L, self._radii[0], self._radii[1],
                     direction, self._out_pos.data_ptr(), _ptr(self._out_off))
        self._tail = (a["ks"].data_ptr(), _ptr(a["origin0"]), _ptr(a["origin_last"]))
        self._configs = [_config_name(True, self.subpixel, self.batched,
                                      segmented=self.batched or n > 1) for n in (1, 2)]

    def run(self, S: int, pos0=None, carry=None, carry_out=None):
        """Launch segments ``[0, S)`` from ``pos0`` (one lane) or ``carry``
        into ``carry_out`` (B lanes). Returns positions ``[S, (B,) T, 2]`` (a
        pair with offsets under subpixel): on the card, views of outputs the
        next run of this object overwrites."""
        if not 1 <= S <= self.cap:
            raise ValueError(f"S must lie in [1, {self.cap}], got {S}")
        frames, args = self._frames[S - 1], self._args[S - 1]
        if self.plain:
            if self.batched:
                out, _ = dog_scan_batch_segments_plain(frames, None, self.fill, carry=carry,
                                                       carry_out=carry_out, **args, **self.kw)
                return out
            return dog_scan_segments_plain(frames, pos0, self.fill, deltas=args["deltas"],
                                           lo=args["lo"], hi=args["hi"],
                                           ks=None if S == 1 else args["ks"], **self.kw)
        single = not self.batched and S == 1  # the unsegmented chunk scan
        if self.batched:
            chain = (None, S, self._frame_stride if S > 1 else 0,
                     self._arg_stride if S > 1 else 0, *self._tail, carry.data_ptr(),
                     carry_out.data_ptr())
        else:
            chain = (pos0.data_ptr(), S, self._frame_stride if S > 1 else 0,
                     self._arg_stride if S > 1 else 0,
                     None if single else self._tail[0], None, None, None, None)
        lib = _lib()
        with torch.cuda.device(self._index):
            stream = torch.cuda.current_stream(self._index).cuda_stream
            args = (*self._head, chain[0], *self._mid, *chain[1:])
            if self.kernel == "dog_scan":
                plan = _scan_plan(self._radii, self._L, self._limit, self.lanes, self._index)
                err = lib.dog_scan_launch(*args, plan.cluster, stream)
            else:
                plan = _tiled_plan(self._radii, self._L, self._limit, self.subpixel,
                                   self._index)
                err = lib.dog_scan_tiled_launch(*args, *plan.tile, plan.cluster, stream)
        if err != 0:
            raise RuntimeError(f"{self.kernel} launch failed: "
                               f"{lib.dog_scan_error_string(err).decode()}")
        _count(self.kernel, self._configs[0 if S == 1 else 1])
        pos, off = self._out[S - 1]
        return (pos, off) if self.subpixel else pos
