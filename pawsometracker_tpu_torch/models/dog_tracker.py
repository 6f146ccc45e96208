"""The DoG tracker model in PyTorch.

The same tracker as ``pawsometracker_tpu/models/dog_tracker.py``: a static
:class:`TrackerSpec`, and per spec the step functions ``snap``/``scan`` and
their bounded and subpixel forms. One step cuts the search window (plus the
kernel apron) around the last position, out-of-frame cells taking the mode
fill; computes the DoG response as two separable correlations; takes the
first maximum in column-major order; and clamps the new position to the frame
(or to a per-step box). A chunk of frames runs as one call of
:func:`~..ops.tracker_kernel.dog_scan` (one chain) or
:func:`~..ops.tracker_kernel.dog_scan_batch` (B videos, or N targets in one
video): the CUDA kernel for tensors on the card, its plain version on the
CPU, or the plain version anywhere with ``engine="xla"``.

All coordinates are 0-based ``(row, col)`` int32.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.dog_kernel import default_gaussian_len, get_sigma
from ..ops.tracker_kernel import (KERNELS, StagedScan, check_kernel, dog_scan, dog_scan_batch,
                                  dog_scan_batch_plain, dog_scan_batch_segments,
                                  dog_scan_batch_segments_plain, dog_scan_plain, dog_scan_segments,
                                  dog_scan_segments_plain)

__all__ = ["TrackerSpec", "TrackerFns", "tracker_fns", "center_guess", "autodetect_spec",
           "make_spec", "spec_from_reference", "resolve_device", "frame_box",
           "full_frame_sub_scan"]


@dataclass(frozen=True)
class TrackerSpec:
    """Static configuration of one tracker instance (reference tracker
    constructor inputs, src/PawsomeTracker.jl:39-52)."""

    frame_shape: tuple[int, int]  # (H, W)
    window_size: tuple[int, int]  # (rows, cols), already normalized
    target_width: float
    darker_target: bool

    @property
    def sigma(self) -> float:
        return get_sigma(self.target_width)

    @property
    def radii(self) -> tuple[int, int]:
        return (self.window_size[0] // 2, self.window_size[1] // 2)

    @property
    def kernel_len(self) -> int:
        # support comes from the SURROUND gaussian (sigma * sqrt(2))
        return default_gaussian_len(self.sigma * math.sqrt(2.0))

    @property
    def pad(self) -> tuple[int, int]:
        """Apron each frame needs so every window tap is in-bounds:
        ``radii + L//2``."""
        half = self.kernel_len // 2
        return (self.radii[0] + half, self.radii[1] + half)

    @property
    def patch_shape(self) -> tuple[int, int]:
        ri, rj = self.radii
        L = self.kernel_len
        return (2 * ri + L, 2 * rj + L)


def center_guess(frame_shape: tuple[int, int]) -> tuple[int, int]:
    """Frame-center starting guess, 0-based (the reference's 1-based
    ``sz .div 2``, src/PawsomeTracker.jl:86-90)."""
    return (frame_shape[0] // 2 - 1, frame_shape[1] // 2 - 1)


def autodetect_spec(spec: TrackerSpec) -> TrackerSpec:
    """First-pass auto-detection spec with a quarter-frame window
    (reference: src/PawsomeTracker.jl:99-107)."""
    h, w = spec.frame_shape
    return TrackerSpec(
        frame_shape=spec.frame_shape,
        window_size=(h // 4, w // 4),
        target_width=spec.target_width,
        darker_target=spec.darker_target,
    )


def make_spec(frame_shape, window_size, target_width, darker_target) -> TrackerSpec:
    """Build a spec. ``window_size`` is a scalar edge length or an
    ALREADY-NORMALIZED ``(rows, cols)`` pair (the ``(w, h)`` reversal happens
    once, in :func:`~..ops.dog_kernel.fix_window_size`)."""
    if isinstance(window_size, (tuple, list)):
        if len(window_size) != 2:
            raise ValueError(f"window_size must be an int or (rows, cols), got {window_size!r}")
        ws = (int(window_size[0]), int(window_size[1]))
    else:
        ws = (int(window_size), int(window_size))
    if not float(target_width) > 0:
        # sigma=0 would give an identically-zero DoG kernel: every track
        # would march to the frame corner
        raise ValueError(f"target_width must be > 0, got {target_width!r}")
    if ws[0] < 1 or ws[1] < 1:
        raise ValueError(f"window_size must be >= 1 per axis, got {ws!r}")
    return TrackerSpec(
        frame_shape=(int(frame_shape[0]), int(frame_shape[1])),
        window_size=ws,
        target_width=float(target_width),
        darker_target=bool(darker_target),
    )


def spec_from_reference(fields: dict) -> TrackerSpec:
    """The port's spec from another tracker spec's fields as plain values
    (``frame_shape``, ``window_size``, ``target_width``, ``darker_target``,
    e.g. ``dataclasses.asdict`` of the JAX package's spec). The tracker has
    no weights: these fields and the DoG taps derived from them are all its
    parameters."""
    return make_spec(tuple(fields["frame_shape"]), tuple(fields["window_size"]),
                     fields["target_width"], fields["darker_target"])


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card and
    raises when there is none (the port never quietly runs on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                               "the plain PyTorch version on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or the CPU, got {dev}")
    return dev


@functools.lru_cache(maxsize=64)
def frame_box(frame_shape, lead: tuple, device: torch.device):
    """``(zeros, hi)``: int32 ``[*lead, 2]`` tensors on ``device``, ``hi``
    holding the frame's last row and column. As ``deltas``, ``lo`` and ``hi``
    of a bounded scan they make it a whole-frame scan. Made once per shape."""
    zeros = torch.zeros(tuple(lead) + (2,), dtype=torch.int32, device=device)
    last = torch.tensor([frame_shape[0] - 1, frame_shape[1] - 1], dtype=torch.int32)
    return zeros, last.expand(tuple(lead) + (2,)).contiguous().to(device)


def full_frame_sub_scan(scan_sub, frame_shape, device: torch.device):
    """A bounded subpixel scan (``scan_sub`` or ``scan_sub_batch`` of
    :class:`TrackerFns`) as a whole-frame scan ``run(frames, pos0, fill)``:
    zero deltas and the clamp box pinned to the frame."""

    def run(frames, pos0, fill):
        zeros, hi = frame_box(tuple(frame_shape), tuple(pos0.shape[:-1]) + (frames.shape[-3],),
                              device)
        return scan_sub(frames, pos0, fill, zeros, zeros, hi)

    return run


@dataclass(frozen=True)
class TrackerFns:
    """Spec-specialized tracker entry points on one device (tensors or
    numpy arrays in, tensors on ``device`` out):

    - ``snap(frame [H,W], guess [2], fill) -> int32 [2]``
    - ``scan(frames [T,H,W], pos0 [2], fill) -> int32 [T,2]``
    - ``scan_bounded(frames, pos0, fill, deltas, lo, hi) -> int32 [T,2]``
    - ``scan_sub(frames, pos0, fill, deltas, lo, hi) -> (int32 [T,2], float32 [T,2])``
    - ``snap_sub(frame, guess, fill) -> (int32 [2], float32 [2])``

    B videos in one launch, with per-video fills ``fills [B]`` (u8):

    - ``snap_batch(frames [B,H,W], guesses [B,2], fills) -> int32 [B,2]``
    - ``scan_batch(frames [B,T,H,W], pos0 [B,2], fills) -> int32 [B,T,2]``
    - ``scan_bounded_batch(frames, pos0, fills, deltas, lo, hi [B,T,2]) -> int32 [B,T,2]``
    - ``scan_sub_batch(frames, pos0, fills, deltas, lo, hi) -> (int32 [B,T,2], float32 [B,T,2])``
    - ``snap_sub_batch(frames [B,H,W], guesses, fills) -> (int32 [B,2], float32 [B,2])``

    N targets in one video, in one launch whose lanes read the same frames
    (the JAX package's layout, steps first):

    - ``snap_multi(frame [H,W], guesses [N,2], fill) -> int32 [N,2]``
    - ``scan_multi(frames [T,H,W], pos0s [N,2], fill) -> int32 [T,N,2]``
    - ``snap_multi_sub(frame, guesses, fill) -> (int32 [N,2], float32 [N,2])``
    - ``scan_multi_sub(frames, pos0s, fill) -> (int32 [T,N,2], float32 [T,N,2])``, clamped
      to the frame

    S chunk scans chained in one launch (the counterparts of the JAX package's
    group dispatch, ``make_super_chain``, ``make_super_chain_batch`` and
    ``make_super_full``), each with ``subpixel=True`` also returning offsets
    of the positions' shape:

    - ``scan_bounded_super(crops [S,K,ch,cw], pos0 [2], fill, deltas, lo, hi [S,K,2], ks [S])
      -> int32 [S,K,2]``: segment s > 0 starts at segment s-1's row ``max(ks-1, 0)``;
    - ``scan_bounded_batch_super(crops [S,L,K,ch,cw], carry [L,2], fills [L], deltas, lo, hi
      [S,L,K,2], ks [S,L], origin0, origin_last [S,L,2], carry_out=None) -> (int32 [S,L,K,2],
      carry [L,2])``: the absolute carry across segments;
    - ``scan_super(frames [S,T,H,W], pos0 [2], fill) -> int32 [S,T,2]``: whole frames,
      each segment from the last one's last step (with ``subpixel``, clamped to the frame).

    The two bounded ones also come staged, for buffers that stay put from
    launch to launch (the ROI engines' device groups), as
    :class:`~..ops.tracker_kernel.StagedScan` s whose checks run once:
    ``scan_bounded_super.stage(crops [cap,K,ch,cw], fill, deltas, lo, hi, ks)`` and
    ``scan_bounded_batch_super.stage(crops [cap,L,K,ch,cw], fills, deltas, lo, hi, ks,
    origin0, origin_last)``, each with ``subpixel=``.
    """

    spec: TrackerSpec
    snap: callable
    scan: callable
    scan_bounded: callable
    scan_sub: callable
    snap_sub: callable
    snap_batch: callable
    scan_batch: callable
    scan_bounded_batch: callable
    scan_sub_batch: callable
    snap_sub_batch: callable
    scan_multi: callable
    snap_multi: callable
    scan_multi_sub: callable
    snap_multi_sub: callable
    scan_bounded_super: callable
    scan_bounded_batch_super: callable
    scan_super: callable


@functools.lru_cache(maxsize=1024)
def _lane_fills(fill: int, n: int, device: torch.device) -> torch.Tensor:
    """One fill for ``n`` lanes, as uint8 ``[n]`` on ``device``, made once."""
    return torch.full((n,), int(fill), dtype=torch.uint8, device=device)


def _build(spec: TrackerSpec, device: torch.device, engine: str) -> TrackerFns:
    """``engine``: ``"xla"`` (the plain version), ``"kernel"`` (the shape
    rule's kernel) or a kernel's name (:data:`~..ops.tracker_kernel.KERNELS`)."""
    plain = engine == "xla"
    run = dog_scan_plain if plain else dog_scan
    run_b = dog_scan_batch_plain if plain else dog_scan_batch
    run_s = dog_scan_segments_plain if plain else dog_scan_segments
    run_bs = dog_scan_batch_segments_plain if plain else dog_scan_batch_segments
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=spec.darker_target)
    if engine in KERNELS:
        kw["kernel"] = engine

    def u8(x):
        return torch.as_tensor(x, device=device).to(torch.uint8).contiguous()

    def i32(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=device).to(torch.int32).contiguous()

    def seg(x):
        # the per-segment arguments keep their strides: the pipelines hand views of one
        # staged buffer, which the kernel reads as they lie
        if torch.is_tensor(x) and x.dtype == torch.int32 and x.device == device:
            return x
        return i32(x)

    def snap(frame_u8, guess, fill):
        return run(u8(frame_u8)[None], i32(guess), int(fill), **kw)[0]

    def snap_sub(frame_u8, guess, fill):
        pos, off = run(u8(frame_u8)[None], i32(guess), int(fill), subpixel=True, **kw)
        return pos[0], off[0]

    def scan(frames_u8, pos0, fill):
        return run(u8(frames_u8), i32(pos0), int(fill), **kw)

    def scan_bounded(frames_u8, pos0, fill, deltas, lo, hi):
        return run(u8(frames_u8), i32(pos0), int(fill), deltas=i32(deltas), lo=i32(lo),
                   hi=i32(hi), **kw)

    def scan_sub(frames_u8, pos0, fill, deltas, lo, hi):
        return run(u8(frames_u8), i32(pos0), int(fill), deltas=i32(deltas), lo=i32(lo),
                   hi=i32(hi), subpixel=True, **kw)

    def snap_batch(frames_u8, guesses, fills):
        return run_b(u8(frames_u8)[:, None], i32(guesses), u8(fills), **kw)[:, 0]

    def snap_sub_batch(frames_u8, guesses, fills):
        pos, off = run_b(u8(frames_u8)[:, None], i32(guesses), u8(fills), subpixel=True, **kw)
        return pos[:, 0], off[:, 0]

    def scan_batch(frames_u8, pos0, fills):
        return run_b(u8(frames_u8), i32(pos0), u8(fills), **kw)

    def scan_bounded_batch(frames_u8, pos0, fills, deltas, lo, hi):
        return run_b(u8(frames_u8), i32(pos0), u8(fills), deltas=i32(deltas), lo=i32(lo),
                     hi=i32(hi), **kw)

    def scan_sub_batch(frames_u8, pos0, fills, deltas, lo, hi):
        return run_b(u8(frames_u8), i32(pos0), u8(fills), deltas=i32(deltas), lo=i32(lo),
                     hi=i32(hi), subpixel=True, **kw)

    def snap_multi(frame_u8, guesses, fill):
        g = i32(guesses)
        return run_b(u8(frame_u8)[None], g, _lane_fills(int(fill), g.shape[0], device),
                     **kw)[:, 0]

    def snap_multi_sub(frame_u8, guesses, fill):
        g = i32(guesses)
        pos, off = run_b(u8(frame_u8)[None], g, _lane_fills(int(fill), g.shape[0], device),
                         subpixel=True, **kw)
        return pos[:, 0], off[:, 0]

    def scan_multi(frames_u8, pos0s, fill):
        p = i32(pos0s)
        return run_b(u8(frames_u8), p, _lane_fills(int(fill), p.shape[0], device),
                     **kw).transpose(0, 1)

    def scan_multi_sub(frames_u8, pos0s, fill):
        p, f = i32(pos0s), u8(frames_u8)
        zeros, hi = frame_box(spec.frame_shape, (p.shape[0], f.shape[0]), device)
        pos, off = run_b(f, p, _lane_fills(int(fill), p.shape[0], device), deltas=zeros,
                         lo=zeros, hi=hi, subpixel=True, **kw)
        return pos.transpose(0, 1), off.transpose(0, 1)

    def scan_bounded_super(crops_u8, pos0, fill, deltas, lo, hi, ks, *, subpixel=False):
        return run_s(u8(crops_u8), seg(pos0), int(fill), deltas=seg(deltas), lo=seg(lo),
                     hi=seg(hi), ks=seg(ks), subpixel=subpixel, **kw)

    def scan_bounded_batch_super(crops_u8, carry, fills, deltas, lo, hi, ks, origin0,
                                 origin_last, *, carry_out=None, subpixel=False):
        return run_bs(u8(crops_u8), None, u8(fills), deltas=seg(deltas), lo=seg(lo), hi=seg(hi),
                      ks=seg(ks), origin0=seg(origin0), origin_last=seg(origin_last),
                      carry=seg(carry), carry_out=carry_out, subpixel=subpixel, **kw)

    def stage_bounded_super(crops_u8, fill, deltas, lo, hi, ks, *, subpixel=False):
        return StagedScan(crops_u8, int(fill), deltas=deltas, lo=lo, hi=hi, ks=ks,
                          subpixel=subpixel, plain=plain, **kw)

    def stage_bounded_batch_super(crops_u8, fills, deltas, lo, hi, ks, origin0, origin_last, *,
                                  subpixel=False):
        return StagedScan(crops_u8, fills, deltas=deltas, lo=lo, hi=hi, ks=ks, origin0=origin0,
                          origin_last=origin_last, subpixel=subpixel, plain=plain, **kw)

    scan_bounded_super.stage = stage_bounded_super
    scan_bounded_batch_super.stage = stage_bounded_batch_super

    def scan_super(frames_u8, pos0, fill, *, subpixel=False):
        f = u8(frames_u8)
        if not subpixel:
            return run_s(f, i32(pos0), int(fill), **kw)
        zeros, hi = frame_box(spec.frame_shape, tuple(f.shape[:2]), device)
        return run_s(f, i32(pos0), int(fill), deltas=zeros, lo=zeros, hi=hi, subpixel=True, **kw)

    return TrackerFns(spec=spec, snap=snap, scan=scan, scan_bounded=scan_bounded,
                      scan_sub=scan_sub, snap_sub=snap_sub, snap_batch=snap_batch,
                      scan_batch=scan_batch, scan_bounded_batch=scan_bounded_batch,
                      scan_sub_batch=scan_sub_batch, snap_sub_batch=snap_sub_batch,
                      scan_multi=scan_multi, snap_multi=snap_multi,
                      scan_multi_sub=scan_multi_sub, snap_multi_sub=snap_multi_sub,
                      scan_bounded_super=scan_bounded_super,
                      scan_bounded_batch_super=scan_bounded_batch_super, scan_super=scan_super)


@functools.lru_cache(maxsize=256)
def _tracker_fns_cached(spec: TrackerSpec, device: torch.device, engine: str) -> TrackerFns:
    return _build(spec, device, engine)


def tracker_fns(spec: TrackerSpec, device=None, engine: str = "auto",
                kernel: str | None = None) -> TrackerFns:
    """Tracker functions for ``spec`` on ``device`` (cached per spec, device,
    engine and kernel). ``device=None`` is the card. ``engine``: ``"auto"``
    and ``"pallas"`` run a CUDA kernel on the card (the plain version on the
    CPU), ``kernel`` (one of :data:`~..ops.tracker_kernel.KERNELS`) or, when
    None, the one the window's shape picks; ``"xla"`` runs the plain PyTorch
    version on either, and takes no ``kernel``. Here ``"auto"`` measures
    nothing: the ROI pipelines measure their bounded scans
    (``pipeline.pick_bounded_engine``) and pass the kernel they chose."""
    if engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"engine must be one of ('auto', 'pallas', 'xla'), got {engine!r}")
    check_kernel(kernel)
    if engine == "xla" and kernel is not None:
        raise ValueError(f"engine='xla' runs the plain version, not the kernel {kernel!r}")
    key = "xla" if engine == "xla" else (kernel or "kernel")
    return _tracker_fns_cached(spec, resolve_device(device), key)
