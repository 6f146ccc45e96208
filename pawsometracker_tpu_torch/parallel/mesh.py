"""Batch tracking on one card, and the whole-frame DoG detectors.

The counterpart of the JAX package's ``pawsometracker_tpu/parallel/mesh.py``
in its single-device form. :class:`ShardedBatchTracker` gives the batched
tracker functions of one spec on one device, B videos per launch of the CUDA
kernel (one CTA per video). :func:`global_detect_batch` and
:func:`global_detect_peaks` find targets in whole frames, through the DoG
response that the JAX package computes outside its Pallas kernel.

Not ported yet (they wait for multi-GPU): ``make_mesh``, ``batch_sharding``,
``sharded_pallas_bounded`` and the mesh forms of :class:`ShardedBatchTracker`;
a ``mesh`` other than ``None`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.dog_tracker import TrackerSpec, autodetect_spec, resolve_device, tracker_fns
from ..ops.dog_kernel import dog_kernel_separable
from ..ops.filters import argmax_colmajor

__all__ = ["ShardedBatchTracker", "global_detect_batch", "global_detect_peaks"]

MULTI_GPU = ("a device mesh (multi-GPU) is not ported yet; pass mesh=None or mesh='auto' "
             "to run on one card")


def _batch_frame_response(spec: TrackerSpec):
    """Shared whole-frame DoG response: ``fn(frames_u8 [B,H,W], fills [B]) ->
    float32 [B,H,W]`` on the frames' device: pad each frame with its fill,
    then the separable correlation with the signed kernel. Both whole-frame
    detectors build on this so they can never disagree.

    The correlation is written as direct taps, each a float32 multiply and a
    separate add, rows first: no matrix product, so no TF32 and no library
    summation order, and the card and the CPU round every operation alike
    (``tests/test_torch_cuda.py`` holds them bit-equal). The JAX package uses
    banded matmuls at HIGHEST precision; the two agree on the peaks of
    distinct blobs, not on exact ties."""
    gc_np, gs_np, direction, L = dog_kernel_separable(spec.sigma, spec.darker_target)
    half = L // 2

    def response(frames: torch.Tensor, fills) -> torch.Tensor:
        B, H, W = frames.shape
        dev = frames.device
        fill = torch.as_tensor(np.asarray(fills), device=dev).to(torch.float32).view(B, 1, 1)
        x = fill.expand(B, H + 2 * half, W + 2 * half).clone()
        x[:, half:half + H, half:half + W] = frames.to(torch.float32)

        def corr(g_np):
            g = torch.from_numpy(np.asarray(g_np, np.float32)).to(dev)
            rows = torch.zeros((B, H, x.shape[2]), dtype=torch.float32, device=dev)
            for k in range(L):
                rows = rows + g[k] * x[:, k:k + H, :]
            out = torch.zeros((B, H, W), dtype=torch.float32, device=dev)
            for k in range(L):
                out = out + g[k] * rows[:, :, k:k + W]
            return out

        return direction * (corr(gc_np) - corr(gs_np))

    return response


@functools.lru_cache(maxsize=128)
def global_detect_batch(spec: TrackerSpec, mesh=None):
    """Whole-frame target detection, batched: the DoG response over the
    ENTIRE frame and its first maximum in column-major order per frame
    (the tracker's tie-break). Framework extension beyond the reference's
    quarter-frame auto-detect (reference: src/PawsomeTracker.jl:99-107).

    Returns ``fn(frames_u8 [B, H, W], fills_u8 [B]) -> int32 [B, 2]``, run on
    the frames' device (numpy frames run on the CPU)."""
    if mesh is not None:
        raise NotImplementedError(MULTI_GPU)
    H = spec.frame_shape[0]
    response = _batch_frame_response(spec)

    def detect(frames, fills):
        resp = response(torch.as_tensor(frames), fills)  # [B, H, W]
        # column-major first max, to match the tracker's tie-break
        k = torch.argmax(resp.transpose(1, 2).reshape(resp.shape[0], -1), dim=1)
        return torch.stack([k % H, k // H], dim=1).to(torch.int32)

    return detect


@functools.lru_cache(maxsize=128)
def global_detect_peaks(spec: TrackerSpec, n_targets: int, min_distance: int | None = None):
    """Top-``n_targets`` DoG-response peaks in ONE frame, with non-maximum
    suppression: multi-target auto-detection.

    Peaks are returned strongest-first; each peak suppresses a disk of radius
    ``min_distance`` (default: the search-window extent, so two targets are
    never the same blob). Ties break column-major like the tracker. If
    suppression exhausts the frame before N peaks are found, the remaining
    entries REPEAT the last valid peak; callers (``track_multi``) reject
    duplicate peaks with a clear error instead of seeding bogus trackers.

    Returns ``fn(frame_u8 [H, W], fill_u8) -> int32 [n_targets, 2]``, run on
    the frame's device."""
    H, W = spec.frame_shape
    N = int(n_targets)
    if min_distance is None:
        min_distance = max(2 * spec.radii[0] + 1, 2 * spec.radii[1] + 1)
    r2 = float(min_distance) ** 2
    response = _batch_frame_response(spec)

    def detect(frame_u8, fill_u8):
        frame = torch.as_tensor(frame_u8)
        resp = response(frame[None], [int(fill_u8)])[0]  # [H, W]
        dev = resp.device
        ii = torch.arange(H, device=dev)[:, None]
        jj = torch.arange(W, device=dev)[None, :]
        out = torch.zeros((N, 2), dtype=torch.int32, device=dev)
        for k in range(N):
            idx = argmax_colmajor(resp)
            if k > 0:
                # suppression exhausted the frame: repeat the previous peak
                exhausted = ~torch.isfinite(resp[idx[0].long(), idx[1].long()])
                idx = torch.where(exhausted, out[k - 1], idx)
            out[k] = idx
            d2 = (ii - idx[0]) ** 2 + (jj - idx[1]) ** 2
            resp = torch.where(d2.to(torch.float32) <= r2, -torch.inf, resp)
        return out

    return detect


class ShardedBatchTracker:
    """Batch-of-videos tracking engine on one device: the batched forms of
    :class:`~..models.dog_tracker.TrackerFns` for ``spec`` (and for its
    quarter-frame autodetect spec), each one launch of the CUDA kernel on the
    card for all B videos.

    ``snap``/``snap_detect``: ``(frames [B,H,W], guesses [B,2], fills [B]) ->
    [B,2]``; ``scan``: ``(frames [B,T,H,W], pos0 [B,2], fills) -> [B,T,2]``;
    ``scan_bounded``/``scan_sub`` take ``deltas, lo, hi [B,T,2]`` too;
    ``snap_sub``/``snap_detect_sub`` also return offsets. ``engine`` and
    ``device`` are as in :func:`~..models.dog_tracker.tracker_fns`. ``mesh``
    must be ``None`` (multi-GPU is not ported)."""

    def __init__(self, spec: TrackerSpec, mesh=None, engine: str = "auto", *, device=None):
        if mesh is not None:
            raise NotImplementedError(MULTI_GPU)
        self.spec = spec
        self.device = resolve_device(device)
        fns = tracker_fns(spec, self.device, engine)
        det = tracker_fns(autodetect_spec(spec), self.device, engine)
        self.snap = fns.snap_batch
        self.snap_detect = det.snap_batch
        self.scan = fns.scan_batch
        self.scan_bounded = fns.scan_bounded_batch
        self.scan_sub = fns.scan_sub_batch
        self.snap_sub = fns.snap_sub_batch
        self.snap_detect_sub = det.snap_sub_batch

    def shard_chunk(self, chunk) -> torch.Tensor:
        """Place a host array (a ``[B, T, H, W]`` chunk, or any per-video
        array) on the tracker's device."""
        return torch.as_tensor(np.ascontiguousarray(chunk)).to(self.device)
