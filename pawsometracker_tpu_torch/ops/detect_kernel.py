"""The whole-frame detectors' DoG response and rounds of suppression: hand-written CUDA
kernels, their wrappers and their plain versions.

:func:`frame_response` gives the DoG response of whole ``uint8`` frames, each on its
fill, and :func:`correlate` that of padded ``float32`` slabs (the space-sharded
detector's rows with their halo). :func:`suppress` takes the N strongest peaks of one
frame's response, each the first maximum in column-major order (the tracker's tie-break),
each suppressing a disc about it; exhausted rounds repeat the last peak.

A CUDA tensor launches the kernels of ``csrc/detect.cu`` (one launch for the response,
one for all N rounds) or raises; it never falls back. A CPU tensor runs the plain
versions, :func:`correlate_plain` and :func:`suppress_plain`, whose direct taps (each a
float32 multiply and a separate add, rows first) and rounds the kernels repeat operation
for operation, so the two agree bit for bit. :data:`launches` counts the kernels'
launches (and only those).
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import numpy as np
import torch

from .dog_kernel import dog_kernel_separable
from .tracker_kernel import _smem_limit

__all__ = ["frame_response", "correlate", "correlate_plain", "pad_plain", "fill_values",
           "suppress", "suppress_plain", "launches", "launches_by_kernel", "reset_launches", "disc_reach"]

#: kernel launches since import (or the last :func:`reset_launches`), and by kernel
launches = 0
launches_by_kernel: Counter = Counter()


def reset_launches() -> None:
    """Set the launch counts to 0."""
    global launches
    launches = 0
    launches_by_kernel.clear()


@functools.lru_cache(maxsize=64)
def _taps(sigma: float, darker_target: bool):
    """``(gc, gs, direction, L)``: the float32 factors of the signed DoG."""
    gc, gs, direction, L = dog_kernel_separable(sigma, darker_target)
    return gc.astype(np.float32), gs.astype(np.float32), float(direction), int(L)


@functools.lru_cache(maxsize=64)
def _tap_pairs(sigma: float, darker_target: bool, device: torch.device) -> torch.Tensor:
    """The taps as ``[L, 2]`` float32 (centre, surround) pairs on ``device``, made
    once, so a launch never waits on a host-to-device copy of them."""
    gc, gs, _, _ = _taps(sigma, darker_target)
    return torch.from_numpy(np.stack([gc, gs], axis=1)).to(device)


# ---- the plain versions -----------------------------------------------------------------


def fill_values(fills, B: int):
    """``fills`` checked to be ``B`` whole numbers in 0..255, as the frames' pixels are:
    a card tensor as it is, which must be uint8 (so no read back is needed to check it),
    anything else (a list, an array, a CPU tensor) as a uint8 array. Both the kernels and
    the plain versions take the fills through here, so they refuse the same fills and
    read the same values."""
    if torch.is_tensor(fills) and fills.is_cuda:
        if fills.dtype != torch.uint8 or fills.numel() != B:
            raise ValueError(f"fills on the card must be uint8 with one value a frame ({B}), "
                             f"got {fills.dtype} of {fills.numel()}")
        return fills.reshape(B)
    vals = np.asarray(fills.cpu() if torch.is_tensor(fills) else fills).reshape(-1)
    if vals.shape != (B,):
        raise ValueError(f"fills must hold one value a frame ({B}), got {vals.shape[0]}")
    if not np.all((vals >= 0) & (vals <= 255) & (vals % 1 == 0)):
        raise ValueError(f"fills must be whole numbers in 0..255, got {vals.tolist()}")
    return vals.astype(np.uint8)


def pad_plain(frames: torch.Tensor, fills, L: int) -> torch.Tensor:
    """``float32 [B, H+L-1, W+L-1]``: each of ``frames`` (uint8 ``[B, H, W]``) on its
    fill (``fills [B]``, see :func:`fill_values`), on the frames' device."""
    B, H, W = frames.shape
    half = L // 2
    fill = fill_values(fills, B)
    fill = fill if torch.is_tensor(fill) else torch.from_numpy(fill)
    fill = fill.to(device=frames.device, dtype=torch.float32).view(B, 1, 1)
    x = fill.expand(B, H + 2 * half, W + 2 * half).clone()
    x[:, half:half + H, half:half + W] = frames.to(torch.float32)
    return x


def correlate_plain(x: torch.Tensor, sigma: float, darker_target: bool) -> torch.Tensor:
    """``float32 [B, R, W]``: the separable correlation of padded slabs ``x [B, R+L-1,
    W+L-1]`` with the signed DoG, as direct taps, each a float32 multiply and a separate
    add, rows first: no matrix product, so no TF32 and no library summation order. Each
    output element reads only its own rows of the slab."""
    gc_np, gs_np, direction, L = _taps(sigma, darker_target)
    B, R, W = x.shape[0], x.shape[1] - L + 1, x.shape[2] - L + 1
    dev = x.device

    def corr(g_np):
        g = torch.from_numpy(g_np).to(dev)
        rows = torch.zeros((B, R, x.shape[2]), dtype=torch.float32, device=dev)
        for k in range(L):
            rows = rows + g[k] * x[:, k:k + R, :]
        out = torch.zeros((B, R, W), dtype=torch.float32, device=dev)
        for k in range(L):
            out = out + g[k] * rows[:, :, k:k + W]
        return out

    return direction * (corr(gc_np) - corr(gs_np))


def suppress_plain(resp: torch.Tensor, n: int, r2: float) -> torch.Tensor:
    """``int32 [n, 2]``: the ``n`` strongest peaks of ``resp [H, W]`` as ``(row, col)``,
    strongest first, each the first maximum in column-major order; each suppresses the
    cells whose squared distance, rounded to float32, is at most ``r2``; a round that
    finds only suppressed cells repeats the previous peak.

    The rounds work on the column-major copy ``[W, H]`` that
    ``ops.filters.argmax_colmajor`` would make each round: its flat argmax is the
    tracker's tie-break, and a round gathers its peak's value without a host read."""
    H, W = resp.shape
    dev = resp.device
    resp_t = resp.transpose(0, 1).contiguous()
    flat = resp_t.view(-1)
    ii = torch.arange(H, device=dev)[None, :]
    jj = torch.arange(W, device=dev)[:, None]
    out = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    for k in range(n):
        at = torch.argmax(flat)
        idx = torch.stack([at % H, at // H]).to(torch.int32)
        if k > 0:
            # suppression exhausted the frame: repeat the previous peak
            found = torch.isfinite(flat[at.view(1)])
            idx = torch.where(found, idx, out[k - 1])
        out[k] = idx
        # int64 distances, compared in float32 as a float scalar promotes them
        d2 = (ii - idx[0]) ** 2 + (jj - idx[1]) ** 2
        resp_t.masked_fill_(d2 <= r2, -torch.inf)
    return out


# ---- the dispatchers ----------------------------------------------------------------------


def frame_response(frames: torch.Tensor, fills, sigma: float, darker_target: bool):
    """``(response float32 [B, H, W], part)``: the DoG response of ``frames`` (uint8 ``[B,
    H, W]``), each padded by half the taps with its fill (``fills``: ``[B]`` values, a
    list, an array or a tensor, see :func:`fill_values`), and ``part``, what
    :func:`suppress` starts from on the card. A CUDA tensor launches ``detect_response``
    once (the pad fused in); a CPU tensor runs :func:`correlate_plain` over
    :func:`pad_plain`, and ``part`` is None."""
    if not frames.is_cuda:
        _, _, _, L = _taps(sigma, darker_target)
        return correlate_plain(pad_plain(frames, fills, L), sigma, darker_target), None
    if frames.dtype != torch.uint8 or frames.dim() != 3:
        raise ValueError(f"frames must be uint8 [B, H, W], got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    B, H, W = frames.shape
    frames = frames.contiguous()
    fill, fill_t = _fill_args(fills, B, frames.device)
    return _response_launch(frames, True, frames.stride(0), W, B, H, W, fill_t, fill, sigma,
                            darker_target)


def correlate(x: torch.Tensor, sigma: float, darker_target: bool) -> torch.Tensor:
    """``float32 [B, R, W]``: :func:`correlate_plain` of padded slabs ``x`` (float32
    ``[B, R+L-1, W+L-1]``); a CUDA tensor launches ``detect_response`` once over them."""
    if not x.is_cuda:
        return correlate_plain(x, sigma, darker_target)
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"slabs must be float32 [B, R+L-1, W+L-1], got {x.dtype} "
                         f"{tuple(x.shape)}")
    _, _, _, L = _taps(sigma, darker_target)
    B, R, W = x.shape[0], x.shape[1] - L + 1, x.shape[2] - L + 1
    if R <= 0 or W <= 0:
        raise ValueError(f"a slab of {tuple(x.shape[1:])} holds no output for {L} taps")
    if x.stride(2) != 1 or x.stride(1) < x.shape[2]:
        x = x.contiguous()
    return _response_launch(x, False, x.stride(0), x.stride(1), B, R, W, None, 0, sigma,
                            darker_target)[0]


def disc_reach(r2: float, limit: int) -> int:
    """The largest distance d (at most ``limit``) with ``float32(d * d) <= r2``: a disc
    of squared radius ``r2`` touches no row or column farther from its centre."""
    r2f = np.float32(r2)
    d = min(int(np.sqrt(max(float(r2f), 0.0))) + 2, limit)
    while d > 0 and np.float32(d * d) > r2f:
        d -= 1
    return d


def suppress(resp: torch.Tensor, part, n: int, r2: float) -> torch.Tensor:
    """``int32 [n, 2]``: :func:`suppress_plain`'s peaks of one frame's response ``resp
    [H, W]``. A CUDA tensor launches ``detect_rounds`` once, from ``part`` (the
    partials :func:`frame_response` gave with the response), and overwrites both (each
    disc set to -inf, the partials it touched recomputed); a CPU tensor runs
    :func:`suppress_plain`."""
    if not resp.is_cuda:
        return suppress_plain(resp, int(n), r2)
    n = int(n)
    if resp.dtype != torch.float32 or resp.dim() != 2 or n < 1:
        raise ValueError(f"the rounds take a float32 [H, W] response and n >= 1, got "
                         f"{resp.dtype} {tuple(resp.shape)} and n = {n}")
    H, W = resp.shape
    P = -(-H // _lib().detect_tile_rows())
    if (part is None or tuple(part.shape) != (P, W, 2) or part.dtype != torch.float32
            or part.device != resp.device or not part.is_contiguous()
            or not resp.is_contiguous()):
        raise ValueError("the rounds on the card take a contiguous response and the partials"
                         " that frame_response gave with it")
    if 8 * W + 9216 > _smem_limit(resp.device.index or 0):  # the columns and the scratch
        raise ValueError(f"the rounds keep {W} columns in shared memory: too wide for the card")
    out = torch.empty((n, 2), dtype=torch.int32, device=resp.device)
    lib = _lib()
    with torch.cuda.device(resp.device):
        stream = torch.cuda.current_stream(resp.device).cuda_stream
        err = lib.detect_rounds_launch(resp.data_ptr(), part.data_ptr(), H, W, P, n,
                                       float(np.float32(r2)), disc_reach(r2, max(H, W)),
                                       out.data_ptr(), stream)
    _check(lib, err, "detect_rounds")
    return out


# ---- the launches -------------------------------------------------------------------------


def _fill_args(fills, B: int, device: torch.device):
    """``(fill, fills tensor or None)``: host fills that are all alike go as one value,
    so a launch needs no copy; a card tensor, or fills that differ, as uint8 ``[B]`` on
    ``device``."""
    vals = fill_values(fills, B)
    if torch.is_tensor(vals):
        return 0, vals.to(device).contiguous()
    if (vals == vals[0]).all():
        return int(vals[0]), None
    return 0, torch.from_numpy(vals).to(device)


def _response_launch(src, u8: bool, batch_stride: int, row_stride: int, B: int, R: int,
                     W: int, fills_t, fill: int, sigma: float, darker_target: bool):
    """``(out [B, R, W], part [B, P, W, 2])``: one launch of the response kernel; ``part``
    holds each 32-row tile's column maxima as (value, row bits) pairs."""
    dev = src.device
    _, _, direction, L = _taps(sigma, darker_target)
    lib = _lib()
    tile_w = lib.detect_response_tile_w(L, _smem_limit(dev.index or 0))
    if tile_w == 0:
        raise ValueError(f"detect_response: {L} taps need more shared memory than the card has")
    out = torch.empty((B, R, W), dtype=torch.float32, device=dev)
    P = -(-R // lib.detect_tile_rows())
    part = torch.empty((B, P, W, 2), dtype=torch.float32, device=dev)
    taps = _tap_pairs(sigma, darker_target, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.detect_response_launch(src.data_ptr(), int(u8), batch_stride, row_stride, B,
                                         R, W, None if fills_t is None else fills_t.data_ptr(),
                                         int(fill), taps.data_ptr(), L, direction, tile_w,
                                         out.data_ptr(), part.data_ptr(), stream)
    _check(lib, err, "detect_response")
    return out, part


def _check(lib, err: int, kernel: str) -> None:
    """Raise on a launch that failed; count one that did not."""
    global launches
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: {lib.detect_error_string(err).decode()}")
    launches += 1
    launches_by_kernel[kernel] += 1


@functools.lru_cache(maxsize=1)
def _lib():
    from ._build import kernel_library

    lib = kernel_library("detect")
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.detect_tile_rows.argtypes = []
    lib.detect_tile_rows.restype = i32
    lib.detect_response_tile_w.argtypes = [i32, i64]
    lib.detect_response_tile_w.restype = i32
    lib.detect_response_launch.argtypes = [vp, i32, i64, i32, i32, i32, i32, vp, i32, vp, i32,
                                           f32, i32, vp, vp, vp]
    lib.detect_response_launch.restype = i32
    lib.detect_rounds_launch.argtypes = [vp, vp, i32, i32, i32, i32, f32, i32, vp, vp]
    lib.detect_rounds_launch.restype = i32
    lib.detect_error_string.argtypes = [i32]
    lib.detect_error_string.restype = ctypes.c_char_p
    return lib
