"""The ROI pipeline's crops: each lane's frames of a chunk cut at per-frame
origins into the crop buffer that goes to the card.

:func:`crop_with_fill` cuts one frame in numpy, the counterpart of the JAX
package's ``_crop_with_fill`` (``pawsometracker_tpu/pipeline.py``), filling
only the crop's border outside the frame. :func:`crop_lanes_plain` cuts a
chunk of every lane with it, a frame at a time: the CPU path and the oracle.
:func:`crop_lanes_native` cuts the same chunk in one call of
``csrc/roi_crop.cpp`` (built with the kernel library, :mod:`._build`), which
prefetches each crop's rows, spreads a large chunk's crops over up to
:data:`THREADS` threads and runs without Python's lock. :func:`lane_cropper`
gives the pipelines the native one on the card and the plain one on the CPU;
a native library that does not build raises, it never hands over to numpy on
the card.

:func:`copy_frames_native` is the full-frame engine's staging copy of frames
served as views into a pinned buffer on the card (:func:`frame_copier`), a
call of its own in the same library: long byte ranges in non-temporal stores,
in the form the view's strides allow (:data:`COPY_FORMS`). On the CPU the
engine copies each chunk itself.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

__all__ = ["crop_with_fill", "crop_lanes_plain", "crop_lanes_native", "crop_threads",
           "lane_cropper", "copy_frames_native", "frame_copier",
           "native_calls", "copy_calls", "copy_forms", "COPY_FORMS", "THREADS",
           "BYTES_PER_THREAD"]

#: most threads one native call spreads its crops over (the caller's and
#: helpers), leaving two of the host's cores to the caller's other threads: a
#: crop's rows come from frames out of cache, so more rows in flight pay
THREADS = max(1, min(6, (os.cpu_count() or 1) - 2))
#: crop bytes a thread must have to be worth its wake-up: a helper costs tens
#: of microseconds to wake, which a 12-frame 185x185 chunk (410 KB) of one
#: lane does not pay back
BYTES_PER_THREAD = 512 * 1024
#: native crop calls since import (each one chunk of every lane)
native_calls = 0
#: native frame copies since import (each one staged chunk)
copy_calls = 0
#: the forms of ``copy_frames`` (``csrc/roi_crop.cpp``), by the code it
#: returns: ``block``, the frames one contiguous run; ``frames``, each frame
#: contiguous but lying apart; ``rows``, rows lying apart (or mirrored)
COPY_FORMS = ("block", "frames", "rows")
#: native frame copies since import, by form
copy_forms = dict.fromkeys(COPY_FORMS, 0)


def crop_threads(nbytes: int) -> int:
    """Threads a native call spreads ``nbytes`` of crops over: one a
    :data:`BYTES_PER_THREAD`, at least 1 and at most :data:`THREADS`."""
    return min(THREADS, max(1, nbytes // BYTES_PER_THREAD))


def crop_with_fill(frame: np.ndarray, o, ch: int, cw: int, fill: int, out=None) -> np.ndarray:
    """Crop ``frame`` at origin ``o`` (may be out of bounds) to ``(ch, cw)``,
    filling out-of-frame cells with the mode fill value. Only the crop's
    border outside the frame is filled; the rest is copied."""
    H, W = frame.shape
    if out is None:
        out = np.empty((ch, cw), np.uint8)
    oi, oj = int(o[0]), int(o[1])
    # the crop's rows [r0, r1) and columns [c0, c1) inside the frame
    r0, c0 = min(max(-oi, 0), ch), min(max(-oj, 0), cw)
    r1, c1 = max(min(H - oi, ch), r0), max(min(W - oj, cw), c0)
    if r1 == r0 or c1 == c0:
        out.fill(fill)
        return out
    out[r0:r1, c0:c1] = frame[oi + r0:oi + r1, oj + c0:oj + c1]
    if r0:
        out[:r0] = fill
    if r1 < ch:
        out[r1:] = fill
    if c0:
        out[r0:r1, :c0] = fill
    if c1 < cw:
        out[r0:r1, c1:] = fill
    return out


def crop_lanes_plain(chunks, counts, origins, fills, out: np.ndarray) -> None:
    """Cut lane b's first ``counts[b]`` frames of ``chunks[b]`` (``[>= k, H,
    W]`` u8) at ``origins[b, i]`` into ``out[b, i]`` (``out [L, K, ch, cw]``),
    the out-of-frame cells ``fills[b]``; the lane's later frames repeat its
    last crop, and a lane with none (``counts[b] == 0``, its chunk unused)
    holds fill."""
    ch, cw = out.shape[-2:]
    for b, k in enumerate(counts):
        k = int(k)
        if k == 0:
            out[b] = fills[b]
            continue
        for i in range(k):
            crop_with_fill(chunks[b][i], origins[b][i], ch, cw, int(fills[b]), out=out[b, i])
        out[b, k:] = out[b, k - 1]


@functools.lru_cache(maxsize=1)
def _lib():
    from ._build import kernel_library

    lib = kernel_library("roi_crop")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.roi_crop_lanes.argtypes = [i32, vp, i32, i32, i32, vp, i32, i32, vp, vp, i32]
    lib.roi_crop_lanes.restype = i32
    lib.copy_frames.argtypes = [vp, i64, i64, i32, i32, i32, vp, i32]
    lib.copy_frames.restype = i32
    return lib


def crop_lanes_native(chunks, counts, origins, fills, out: np.ndarray,
                      threads: int | None = None) -> None:
    """:func:`crop_lanes_plain` in one call of ``csrc/roi_crop.cpp`` on
    ``threads`` threads (by default one for each :data:`BYTES_PER_THREAD` of
    crops, up to :data:`THREADS`): every lane's crops of the chunk, with
    Python's lock released. ``out`` is C-contiguous; each chunk's frames have
    1-byte columns. Raises when the library does not build or load, or the
    call refuses its arguments."""
    global native_calls
    L, K, ch, cw = out.shape
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 [L, K, ch, cw], got {out.dtype}")
    meta = np.zeros((L, 4), np.int64)
    frame = None
    for b, k in enumerate(counts):
        if int(k) == 0:
            continue
        c = chunks[b]
        if (c.dtype != np.uint8 or c.ndim != 3 or c.strides[2] != 1 or c.shape[0] < int(k)
                or c.shape[1:] != (frame or c.shape[1:])):
            raise ValueError(f"lane {b}: a chunk of {int(k)} uint8 [T, H, W] frames with"
                             f" 1-byte columns, of every lane's H and W, is needed, got"
                             f" {c.dtype} {c.shape} {c.strides}")
        frame = c.shape[1:]
        meta[b] = (c.ctypes.data, c.strides[0], c.strides[1], int(k))
    H, W = frame or (1, 1)
    o = np.ascontiguousarray(origins, np.int64)
    f = np.ascontiguousarray(fills, np.uint8)
    if o.shape != (L, K, 2) or f.shape != (L,):
        raise ValueError(f"origins [L, K, 2] and fills [L] for out {out.shape}, got"
                         f" {o.shape} and {f.shape}")
    if threads is None:
        threads = crop_threads(int(meta[:, 3].sum()) * ch * cw)
    err = _lib().roi_crop_lanes(L, meta.ctypes.data, K, H, W, o.ctypes.data, ch, cw,
                                f.ctypes.data, out.ctypes.data, int(threads))
    if err:
        raise ValueError(f"roi_crop_lanes refused its arguments: counts {list(counts)}, K={K},"
                         f" frames {H}x{W}, crops {ch}x{cw}")
    native_calls += 1


def copy_frames_native(src: np.ndarray, dst: np.ndarray, threads: int | None = None) -> str:
    """Copy the frames ``src [k, H, W]`` into ``dst`` of the same shape in one
    call of ``csrc/roi_crop.cpp``'s ``copy_frames`` on ``threads`` threads (by
    default one for each :data:`BYTES_PER_THREAD`, up to :data:`THREADS`),
    with Python's lock released. ``dst`` is C-contiguous; ``src``'s frames
    have 1-byte columns. Returns the form the copy took (:data:`COPY_FORMS`),
    counted in :data:`copy_forms`. Raises when the library does not build or
    load, or the call refuses its arguments."""
    global copy_calls
    if src.shape != dst.shape or src.ndim != 3:
        raise ValueError(f"copy of frames {src.shape} into {dst.shape}")
    if dst.dtype != np.uint8 or not dst.flags.c_contiguous:
        raise ValueError(f"dst must be a C-contiguous uint8 [k, H, W], got {dst.dtype}")
    if src.dtype != np.uint8 or src.strides[2] != 1:
        raise ValueError(f"uint8 [k, H, W] frames with 1-byte columns are needed, got"
                         f" {src.dtype} {src.shape} {src.strides}")
    k, H, W = src.shape
    if threads is None:
        threads = crop_threads(src.nbytes)
    form = _lib().copy_frames(src.ctypes.data, src.strides[0], src.strides[1], k, H, W,
                              dst.ctypes.data, int(threads))
    if not 0 <= form < len(COPY_FORMS):
        raise ValueError(f"copy_frames refused its arguments: {k} frames {H}x{W}, strides"
                         f" {src.strides}, {threads} threads")
    copy_calls += 1
    copy_forms[COPY_FORMS[form]] += 1
    return COPY_FORMS[form]


def frame_copier():
    """The full-frame engine's staging copy on the card,
    :func:`copy_frames_native`, its library built now, so that a failed build
    raises here."""
    _lib()
    return copy_frames_native


def lane_cropper(device):
    """The chunk crop of the pipelines on ``device``: :func:`crop_lanes_native`
    on a card (its library built now, so that a failed build raises here),
    :func:`crop_lanes_plain` on the CPU."""
    if getattr(device, "type", device) == "cuda":
        _lib()
        return crop_lanes_native
    return crop_lanes_plain
