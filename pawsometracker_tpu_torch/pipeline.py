"""Full-frame streaming: chunks of whole frames through the tracker scan.

The counterpart of the JAX package's ``run_full_pipeline``
(``pawsometracker_tpu/pipeline.py``) and of the full-frame loop of its
``track_batch`` (``pawsometracker_tpu/batch.py:493-569``): each chunk's scan
starts from the previous chunk's last position, read on the device, and the
host takes the positions ``depth`` chunks behind. On the card a chunk travels
through a ring of staging slots: the host copies it into a pinned buffer
(padded to the scan length by repeating its last frame), a side stream copies
that to the device (``non_blocking``) and records an event, and the kernel's
stream waits on that event before the scan. A slot is refilled only after its
copy's event has completed and after the scan that read it. A batch of videos
stages one chunk per video into the rows of one slot and runs them in one
launch.

Also here: the ring-budget cap on the full-frame pipeline depth, and
``_crop_with_fill``, which the parallel decoder imports. The speculative ROI
pipeline is not ported yet.
"""

from __future__ import annotations

import functools
import logging
import os
from collections import deque

import numpy as np
import torch

from .io.decode import ChunkPrefetcher

logger = logging.getLogger(__name__)

__all__ = ["auto_depth_cap", "run_full_pipeline", "run_batch_pipeline", "AUTO_DEPTH_MAX"]

#: cap for pipeline_depth="auto"
AUTO_DEPTH_MAX = 7

#: decode-ring memory budget for pipeline_depth="auto" (MB); the depth cap
#: shrinks on large frames so (depth+2)*K frames stay inside it. Override:
#: PAWS_RING_BUDGET_MB.
RING_BUDGET_MB = 512


def auto_depth_cap(frame_shape, k_frames: int, lanes: int = 1) -> int:
    """Depth cap for ``pipeline_depth="auto"``: :data:`AUTO_DEPTH_MAX`,
    bounded so (depth+2)*K frames plus the decode margin stay within
    :data:`RING_BUDGET_MB` for this frame size (1.5 bytes/pixel, the yuv420p
    frames a native decode ring holds). Floors at depth 1, and warns once when
    that floor overruns the budget."""
    budget = float(os.environ.get("PAWS_RING_BUDGET_MB", RING_BUDGET_MB)) * 1e6
    fb = 1.5 * max(float(frame_shape[0]) * float(frame_shape[1]), 1.0) * max(lanes, 1)
    frames = int(budget // fb)
    cap = min(AUTO_DEPTH_MAX, (frames - 8) // max(k_frames, 1) - 2)
    if cap < 1:
        _warn_ring_budget(round(budget / 1e6), lanes, frame_shape[1],
                          frame_shape[0], round((3 * k_frames + 8) * fb / 1e6))
        return 1
    return cap


@functools.lru_cache(maxsize=64)
def _warn_ring_budget(budget_mb, lanes, w, h, need_mb) -> None:
    """One-time (per configuration) warning that the depth-1 floor overruns
    the requested ring budget."""
    logger.warning(
        "PAWS_RING_BUDGET_MB=%s cannot hold the minimum decode ring for "
        "%d lane(s) of %dx%d frames (need ~%s MB); running at depth 1 "
        "beyond the budget", budget_mb, lanes, w, h, need_mb,
    )


def _crop_with_fill(frame: np.ndarray, o, ch: int, cw: int, fill: int, out=None) -> np.ndarray:
    """Crop ``frame`` at origin ``o`` (may be out of bounds) to ``(ch, cw)``,
    filling out-of-frame cells with the mode fill value."""
    H, W = frame.shape
    if out is None:
        out = np.empty((ch, cw), np.uint8)
    out.fill(fill)
    r0, c0 = max(0, o[0]), max(0, o[1])
    r1, c1 = min(H, o[0] + ch), min(W, o[1] + cw)
    if r1 > r0 and c1 > c0:
        out[r0 - o[0] : r1 - o[0], c0 - o[1] : c1 - o[1]] = frame[r0:r1, c0:c1]
    return out


class _Slot:
    """One staging slot: a host buffer (pinned when the scan runs on the
    card), its device twin (the same tensor on the CPU), the event that marks
    the host-to-device copy done and the event that marks the scan that read
    the device buffer done."""

    __slots__ = ("host", "dev", "copied", "consumed")

    def __init__(self, shape, device):
        cuda = device.type == "cuda"
        self.host = torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)
        self.dev = torch.empty(shape, dtype=torch.uint8, device=device) if cuda else self.host
        self.copied = None
        self.consumed = None


class _FullFrameEngine:
    """Runs the chunk scans of one frame stream, or of ``lanes`` streams in
    one launch, chaining each chunk's start positions on the device.
    ``scan(frames, pos0, fill)`` takes ``frames [T,H,W]`` (one stream, any
    number of targets in ``pos0``) or ``[lanes,T,H,W]`` and returns positions
    (steps first for one stream, ``[lanes,T,2]`` for lanes), or ``(positions,
    offsets)`` with ``subpixel``.

    Every chunk is copied once, into a staging slot: on the CPU the scan then
    runs at once; on the card the slot is one of a ring of ``slots``
    :class:`_Slot` s, and the dispatch returns before the scan ends, the
    results coming back through pinned buffers and an event that
    :meth:`to_host` waits on."""

    def __init__(self, scan, pos0, fill, subpixel, timer, device, slots: int, lanes=None):
        self.scan = scan
        self.device = device
        self.pos0 = torch.as_tensor(pos0).to(device=device, dtype=torch.int32)
        self.fill = fill
        self.subpixel = subpixel
        self.timer = timer
        self.lanes = lanes
        self._cuda = device.type == "cuda"
        self._n_slots = max(2, int(slots)) if self._cuda else 1
        self._slots: list[_Slot] = []
        self._next = 0
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(device)

    def _stage(self, chunks, T: int) -> _Slot:
        """Copy one chunk per stream (``None`` for a lane past its end) into
        the next slot, each padded to ``T`` steps by repeating its last frame,
        and on the card on to the device; returns the slot."""
        frame_shape = next(c.shape[1:] for c in chunks if c is not None)
        lead = (T,) if self.lanes is None else (self.lanes, T)
        if len(self._slots) < self._n_slots:
            self._slots.append(_Slot(lead + tuple(frame_shape), self.device))
        slot = self._slots[self._next]
        self._next = (self._next + 1) % self._n_slots
        if slot.copied is not None:
            slot.copied.synchronize()  # the pinned buffer is free once its copy is done
        host = slot.host.numpy()
        for row, chunk in zip([host] if self.lanes is None else host, chunks):
            # a lane past its end keeps whatever its row holds: its steps are discarded
            if chunk is not None:
                row[:len(chunk)] = chunk
                row[len(chunk):] = chunk[-1]
        if not self._cuda:
            return slot
        with torch.cuda.stream(self._copy_stream):
            if slot.consumed is not None:
                self._copy_stream.wait_event(slot.consumed)  # the last scan read it
            slot.dev.copy_(slot.host, non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._copy_stream)
        torch.cuda.current_stream(self.device).wait_event(slot.copied)
        return slot

    def _chain(self, pos0, pos, valid, T: int):
        """The next chunk's start: each stream's position after its last valid
        step (a lane with none keeps its start). Padded steps move the position,
        so a lane that ended inside the chunk does not continue from the end."""
        if self.lanes is None:
            return pos[valid[0] - 1]
        if all(k == T for k in valid):
            return pos[:, -1]
        return torch.stack([pos[b, k - 1] if k else pos0[b] for b, k in enumerate(valid)])

    def dispatch(self, chunks, T: int):
        """Start the scan of one chunk per stream (``[chunk]`` for one stream;
        ``None`` for a lane past its end), padded to ``T`` steps; returns a
        handle for :meth:`ready` and :meth:`to_host`."""
        pos0 = self.pos0
        with self.timer.section("upload"):
            slot = self._stage(chunks, T)
        with self.timer.section("device"):
            out = self.scan(slot.dev, pos0, self.fill)
        pos, off = out if self.subpixel else (out, None)
        self.pos0 = self._chain(pos0, pos, [0 if c is None else len(c) for c in chunks], T)
        if not self._cuda:
            return pos, off, None
        slot.consumed = torch.cuda.Event()
        slot.consumed.record(torch.cuda.current_stream(self.device))
        pos_h = torch.empty(pos.shape, dtype=pos.dtype, pin_memory=True)
        pos_h.copy_(pos, non_blocking=True)
        off_h = None
        if off is not None:
            off_h = torch.empty(off.shape, dtype=off.dtype, pin_memory=True)
            off_h.copy_(off, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return pos_h, off_h, done

    @staticmethod
    def ready(handle) -> bool:
        """True when :meth:`to_host` will not block."""
        return handle[2] is None or handle[2].query()

    @staticmethod
    def to_host(handle):
        """The chunk's positions (and offsets) as numpy arrays."""
        pos, off, done = handle
        if done is not None:
            done.synchronize()
        return pos.numpy().copy(), (None if off is None else off.numpy().copy())

    def close(self):
        """Wait for the card's work on this engine's buffers before they go."""
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
            self._copy_stream.synchronize()
            self._slots.clear()


def run_full_pipeline(
    src,
    pos0_abs,
    fill: int,
    n_rest: int,
    *,
    chunk_size: int,
    depth: int,
    scan,
    subpixel: bool,
    dia,
    timer,
    prefetchers: list,
    device,
    progress=None,
):
    """Full-frame streaming of one video: chunk scans chain their start
    positions on the device and the host drains positions ``depth`` chunks
    behind. ``pos0_abs`` is one position ``[2]``, or ``[N, 2]`` for N targets
    (``scan`` then returns ``[T, N, 2]``). Frames are whole, so results equal
    the synchronous loop's at every depth. Returns ``(position blocks, offset
    blocks, frames tracked)``."""
    positions: list[np.ndarray] = []
    offsets: list[np.ndarray] = []
    tracked = 0
    pending: deque = deque()  # (handle, chunk)

    from .diagnose import Dont

    keep = not isinstance(dia, Dont)
    eng = _FullFrameEngine(scan, pos0_abs, fill, subpixel, timer, device, slots=depth + 2)

    def drain_one():
        nonlocal tracked
        handle, frames = pending.popleft()
        k = len(frames)
        with timer.section("drain"):
            out_np, off_np = eng.to_host(handle)
        positions.append(out_np[:k])
        if off_np is not None:
            offsets.append(off_np[:k])
        if keep:
            with timer.section("diagnose"):
                for i in range(k):
                    dia(frames[i], out_np[i])
        # the chunk was copied into a staging slot at dispatch, so the
        # prefetcher may refill its buffer now
        prefetch.recycle(frames)
        tracked += k
        if progress is not None:
            progress(tracked, n_rest)

    prefetch = ChunkPrefetcher(src, chunk_size, max_frames=n_rest)
    prefetchers.append(prefetch)
    try:
        for chunk in prefetch:
            while len(pending) > depth:
                drain_one()
            while pending and eng.ready(pending[0][0]):
                drain_one()
            pending.append((eng.dispatch([chunk], chunk_size), chunk))
        while pending:
            drain_one()
    finally:
        eng.close()
    return positions, offsets, tracked


def run_batch_pipeline(
    prefetchers: list,
    pos0,
    fills,
    *,
    chunk_size: int,
    depth: int,
    scan,
    subpixel: bool,
    dias: list,
    timer,
    device,
    progress=None,
):
    """Full-frame streaming of B videos in lockstep, one launch per chunk
    for all of them (the JAX package's ``track_batch`` loop,
    ``pawsometracker_tpu/batch.py:493-569``, with the host draining ``depth``
    chunks behind). ``prefetchers[b]`` yields video b's chunks; a video whose
    chunk comes back short has ended, and its lane runs on with discarded
    steps while the others continue. ``scan(frames [B,T,H,W], pos0 [B,2],
    fills)`` returns ``[B,T,2]`` (and offsets with ``subpixel``).

    Returns per video ``(position blocks, offset blocks, frames tracked)`` as
    three lists."""
    from .diagnose import Dont

    B = len(prefetchers)
    iters = [iter(p) for p in prefetchers]
    active = [True] * B
    positions: list[list] = [[] for _ in range(B)]
    offsets: list[list] = [[] for _ in range(B)]
    counts = [0] * B
    pending: deque = deque()  # (handle, chunks)
    eng = _FullFrameEngine(scan, pos0, fills, subpixel, timer, device, slots=depth + 2, lanes=B)

    def gather():
        """One chunk per active video; marks videos at their end inactive."""
        chunks = [None] * B
        for b in range(B):
            if active[b]:
                chunk = next(iters[b], None)
                if chunk is None or chunk.shape[0] == 0:
                    active[b] = False
                else:
                    chunks[b] = chunk
                    active[b] = chunk.shape[0] == chunk_size
        return chunks

    def drain_one():
        handle, chunks = pending.popleft()
        with timer.section("drain"):
            out_np, off_np = eng.to_host(handle)
        for b, chunk in enumerate(chunks):
            if chunk is None:
                continue
            k = len(chunk)
            positions[b].append(out_np[b, :k])
            if off_np is not None:
                offsets[b].append(off_np[b, :k])
            counts[b] += k
            if not isinstance(dias[b], Dont):
                with timer.section("diagnose"):
                    for i in range(k):
                        dias[b](chunk[i], out_np[b, i])
            prefetchers[b].recycle(chunk)
        if progress is not None:
            progress(sum(counts))

    try:
        while True:
            chunks = gather()
            if all(c is None for c in chunks):
                break
            while len(pending) > depth:
                drain_one()
            while pending and eng.ready(pending[0][0]):
                drain_one()
            pending.append((eng.dispatch(chunks, chunk_size), chunks))
        while pending:
            drain_one()
    finally:
        eng.close()
    return positions, offsets, counts
