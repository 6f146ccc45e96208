"""Streaming pipelines: whole frames, or speculative crops around the target.

Full frames: the counterpart of the JAX package's ``run_full_pipeline``
(``pawsometracker_tpu/pipeline.py``) and of the full-frame loop of its
``track_batch`` (``pawsometracker_tpu/batch.py:493-569``): each chunk's scan
starts from the previous chunk's last position, read on the device, and the
host takes the positions ``depth`` chunks behind. On the card a chunk lands on
the prefetch thread in a pinned buffer of its stream's ring (:func:`staging_ring`:
a decoder writes it there; frames served as views of the caller's array are
copied in by the native copy, without Python's lock), so the controller's
thread copies no frame. At dispatch a side stream copies its real frames to
the device (``non_blocking``), pads the short last chunk there by repeating
its last frame, and records an event, which the kernel's stream waits on
before the scan. A buffer goes back to its ring once the chunk's positions
are in, and is handed out again only once its copy's event has completed. A
batch of videos has a ring a video, each lane's rows copied to its row of the
device slot, and runs them in one launch.

ROI streaming: the counterpart of the JAX package's speculative pipeline.
Each chunk of K frames is cut into crops around where each lane's target is
predicted to be, and only the crops go to the card, through the bounded scan.
The controller, :class:`SpeculativePipeline` (generic over L lanes, as the
reference's), chains the scans on the device, drains positions behind them,
checks that every window a scan read lay inside its crop, and replays from
retained frames at exact origins when one did not, so the positions always
equal full-frame streaming. A lane source delivers the crops (the native
decoder's retained ring, its direct ROI reads, or prefetched chunks cropped
here) and a lane engine stages them and runs the scans:

- ``run_roi_pipeline``, one video and one target (``track``):
  :class:`SingleVideoSource` and :class:`_SingleEngine`, the unbatched scan;
- ``run_multi_roi_pipeline``, N targets of one video (``track_multi``):
  :class:`FanoutSource` and :class:`_BatchedEngine`, one batched launch a
  chunk;
- B videos (``track_batch``, which builds the controller itself):
  :class:`PerVideoSource` and :class:`_BatchedEngine`.

Under a device mesh (``track_batch(mesh=...)``) the lanes split into data
shards, one a row of the mesh: the full-frame engine and the batched lane
engine copy each shard's lanes of the one pinned buffer to its device on that
device's side stream, run one launch a shard in that device's context, keep
the chain per shard on its device, and gather the positions into one pinned
buffer behind an event a shard.

Every dispatch is one launch a data shard, made at once: the reference's group
dispatch (``_GroupDispatchBase``, the ``make_super_*`` programs and the
variable that pins their size) has no counterpart here. It pays a device
reached over a link, where each call is a round trip; the card sits on the
host's own bus, a launch returns at once and the copies run on side streams.
Without a counterpart for the same reason: the reference's dispatch thread
(``_SerialDispatcher``, ``_ImmediateResult``) and its ``PAWS_SYNC_DISPATCH``
and ``PAWS_STAGE_THREADS``, and its prewarm of the super-programs
(``_maybe_prewarm``, ``PAWS_SUPER_PREWARM``).

Also here: the ring-budget cap on the pipeline depth. The lane sources cut a
chunk's crops of every lane in one call of the device's cropper
(:func:`.ops.roi_crop.lane_cropper`: native on the card).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from .io.decode import ChunkPrefetcher, ChunkRing
from .models.dog_tracker import make_spec, resolve_device, tracker_fns
from .ops import tracker_kernel as tk
from .ops.roi_crop import crop_lanes_plain, frame_copier, lane_cropper
from .parallel.mesh import BatchSharding, Sharded, ShardedBatchTracker, ShardedFn, on_device
from .utils.compilecache import cache_root

logger = logging.getLogger(__name__)

__all__ = ["auto_depth_cap", "run_full_pipeline", "run_batch_pipeline", "run_roi_pipeline",
           "run_multi_roi_pipeline", "roi_geometry", "chain_batch", "last_rows",
           "pick_bounded_engine", "pick_bounded_engine_batch",
           "SpeculativePipeline", "SingleVideoSource", "FanoutSource", "PerVideoSource",
           "staging_ring", "AUTO_DEPTH_MAX"]

#: mispredict replays since import (observability: tests and debugging)
replay_count = 0

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


#: pipeline_depth="auto" deepens when the lagged drain blocks longer than this
AUTO_DRAIN_BLOCK_S = 0.002

#: sentinel: a chunk's frames live in the native decoder's retained ring
RETAINED = "native-retained"


def _predict_slack(k_frames: int, depth: int, r: int) -> int:
    """Per-axis prediction-error budget (px) on top of the window and kernel
    apron in predict mode: the only margin term, since per-frame crop origins
    ride the predicted path. Deliberately independent of the depth, so that
    depth only hides latency and the crop geometry is the same at every depth;
    a finite budget costs replays, never positions. ``PAWS_PREDICT_SLACK``
    overrides (px)."""
    env = os.environ.get("PAWS_PREDICT_SLACK")
    if env:
        return max(1, int(env))
    return max(24, 2 * r, k_frames)


def roi_geometry(spec, k_frames: int, depth: int = 0, mode: str = "contain"):
    """``(crop_h, crop_w, margin)`` for K-frame ROI scans at pipeline
    ``depth`` (chunks the host may run ahead of the device).

    predict mode: per-frame origins put each frame's expected window centre at
    its crop's centre, so the margin is window radius + kernel apron + the
    prediction slack. contain mode: one origin per chunk at the last known
    position, the margin the worst-case drift over the whole (depth+1)*K
    horizon: no speculation, no replays, larger crops."""
    ri, rj = spec.radii
    half = spec.kernel_len // 2
    if mode == "predict":
        mi = ri + half + _predict_slack(k_frames, depth, ri)
        mj = rj + half + _predict_slack(k_frames, depth, rj)
    else:
        mi = (depth + 1) * k_frames * ri + half
        mj = (depth + 1) * k_frames * rj + half
    return 2 * mi + 1, 2 * mj + 1, (mi, mj)


def _lane_shards(scan, lanes, device) -> list:
    """Per data shard of an engine's lanes: ``(lane slice, device, scan)``.
    A :class:`~.parallel.mesh.ShardedFn` scan (a mesh) gives one shard a row
    of its mesh, each with its own single-device scan; any other scan one
    shard of every lane on ``device``."""
    if isinstance(scan, ShardedFn):
        return list(zip(BatchSharding(scan.mesh, 1).lanes(lanes), scan.devices, scan.fns))
    return [(slice(None), device, scan)]


def _parts(x, shards) -> list:
    """``x`` split as ``shards`` split the lanes: a :class:`Sharded`'s own
    shards, else slices of ``x`` (``x`` itself for one shard)."""
    if isinstance(x, Sharded):
        return list(x.shards)
    if len(shards) == 1:
        return [x]
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return [t[sl] for sl, _, _ in shards]


def _shard_shape(shape, sl) -> tuple:
    """``shape`` with its leading (lane) axis cut to the lanes ``sl``."""
    return (len(range(shape[0])[sl]),) + tuple(shape[1:])


def _record(stream):
    """A new event recorded on ``stream``."""
    event = torch.cuda.Event()
    event.record(stream)
    return event


class _DeviceGroup:
    """The card side of one chunk: per data shard its frames ``frames[i]``
    (u8), for the ROI engines its int32 arguments ``args[i]`` (else None),
    and the event that marks done the launch that read them."""

    __slots__ = ("frames", "args", "consumed")

    def __init__(self, frames: list, args: list):
        self.frames = frames
        self.args = args
        self.consumed = [None] * len(frames)


class _ShardedEngine:
    """What the engines share: their lanes split into data shards
    (:func:`_lane_shards`), on the card a side stream a device for the copies
    to the card (shards on one device share it), and results that come back
    into pinned buffers behind an event a shard.

    A dispatch stages its chunk and launches it at once, one launch a data
    shard; it returns the chunk's handle, ``(positions, offsets, events)``.
    On the card the chunk's copy starts at once, into the next device slot
    (:class:`_DeviceGroup`) of a ring of :attr:`RING`; a slot's buffers are
    refilled only behind the launch that read them, a wait on the card."""

    #: device slots in the ring; its size sets how far copies run ahead of launches
    RING = 3

    def __init__(self, scan, lanes, device):
        self.shards = _lane_shards(scan, lanes, device)
        self._cuda = self.shards[0][1].type == "cuda"
        if self._cuda:
            self._copy_streams = {dev: torch.cuda.Stream(dev) for _, dev, _ in self.shards}
            # the first shard's (the only one without a mesh)
            self._copy_stream = self._copy_streams[self.shards[0][1]]
        self._ring: list[_DeviceGroup] = []
        self._ring_next = 0
        self._group = None  # the device slot of the chunk being dispatched
        #: chunk launches, each one launch a data shard
        self.groups = 0

    def reset(self):
        """Invalidate the chain on the device (replay, run start)."""

    def _run(self, entry):
        """Launch the staged chunk; returns its handle."""
        with self.timer.section("device"):
            handle = self._launch(entry)
        self.groups += 1
        return handle

    def _slot(self, make):
        """The device slot the chunk about to be staged goes to: the next of
        the ring, made by ``make()`` the first time round. On the CPU there
        are no device slots (None)."""
        if not self._cuda:
            return None
        i = self._ring_next
        self._ring_next = (i + 1) % self.RING
        if i == len(self._ring):
            self._ring.append(make())
        self._group = self._ring[i]
        return self._group

    def _copy_in(self, group, copies, events=None) -> list:
        """Per shard i, on its device's side stream: wait for the launch that
        last read ``group``, start the ``(dst, src)`` copies ``copies[i]``
        and record their event (new, or ``events[i]`` recorded again), which
        the shard's scan stream waits for. Returns the events."""
        out = []
        for i, (_, dev, _) in enumerate(self.shards):
            stream = self._copy_streams[dev]
            with self.timer.span("shard.copy_in", shard=i):
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    if group.consumed[i] is not None:
                        stream.wait_event(group.consumed[i])
                    for dst, src in copies[i]:
                        dst.copy_(src, non_blocking=True)
                    if events is None:
                        out.append(_record(stream))
                    else:
                        events[i].record(stream)
                        out.append(events[i])
                torch.cuda.current_stream(dev).wait_event(out[-1])
        return out

    def _results(self, outs, bufs):
        """The handle of a launched chunk whose scans gave, per shard,
        ``(positions, offsets or None)``, lanes first: on the CPU the shards'
        rows concatenated; on the card, after marking the device slot consumed
        once the work queued so far has run, the copies of each shard's rows
        into its lanes of the pinned ``bufs = (pos_h, off_h)``, behind one
        event a shard."""
        if not self._cuda:
            def cat(parts):
                return parts[0] if len(parts) == 1 else torch.cat(parts)

            return (cat([p for p, _ in outs]),
                    None if outs[0][1] is None else cat([o for _, o in outs]), None)
        pos_h, off_h = bufs
        done = []
        for i, ((sl, dev, _), (pos, off)) in enumerate(zip(self.shards, outs)):
            with self.timer.span("shard.results", shard=i), torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev)
                self._group.consumed[i] = _record(stream)
                pos_h[sl].copy_(pos, non_blocking=True)
                if off is not None:
                    off_h[sl].copy_(off, non_blocking=True)
                done.append(_record(stream))
        return pos_h, off_h, done

    @staticmethod
    def ready(handle) -> bool:
        """True when :meth:`to_host` will not block: the chunk's results are in."""
        return handle[2] is None or all(e.query() for e in handle[2])

    def to_host(self, handle):
        """The chunk's positions (and offsets) as numpy arrays."""
        pos, off, done = handle
        with self.timer.span("drain.wait"):
            for i, e in enumerate(done or ()):
                with self.timer.span("shard.wait", shard=i):
                    e.synchronize()
        return pos.numpy().copy(), (None if off is None else off.numpy().copy())

    def close(self):
        """Wait for the card's work on this engine's buffers before they go."""
        if self._cuda:
            for dev, stream in self._copy_streams.items():
                torch.cuda.current_stream(dev).synchronize()
                stream.synchronize()
        self._ring.clear()
        self._group = None


def staging_ring(device) -> ChunkRing:
    """The ring a full-frame stream's prefetcher fills (:class:`_FullFrameEngine`):
    on the card pinned buffers, into which a decoder or the resampler writes
    and frames served as views are copied by the native copy
    (:func:`.ops.roi_crop.copy_frames_native`: up to 6 threads, without
    Python's lock), on the prefetch thread, so the controller's thread copies
    no frame and the copy overlaps the card's work on the chunks before; the
    copy built now, so that a failed build raises here. Off the card the
    prefetcher's plain ring."""
    if torch.device(device).type != "cuda":
        return ChunkRing()
    return ChunkRing(alloc=lambda shape: torch.empty(shape, dtype=torch.uint8,
                                                     pin_memory=True).numpy(),
                     copy=frame_copier())


class _FullEntry(NamedTuple):
    """A staged full-frame chunk: its host array (the CPU scans read it; None
    on the card) and each lane's real frames."""

    host: object
    valid: list


class _FullFrameEngine(_ShardedEngine):
    """Runs the chunk scans of one frame stream, or of ``lanes`` streams in
    one launch (one launch a data shard under a mesh), chaining each chunk's
    start positions on the device. ``scan(frames, pos0, fill)`` takes
    ``frames [T,H,W]`` (one stream, any number of targets in ``pos0``) or
    ``[lanes,T,H,W]`` and returns positions (steps first for one stream,
    ``[lanes,T,2]`` for lanes), or ``(positions, offsets)`` with
    ``subpixel``; a :class:`~.parallel.mesh.ShardedFn` runs each shard's lanes
    on its device, the chain kept per shard.

    Every chunk is padded to the scan length by repeating its last frame. On
    the CPU it is copied into a new host array, which the scan reads. On the
    card it lies in a pinned buffer of its stream's ring (``rings``, one a
    stream, each a :func:`staging_ring` its prefetcher fills); its real frames
    go from there to each shard's device slot on that device's side stream,
    which then pads the slot on the card, and the ring hands the buffer out
    again only once that copy's event has completed. The dispatch
    returns before the scans end, the results coming back into pinned buffers
    behind an event a shard that :meth:`to_host` waits on."""

    def __init__(self, scan, pos0, fill, subpixel, timer, device, lanes=None, rings=None):
        super().__init__(scan, lanes, device)
        self.pos0 = [torch.as_tensor(p).to(device=dev, dtype=torch.int32)
                     for p, (_, dev, _) in zip(_parts(pos0, self.shards), self.shards)]
        self.fill = _parts(fill, self.shards)
        self.subpixel = subpixel
        self.timer = timer
        self.lanes = lanes
        self.rings = rings

    def _new_group(self, shape) -> _DeviceGroup:
        return _DeviceGroup([torch.empty(_shard_shape(shape, sl), dtype=torch.uint8, device=dev)
                             for sl, dev, _ in self.shards], None)

    def _stage(self, chunks, T: int):
        """Stage one chunk per stream (``None`` for a lane past its end), each
        padded to ``T`` steps by repeating its last frame: on the CPU into a
        new host array; on the card from its ring's buffer to each shard's
        device slot, padded there; returns the staged entry."""
        frame_shape = next(c.shape[1:] for c in chunks if c is not None)
        shape = ((T,) if self.lanes is None else (self.lanes, T)) + tuple(frame_shape)
        group = self._slot(lambda: self._new_group(shape))
        valid = [0 if c is None else len(c) for c in chunks]
        if not self._cuda:
            host = np.empty(shape, np.uint8)
            for row, chunk in zip([host] if self.lanes is None else host, chunks):
                # a lane past its end keeps whatever its row holds: its steps are discarded
                if chunk is not None:
                    row[:len(chunk)] = chunk
                    row[len(chunk):] = chunk[-1]
            return _FullEntry(host, valid)
        copies, lanes_of = [], []
        for i, (sl, _, _) in enumerate(self.shards):
            dst = group.frames[i]
            pairs, mine = [], []
            lanes = (0,) if self.lanes is None else range(self.lanes)[sl]
            for r, b in enumerate(lanes):
                chunk = chunks[b]
                if chunk is None:  # a lane past its end keeps whatever its row holds
                    continue
                if not self.rings[b].holds(chunk):
                    raise RuntimeError("on the card the full-frame engine stages chunks from"
                                       " their pinned rings only (staging_ring)")
                row, k = (dst if self.lanes is None else dst[r]), len(chunk)
                pairs.append((row[:k], torch.from_numpy(chunk)))
                if k < T:  # pad on the card, behind the copy on the same stream
                    pairs.append((row[k:], row[k - 1:k].expand(T - k, *row.shape[1:])))
                mine.append(b)
            copies.append(pairs)
            lanes_of.append(mine)
        events = self._copy_in(group, copies)
        for event, mine in zip(events, lanes_of):
            for b in mine:
                self.rings[b].copied(chunks[b], event)
        return _FullEntry(None, valid)

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
        with self.timer.section("upload"):
            entry = self._stage(chunks, T)
        return self._run(entry)

    def _launch(self, entry):
        outs = []
        for i, (sl, dev, scan) in enumerate(self.shards):
            frames = self._group.frames[i] if self._cuda else torch.from_numpy(entry.host[sl])
            T = frames.shape[-3]
            with self.timer.span("shard.launch", shard=i), on_device(dev):
                out = scan(frames, self.pos0[i], self.fill[i])
                pos, off = out if self.subpixel else (out, None)
                self.pos0[i] = self._chain(self.pos0[i], pos, entry.valid[sl], T)
            outs.append((pos, off))
        bufs = None
        if self._cuda:
            first = outs[0][0]
            shape = (tuple(first.shape) if len(outs) == 1
                     else (self.lanes,) + tuple(first.shape[1:]))
            bufs = (torch.empty(shape, dtype=first.dtype, pin_memory=True),
                    torch.empty(shape, dtype=torch.float32, pin_memory=True)
                    if self.subpixel else None)
        return self._results(outs, bufs)


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
    stats: dict | None = None,
):
    """Full-frame streaming of one video: chunk scans chain their start
    positions on the device and the host drains positions ``depth`` chunks
    behind. ``pos0_abs`` is one position ``[2]``, or ``[N, 2]`` for N targets
    (``scan`` then returns ``[T, N, 2]``). Frames are whole, so results equal
    the synchronous loop's at every depth. ``stats``, when given, receives
    the chunk launches as ``groups``. Returns ``(position blocks, offset
    blocks, frames tracked)``."""
    positions: list[np.ndarray] = []
    offsets: list[np.ndarray] = []
    tracked = 0
    drained = 0
    pending: deque = deque()  # (handle, chunk)

    from .diagnose import Dont

    keep = not isinstance(dia, Dont)
    ring = staging_ring(device)
    eng = _FullFrameEngine(scan, pos0_abs, fill, subpixel, timer, device, rings=[ring])

    def drain_one():
        nonlocal tracked, drained
        handle, frames = pending.popleft()
        k = len(frames)
        with timer.span("drain", seq=drained):
            with timer.section("drain"):
                out_np, off_np = eng.to_host(handle)
            drained += 1
            positions.append(out_np[:k])
            if off_np is not None:
                offsets.append(off_np[:k])
            if keep:
                with timer.section("diagnose"):
                    for i in range(k):
                        dia(frames[i], out_np[i])
            # the chunk's positions are in, so its copy to the card is done: the
            # prefetcher may refill its buffer now
            prefetch.recycle(frames)
            tracked += k
            if progress is not None:
                progress(tracked, n_rest)

    with timer.span("pipeline", stream="full"):
        try:
            prefetch = ChunkPrefetcher(src, chunk_size, max_frames=n_rest, ring=ring, timer=timer)
            prefetchers.append(prefetch)
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
    if stats is not None:
        stats["groups"] = eng.groups
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
    chunks behind). ``prefetchers[b]`` yields video b's chunks, on the card
    into its :func:`staging_ring`; a video whose chunk comes back short has
    ended, and its lane runs on with discarded steps while the others
    continue. ``scan(frames
    [B,T,H,W], pos0 [B,2], fills)`` returns ``[B,T,2]`` (and offsets with
    ``subpixel``).

    Returns per video ``(position blocks, offset blocks, frames tracked)`` as
    three lists."""
    from .diagnose import Dont

    B = len(prefetchers)
    iters = [iter(p) for p in prefetchers]
    active = [True] * B
    positions: list[list] = [[] for _ in range(B)]
    offsets: list[list] = [[] for _ in range(B)]
    counts = [0] * B
    pending: deque = deque()  # (handle, chunks, dispatch seq)
    eng = _FullFrameEngine(scan, pos0, fills, subpixel, timer, device, lanes=B,
                           rings=[p.ring for p in prefetchers])

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
        handle, chunks, seq = pending.popleft()
        with timer.span("drain", seq=seq):
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

    with timer.span("pipeline", stream="full"):
        try:
            seq = 0
            while True:
                chunks = gather()
                if all(c is None for c in chunks):
                    break
                while len(pending) > depth:
                    drain_one()
                while pending and eng.ready(pending[0][0]):
                    drain_one()
                pending.append((eng.dispatch(chunks, chunk_size), chunks, seq))
                seq += 1
            while pending:
                drain_one()
        finally:
            eng.close()
    return positions, offsets, counts


# ---------------------------------------------------------------------------
# ROI streaming: the engine (device side), the source (frame delivery) and the
# controller, then the single-video frontend
# ---------------------------------------------------------------------------


# ---- the measured engine choice ---------------------------------------------------------

#: the decision rule's version, the first field of every key of the engine cache: a change to
#: the probe or the rule measures again
ENGINE_RULE = "torch-v1"
#: the other kernel replaces the shape rule's only when it takes less than this share of
#: its time (the JAX package's margin, ``pawsometracker_tpu/pipeline.py:526-531``)
ENGINE_MARGIN = 0.75
#: a measurement whose every time exceeds this (ms) is kept for the process and not
#: persisted: the next process measures again (the JAX package's rule)
DEGRADED_MS = 500.0

#: the decisions of this process, by key (:func:`_engine_key`)
_session_engine_cache: dict = {}


def _engine_cache_path() -> str:
    """The engine cache: ``engine_cache_torch.json`` under the port's cache root
    (``$PAWSOMETRACKER_CACHE``, else ``~/.cache/pawsometracker_tpu_torch``), a
    file of its own beside the JAX package's ``engine_cache.json`` where both
    share a root."""
    d = cache_root()
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "engine_cache_torch.json")


def _load_engine_cache() -> dict:
    p = _engine_cache_path()
    if not os.path.exists(p):
        return {}
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_engine_cache(entries: dict) -> None:
    """Add ``entries`` to the cache file, atomically: the file is read again
    just before the write, so decisions another process saved while this one
    measured are kept, and a reader sees the old file or the new one."""
    p = _engine_cache_path()
    cache = _load_engine_cache()
    cache.update(entries)
    tmp = f"{p}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1)
    os.replace(tmp, p)


def _measures(device: torch.device) -> bool:
    """Whether the chooser measures on ``device``: on a CUDA card only."""
    return device.type == "cuda"


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device)


def _engine_key(roi_spec, k_frames: int, batch, subpixel: bool, device) -> str:
    """The decision's key: the rule, the card and the software that ran it (the
    kernel library's digest, so an edited ``.cu`` measures again), and the
    geometry. ``fill`` is not in it: the DoG response of a constant is 0,
    so the probe's times and positions do not depend on it."""
    from .ops._build import library_digest

    fields = (ENGINE_RULE, _device_kind(device), torch.__version__, torch.version.cuda,
              library_digest("dog_scan"), roi_spec.frame_shape, roi_spec.radii,
              round(roi_spec.sigma, 6), roi_spec.darker_target, k_frames)
    fields += (() if batch is None else (f"B{batch}",)) + (("sub",) if subpixel else ())
    return "|".join(map(str, fields))


def pick_bounded_engine(roi_spec, k_frames: int, fill: int = 128, subpixel: bool = False, *,
                        device=None):
    """The bounded scan of one chain for this card and geometry, chosen by
    measurement (the JAX package's ``pick_bounded_engine``,
    ``pawsometracker_tpu/pipeline.py:346-381``).

    On the card it times the kernels that take the window (``dog_scan``
    where it fits shared memory, ``dog_scan_tiled`` always) on the JAX
    package's probe: an off-centre blob, then a flat field and a centred
    blob, whose responses tie. Each must give the plain version's positions
    on all three, and offsets within ``atol=1e-3`` with ``subpixel``: a
    parity pin for the built kernels on this card. The shape rule's kernel
    stays unless the other takes under :data:`ENGINE_MARGIN` of its time.
    The decision is kept for the process and in the engine cache
    (:func:`_engine_cache_path`), per card, software and geometry, so each
    card measures once. The probe times one chunk launch.

    Unlike the JAX package's chooser, nothing falls back: a kernel that
    differs from the plain version raises :class:`RuntimeError` (naming the
    kernel, the geometry and the first step that differs), and so does a
    kernel that fails to build or launch. Off the card it measures nothing.

    Returns ``("pallas", info)``: ``info["kernel"]`` the chosen kernel,
    ``info["<kernel>_ms"]`` each candidate's best of 3 card times on the blob,
    ``info["xla_ms"]`` the plain version's one run, ``parity`` and
    ``tie_parity``; ``("xla", {"reason": "non-cuda device"})`` off the card.
    ``device=None`` is the card."""
    return _pick_engine_measured(roi_spec, k_frames, fill, None, subpixel, device)


def pick_bounded_engine_batch(roi_spec, k_frames: int, batch: int, fill: int = 128,
                              subpixel: bool = False, *, device=None):
    """:func:`pick_bounded_engine` for the batched bounded scan of ``batch``
    lanes (the batch and multi ROI paths; under a mesh, a shard's lanes):
    the JAX package's ``pick_bounded_engine_batch``."""
    return _pick_engine_measured(roi_spec, k_frames, fill, int(batch), subpixel, device)


def _pick_engine_measured(roi_spec, k_frames: int, fill: int, batch, subpixel: bool = False,
                          device=None):
    dev = resolve_device(device)
    if not _measures(dev):
        return "xla", {"reason": "non-cuda device"}
    key = _engine_key(roi_spec, k_frames, batch, subpixel, dev)
    if key in _session_engine_cache:
        info = _session_engine_cache[key]
        return info["engine"], info
    saved = _load_engine_cache().get(key)
    if saved is not None:
        _session_engine_cache[key] = saved
        return saved["engine"], saved
    with tk.probing(), on_device(dev):
        info = _measure_engines(roi_spec, k_frames, fill, batch, subpixel, dev)
    _session_engine_cache[key] = info
    times = [v for k, v in info.items() if k.endswith("_ms")]
    if min(times) > DEGRADED_MS:
        info["transient"] = "degraded measurement, not persisted"
        return info["engine"], info
    try:
        _save_engine_cache({key: info})
    except OSError:
        pass  # a read-only cache root: the process keeps its decision
    return info["engine"], info


def _probe_inputs(roi_spec, k_frames: int, fill: int, batch, device) -> dict:
    """The JAX package's probe (``pawsometracker_tpu/pipeline.py:424-470``), on
    ``device``: the bounded scan's arguments over K copies of a frame (in
    each of ``batch`` lanes) from the crop's centre, with zero rebases and the
    crop as the box; by name, the off-centre blob (a unique maximum) first,
    then the flat field and the centred blob (exact ties)."""
    ch, cw = roi_spec.frame_shape
    yy, xx = np.mgrid[:ch, :cw]
    sig = max(roi_spec.sigma, 1.0)
    sign = -1.0 if roi_spec.darker_target else 1.0

    def blob(ci, cj):
        g = np.exp(-((yy - ci) ** 2 + (xx - cj) ** 2) / (2.0 * sig ** 2))
        return np.clip(fill + sign * 110.0 * g, 0, 255).astype(np.uint8)

    frames = {"blob": blob(ch // 2 + 3, cw // 2 - 2),
              "flat field": np.full((ch, cw), fill, np.uint8),
              "centred blob": blob(ch // 2, cw // 2)}
    lanes = () if batch is None else (batch,)

    def i32(a):
        return torch.from_numpy(np.array(a, np.int32)).to(device)

    zeros = i32(np.zeros(lanes + (k_frames, 2)))
    hi = i32(np.broadcast_to([ch - 1, cw - 1], lanes + (k_frames, 2)))
    pos = i32(np.broadcast_to([ch // 2, cw // 2], lanes + (2,)))
    fills = fill if batch is None else torch.full((batch,), fill, dtype=torch.uint8,
                                                  device=device)
    return {name: (torch.from_numpy(np.ascontiguousarray(
                       np.broadcast_to(fr, lanes + (k_frames, ch, cw)))).to(device),
                   pos, fills, zeros, zeros, hi)
            for name, fr in frames.items()}


#: card clock cycles of the sleep queued before each timed candidate run (about 1 ms on an
#: H100): longer than the host takes to issue the run, so the events time the card's work
_QUEUE_CYCLES = 2_000_000


def _timed(name: str, fn, reps: int):
    """Run ``fn`` on the card; returns its output on the host and a time in ms
    by CUDA events. With ``reps`` > 1 (a candidate kernel): once to warm up,
    then the best of ``reps`` runs, each queued behind a short sleep of the
    card, so that the time is the kernel's and not the wrapper's Python,
    which both candidates share; with 1 (the plain version, a Python loop of
    small launches): one run, the host's issue included. ``name`` says what
    runs."""
    if reps > 1:
        fn()
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if reps > 1:
            torch.cuda._sleep(_QUEUE_CYCLES)
        t0.record()
        out = fn()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1))
    host = tuple(o.cpu().numpy() for o in out) if isinstance(out, tuple) else out.cpu().numpy()
    return host, best


def _first_mismatch(got, want, subpixel: bool):
    """Where ``got`` first differs from ``want`` (positions exactly, offsets
    beyond ``atol=1e-3``), as ``(index, got, want)``, or None."""
    pairs = [(got[0], want[0], 0.0), (got[1], want[1], 1e-3)] if subpixel else [(got, want, 0.0)]
    for g, w, atol in pairs:
        bad = np.abs(g.astype(np.float64) - w.astype(np.float64)) > atol
        if bad.any():
            idx = np.argwhere(bad)[0][:-1]  # the step (and lane) of the first difference
            return tuple(int(i) for i in idx), g[tuple(idx)].tolist(), w[tuple(idx)].tolist()
    return None


def _measure_engines(roi_spec, k_frames: int, fill: int, batch, subpixel: bool,
                     device) -> dict:
    """Time every kernel that takes the window against the plain version on
    the probe (:func:`_probe_inputs`) and choose; raise on any difference."""
    candidates = tk.kernels_for(roi_spec.radii, roi_spec.kernel_len,
                                tk._smem_limit(device.index or 0))
    name = ("scan_sub" if subpixel else "scan_bounded") + ("" if batch is None else "_batch")
    inputs = _probe_inputs(roi_spec, k_frames, fill, batch, device)
    kw = dict(radii=roi_spec.radii, sigma=roi_spec.sigma, darker_target=roi_spec.darker_target,
              subpixel=subpixel)

    def plain(frames, pos, fills, deltas, lo, hi):  # read from the module at each call
        run = tk.dog_scan_plain if batch is None else tk.dog_scan_batch_plain
        return run(frames, pos, fills, deltas=deltas, lo=lo, hi=hi, **kw)

    want, info = {}, {"engine": "pallas"}
    for probe, args in inputs.items():  # the oracle: once on each input
        want[probe], ms = _timed("plain", functools.partial(plain, *args), 1)
        if probe == "blob":
            info["xla_ms"] = round(ms, 4)
    times = {}
    for kernel in candidates:
        scan = getattr(tracker_fns(roi_spec, device, "pallas", kernel=kernel), name)
        for probe, args in inputs.items():
            got, ms = _timed(kernel, functools.partial(scan, *args), 3 if probe == "blob" else 1)
            if probe == "blob":
                times[kernel] = ms
            bad = _first_mismatch(got, want[probe], subpixel)
            if bad is not None:
                where, g, w = bad
                ch, cw = roi_spec.frame_shape
                raise RuntimeError(
                    f"{kernel} differs from the plain version on this card: {ch}x{cw} crop, "
                    f"window {roi_spec.window_size}, sigma {roi_spec.sigma:.6g}, K={k_frames}"
                    + ("" if batch is None else f", B={batch}")
                    + (", subpixel" if subpixel else "")
                    + f", probe {probe!r}: first at {'step' if batch is None else '(lane, step)'}"
                    f" {where}: {g} against {w}")
    default = candidates[0]
    wins = [k for k in candidates[1:] if times[k] < ENGINE_MARGIN * times[default]]
    info["kernel"] = min(wins, key=times.get) if wins else default
    info["default"] = default
    info.update({f"{k}_ms": round(t, 4) for k, t in times.items()})
    info.update(parity=True, tie_parity=True)
    return info


def _select_batched_bounded(tracker, roi_spec, k_frames: int, batch: int, fill: int,
                            engine: str, subpixel: bool = False):
    """The batched bounded scan of the batch and multi ROI paths on the
    tracker's one device (the JAX package's ``_select_batched_bounded``,
    ``pawsometracker_tpu/pipeline.py:558-573``): ``"auto"`` the kernel
    :func:`pick_bounded_engine_batch` chooses (the plain version off the
    card), ``"pallas"`` the shape rule's kernel, ``"xla"`` the plain version.
    Returns ``(scan, segments)``: the chunk scan (``scan_sub_batch`` with
    ``subpixel``, else ``scan_bounded_batch``) and its segmented form, which
    the port's lane engine launches for every chunk."""
    kernel = None
    if engine == "auto":
        engine, info = pick_bounded_engine_batch(roi_spec, k_frames, batch, fill,
                                                 subpixel=subpixel, device=tracker.device)
        kernel = info.get("kernel")
    fns = tracker_fns(roi_spec, tracker.device, engine, kernel=kernel)
    return (fns.scan_sub_batch if subpixel else fns.scan_bounded_batch,
            functools.partial(fns.scan_bounded_batch_super, subpixel=subpixel))


def _select_sharded_bounded(tracker, roi_spec, k_frames: int, batch: int, fill: int,
                            engine: str, mesh, subpixel: bool = False):
    """The batched bounded scan of the batch ROI path under a mesh (the JAX
    package's ``_select_sharded_bounded``, ``pawsometracker_tpu/pipeline.py:576-598``):
    where the batch divides the mesh's ``data`` axis, ``"pallas"`` gives
    :func:`~.parallel.mesh.sharded_pallas_bounded` with the shape rule's
    kernel (one launch a shard), and ``"auto"`` measures at the per-shard
    batch on the mesh's first device (:func:`pick_bounded_engine_batch`) and
    gives it with the chosen kernel on the card; otherwise the tracker's own
    scan (``"xla"``: the plain version a shard; ``"auto"`` off the card, or
    on a batch the data axis does not divide). ``engine="pallas"`` with a
    batch the data axis does not divide raises."""
    from .parallel.mesh import sharded_pallas_bounded

    data_size = mesh.shape["data"]
    if engine == "pallas" and batch % data_size:
        raise ValueError(
            f"engine='pallas' under a mesh needs the batch ({batch}) divisible "
            f"by the mesh data axis ({data_size})"
        )
    kernel = None
    if engine == "auto" and batch % data_size == 0:
        engine, info = pick_bounded_engine_batch(roi_spec, k_frames, max(batch // data_size, 1),
                                                 fill, subpixel=subpixel,
                                                 device=mesh.data_devices()[0])
        kernel = info.get("kernel")
    if engine == "pallas":
        return sharded_pallas_bounded(roi_spec, mesh, subpixel=subpixel, kernel=kernel)
    return tracker.scan_sub if subpixel else tracker.scan_bounded


def _staged(seg, *args, subpixel: bool):
    """The staged form of the segmented scan ``seg`` (a tracker function, or
    a ``functools.partial`` of one; its function's ``stage``, see
    :class:`~.models.dog_tracker.TrackerFns`) over the buffers ``args``."""
    return getattr(seg, "func", seg).stage(*args, subpixel=subpixel)


class _CropBuffer(np.ndarray):
    """A crop buffer ``[L, K, ch, cw]`` u8 in pinned host memory, carrying the
    :class:`_RoiSlot` through which its chunk goes to the card."""

    slot = None


def _crop_bytes(shape) -> tuple:
    """The bytes of crops of ``shape``, and where the int32 arguments start
    after them in one staged buffer: the next multiple of 16."""
    n = int(np.prod(shape))
    return n, -(-n // 16) * 16


class _RoiSlot:
    """The host side of one crop buffer ``[L, K, ch, cw]`` on the card: one
    pinned buffer ``raw`` holding the crops ``host`` and, after them, the
    scan's int32 arguments ``args`` (laid out by the engine, a span a shard),
    as a device slot's row holds them, so that one copy takes both to the
    card; pinned buffers for the positions ``[L, K, 2]`` (and offsets) coming
    back; and per shard an event recorded after its copies to the card
    (``copied``, the last ones) and one after its results' copies back
    (``done``)."""

    __slots__ = ("raw", "host", "args", "args_np", "pos", "off", "copied", "copy_events",
                 "done")

    def __init__(self, shape, n_args: int, subpixel: bool, shards: int):
        lanes_steps = tuple(shape[:2]) + (2,)
        n, at = _crop_bytes(shape)
        self.raw = torch.empty(at + 4 * n_args, dtype=torch.uint8, pin_memory=True)
        self.host = self.raw[:n].view(tuple(shape))
        self.args = self.raw[at:].view(torch.int32)
        self.args_np = self.args.numpy()
        self.pos = torch.empty(lanes_steps, dtype=torch.int32, pin_memory=True)
        self.off = (torch.empty(lanes_steps, dtype=torch.float32, pin_memory=True)
                    if subpixel else None)
        self.copied = []
        self.copy_events = [torch.cuda.Event() for _ in range(shards)]
        self.done = [torch.cuda.Event() for _ in range(shards)]


class _RoiGroup(_DeviceGroup):
    """A ROI engine's device slot: per shard one buffer ``[1, row]`` u8 whose
    row holds a chunk's crops and, after them, its int32 arguments (the
    slot's ``raw`` layout); ``frames [1, L_i, K, ch, cw]`` and ``args [1, n]``
    are its views, ``rows`` its row. ``staged`` holds per shard the engine's
    segmented scan over it (:class:`~.ops.tracker_kernel.StagedScan`, checked
    once, here), launched at S = 1, and ``starts`` the view of its chain
    start. ``launched`` holds per shard the event re-recorded after each
    launch, which ``consumed`` then names."""

    __slots__ = ("rows", "staged", "starts", "launched")


class _RoiEntry(NamedTuple):
    """A staged ROI chunk: its crop buffer, its flat int32 arguments, whether
    it starts the chain, and its real frame count (L = 1)."""

    buf: object
    args: np.ndarray
    first: bool
    k: int


class _RoiEngine(_ShardedEngine):
    """What the lane engines share: the staging of a chunk's crops and
    arguments, and the way its positions come back.

    The lanes split into data shards (:func:`_lane_shards`): one on the
    engine's device, or under a mesh one a row of it, each on its device with
    its own scan and segmented scan (``segments``: one device's, or a
    :class:`~.parallel.mesh.ShardedFn` scan's own ``segments``). On the card
    every crop buffer comes from :meth:`alloc`, pinned, with a
    :class:`_RoiSlot`: each shard's crops and int32 arguments go to its
    device slot (:class:`_RoiGroup`) in non-blocking copies on that device's
    side stream, one where there is one shard, the launch waits on their
    events, and the positions come back into the buffer's pinned ones behind
    an event a shard that :meth:`ready` queries and :meth:`to_host` waits on.
    The launch is the segmented scan at S = 1, staged over the slot's buffers
    when the slot was made (``segments``' ``stage``, checked once), so a
    launch converts, checks and repacks nothing. A buffer is refilled only
    after :meth:`claim` (its last copies done). On the CPU the launch hands
    the chunk's buffers to the scans as arguments."""

    def __init__(self, scan, crop_shape, frame_shape, subpixel, timer, device, lanes: int,
                 segments):
        self.ch, self.cw = crop_shape
        self.frame_max = np.array([frame_shape[0] - 1, frame_shape[1] - 1])
        self.subpixel = subpixel
        self.timer = timer
        super().__init__(scan, lanes, device)
        self.seg_fns = scan.segments if isinstance(scan, ShardedFn) else [segments]
        self.lanes = [len(range(lanes)[sl]) for sl, _, _ in self.shards]
        self.reset()

    def _spans(self, K: int) -> list:
        """Per shard, the ``(start, stop)`` of its arguments in the flat buffer."""
        ends = np.cumsum([self._n_args(n, K) for n in self.lanes]).tolist()
        return list(zip([0] + ends[:-1], ends))

    def alloc(self, shape):
        """A new crop buffer ``shape = [L, K, ch, cw]``: a
        :class:`_CropBuffer` on the card, a plain array on the CPU."""
        if not self._cuda:
            return np.empty(shape, np.uint8)
        slot = _RoiSlot(shape, self._spans(shape[1])[-1][1], self.subpixel, len(self.shards))
        buf = slot.host.numpy().view(_CropBuffer)
        buf.slot = slot
        return buf

    @staticmethod
    def claim(buf):
        """Wait until ``buf`` may be refilled: its last copies to the card are done."""
        slot = getattr(buf, "slot", None)
        if slot is not None:
            for copied in slot.copied:
                copied.synchronize()

    def _bounds(self, o):
        """Per-frame clamp box: the frame's bounds in each frame's crop
        coordinates, for per-frame origins ``o`` (``[K, 2]`` or ``[L, K, 2]``)."""
        lo = np.maximum(-o, 0)
        hi = np.minimum([self.ch - 1, self.cw - 1], self.frame_max - o)
        return lo, hi

    def _new_group(self, K: int) -> _RoiGroup:
        """A device slot: per shard its buffer, the views of it and the
        staged segmented scan over them."""
        group = _RoiGroup([], [])
        group.rows, group.staged, group.starts, group.launched = [], [], [], []
        for i, (n, (_, dev, _)) in enumerate(zip(self.lanes, self.shards)):
            crop, at = _crop_bytes((n, K, self.ch, self.cw))
            raw = torch.empty((1, at + 4 * self._n_args(n, K)), dtype=torch.uint8, device=dev)
            frames = raw[:, :crop].view(1, n, K, self.ch, self.cw)
            args = raw[:, at:].view(torch.int32)
            staged, start = self._staged_scan(i, frames, args)
            group.frames.append(frames)
            group.args.append(args)
            group.rows.append(raw[0])
            group.staged.append(staged)
            group.starts.append(start)
            group.launched.append(torch.cuda.Event() if dev.type == "cuda" else None)
        group.consumed = [None] * len(self.shards)
        return group

    def _stage(self, buf, args):
        """Stage the chunk's crops ``buf [L, K, ch, cw]`` and flat arguments:
        on the card, start their copies from the pinned buffer into each
        shard's device slot, on the shard's side stream, with its scan stream
        waiting for them: one copy for one shard (the buffer's ``raw`` is the
        slot's row), else two a shard (its lanes' crops, and its span of the
        arguments, lie apart in the buffer)."""
        K = buf.shape[1]
        group = self._slot(lambda: self._new_group(K))
        if not self._cuda:
            return
        slot = buf.slot
        slot.args_np[...] = args
        if len(self.shards) == 1:
            copies = [[(group.rows[0], slot.raw)]]
        else:
            copies = [[(group.frames[i][0], slot.host[sl]), (group.args[i][0], slot.args[a0:a1])]
                      for i, ((sl, _, _), (a0, a1)) in enumerate(zip(self.shards,
                                                                      self._spans(K)))]
        slot.copied = self._copy_in(group, copies, slot.copy_events)

    def _finish(self, entry, outs):
        """The handle of the launched ``entry`` whose scans gave, per shard,
        ``(positions [L_i, K, 2], offsets)``: on the CPU the rows; on the
        card, after marking the device slot consumed once the work queued so
        far has run, the copies of the rows into the shard's lanes of the
        buffer's pinned ones, behind its slot's ``done`` events."""
        if not self._cuda:
            return self._results(outs, None)
        group = self._group
        slot = entry.buf.slot
        one = len(self.shards) == 1
        for i, ((sl, dev, _), (pos, off)) in enumerate(zip(self.shards, outs)):
            with self.timer.span("shard.results", shard=i), torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev)
                group.launched[i].record(stream)
                group.consumed[i] = group.launched[i]
                (slot.pos if one else slot.pos[sl]).copy_(pos, non_blocking=True)
                if off is not None:
                    (slot.off if one else slot.off[sl]).copy_(off, non_blocking=True)
                slot.done[i].record(stream)
        return slot.pos, slot.off, slot.done


class _SingleArgs(NamedTuple):
    """Views of :class:`_SingleEngine`'s flat int32 arguments (the last axis of
    a numpy array on the host, or of its ``[1, n]`` twin on the device):
    ``deltas``, ``lo``, ``hi`` ``[..., K, 2]``, the chain's start ``[..., 2]``
    (a chain's first chunk) and the real frame count ``ks [...]``."""

    deltas: object
    lo: object
    hi: object
    start: object
    ks: object


def _single_args(flat, K: int) -> _SingleArgs:
    lead, n = tuple(flat.shape[:-1]), 2 * K
    return _SingleArgs(flat[..., :n].reshape(lead + (K, 2)),
                       flat[..., n:2 * n].reshape(lead + (K, 2)),
                       flat[..., 2 * n:3 * n].reshape(lead + (K, 2)),
                       flat[..., 3 * n:3 * n + 2], flat[..., 3 * n + 2])


class _SingleEngine(_RoiEngine):
    """Lane adapter for L = 1 over the unbatched bounded scan
    ``scan(frames [K,ch,cw], pos0 [2], fill, deltas, lo, hi)`` and its
    segmented form ``segments`` (``scan_bounded_super``): the JAX package's
    ``_SingleEngine``.

    It owns the chain on the device: a chunk starts from a view of the
    previous output's last real row, ``prev[prev_k - 1]``, which ``deltas[0]``
    rebases into the new crop, so the host never waits for it. After
    :meth:`reset` (a replay, or the start of a run) the first chunk takes its
    absolute start ``P - o[0]`` from the host. Its arguments: deltas, lo, hi
    ``[K, 2]``, a chain start and ``ks``."""

    def __init__(self, scan, crop_shape, frame_shape, fill, subpixel, timer, device,
                 segments=None):
        self.fill = int(fill)
        self.scan = scan
        super().__init__(scan, crop_shape, frame_shape, subpixel, timer, device, lanes=1,
                         segments=segments)

    def reset(self):
        self._prev = None
        self._prev_k = None
        self._prev_origin = None

    @staticmethod
    def _n_args(lanes, K):
        return 6 * K + 4

    @staticmethod
    def _deltas(o, prev_last):
        """Per-frame rebase: ``d[0]`` maps the carried position from
        ``prev_last`` (the previous chunk's last real frame origin, or this
        chunk's own first origin at a chain start) into frame 0's crop;
        ``d[i] = o[i-1] - o[i]`` thereafter."""
        d = np.empty_like(o)
        d[0] = prev_last - o[0]
        d[1:] = o[:-1] - o[1:]
        return d

    def dispatch(self, buf, origins, P_abs, valid=None):
        """Launch the scan of the chunk in ``buf`` (``[1, K, ch, cw]``, cropped
        at per-frame ``origins [1, K, 2]``; ``valid[0]`` real frames), chained
        to the last one, or from ``P_abs`` after a reset; returns a handle for
        :meth:`ready` and :meth:`to_host`."""
        o = np.asarray(origins[0], np.int64)
        K = buf.shape[1]
        k = K if valid is None else int(valid[0])
        first = self._prev is None
        args = np.zeros(self._n_args(1, K), np.int32)
        a = _single_args(args, K)
        a.deltas[...] = self._deltas(o, o[0] if first else self._prev_origin)
        a.lo[...], a.hi[...] = self._bounds(o)
        a.ks[...] = k
        if first:
            a.start[...] = np.asarray(P_abs[0], np.int64) - o[0]
        with self.timer.section("upload"):
            self._stage(buf, args)
        # the chain continues from the last REAL row: its frame count, and the
        # origin that row was cropped at
        self._prev_origin = o[max(k - 1, 0)]
        return self._run(_RoiEntry(buf, args, first, max(k, 1)))

    def _staged_scan(self, i: int, frames, args):
        a = _single_args(args, frames.shape[2])
        return (_staged(self.seg_fns[0], frames[:, 0], self.fill, a.deltas, a.lo, a.hi, a.ks,
                        subpixel=self.subpixel), a.start[0])

    def _launch(self, entry):
        # positions [1, K, 2]: the staged scan's one segment, or the scan's one lane
        if self._cuda:  # the staged scan, from its start or the chain
            pos0 = self._group.starts[0] if entry.first else self._prev[self._prev_k - 1]
            with self.timer.span("shard.launch", shard=0):
                out = self._group.staged[0].run(1, pos0=pos0)
        else:
            a = _single_args(torch.from_numpy(entry.args), entry.buf.shape[1])
            pos0 = a.start if entry.first else self._prev[self._prev_k - 1]
            with self.timer.span("shard.launch", shard=0):
                out = self.scan(torch.from_numpy(entry.buf[0]), pos0, self.fill, a.deltas, a.lo,
                                a.hi)
                out = tuple(x[None] for x in out) if self.subpixel else out[None]
        pos, off = out if self.subpixel else (out, None)
        self._prev, self._prev_k = pos[0], entry.k
        return self._finish(entry, [(pos, off)])


class _BatchArgs(NamedTuple):
    """Views of :class:`_BatchedEngine`'s flat int32 arguments of one shard
    (the last axis of a numpy array on the host, or of its ``[1, n]`` twin on
    the device): the scan's ``deltas``, ``lo``, ``hi`` ``[..., L, K, 2]``; per
    lane the first and last real frame's crop origin and the chain's seed
    ``[..., L, 2]``; and the real frame count ``ks [..., L]``."""

    deltas: object
    lo: object
    hi: object
    origin0: object
    origin_last: object
    seed: object
    ks: object


def _batch_args(flat, lanes: int, K: int) -> _BatchArgs:
    lead, n, o = tuple(flat.shape[:-1]), 2 * lanes * K, 6 * lanes * K
    steps, pair = lead + (lanes, K, 2), lead + (lanes, 2)
    return _BatchArgs(
        flat[..., :n].reshape(steps), flat[..., n:2 * n].reshape(steps),
        flat[..., 2 * n:o].reshape(steps), flat[..., o:o + 2 * lanes].reshape(pair),
        flat[..., o + 2 * lanes:o + 4 * lanes].reshape(pair),
        flat[..., o + 4 * lanes:o + 6 * lanes].reshape(pair),
        flat[..., o + 6 * lanes:o + 7 * lanes])


def last_rows(ks, K: int) -> np.ndarray:
    """Per lane, the row of its last real step in a ``[L*K, 2]`` view of the
    positions (row ``b*K``, a lane's first, when it has none)."""
    ks = np.asarray(ks, np.int64)
    return np.arange(ks.shape[0]) * K + np.maximum(ks - 1, 0)


def chain_batch(scan, frames, carry, ks, last_row, origin0, origin_last, fills, deltas, lo, hi):
    """One chained scan of L lanes as tensor ops beside the scan: the JAX
    package's ``make_chained_batch`` (``pawsometracker_tpu/pipeline.py:248-277``),
    the plain form of the carry that the batched engine's launches keep
    (``scan_bounded_batch_super`` with S = 1).

    The chain's state is an absolute per-lane carry ``[L, 2]`` int32 on the
    device. The scan starts at ``carry - origin0`` (so ``deltas[:, 0]`` is
    zero: the chunk-to-chunk shift is this rebase), and the next carry is
    ``positions[b, ks[b]-1] + origin_last[b]`` (read through ``last_row``, see
    :func:`last_rows`), or the carry itself for a lane with ``ks == 0``: a
    short video past its end, or a split remainder, whose rows are argmaxes
    over fill. Returns ``(scan output, new carry)``."""
    out = scan(frames, carry - origin0, fills, deltas, lo, hi)
    pos = out[0] if isinstance(out, tuple) else out
    last = pos.reshape(-1, 2).index_select(0, last_row)
    return out, torch.where(ks[:, None] > 0, last + origin_last, carry)


class _BatchedEngine(_RoiEngine):
    """Lane adapter for L lanes (B videos, or N targets of one video) over
    the batched bounded scan ``scan(frames [L,K,ch,cw], pos0 [L,2], fills
    [L], deltas, lo, hi [L,K,2])`` and its segmented form ``segments``
    (``scan_bounded_batch_super``; a :class:`~.parallel.mesh.ShardedFn` scan
    brings its own): the JAX package's ``_BatchedEngine``. Every chunk is one
    segmented launch at S = 1 a data shard.

    The chain is an absolute per-lane carry ``[L, 2]`` on the device, one a
    shard, which the launches read and write themselves (the JAX package's
    ``make_chained_batch``; :func:`chain_batch` is the same rule as tensor
    ops). After
    :meth:`reset` (a replay, or the start of a run) the next chunk seeds every
    shard's from the controller's ``P_abs``, which travels in the staged
    arguments. The arguments are one flat int32 buffer, a :func:`_batch_args`
    span a shard, each copied to its device in one piece beside its crops."""

    def __init__(self, scan, crop_shape, frame_shape, fills, subpixel, timer, device,
                 segments=None):
        fills = np.asarray(fills, np.uint8)
        super().__init__(scan, crop_shape, frame_shape, subpixel, timer, device,
                         lanes=len(fills), segments=segments)
        self.fills = [torch.as_tensor(fills[sl]).to(dev) for sl, dev, _ in self.shards]
        self._carry = [torch.zeros((n, 2), dtype=torch.int32, device=dev)
                       for n, (_, dev, _) in zip(self.lanes, self.shards)]

    def reset(self):
        self._seed = True  # the next chunk seeds the carries from P_abs

    @staticmethod
    def _n_args(lanes, K):
        return 6 * lanes * K + 7 * lanes

    @staticmethod
    def _deltas(origins):
        """Per-lane per-frame rebase ``[L, K, 2]``; ``d[:, 0]`` is zero: the
        chunk-to-chunk shift is the carry rebase inside the chain."""
        d = np.zeros_like(origins)
        d[:, 1:] = origins[:, :-1] - origins[:, 1:]
        return d

    @staticmethod
    def _last_origin(origins, ks):
        """Per-lane origin of the last REAL frame: ``origins[b, ks[b]-1]``."""
        idx = np.maximum(np.asarray(ks) - 1, 0)
        return origins[np.arange(origins.shape[0]), idx]

    def dispatch(self, buf, origins, P_abs, valid=None):
        """Launch the scan of the chunk in ``buf`` (``[L, K, ch, cw]``, cropped
        at per-frame ``origins [L, K, 2]``; ``valid[b]`` real frames in lane
        b), chained by the carry, or from ``P_abs [L, 2]`` after a reset;
        returns a handle for :meth:`ready` and :meth:`to_host`."""
        L, K = buf.shape[:2]
        o = np.asarray(origins, np.int64)
        ks = np.full(L, K, np.int64) if valid is None else np.asarray(valid, np.int64)
        first, self._seed = self._seed, False
        spans = self._spans(K)
        args = np.zeros(spans[-1][1], np.int32)
        for (sl, _, _), n, (a0, a1) in zip(self.shards, self.lanes, spans):
            a = _batch_args(args[a0:a1], n, K)
            a.deltas[...] = self._deltas(o[sl])
            a.lo[...], a.hi[...] = self._bounds(o[sl])
            a.origin0[...] = o[sl, 0]
            a.origin_last[...] = self._last_origin(o[sl], ks[sl])
            a.ks[...] = ks[sl]
            if first:
                a.seed[...] = np.asarray(P_abs, np.int64).reshape(L, 2)[sl]
        with self.timer.section("upload"):
            self._stage(buf, args)
        return self._run(_RoiEntry(buf, args, first, 0))

    def _staged_scan(self, i: int, frames, args):
        a = _batch_args(args, self.lanes[i], frames.shape[2])
        return (_staged(self.seg_fns[i], frames, self.fills[i], a.deltas, a.lo, a.hi, a.ks,
                        a.origin0, a.origin_last, subpixel=self.subpixel), a.seed[0])

    def _launch(self, entry):
        outs = []  # per shard, positions [1, L_i, K, 2] (and offsets): one segment
        if self._cuda:  # each shard's staged scan, from its seed or carry
            for i, carry in enumerate(self._carry):
                carry_in = self._group.starts[i] if entry.first else carry
                with self.timer.span("shard.launch", shard=i):
                    out = self._group.staged[i].run(1, carry=carry_in, carry_out=carry)
                outs.append(out if self.subpixel else (out, None))
        else:  # each shard's lanes of the host buffers, as a segment
            K = entry.buf.shape[1]
            for i, ((sl, dev, _), n, (a0, a1), seg) in enumerate(
                    zip(self.shards, self.lanes, self._spans(K), self.seg_fns)):
                a = _batch_args(torch.from_numpy(entry.args[None, a0:a1]), n, K)
                carry = a.seed[0] if entry.first else self._carry[i]
                with self.timer.span("shard.launch", shard=i), on_device(dev):
                    out, _ = seg(torch.from_numpy(entry.buf[None, sl]), carry, self.fills[i],
                                 a.deltas, a.lo, a.hi, a.ks, a.origin0, a.origin_last,
                                 carry_out=self._carry[i])
                outs.append(out if self.subpixel else (out, None))
        return self._finish(entry, [(p[0], None if o is None else o[0]) for p, o in outs])


class SingleVideoSource:
    """One video, one target lane. Delivery: the native decoder's retained
    ring (predict mode), its direct ROI reads (contain mode), or a prefetched
    chunk cropped here by ``crop`` (:func:`.ops.roi_crop.lane_cropper`; with
    per-frame diagnostics when asked). Fills ``buf [1, K, ch, cw]`` at
    per-frame origins, re-crops retained frames for a replay, and releases,
    recycles and diagnoses accepted frames. ``timer``: the call's, for the
    prefetcher's spans."""

    def __init__(self, src, *, K, ch, cw, fill, dia, mode, native_roi, depth, n_rest,
                 prefetchers, crop=crop_lanes_plain, timer=None):
        from .diagnose import Dont

        self.src = src
        self.K, self.ch, self.cw, self.fill = K, ch, cw, fill
        self.crop = crop
        self._fills = np.array([fill], np.uint8)
        self.dia = dia
        self.mode = mode
        self.keep_for_dia = not isinstance(dia, Dont)
        # contain-mode native reads retain no frames, so diagnostics (which
        # read each frame at accept time) take the prefetcher there
        self.use_native_roi = native_roi and mode == "contain" and not self.keep_for_dia
        # retained reads deadlock if the ring cannot hold the chunks in flight
        # plus one decoding chunk; with diagnostics the ring must also serve
        # zero-copy views of retained frames, which the overlay reads
        self.use_native_retained = (
            native_roi
            and mode == "predict"
            and hasattr(src, "read_roi_chunk_retained")
            and getattr(src, "ring_frames", 0) >= (depth + 2) * K
            and (not self.keep_for_dia or getattr(src, "can_view_retained", False))
        )
        self._pf = None
        if not (self.use_native_roi or self.use_native_retained):
            self._pf = ChunkPrefetcher(src, K, max_frames=n_rest, timer=timer)
            prefetchers.append(self._pf)
            self._it = iter(self._pf)

    def acquire(self, remaining, origins, buf, timer):
        o = origins[0]  # [K, 2] per-frame origins for this lane
        if self.use_native_roi or self.use_native_retained:
            reader = (self.src.read_roi_chunk_retained if self.use_native_retained
                      else self.src.read_roi_chunk)
            with timer.section("crop"):
                got = reader(min(self.K, remaining), o, self.ch, self.cw, self.fill, out=buf[0])
            k = got.shape[0]
            if k == 0:
                return None
            buf[0, k:] = buf[0, k - 1]
            return (RETAINED if self.use_native_retained else None, np.array([k]))
        chunk = next(self._it, None)
        if chunk is None or chunk.shape[0] == 0:
            return None
        k = chunk.shape[0]
        with timer.section("crop"):
            self.crop([chunk], [k], origins, self._fills, buf)
        # predict mode retains the frames for an exact replay; diagnostics
        # need them too; otherwise they go back to the prefetcher now
        if not (self.mode == "predict" or self.keep_for_dia):
            self._pf.recycle(chunk)
            chunk = None
        return (chunk, np.array([k]))

    def recrop(self, tokens, valid, origins, rbuf, timer, base, off):
        k = int(valid[0])
        f0 = int(off[0])  # frame offset within tokens (split sub-chunks)
        with timer.section("crop"):
            if tokens is RETAINED:
                # the entry's frames sit behind the re-dispatched chunks still
                # in flight (unaccepted, hence unreleased): ``base`` is their
                # frame count, the offset into the retained window
                self.src.recrop(int(base[0]), k, origins[0], self.ch, self.cw, self.fill,
                                out=rbuf[0])
                rbuf[0, k:] = rbuf[0, k - 1]
            else:
                self.crop([tokens[f0:]], [k], origins, self._fills, rbuf)

    def accept(self, tokens, valid, abs_pos, timer, off):
        k = int(valid[0])
        f0 = int(off[0])
        if tokens is RETAINED:
            if self.keep_for_dia:
                # overlay straight from the ring (zero-copy views), then
                # release: this chunk's frames are the oldest retained
                with timer.section("diagnose"):
                    for i in range(k):
                        self.dia(self.src.retained_frame(i), abs_pos[0, i])
            self.src.release(k)
        elif tokens is not None:
            with timer.section("diagnose"):
                for i in range(k):
                    self.dia(tokens[f0 + i], abs_pos[0, i])
            if f0 + k == tokens.shape[0]:  # the last sub-chunk recycles the array
                self._pf.recycle(tokens)


class FanoutSource:
    """One video stream, N target lanes: each decoded chunk gives N crops,
    each lane's at its own per-frame origins. Delivery: the native decoder's
    retained ring (``advance_retained``, then ``recrop`` per lane, at every
    depth, contain mode included: its gate is the ring's size), or a shared
    prefetched chunk cropped here. The shared overlay is drawn at accept time
    with all N positions of a frame. ``timer``: the call's, for the
    prefetcher's spans."""

    def __init__(self, src, *, N, K, ch, cw, fill, mode, depth, n_rest, prefetchers, dia=None,
                 crop=crop_lanes_plain, timer=None):
        from .diagnose import Dont

        self.src = src
        self.N, self.K, self.ch, self.cw, self.fill = N, K, ch, cw, fill
        self.crop = crop
        self._fills = np.full(N, fill, np.uint8)
        self.mode = mode
        self.dia = dia
        self.keep_for_dia = dia is not None and not isinstance(dia, Dont)
        # diagnostics ride the ring too when it serves zero-copy views of
        # retained frames (the rule of SingleVideoSource)
        self.native = (
            hasattr(src, "read_roi_chunk_retained")
            and getattr(src, "ring_frames", 0) >= (depth + 2) * K
            and (not self.keep_for_dia or getattr(src, "can_view_retained", False))
        )
        self._retained = 0  # frames advanced into the ring and not yet released
        self._pf = None
        if not self.native:
            self._pf = ChunkPrefetcher(src, K, max_frames=n_rest, timer=timer)
            prefetchers.append(self._pf)
            self._it = iter(self._pf)

    def _crop_lanes(self, frames, k, origins, buf, base, timer, f0=0):
        with timer.section("crop"):
            if frames is not RETAINED:  # every lane's crops of the chunk in one call
                self.crop([frames[f0:]] * self.N, [k] * self.N, origins, self._fills, buf)
                return
            for t in range(self.N):
                self.src.recrop(base, k, origins[t], self.ch, self.cw, self.fill, out=buf[t])
                buf[t, k:] = buf[t, k - 1]

    def acquire(self, remaining, origins, buf, timer):
        if self.native:
            base = self._retained
            k = self.src.advance_retained(min(self.K, remaining))
            if not k:
                return None
            self._retained += k
            self._crop_lanes(RETAINED, k, origins, buf, base, timer)
            return (RETAINED, np.full(self.N, k, np.int64))
        chunk = next(self._it, None)
        if chunk is None or chunk.shape[0] == 0:
            return None
        k = chunk.shape[0]
        self._crop_lanes(chunk, k, origins, buf, 0, timer)
        return (chunk, np.full(self.N, k, np.int64))

    def recrop(self, tokens, valid, origins, rbuf, timer, base, off):
        # the lanes share one stream, so the offset into the retained window
        # is their (equal) in-flight frame count
        self._crop_lanes(tokens, int(valid[0]), origins, rbuf, int(base[0]), timer,
                         f0=int(off[0]))

    def accept(self, tokens, valid, abs_pos, timer, off):
        k = int(valid[0])
        f0 = int(off[0])
        if tokens is RETAINED:
            if self.keep_for_dia:
                with timer.section("diagnose"):
                    for i in range(k):
                        self.dia(self.src.retained_frame(i), abs_pos[:, i])
            self.src.release(k)
            self._retained -= k
        elif tokens is not None:
            if self.keep_for_dia:
                with timer.section("diagnose"):
                    for i in range(k):
                        self.dia(tokens[f0 + i], abs_pos[:, i])
            if f0 + k == tokens.shape[0]:  # the last sub-chunk recycles the array
                self._pf.recycle(tokens)


class PerVideoSource:
    """B videos, one lane each: per-lane end of stream, fill values and
    diagnostics. A lane's delivery is its native decoder's retained ring
    (``nat_retained``, decided for all lanes by the caller) or its own
    prefetcher, cropped here by ``crop`` (:func:`.ops.roi_crop.lane_cropper`),
    every lane's chunk in one call. A lane with no frames in a chunk gets a
    crop of pure fill: its steps are discarded and its chain carry stays put."""

    def __init__(self, sources, *, K, ch, cw, fills, dias, ns, nat_retained, prefetcher_objs,
                 crop=crop_lanes_plain):
        from .diagnose import Dont

        B = len(sources)
        self.sources = sources
        self.B, self.K, self.ch, self.cw = B, K, ch, cw
        self.fills = np.ascontiguousarray(fills, np.uint8)
        self.crop = crop
        self.dias = dias
        self.keeps = [d is not None and not isinstance(d, Dont) for d in dias]
        self.nat_retained = nat_retained
        self.active = [True] * B
        if nat_retained:
            self._left = [n - 1 for n in ns]  # frames still to track per video
            self._retained = [0] * B
            self._pf = None
        else:
            self._pf = prefetcher_objs
            self._its = [iter(p) for p in prefetcher_objs]

    def acquire(self, remaining, origins, buf, timer):
        valid = np.zeros(self.B, np.int64)
        tokens = [None] * self.B
        with timer.section("crop"):
            if not self.nat_retained:
                for b in range(self.B):
                    chunk = next(self._its[b], None) if self.active[b] else None
                    if chunk is None or chunk.shape[0] == 0:
                        self.active[b] = False
                        continue
                    tokens[b] = chunk
                    valid[b] = chunk.shape[0]
                    if valid[b] < self.K:
                        self.active[b] = False
                if valid.sum() == 0:
                    return None
                self.crop(tokens, valid, origins, self.fills, buf)
                return (tokens, valid)
            for b in range(self.B):
                k = 0
                if self.active[b]:
                    base = self._retained[b]
                    want = min(self.K, self._left[b], max(int(remaining), 1))
                    k = self.sources[b].advance_retained(want)
                    if k == 0:
                        self.active[b] = False
                    else:
                        self._retained[b] += k
                        self._left[b] -= k
                        # short of the request means the decoder's end
                        # (a probe short of K by request is not)
                        if k < want or self._left[b] == 0:
                            self.active[b] = False
                        tokens[b] = RETAINED
                        self.sources[b].recrop(base, k, origins[b], self.ch, self.cw,
                                               int(self.fills[b]), out=buf[b])
                if k > 0:
                    valid[b] = k
                    buf[b, k:] = buf[b, k - 1]
                else:
                    buf[b] = self.fills[b]
        if valid.sum() == 0:
            return None
        return (tokens, valid)

    def recrop(self, tokens, valid, origins, rbuf, timer, base, off):
        with timer.section("crop"):
            if not self.nat_retained:
                self.crop([None if t is None else t[int(f0):] for t, f0 in zip(tokens, off)],
                          valid, origins, self.fills, rbuf)
                return
            for b in range(self.B):
                k = int(valid[b])
                if k > 0:
                    # the offset into this lane's retained window is its own
                    # in-flight frame count
                    self.sources[b].recrop(int(base[b]), k, origins[b], self.ch, self.cw,
                                           int(self.fills[b]), out=rbuf[b])
                    rbuf[b, k:] = rbuf[b, k - 1]
                else:
                    rbuf[b] = self.fills[b]

    def accept(self, tokens, valid, abs_pos, timer, off):
        for b in range(self.B):
            k = int(valid[b])
            f0 = int(off[b])
            if k > 0:
                if tokens[b] is RETAINED:
                    if self.keeps[b]:
                        with timer.section("diagnose"):
                            for i in range(k):
                                self.dias[b](self.sources[b].retained_frame(i), abs_pos[b, i])
                    self.sources[b].release(k)
                    self._retained[b] -= k
                else:
                    with timer.section("diagnose"):
                        for i in range(k):
                            self.dias[b](tokens[b][f0 + i], abs_pos[b, i])
            if (tokens[b] is not None and tokens[b] is not RETAINED
                    and f0 + k == tokens[b].shape[0]):
                self._pf[b].recycle(tokens[b])


#: converged auto depth per (lanes, K, crop, frame, mode) geometry and
#: process, with the replay-learned soft cap: a later run of the same geometry
#: starts where the last one settled instead of ramping from 1. Positions are
#: the same at every depth, so this is only a warm start.
_AUTO_DEPTH_MEMO: dict = {}


class _Pending:
    """One in-flight (or rewind-queued) chunk: the engine handle and what is
    needed to validate, accept or re-dispatch it.

    ``exact``: dispatched from the rewind queue with nothing in flight, so
    aimed from the exact last accepted position (the replay's progress
    candidate). ``blind``: aimed before any velocity estimate existed (the
    run-start probe), so the error-gated depth controller does not learn from
    its miss. ``off [L]``: this entry's frame offset within its ``tokens``
    (non-zero only for the second half of a split). ``seq``: the pipeline's
    dispatch count when it was dispatched (the spans' ``seq``)."""

    __slots__ = ("handle", "origins", "valid", "tokens", "buf", "exact", "off", "blind", "seq")

    def __init__(self, handle, origins, valid, tokens, buf, exact=False, off=None, blind=False,
                 seq=0):
        self.handle = handle
        self.origins = origins
        self.valid = valid
        self.tokens = tokens
        self.buf = buf
        self.exact = exact
        self.off = np.zeros(len(valid), np.int64) if off is None else off
        self.blind = blind
        self.seq = seq


class SpeculativePipeline:
    """The speculative ROI pipeline, generic over ``L >= 1`` lanes (targets
    or videos).

    A lane *source* fills rotating ``[L, K, ch, cw]`` crop buffers (and can
    re-crop retained frames exactly for a replay); a lane *engine* owns the
    chain on the device and the scans; a *sink* takes the accepted absolute
    positions. The controller aims the crops from the velocity (a
    coordinated-turn prediction), keeps the pending chunks, drains them
    behind the device (deepening the pipeline in ``depth="auto"`` when a drain
    blocks longer than :data:`AUTO_DRAIN_BLOCK_S`), checks each lane's
    windows against its crops, and on a miss replays the chunk and all after
    it through the rewind queue (reference hot-loop drift bound:
    src/PawsomeTracker.jl:55-62)."""

    #: accepted chunks without a replay before the soft depth cap relaxes by one
    CLEAN_RELAX_CHUNKS = 16

    #: per-axis clamp (px/frame^2) of the quadratic aim term: secant noise on
    #: erratic motion must not swing the aim through the horizon squared
    ACCEL_CLAMP = 0.25

    #: turn-rate clamp (rad/frame) of the coordinated-turn aim (a full turn in
    #: ~63 frames); faster apparent turning is secant noise
    OMEGA_CLAMP = 0.1

    def __init__(self, *, L, K, crop_shape, margin, spec, mode, depth, engine, source, sink,
                 timer, auto_cap=None):
        self.L, self.K = L, K
        self.ch, self.cw = crop_shape
        self.margin = np.asarray(margin)
        self.H, self.W = spec.frame_shape
        # containment half-extent: window radii + kernel apron of the full
        # spec (the windows the equivalent full-frame scan would read)
        self.rh = np.array(spec.radii) + spec.kernel_len // 2
        self.frame_max = np.array([self.H - 1, self.W - 1])
        self.mode = mode
        self.auto_depth = depth == "auto"
        if self.auto_depth:
            # the frontend's cap already holds the ring budget; without one
            # the memory cap applies here
            self.depth_max = (auto_cap if auto_cap is not None
                              else auto_depth_cap(spec.frame_shape, K))
        else:
            self.depth_max = depth
        self._memo_key = (L, K, crop_shape, spec.frame_shape, mode)
        if self.auto_depth:
            memo_depth, memo_cap = _AUTO_DEPTH_MEMO.get(self._memo_key, (1, AUTO_DEPTH_MAX))
            self.depth_cur = min(memo_depth, self.depth_max)
        else:
            self.depth_cur = depth
            memo_cap = AUTO_DEPTH_MAX
        self.engine = engine
        self.source = source
        self.sink = sink
        self.timer = timer
        #: chunk dispatches and replays of this pipeline (the run's launches)
        self.dispatches = 0
        self.replays = 0
        # rotating crop buffers: a buffer goes back to the pool only once its
        # chunk is drained or re-dispatched; the cap bounds the growth from
        # buffers allocated when the pool runs dry
        self._pool_max = self.depth_max + 2
        self._free = [self._new_buffer() for _ in range(self._pool_max)]
        self._pending: deque = deque()  # of _Pending
        self._rewind: deque = deque()  # replayed entries awaiting re-dispatch
        # eager drain (PAWS_EAGER_DRAIN=0 disables): take results the moment
        # they are ready instead of always ``depth`` chunks behind, so the aim
        # is as fresh as the real latency allows; the positions are the same
        self._ready = (getattr(engine, "ready", None)
                       if os.environ.get("PAWS_EAGER_DRAIN", "1") != "0" else None)
        # replay hysteresis (see _replay): a soft ceiling just below the depth
        # that last mispredicted, relaxed after sustained clean chunks, warm
        # started from the memo
        self._depth_soft_cap = min(self.depth_max, memo_cap)
        self._clean_since_replay = 0
        # relaxing the soft cap re-probes a horizon that may replay: only
        # after a drain blocked at the cap, and at a price that doubles with
        # each failed exploration
        self._cap_wanted = False
        self._relax_need = self.CLEAN_RELAX_CHUNKS
        # per-axis prediction-error budget: the slack part of the margin
        self._slack = np.maximum(np.asarray(self.margin) - self.rh, 1)

    # -- buffers ------------------------------------------------------------
    def _new_buffer(self):
        alloc = getattr(self.engine, "alloc", None)
        shape = (self.L, self.K, self.ch, self.cw)
        return np.empty(shape, np.uint8) if alloc is None else alloc(shape)

    def _take_buffer(self):
        """A crop buffer from the pool (a new one when it is dry), once the
        engine says it may be refilled."""
        buf = self._free.pop() if self._free else self._new_buffer()
        claim = getattr(self.engine, "claim", None)
        if claim is not None:
            claim(buf)
        return buf

    def _give_buffer(self, buf):
        if buf is not None and len(self._free) < self._pool_max:
            self._free.append(buf)

    # -- aiming -------------------------------------------------------------
    def _aim(self):
        """Per-lane per-frame crop origins ``[L, K, 2]``: frame ``i`` of the
        next chunk is cropped at the predicted position of its own window
        centre (the previous frame's position, horizon ``staleness + i``), so
        the margin never has to cover in-chunk motion."""
        if self.mode == "predict":
            # per-lane staleness: frames in flight ahead of the newest drained position
            stale = np.zeros(self.L, np.int64)
            for ent in self._pending:
                stale += ent.valid
            h = (stale[:, None] + np.arange(self.K)[None, :]).astype(np.float64)
            h = h[..., None]  # [L, K, 1]
            # the chunk secant estimates the velocity at the chunk's midpoint:
            # advance it to P's own frame with the measured curvature
            vel = self.vel + self.accel * self._vel_lag[:, None]
            # coordinated turn: rotate the velocity at the turn rate
            # w = (v x a)/|v|^2 and integrate (exact on circular arcs); the
            # acceleration's parallel part keeps its quadratic term, and the
            # model decays to the quadratic one as w -> 0
            v2 = np.sum(vel * vel, axis=-1)  # [L]
            cross = vel[:, 0] * self.accel[:, 1] - vel[:, 1] * self.accel[:, 0]
            omega = np.where(v2 > 1e-6, cross / np.maximum(v2, 1e-9), 0.0)
            omega = np.clip(omega, -self.OMEGA_CLAMP, self.OMEGA_CLAMP)[:, None, None]
            vdota = np.sum(vel * self.accel, axis=-1)
            a_par = np.where(v2 > 1e-6, vdota / np.maximum(v2, 1e-9), 0.0)[:, None] * vel
            th = omega * h  # [L, K, 1]
            # the integral of R(ws) v over [0, h], with the small-w limits
            # (sin(th)/w -> h, (1 - cos(th))/w -> w h^2 / 2)
            small = np.abs(th) < 1e-4
            with np.errstate(divide="ignore", invalid="ignore"):
                s_w = np.where(small, h, np.sin(th) / np.where(small, 1.0, omega))
                c_w = np.where(small, 0.5 * omega * h * h,
                               (1.0 - np.cos(th)) / np.where(small, 1.0, omega))
            vi = vel[:, None, 0:1]
            vj = vel[:, None, 1:2]
            # rotation convention: a = w z x v maps v = (i, j) to (-w j, +w i)
            turn = np.concatenate([s_w * vi - c_w * vj, c_w * vi + s_w * vj], axis=-1)
            pred = self.P[:, None, :] + turn + 0.5 * a_par[:, None, :] * h * h
            return np.round(pred).astype(np.int64) - self.margin
        return np.broadcast_to((self.P - self.margin)[:, None, :], (self.L, self.K, 2))

    # -- validation ---------------------------------------------------------
    def _contained(self, pos_np, origins, valid):
        """Every window each lane's scan read lies inside its frame's crop
        (reads past the true frame edge hit the same fill in the crop scan and
        in a full-frame scan). Frame ``i``'s window is centred at the previous
        position (``P`` for frame 0) and checked against ``origins[lane, i]``;
        keeping the check per window is what makes a 1-frame rewind chunk at
        the exact ``P - margin`` origin always pass."""
        for lane in range(self.L):
            k = int(valid[lane])
            if k == 0:
                continue
            abs_ = pos_np[lane, :k].astype(np.int64) + origins[lane, :k]
            seq = np.concatenate([self.P[lane][None].astype(np.int64), abs_[: k - 1]])
            o = origins[lane, :k]
            if not ((np.maximum(seq - self.rh, 0) >= o).all()
                    and (np.minimum(seq + self.rh, self.frame_max)
                         <= o + [self.ch - 1, self.cw - 1]).all()):
                return False
        return True

    # -- accept / replay / drain -------------------------------------------
    def _accept(self, pos_np, off_np, ent):
        origins, valid = ent.origins, ent.valid
        abs_pos = pos_np.astype(np.int64) + origins  # [L, K, 2]
        self.sink(abs_pos, valid, off_np)
        self.source.accept(ent.tokens, valid, abs_pos, self.timer, ent.off)
        for lane in range(self.L):
            k = int(valid[lane])
            if k > 1:
                self._vel_ready = True
                new_vel = (abs_pos[lane, k - 1] - abs_pos[lane, 0]) / (k - 1)
                if self._last_k[lane] > 1:
                    # curvature from consecutive chunk secants (midpoints
                    # ~(k_prev + k)/2 frames apart), clamped
                    gap = 0.5 * (self._last_k[lane] + k)
                    self.accel[lane] = np.clip((new_vel - self.vel[lane]) / gap,
                                               -self.ACCEL_CLAMP, self.ACCEL_CLAMP)
                self.vel[lane] = new_vel
                self._last_k[lane] = k
                self._vel_lag[lane] = 0.5 * (k - 1)  # secant midpoint lag
            if k > 0:
                self.P[lane] = abs_pos[lane, k - 1]
        self.tracked += valid
        if self.auto_depth and self.mode == "predict" and not ent.blind:
            self._update_depth_from_error(abs_pos, origins, valid)
        self._give_buffer(ent.buf)

    def _update_depth_from_error(self, abs_pos, origins, valid):
        """Error-aware depth control: each accepted chunk shows how far the
        aim missed, so the controller stops deepening before the error
        reaches the margin. A miss over 80% of the slack backs the pipeline
        off a step and holds the cap there; over 45% holds; clean chunks earn
        one cap step per ``_relax_need`` once a blocked drain asked for more."""
        worst = 0.0
        for lane in range(self.L):
            k = int(valid[lane])
            if k == 0:
                continue
            pred_center = origins[lane, :k] + self.margin
            err = np.abs(abs_pos[lane, :k] - pred_center) / self._slack
            worst = max(worst, float(err.max()))
        if worst > 0.8:
            self._depth_soft_cap = max(1, min(self._depth_soft_cap, self.depth_cur - 1))
            self.depth_cur = min(self.depth_cur, self._depth_soft_cap)
            self._clean_since_replay = 0
        elif worst > 0.45:
            self._clean_since_replay = 0
        elif self._depth_soft_cap < self.depth_max and self._cap_wanted:
            self._clean_since_replay += 1
            if self._clean_since_replay >= self._relax_need:
                self._clean_since_replay = 0
                self._cap_wanted = False
                self._depth_soft_cap += 1

    def _replay(self, entries):
        """Mispredict: put every undrained entry (oldest first) at the front
        of the rewind queue; the main loop re-dispatches them through the
        pipeline, re-cropped from retained frames at a fresh aim. The first
        re-dispatches with nothing in flight, so its frame 0 is cropped at
        exactly ``P - margin`` and its window is contained; a later frame that
        still escapes splits the chunk (:meth:`_split_exact`) down to the
        always-contained single frame, so every replay makes progress."""
        global replay_count
        replay_count += 1
        self.replays += 1
        if self.auto_depth:
            # hysteresis: hold the re-ramp below the depth that mispredicted;
            # a replay at the cap (a failed exploration) doubles the price of
            # the next one; halve the depth rather than reset it to 1
            if self.depth_cur >= self._depth_soft_cap:
                self._relax_need = min(self._relax_need * 2, 8 * self.CLEAN_RELAX_CHUNKS)
            self._depth_soft_cap = max(1, self.depth_cur - 1)
            self._clean_since_replay = 0
            self.depth_cur = max(1, self.depth_cur // 2)
        # the curvature estimate failed: zero it and the secant history, so
        # two fresh chunks establish a new pair
        self.accel[:] = 0.0
        self._last_k[:] = 0
        self.engine.reset()  # the chain on the device past this point is invalid
        # prepend: the queue may still hold later chunks of the same cascade,
        # and frames must be re-dispatched in order
        self._rewind.extendleft(reversed(entries))

    def _split_exact(self, ent):
        """An exact-origin rewind chunk still escaped its crops: halve it
        (the first half keeps the buffer). Its frame 0 is contained by
        construction, so halving ends at an accepted 1-frame chunk."""
        k = int(ent.valid.max())
        if k <= 1:
            # impossible by construction: fail loudly rather than replay forever
            raise RuntimeError("1-frame exact rewind chunk failed containment")
        j = max(1, k // 2)
        v1 = np.minimum(ent.valid, j)
        v2 = ent.valid - v1
        first = _Pending(None, ent.origins, v1, ent.tokens, ent.buf, off=ent.off, seq=ent.seq)
        if v2.max() <= 0:
            return [first]
        return [first, _Pending(None, ent.origins, v2, ent.tokens, None, off=ent.off + v1,
                                seq=ent.seq)]

    def _dispatch_rewind(self):
        """Re-dispatch the oldest replayed chunk. Its frames are not the
        oldest retained while earlier re-dispatched chunks are in flight, so
        the source gets their frame counts as the ``base`` offset."""
        ent = self._rewind.popleft()
        exact = not self._pending  # frame 0's aim degenerates to P - margin
        seq = self.dispatches
        with self.timer.span("dispatch", seq=seq, replay=True):
            with self.timer.section("aim"):
                origins = self._aim()
            base = np.zeros(self.L, np.int64)
            for p in self._pending:
                base += p.valid
            buf = self._take_buffer()
            self.source.recrop(ent.tokens, ent.valid, origins, buf, self.timer, base, ent.off)
            handle = self.engine.dispatch(buf, origins, self.P, ent.valid)
        self.dispatches += 1
        self._pending.append(_Pending(handle, origins, ent.valid, ent.tokens, buf, exact=exact,
                                      off=ent.off, seq=seq))
        self._give_buffer(ent.buf)

    def _drain_one(self):
        entry = self._pending.popleft()
        with self.timer.span("drain", seq=entry.seq):
            with self.timer.section("drain"):
                t0 = time.perf_counter()
                pos_np, off_np = self.engine.to_host(entry.handle)
                blocked = time.perf_counter() - t0
            if self.auto_depth and blocked > AUTO_DRAIN_BLOCK_S:
                if self.depth_cur < min(self.depth_max, self._depth_soft_cap):
                    # the lagged drain still blocked: add a chunk of slack (up to
                    # the replay-learned soft cap)
                    self.depth_cur += 1
                elif self._depth_soft_cap < self.depth_max:
                    # blocked at the ceiling: the soft cap may be explored; never
                    # in the same event as deepening
                    self._cap_wanted = True
            if self.mode == "predict" and not self._contained(pos_np, entry.origins, entry.valid):
                head = self._split_exact(entry) if entry.exact else [entry]
                rest = list(self._pending)
                self._pending.clear()
                with self.timer.span("replay", seq=entry.seq):
                    self._replay(head + rest)
                return
            with self.timer.span("accept"):
                self._accept(pos_np, off_np, entry)

    # -- main loop ----------------------------------------------------------
    def run(self, pos0_abs, n_rest: int):
        """Track up to ``n_rest`` frames per lane from absolute start
        positions ``pos0_abs [L, 2]``. Returns per-lane tracked counts."""
        self.P = np.asarray(pos0_abs, np.int64).reshape(self.L, 2).copy()
        self.vel = np.zeros((self.L, 2))
        self.accel = np.zeros((self.L, 2))
        self._last_k = np.zeros(self.L, np.int64)
        self._vel_lag = np.zeros(self.L)
        self._vel_ready = False
        self.tracked = np.zeros(self.L, np.int64)
        self.engine.reset()
        try:
            remaining = n_rest
            eof = False
            while True:
                # evidence-proportional horizon (auto depth only; a pinned
                # depth is honoured): no velocity yet means a standing-still
                # guess (drain the probe at once), and a velocity measured
                # over N frames says little about 5N frames out
                if self.mode != "predict" or not self.auto_depth:
                    depth_eff = self.depth_cur
                elif not self._vel_ready:
                    depth_eff = 0
                else:
                    evidence = int(self.tracked.max()) // max(self.K, 1)
                    depth_eff = min(self.depth_cur, max(1, evidence))
                while len(self._pending) > depth_eff:
                    self._drain_one()
                if self._ready is not None:
                    # finished results cost nothing to take and freshen the
                    # aim; a replay clears _pending, which ends this loop
                    while self._pending and self._ready(self._pending[0].handle):
                        self._drain_one()
                if self._rewind:
                    # replayed chunks re-enter ahead of fresh frames, in order
                    self._dispatch_rewind()
                    continue
                if remaining <= 0 or eof:
                    if self._pending:
                        # one at a time: a containment failure refills the
                        # rewind queue, which the next iteration re-dispatches
                        self._drain_one()
                        continue
                    break
                seq = self.dispatches
                with self.timer.span("dispatch", seq=seq, replay=False):
                    with self.timer.section("aim"):
                        origins = self._aim()
                    buf = self._take_buffer()
                    take = remaining
                    if self.mode == "predict" and not self._vel_ready:
                        # no velocity yet: a short probe chunk learns it (the scan
                        # runs all K rows; the extra ones are discarded)
                        take = min(remaining, max(2, self.K // 4))
                    got = self.source.acquire(take, origins, buf, self.timer)
                    if got is None:
                        self._free.append(buf)
                        eof = True
                        continue
                    tokens, valid = got
                    handle = self.engine.dispatch(buf, origins, self.P, valid)
                self.dispatches += 1
                self._pending.append(_Pending(handle, origins, valid, tokens, buf,
                                              blind=not self._vel_ready, seq=seq))
                remaining -= int(valid.max())
            if self.auto_depth:
                # recorded on a clean finish only
                _AUTO_DEPTH_MEMO[self._memo_key] = (self.depth_cur, self._depth_soft_cap)
        finally:
            close = getattr(self.engine, "close", None)
            if close is not None:
                close()
        return self.tracked

    def report(self, stats: dict) -> None:
        """Add the run's crop shape, K, mode, final depth, its dispatch and
        replay counts, and its chunk launches (``groups``, each one launch a
        data shard) to ``stats``."""
        stats.update(crop=(self.ch, self.cw), K=self.K, mode=self.mode, depth=self.depth_cur,
                     dispatches=self.dispatches, replays=self.replays,
                     groups=getattr(self.engine, "groups", self.dispatches))


def run_roi_pipeline(
    src,
    spec,
    pos0_abs,
    fill: int,
    n_rest: int,
    *,
    roi_frames: int,
    depth,
    engine: str,
    subpixel: bool,
    dia,
    timer,
    native_roi: bool,
    prefetchers: list,
    device,
    speculate: str = "predict",
    progress=None,
    auto_cap: int | None = None,
    stats: dict | None = None,
):
    """Track ``n_rest`` frames of ``src`` by speculative ROI streaming (one
    video, one target: :class:`SpeculativePipeline` with L = 1 over
    :class:`_SingleEngine`). ``engine``: ``"auto"`` scans with the kernel
    :func:`pick_bounded_engine` chooses for the crop on the card (the plain
    version on the CPU), ``"pallas"`` with the shape rule's kernel (the plain
    version on the CPU), ``"xla"`` with the plain version.

    Returns ``(position blocks, offset blocks, frames tracked)``, each
    position block an absolute int ``[k, 2]``. ``prefetchers`` collects any
    prefetcher made here, so the caller joins it before closing ``src``.
    ``stats``, when given, receives the crop shape, K, the depth the run
    ended at, and its dispatch and replay counts.

    ``depth="auto"`` starts at 1 (or where the last run of this geometry
    settled) and deepens while the lagged drain blocks; a replay backs it
    off. Positions are the same at every depth."""
    K = roi_frames
    if depth == "auto":
        depth_max = auto_depth_cap(spec.frame_shape, K)
        if auto_cap is not None:
            depth_max = min(depth_max, auto_cap)
    else:
        depth_max = depth
    mode = speculate if depth_max > 0 else "contain"
    ch, cw, margin = roi_geometry(spec, K, depth_max, mode)
    roi_spec = make_spec((ch, cw), spec.window_size, spec.target_width, spec.darker_target)
    kernel = None
    if engine == "auto":
        # the measured choice, kept per card and geometry; also a parity pin
        # of the kernels against the plain version on this card
        engine, info = pick_bounded_engine(roi_spec, K, fill, subpixel=subpixel, device=device)
        kernel = info.get("kernel")
    fns = tracker_fns(roi_spec, device, engine, kernel=kernel)

    positions: list[np.ndarray] = []
    offsets: list[np.ndarray] = []
    done = 0

    def sink(abs_pos, valid, off_np):
        nonlocal done
        k = int(valid[0])
        positions.append(abs_pos[0, :k])
        if off_np is not None:
            offsets.append(off_np[0, :k])
        done += k
        if progress is not None:
            progress(done, n_rest)

    with timer.span("pipeline", stream="roi"):
        with timer.section("buffers"):  # the controller, its pinned crop buffers
            pipe = SpeculativePipeline(
                L=1, K=K, crop_shape=(ch, cw), margin=margin, spec=spec, mode=mode, depth=depth,
                auto_cap=depth_max if depth == "auto" else None,
                engine=_SingleEngine(fns.scan_sub if subpixel else fns.scan_bounded, (ch, cw),
                                     spec.frame_shape, fill, subpixel, timer, device,
                                     segments=functools.partial(fns.scan_bounded_super,
                                                                subpixel=subpixel)),
                source=SingleVideoSource(src, K=K, ch=ch, cw=cw, fill=fill, dia=dia, mode=mode,
                                         native_roi=native_roi, depth=depth_max, n_rest=n_rest,
                                         prefetchers=prefetchers, crop=lane_cropper(device),
                                         timer=timer),
                sink=sink,
                timer=timer,
            )
        tracked = pipe.run(np.asarray(pos0_abs).reshape(1, 2), n_rest)
    if stats is not None:
        pipe.report(stats)
    return positions, offsets, int(tracked[0])


def run_multi_roi_pipeline(
    src,
    spec,
    pos0_abs,
    fill: int,
    n_rest: int,
    *,
    roi_frames: int,
    depth,
    timer,
    prefetchers: list,
    device,
    engine: str = "auto",
    subpixel: bool = False,
    dia=None,
    progress=None,
    auto_cap: int | None = None,
    stats: dict | None = None,
):
    """Track N targets in one stream by speculative ROI streaming
    (:class:`SpeculativePipeline` with L = N over :class:`_BatchedEngine` and
    :class:`FanoutSource`): each decoded frame gives N crops, aimed per
    target and scanned in one batched bounded launch a chunk, validated and
    replayed as for one target. With the native decoder the crops are cut in
    C++ from its retained ring. ``engine`` as in :func:`run_roi_pipeline`;
    ``stats`` as there.

    Returns ``(position blocks, offset blocks, frames tracked)``, each
    position block an absolute int ``[k, N, 2]`` (offsets ``[k, N, 2]``, an
    empty list unless ``subpixel``)."""
    K = roi_frames
    if depth == "auto":
        depth_max = auto_depth_cap(spec.frame_shape, K)
        if auto_cap is not None:
            depth_max = min(depth_max, auto_cap)
    else:
        depth_max = depth
    mode = "predict" if depth_max > 0 else "contain"
    ch, cw, margin = roi_geometry(spec, K, depth_max, mode)
    roi_spec = make_spec((ch, cw), spec.window_size, spec.target_width, spec.darker_target)
    N = int(np.asarray(pos0_abs).shape[0])
    tracker = ShardedBatchTracker(roi_spec, None, engine, device=device)
    scan, segments = _select_batched_bounded(tracker, roi_spec, K, N, fill, engine,
                                             subpixel=subpixel)

    positions: list[np.ndarray] = []
    offsets: list[np.ndarray] = []
    done = 0

    def sink(abs_pos, valid, off_np):
        nonlocal done
        k = int(valid[0])  # one stream: every lane has the chunk's length
        positions.append(np.transpose(abs_pos[:, :k], (1, 0, 2)))
        if off_np is not None:
            offsets.append(np.transpose(off_np[:, :k], (1, 0, 2)))
        done += k
        if progress is not None:
            progress(done, n_rest)

    with timer.span("pipeline", stream="roi"):
        with timer.section("buffers"):  # the controller, its pinned crop buffers
            pipe = SpeculativePipeline(
                L=N, K=K, crop_shape=(ch, cw), margin=margin, spec=spec, mode=mode, depth=depth,
                auto_cap=depth_max if depth == "auto" else None,
                engine=_BatchedEngine(scan, (ch, cw), spec.frame_shape,
                                      np.full(N, fill, np.uint8), subpixel, timer, device,
                                      segments=segments),
                source=FanoutSource(src, N=N, K=K, ch=ch, cw=cw, fill=fill, mode=mode,
                                    depth=depth_max, n_rest=n_rest, prefetchers=prefetchers,
                                    dia=dia, crop=lane_cropper(device), timer=timer),
                sink=sink,
                timer=timer,
            )
        tracked = pipe.run(np.asarray(pos0_abs, np.int64), n_rest)
    if stats is not None:
        pipe.report(stats)
    return positions, offsets, int(tracked[0])
