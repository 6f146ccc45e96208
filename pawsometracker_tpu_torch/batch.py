"""Batched multi-video tracking on one card.

``track_batch(files, ...)`` has the signature, defaults and outputs of the
JAX package's ``track_batch`` (``pawsometracker_tpu/batch.py``), plus a
keyword-only ``device``. Every file is an independent video. The per-video
scan is sequential but independent across videos, so B videos run in one
launch of the CUDA kernel per chunk, one thread-block cluster per video.

Streaming is the JAX package's: ``stream="auto"`` sends only drift-bounded
crops of each video to the card when a crop is under half the frame (1080p,
but not small test clips), through the speculative ROI pipeline with one
lane per video (:class:`..pipeline.PerVideoSource`,
:class:`..pipeline._BatchedEngine`); ``"roi"`` forces it and ``"full"``
streams whole frames, decoded on one prefetch thread per video and staged
into the rows of one pinned ``[B, T, H, W]`` slot
(:func:`..pipeline.run_batch_pipeline`). The positions are the same either
way. ``mesh`` shards the videos over a device mesh
(:func:`..parallel.mesh.make_mesh`), one launch per data shard on its device,
as the JAX package shards them over its chips; ``mesh="auto"`` builds such a
mesh over the local cards whenever there are several.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .api import (
    DEFAULT_CHUNK_SIZE,
    DEFAULT_MAX_DURATION_SECONDS,
    IJ,
    _auto_ring_gate,
    _check_choice,
    _check_stream,
    _resolve_guess,
    _resolve_roi_frames,
    _views_available,
    grid_prefix,
)
from .diagnose import Diagnose, Dont
from .io.decode import ChunkPrefetcher, open_source, view_origin
from .models.dog_tracker import full_frame_sub_scan, make_spec, resolve_device
from .ops.dog_kernel import fix_window_size, guess_window_size
from .ops.filters import mode_u8_host
from .ops.roi_crop import lane_cropper
from .parallel.mesh import Mesh, Sharded, ShardedBatchTracker, make_mesh, mesh_device
from .pipeline import (
    AUTO_DEPTH_MAX,
    PerVideoSource,
    SpeculativePipeline,
    _BatchedEngine,
    _select_batched_bounded,
    _select_sharded_bounded,
    auto_depth_cap,
    roi_geometry,
    run_batch_pipeline,
    staging_ring,
)
from .utils.profiling import Timer

__all__ = ["track_batch"]

logger = logging.getLogger(__name__)


def _broadcast(x, n, default):
    if x is None:
        return [default] * n
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError(f"expected {n} entries, got {len(x)}")
        return [default if v is None else v for v in x]
    return [x] * n


def _call_device(mesh, device) -> torch.device:
    """The device of a call: with a :class:`~.parallel.mesh.Mesh`, ``device``
    if it is one of the mesh's (``None``: the mesh's first), else raises
    ``ValueError``; with ``None`` or ``"auto"``, ``device`` as
    :func:`~.models.dog_tracker.resolve_device` gives it. Any other ``mesh``
    raises ``TypeError``."""
    if isinstance(mesh, Mesh):
        return mesh_device(mesh, device)
    if mesh is None or (isinstance(mesh, str) and mesh == "auto"):
        return resolve_device(device)
    raise TypeError(f"mesh must be a Mesh (see make_mesh), 'auto' or None, got {mesh!r}")


def _resolve_mesh(mesh, B: int, device: torch.device):
    """Resolve ``mesh="auto"`` for a bucket of ``B`` videos (the JAX
    package's rule, ``pawsometracker_tpu/batch.py:39-58``): a pure
    data-parallel mesh over the most local cards whose count divides ``B``
    (sharding the leading batch axis needs exact divisibility). One device
    (``device`` on the CPU counts as one), or no usable divisor, means
    single-device execution (None), which is always correct; results are
    identical either way."""
    if not (isinstance(mesh, str) and mesh == "auto"):
        return mesh
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    n = min(n, B)
    while n > 1 and B % n:
        n -= 1
    if n < 2:
        return None
    return make_mesh(n)


def _per_lane(mask, a, b):
    """Per lane, ``a`` where ``mask`` (a host bool array) is true, else
    ``b``: tensors on one device, or :class:`~.parallel.mesh.Sharded` shard by
    shard on each shard's device."""
    if isinstance(a, Sharded):
        sl = a.sharding.lanes(len(mask))
        return Sharded([_per_lane(mask[s], x, y) for s, x, y in zip(sl, a.shards, b.shards)],
                       a.sharding)
    return torch.where(torch.as_tensor(mask, device=a.device)[:, None], a, b)


def _is_single_location(x):
    """True for one start_location value (IJ or numeric (x, y)), as opposed to
    a per-file list of locations."""
    if x is None or isinstance(x, IJ):
        return True
    return (
        isinstance(x, tuple)
        and len(x) == 2
        and all(isinstance(v, (int, float, np.integer, np.floating)) for v in x)
    )


def track_batch(
    files,
    *,
    start=None,
    stop=None,
    target_width=25,
    start_location=None,
    window_size=None,
    darker_target=True,
    fps: float = 24,
    sar: float | None = None,
    mesh=None,
    backend: str = "auto",
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    stream: str = "auto",
    roi_frames: int | None = None,
    pipeline_depth: int | str = "auto",
    diagnostic_files=None,
    engine: str = "auto",
    subpixel: bool = False,
    decode_workers: int | None = None,
    fast_decode: bool | None = None,
    progress=None,
    input_fps: float | None = None,
    device=None,
):
    """Track one target in each of ``files`` concurrently on the card.

    Entries of ``files`` may be in-memory uint8 frame arrays ``[T, H, W]`` /
    ``[T, H, W, 3]`` (see :func:`.api.track`), mixed freely with paths;
    ``input_fps`` states the arrays' native rate (default: already at
    ``fps``).

    Unlike ``track(list)`` (consecutive segments of ONE recording), every
    file here is an independent video. Videos may have DIFFERENT resolutions,
    and ``target_width`` / ``window_size`` / ``darker_target`` may be
    per-file lists: the batch is bucketed by tracker configuration (one
    batched launch per chunk and bucket) and results are returned in input
    order, each identical to a per-video :func:`.api.track` call.
    ``start``/``stop``/``start_location`` may be scalars (broadcast) or
    per-file lists; ``start_location`` entries follow the same kinds as
    :func:`.api.track` (None / IJ / (x, y)).

    ``mesh``: a :class:`~.parallel.mesh.Mesh` (:func:`~.parallel.mesh.make_mesh`)
    to shard the batch over its devices (the batch of each bucket must divide
    its data axis), or ``"auto"`` to build a data-parallel mesh over the local
    cards whenever more than one is present (each bucket uses the most cards
    whose count divides its batch; None = one device).
    ``diagnostic_files``: optional per-file overlay video paths (None entries
    disable). ``subpixel=True`` returns
    float positions (integer recurrence + parabolic response-peak refinement,
    exactly like :func:`.api.track`). ``engine``, ``stream``, ``roi_frames``
    and ``pipeline_depth`` are as in :func:`.api.track`. ``progress`` is an
    optional ``callback(frames_done, frames_expected)`` over the whole batch.
    ``device`` (keyword-only): ``None`` is the CUDA card and raises when there
    is none; ``"cpu"`` runs the plain PyTorch version on the host. With a
    mesh, ``None`` means the mesh's devices, and any other device must be one
    of them.

    Returns a list of ``(ts, positions)``.
    """
    _check_choice("backend", backend, ("auto", "native", "opencv"))
    _check_choice("engine", engine, ("auto", "pallas", "xla"))
    _check_stream(stream, roi_frames)
    dev = _call_device(mesh, device)
    files = list(files)
    B = len(files)
    if B == 0:
        return []
    tws = _broadcast(target_width, B, 25)
    wss = _broadcast(window_size, B, None) if isinstance(window_size, (list,)) else [window_size] * B
    darks = _broadcast(darker_target, B, True) if isinstance(darker_target, (list,)) else [darker_target] * B
    starts_in = _broadcast(start, B, None)
    stops_in = _broadcast(stop, B, None)
    locs_in = (
        [start_location] * B
        if _is_single_location(start_location)
        else _broadcast(start_location, B, None)
    )
    dias_in = _broadcast(diagnostic_files, B, None) if diagnostic_files else [None] * B

    # bucket by tracker configuration (+ resolution, probed cheaply): one
    # batched scan per bucket
    from .io.decode import probe as _probe

    keys, infos = [], []
    for f, tw, ws, dk in zip(files, tws, wss, darks):
        info = _probe(f)
        infos.append(info)
        keys.append((info.frame_shape, float(tw), None if ws is None else tuple(np.atleast_1d(ws)), bool(dk)))
    buckets: dict = {}
    for i, k in enumerate(keys):
        buckets.setdefault(k, []).append(i)

    bucket_cb = None
    if progress is not None:
        # aggregate across the whole batch: expected total from per-file
        # durations, capped by container frame counts on open-ended stops
        est_total = 0
        for i in range(B):
            t0 = 0.0 if starts_in[i] is None else float(starts_in[i])
            t1 = DEFAULT_MAX_DURATION_SECONDS if stops_in[i] is None else float(stops_in[i])
            ni = max(int(np.round(fps * (t1 - t0))) - 1, 0)
            fc, nf = infos[i].frame_count, infos[i].fps
            if t1 >= DEFAULT_MAX_DURATION_SECONDS and fc and nf:
                ni = min(ni, max(int(np.round(fc * fps / nf)) - 1, 1))
            est_total += ni
        done_base = {"n": 0}

        def bucket_cb(done_in_bucket):
            progress(done_base["n"] + done_in_bucket, est_total)

    results: list = [None] * B
    for k, idxs in buckets.items():
        sub = _track_batch_uniform(
            [files[i] for i in idxs],
            infos=[infos[i] for i in idxs],
            start=[starts_in[i] for i in idxs],
            stop=[stops_in[i] for i in idxs],
            target_width=tws[idxs[0]],
            start_location=[locs_in[i] for i in idxs],
            window_size=wss[idxs[0]],
            darker_target=darks[idxs[0]],
            fps=fps,
            sar=sar,
            mesh=mesh,
            backend=backend,
            chunk_size=chunk_size,
            stream=stream,
            roi_frames=roi_frames,
            pipeline_depth=pipeline_depth,
            diagnostic_files=[dias_in[i] for i in idxs],
            engine=engine,
            subpixel=subpixel,
            decode_workers=decode_workers,
            fast_decode=fast_decode,
            progress=bucket_cb,
            input_fps=input_fps,
            device=dev,
        )
        for i, r in zip(idxs, sub):
            results[i] = r
        if bucket_cb is not None:
            done_base["n"] += sum(max(len(ij) - 1, 0) for _, ij in sub)
    return results


def _track_batch_uniform(
    files,
    *,
    infos,
    start,
    stop,
    target_width: float,
    start_location,
    window_size,
    darker_target: bool,
    fps: float,
    sar: float | None,
    mesh,
    backend: str,
    chunk_size: int,
    stream: str,
    roi_frames: int | None,
    pipeline_depth: int | str,
    diagnostic_files,
    engine: str,
    subpixel: bool,
    decode_workers: int | None,
    fast_decode: bool | None,
    progress,
    input_fps: float | None,
    device: torch.device,
):
    """One-bucket core of :func:`track_batch`: all videos share a resolution
    and tracker configuration (``infos`` are the videos' probes, and
    ``start``, ``stop``, ``start_location`` and ``diagnostic_files`` are
    per-video lists)."""
    B = len(files)
    timer = Timer(entry="track_batch", videos=B)
    mesh = _resolve_mesh(mesh, B, device)
    tracker_engine = engine
    if mesh is not None:
        # the work goes to the mesh's devices (track_batch checked an explicit
        # one against the mesh; "auto" spans every card). The kernel is the
        # engine of "auto" and "pallas" alike; the mesh tracker refuses
        # "pallas" (as the JAX package's does), and the ROI path selects its
        # sharded engine by the caller's choice below
        device = None
        tracker_engine = "xla" if engine == "xla" else "auto"
    starts = [0.0 if s is None else float(s) for s in start]
    stops = [DEFAULT_MAX_DURATION_SECONDS if s is None else float(s) for s in stop]
    if window_size is None:
        window_size = guess_window_size(target_width)
    window_size = fix_window_size(window_size)

    auto_depth = pipeline_depth == "auto"
    depth_gate = AUTO_DEPTH_MAX if auto_depth else max(0, int(pipeline_depth))
    mode = "predict" if depth_gate > 0 else "contain"
    roi_frames = _resolve_roi_frames(roi_frames, depth_gate, "predict")
    # the retained native path is gated once: the ring is sized here, and
    # each source's capability is checked once it is open. Overlays ride the
    # ring too (views of retained frames), where the native layer serves them
    retention_possible = (
        stream != "full" and mode == "predict"
        and (all(p is None for p in diagnostic_files) or _views_available()))
    if auto_depth:
        # each video opens its own ring, so the budget is shared by the B
        # lanes; the shapes come from the caller's probes (no second read)
        depth_gate = min(
            (_auto_ring_gate(f, roi_frames, depth_gate, lanes=B, info=i,
                             zero_copy=view_origin(f, start=t0, fps=fps,
                                                   input_fps=input_fps) is not None)
             for f, i, t0 in zip(files, infos, starts)),
            default=depth_gate)
    ring = (depth_gate + 2) * roi_frames + 8 if retention_possible else None

    sources, prefetchers, dias = [], [], []
    try:
        with timer.section("setup"):
            for f, t0, t1 in zip(files, starts, stops):
                sources.append(
                    open_source(f, start=t0, stop=t1, fps=fps, backend=backend, prefetch=ring,
                                workers=decode_workers, input_fps=input_fps,
                                fast_decode=fast_decode)
                )

            shapes = {s.info.frame_shape for s in sources}
            if len(shapes) != 1:
                raise ValueError(f"all videos in a batch must share one resolution, got {shapes}")
            frame_shape = shapes.pop()

            ns = [int(np.round(fps * (t1 - t0))) for t0, t1 in zip(starts, stops)]
            frames0 = []
            with timer.span("frame1"):
                for f, s in zip(files, sources):
                    fr = s.read()
                    if fr is None:
                        raise EOFError(f"no frames decoded from {f}")
                    frames0.append(fr)
                frames0 = np.stack(frames0)
            fills = np.empty(B, np.uint8)
            for b, f in enumerate(frames0):
                with timer.span("mode", lane=b):
                    fills[b] = mode_u8_host(f)

            spec = make_spec(frame_shape, window_size, target_width, darker_target)
            tracker = ShardedBatchTracker(spec, mesh, tracker_engine, device=device, timer=timer)

            guesses = np.array(
                [
                    _resolve_guess(loc, sar if sar is not None else s.info.sar, frame_shape)
                    for loc, s in zip(start_location, sources)
                ],
                np.int32,
            )
            auto = np.array([loc is None for loc in start_location])

        with timer.section("snap"):
            f0 = tracker.shard_chunk(frames0)
            fills_dev = tracker.shard_chunk(fills)
            g_dev = tracker.shard_chunk(guesses)
            # where any lane auto-detects, every lane snaps both ways and each
            # takes its own (the JAX package's rule)
            if subpixel:
                pos, off = tracker.snap_sub(f0, g_dev, fills_dev)
                if auto.any():
                    pos_det, off_det = tracker.snap_detect_sub(f0, g_dev, fills_dev)
                    pos = _per_lane(auto, pos_det, pos)
                    off = _per_lane(auto, off_det, off)
                with timer.span("snap.wait"):
                    off0 = off.cpu().numpy()
            else:
                pos = tracker.snap(f0, g_dev, fills_dev)
                if auto.any():
                    pos = _per_lane(auto, tracker.snap_detect(f0, g_dev, fills_dev), pos)
                off0 = np.zeros((B, 2), np.float32)
            with timer.span("snap.wait"):
                pos_host = pos.cpu().numpy()

        with timer.section("setup"):
            for p, fr0 in zip(diagnostic_files, frames0):
                d = Dont() if p is None else Diagnose(p, darker_target, fps)
                d.update_ratio(fr0.shape)
                dias.append(d)

        # ROI streaming, as the JAX package decides it: only drift-bounded
        # crops of each video go to the card, B lanes of one launch a chunk,
        # through the speculative pipeline (see .pipeline)
        ch, cw, margin = roi_geometry(spec, roi_frames, depth_gate, mode)
        use_roi = stream == "roi" or (
            stream == "auto" and ch * cw * 2 < frame_shape[0] * frame_shape[1])
        # on the native retained ring every source crops (and replays) in C++,
        # so full frames never enter Python for the whole batch
        nat_retained = use_roi and retention_possible and all(
            hasattr(s, "read_roi_chunk_retained")
            and getattr(s, "ring_frames", 0) >= (depth_gate + 2) * roi_frames
            and (p is None or getattr(s, "can_view_retained", False))
            for s, p in zip(sources, diagnostic_files))
        if use_roi:
            chunk_size = roi_frames
        if not nat_retained:
            # full frames land in each video's staging ring (pinned on the card)
            prefetchers = [ChunkPrefetcher(s, chunk_size, max_frames=n - 1,
                                           ring=None if use_roi else staging_ring(tracker.device),
                                           timer=timer, lane=b)
                           for b, (s, n) in enumerate(zip(sources, ns))]
        stats = {"stream": "roi" if use_roi else "full",
                 "shards": 1 if mesh is None else mesh.shape["data"]}
        if use_roi:
            counts = np.zeros(B, np.int64)
            pos_blocks = [[] for _ in range(B)]
            off_blocks = [[] for _ in range(B)]

            def sink(abs_pos, valid, off_np):
                for b in range(B):
                    k = int(valid[b])
                    if k > 0:
                        pos_blocks[b].append(abs_pos[b, :k])
                        if off_np is not None:
                            off_blocks[b].append(off_np[b, :k])
                        counts[b] += k
                if progress is not None:
                    progress(int(counts.sum()))

            roi_spec = make_spec((ch, cw), window_size, target_width, darker_target)
            roi_engine = ShardedBatchTracker(roi_spec, mesh, tracker_engine, device=device)
            auto_cap = None
            if auto_depth:
                # the ring gate, bounded again by the decoded size (an input
                # that could not be probed kept the gate); view-serving arrays
                # retain no copies, so there is nothing to bound
                auto_cap = depth_gate
                if not all(getattr(s, "serves_views", False) for s in sources):
                    auto_cap = min(depth_gate, auto_depth_cap(frame_shape, roi_frames, lanes=B))
            segments = None  # a ShardedFn scan brings its own
            if mesh is None:  # the measured choice on the card
                scan, segments = _select_batched_bounded(roi_engine, roi_spec, roi_frames, B,
                                                         int(fills[0]), engine,
                                                         subpixel=subpixel)
            else:  # one kernel launch a shard where the batch divides the data axis, the
                # kernel measured at the shard's batch
                scan = _select_sharded_bounded(roi_engine, roi_spec, roi_frames, B,
                                               int(fills[0]), engine, mesh, subpixel=subpixel)
            with timer.span("pipeline", stream="roi"):
                with timer.section("buffers"):  # the controller, its pinned crop buffers
                    pipe = SpeculativePipeline(
                        L=B, K=roi_frames, crop_shape=(ch, cw), margin=margin, spec=spec,
                        mode=mode, depth="auto" if auto_depth else depth_gate, auto_cap=auto_cap,
                        engine=_BatchedEngine(scan, (ch, cw), frame_shape, fills, subpixel, timer,
                                              device, segments=segments),
                        source=PerVideoSource(sources, K=roi_frames, ch=ch, cw=cw, fills=fills,
                                              dias=dias, ns=ns, nat_retained=nat_retained,
                                              prefetcher_objs=prefetchers,
                                              crop=lane_cropper(device)),
                        sink=sink,
                        timer=timer,
                    )
                pipe.run(pos_host.astype(np.int64), max(ns) - 1)
            pipe.report(stats)
            counts = counts.tolist()
        else:
            if pipeline_depth == "auto":
                # full-frame chunks are memory-heavy: at most 3 deep, bounded
                # by the ring budget shared by the B lanes
                depth = min(3, auto_depth_cap(frame_shape, chunk_size, lanes=B))
            else:
                depth = max(0, int(pipeline_depth))
            scan = tracker.scan
            if subpixel and mesh is None:
                scan = full_frame_sub_scan(tracker.scan_sub, frame_shape, tracker.device)
            elif subpixel:
                scan = tracker.scan_sub.map(
                    lambda fn, dev: full_frame_sub_scan(fn, frame_shape, dev))
            pos_blocks, off_blocks, counts = run_batch_pipeline(
                prefetchers, pos, fills_dev, chunk_size=chunk_size, depth=depth, scan=scan,
                subpixel=subpixel, dias=dias, timer=timer, device=tracker.device,
                progress=progress,
            )
        stats["sections"] = dict(timer.totals)
    finally:
        for p in prefetchers:
            p.close()  # join decode threads BEFORE destroying the sources
        for s in sources:
            s.close()
        for d in dias:
            d.close()
    timer.finish(stats)
    # the record carries the numbers as ``paws_stats`` for a handler
    logger.debug("track_batch B=%d: %d frames on %s, %s", B, sum(counts) + B,
                 tracker.device, stats, extra={"paws_stats": stats})

    out = []
    sz = np.array(frame_shape) - 1
    for b in range(B):
        n_b = 1 + counts[b]
        ts = grid_prefix(starts[b], stops[b], ns[b], n_b)
        ij = np.concatenate([pos_host[b].reshape(1, 2)] + pos_blocks[b], axis=0)[:n_b]
        if subpixel:
            off = np.concatenate([off0[b].reshape(1, 2)] + off_blocks[b], axis=0)[:n_b]
            ij = np.clip(ij.astype(np.float64) + off, 0, sz)
        out.append((ts, ij))
    return out
