"""Multi-target tracking: N independent DoG trackers over ONE frame stream.

``track_multi(file, ...)`` has the signature, defaults and outputs of the JAX
package's ``track_multi`` (``pawsometracker_tpu/multi.py``), plus a
keyword-only ``device``. The frame is decoded once per step and each chunk
runs as one launch of the CUDA kernel with one lane per target (on full
frames all lanes read the same frames, on ROI each its own crops); so
tracking N targets costs one decode plus N window correlations on N SMs.
Targets share the tracker configuration (target_width, window_size,
polarity).

Limitation (inherent to the matched-filter design): the trackers carry no
identity model: if two targets' search windows overlap on the same blob,
both will lock onto it.

Streaming is the JAX package's: ``stream="auto"`` sends N drift-bounded
crops a frame (one per target) to the card when together they are under half
the frame, through the speculative ROI pipeline with one lane per target
(:func:`..pipeline.run_multi_roi_pipeline`, one batched bounded launch a
chunk); ``"roi"`` forces it and ``"full"`` streams whole frames. The
positions are the same either way.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .api import (
    DEFAULT_MAX_DURATION_SECONDS,
    _auto_ring_gate,
    _check_choice,
    _check_stream,
    _resolve_guess,
    _resolve_roi_frames,
    _views_available,
    grid_prefix,
)
from .diagnose import Diagnose, Dont
from .io.decode import open_source
from .models.dog_tracker import make_spec, resolve_device, tracker_fns
from .ops import detect_kernel
from .ops.dog_kernel import fix_window_size, guess_window_size
from .ops.filters import mode_u8_host
from .parallel.mesh import global_detect_peaks
from .pipeline import (
    AUTO_DEPTH_MAX,
    auto_depth_cap,
    roi_geometry,
    run_full_pipeline,
    run_multi_roi_pipeline,
)
from .utils.profiling import Timer

__all__ = ["track_multi"]

logger = logging.getLogger(__name__)


def takes_roi(stream: str, n_targets: int, spec, roi_frames: int, depth_gate: int) -> bool:
    """Whether ``n_targets`` lanes take the ROI pipeline: ``stream="roi"``, or
    ``"auto"`` where their crops (:func:`.pipeline.roi_geometry` at the gate's
    depth, predict mode unless the gate is 0) come to under half the frame, the
    JAX package's rule."""
    mode = "predict" if depth_gate > 0 else "contain"
    ch, cw, _ = roi_geometry(spec, roi_frames, depth_gate, mode)
    H, W = spec.frame_shape
    return stream == "roi" or (stream == "auto" and n_targets * ch * cw * 2 < H * W)


def track_multi(
    file,
    start_locations=None,
    *,
    n_targets: int | None = None,
    min_distance: int | None = None,
    start: float = 0.0,
    stop: float | None = None,
    target_width: float = 25,
    window_size=None,
    darker_target: bool = True,
    fps: float = 24,
    sar: float | None = None,
    backend: str = "auto",
    chunk_size: int = 16,
    stream: str = "auto",
    roi_frames: int | None = None,
    pipeline_depth: int | str = "auto",
    engine: str = "auto",
    subpixel: bool = False,
    decode_workers: int | None = None,
    fast_decode: bool | None = None,
    diagnostic_file: str | None = None,
    progress=None,
    input_fps: float | None = None,
    device=None,
):
    """Track N targets in one video.

    ``file`` may be an in-memory uint8 frame array ``[T, H, W]`` or
    ``[T, H, W, 3]`` (see :func:`.api.track`); ``input_fps`` states the
    array's native rate (default: already at ``fps``).

    Each entry of ``start_locations`` is an ``IJ`` or display ``(x, y)``.
    Alternatively pass ``start_locations=None`` with ``n_targets=N`` to
    AUTO-DETECT the N strongest DoG-response peaks in frame 1
    (:func:`.parallel.mesh.global_detect_peaks`; ``min_distance`` sets the
    non-maximum-suppression radius, default the search-window extent);
    targets are then ordered strongest-first. Returns ``(ts, positions)``
    with ``positions int [T, N, 2]`` (float with ``subpixel=True``: integer
    recurrence + parabolic response-peak refinement, exactly like
    :func:`.api.track`).

    ``diagnostic_file`` writes ONE shared 640x360 overlay video with N
    markers and one 100-point trail per target (frame 1 sets the scale only,
    frames 2..n are written). ``engine``, ``stream``, ``roi_frames`` and
    ``pipeline_depth`` are as in :func:`.api.track`. ``device``
    (keyword-only): ``None`` is the CUDA card and raises when there is none;
    ``"cpu"`` runs the plain PyTorch version on the host.
    """
    timer = Timer(entry="track_multi", videos=1)
    autodetect = start_locations is None
    if autodetect:
        if not n_targets or int(n_targets) < 1:
            raise ValueError(
                "give start_locations, or n_targets>=1 for multi-target auto-detect"
            )
    else:
        if n_targets is not None or min_distance is not None:
            raise ValueError(
                "n_targets/min_distance configure auto-detection and conflict "
                "with explicit start_locations: pass one or the other"
            )
        if isinstance(start_locations, np.ndarray):
            # a [N, 2] array of (x, y) rows is a natural input; `if not arr`
            # would raise numpy's truth-value ambiguity before any message
            start_locations = [tuple(row) for row in start_locations.tolist()]
        if len(start_locations) == 0:
            raise ValueError("start_locations must name at least one target")
        if any(loc is None for loc in start_locations):
            raise ValueError(
                "every target needs an explicit start location (IJ or (x, y)), "
                "or pass start_locations=None with n_targets=N to auto-detect"
            )
    stop = DEFAULT_MAX_DURATION_SECONDS if stop is None else float(stop)
    _check_choice("backend", backend, ("auto", "native", "opencv"))
    _check_choice("engine", engine, ("auto", "pallas", "xla"))
    _check_stream(stream, roi_frames)
    dev = resolve_device(device)
    if window_size is None:
        window_size = guess_window_size(target_width)
    window_size = fix_window_size(window_size)

    t = stop - start
    n = int(np.round(fps * t))
    if n < 1:
        raise ValueError(f"no frames to track in [{start}, {stop}] at fps={fps}")

    if pipeline_depth == "auto":
        depth_gate = AUTO_DEPTH_MAX
    else:
        pipeline_depth = depth_gate = max(0, int(pipeline_depth))
    roi_frames = _resolve_roi_frames(roi_frames, depth_gate, "predict")
    if pipeline_depth == "auto":
        depth_gate = _auto_ring_gate(file, roi_frames, depth_gate)
    # the fan-out crops each target from the native ring at every depth
    # (contain mode included), so the ring is sized wherever ROI streaming is
    # possible; with a diagnostic file only if the native layer serves views
    # of retained frames (else the source takes the prefetcher, and a large
    # ring would be dead memory)
    ring_ok = stream != "full" and (diagnostic_file is None or _views_available())
    ring = (depth_gate + 2) * roi_frames + 8 if ring_ok else None
    src = open_source(
        file, start=start, stop=stop, fps=fps, backend=backend, prefetch=ring,
        workers=decode_workers, input_fps=input_fps, fast_decode=fast_decode,
    )
    prefetchers: list = []  # joined in finally BEFORE src.close()
    dia = None  # made INSIDE the try, so a failed open leaves no encoder behind; closed last
    try:
        with timer.section("setup"):
            # one shared overlay video, N markers/trails per frame
            dia = (Dont() if diagnostic_file is None
                   else Diagnose(diagnostic_file, darker_target, fps))
            sar_val = float(sar) if sar is not None else src.info.sar
            with timer.span("frame1"):
                frame0 = src.read()
            if frame0 is None:
                raise EOFError(f"no frames decoded from {file}")
            frame_shape = frame0.shape
            dia.update_ratio(frame_shape)  # frame 1 sets the scale only
        if progress is not None:
            est = n - 1
            fc = getattr(src.info, "frame_count", 0) or 0
            nf = getattr(src.info, "fps", 0) or 0
            if stop >= DEFAULT_MAX_DURATION_SECONDS and fc and nf:
                est = min(est, max(int(np.round(fc * fps / nf)) - 1, 1))
            user_cb, est_total = progress, est

            def progress(done, _t, _cb=user_cb, _est=est_total):
                _cb(done, _est)

        with timer.section("setup"):
            with timer.span("mode", lane=0):
                fill = mode_u8_host(frame0)
            spec = make_spec(frame_shape, window_size, target_width, darker_target)
            fns = tracker_fns(spec, dev, engine)
            # a C-ordered copy: frame 1 may be a read-only view, or strided
            frame0_dev = torch.from_numpy(np.array(frame0, order="C")).to(dev)

        with timer.section("snap"):
            if autodetect:
                # the whole detection as the caller waits on it: the response's and
                # the rounds' launches, then the wait for the peaks on the host
                launched = detect_kernel.launches
                with timer.span("detect", targets=int(n_targets)):
                    peaks = global_detect_peaks(spec, int(n_targets), min_distance)
                    guesses = peaks(frame0_dev, fill, timer=timer).cpu().numpy()
                launched = detect_kernel.launches - launched
                # exhausted suppression repeats the last peak: reject instead of
                # seeding duplicate trackers pinned to the same blob
                if len({tuple(g) for g in guesses}) < len(guesses):
                    raise ValueError(
                        f"auto-detect found fewer than n_targets={n_targets} "
                        "separable peaks (frame too small for min_distance, or "
                        "fewer targets present): lower n_targets/min_distance "
                        "or pass explicit start_locations"
                    )
            else:
                guesses = np.array(
                    [_resolve_guess(loc, sar_val, frame_shape) for loc in start_locations],
                    np.int32,
                )
            if subpixel:
                pos, off0 = fns.snap_multi_sub(frame0_dev, guesses, fill)
                offs = [off0.cpu().numpy()[None]]
            else:
                pos = fns.snap_multi(frame0_dev, guesses, fill)
                offs = []

        with timer.span("snap.wait"):
            out = [pos.cpu().numpy()[None]]
        last_frame = 1
        # ROI streaming where the JAX package takes it: N crops a frame under
        # half the frame
        N = guesses.shape[0]
        use_roi = takes_roi(stream, N, spec, roi_frames, depth_gate)
        counts = {"multi.lanes": N}
        if autodetect:
            counts["detect.rounds"] = int(n_targets)
            counts["detect.kernel_launches"] = launched
        stats = {"stream": "roi" if use_roi else "full", "counts": counts}
        if n > 1 and use_roi:
            pos_blocks, off_blocks, tracked = run_multi_roi_pipeline(
                src,
                spec,
                out[0][0],
                fill,
                n - 1,
                roi_frames=roi_frames,
                depth=pipeline_depth,
                timer=timer,
                prefetchers=prefetchers,
                device=dev,
                engine=engine,
                subpixel=subpixel,
                dia=dia,
                progress=progress,
                auto_cap=depth_gate if pipeline_depth == "auto" else None,
                stats=stats,
            )
            out.extend(pos_blocks)
            offs.extend(off_blocks)
            last_frame += tracked
        elif n > 1:
            pos_blocks, off_blocks, tracked = run_full_pipeline(
                src,
                pos,
                fill,
                n - 1,
                chunk_size=chunk_size,
                depth=min(3, auto_depth_cap(frame_shape, chunk_size))
                if pipeline_depth == "auto" else max(0, int(pipeline_depth)),
                scan=fns.scan_multi_sub if subpixel else fns.scan_multi,
                subpixel=subpixel,
                dia=dia,
                timer=timer,
                prefetchers=prefetchers,
                device=dev,
                progress=progress,
            )
            out.extend(pos_blocks)
            offs.extend(off_blocks)
            last_frame += tracked
        stats["sections"] = dict(timer.totals)
    finally:
        for p in prefetchers:
            p.close()
        src.close()
        if dia is not None:
            dia.close()
    timer.finish(stats)
    # the record carries the numbers as ``paws_stats`` for a handler
    logger.debug("track_multi %s: N=%d, %d frames on %s, %s", file, N, last_frame, dev,
                 stats, extra={"paws_stats": stats})

    positions = np.concatenate(out, axis=0)
    ts = grid_prefix(start, stop, n, last_frame)
    if subpixel:
        off_all = np.concatenate(offs, axis=0)
        sz = np.array(frame_shape) - 1
        return ts, np.clip(
            positions[:last_frame].astype(np.float64) + off_all[:last_frame], 0, sz
        )
    return ts, positions[:last_frame]
