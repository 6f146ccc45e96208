"""Public tracking API of the PyTorch port.

``track(file | files, ...)`` has the signature, defaults and outputs of the
JAX package's ``track`` (reference: src/PawsomeTracker.jl:109-214), plus a
keyword-only ``device``: the card by default (``track`` raises when there is
none), or ``device="cpu"`` for the plain PyTorch version on the host.

Coordinate conventions (0-based everywhere; ``julia = python + 1``):

- ``start_location=None``: auto-detect in a quarter-frame window centered on
  the frame (reference: src/PawsomeTracker.jl:99-107).
- ``start_location=IJ(i, j)``: raw frame index (row i, col j).
- ``start_location=(x, y)``: *display* pixel coordinates from the left-top
  corner; x is divided by the sample aspect ratio to get the raw column.

Returns ``(ts, positions)``: ``ts`` float64 seconds, ``positions`` int
``[N, 2]`` of (row, col) (float with ``subpixel=True``).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .diagnose import Dont, diagnose
from .io.decode import open_source, view_origin
from .models.dog_tracker import (
    autodetect_spec,
    center_guess,
    full_frame_sub_scan,
    make_spec,
    resolve_device,
    tracker_fns,
)
from .ops.dog_kernel import fix_window_size, guess_window_size
from .ops.filters import mode_u8_host
from .pipeline import (
    AUTO_DEPTH_MAX,
    auto_depth_cap,
    roi_geometry,
    run_full_pipeline,
    run_roi_pipeline,
)
from .utils.profiling import Timer

logger = logging.getLogger("pawsometracker_tpu_torch")

#: 24 hours minus 1 millisecond (reference: src/PawsomeTracker.jl:19)
DEFAULT_MAX_DURATION_SECONDS = 86399.999

#: frames per device scan call; the host decodes the next chunk while the
#: device tracks the current one
DEFAULT_CHUNK_SIZE = 64

#: frames per ROI chunk; None = auto: 12 in predict mode, 8 in contain mode
#: (shrinking with the depth to hold the crop size), see _resolve_roi_frames
DEFAULT_ROI_FRAMES = None

#: chunks the host may run ahead of the device; "auto" adapts at run time
#: from the measured drain latency (ROI) or takes the ring budget's cap (full
#: frames), with the same positions at every depth
DEFAULT_PIPELINE_DEPTH = "auto"

__all__ = ["track", "IJ", "DEFAULT_MAX_DURATION_SECONDS"]


def grid_prefix(start: float, stop: float, n: int, k: int) -> np.ndarray:
    """The first ``k`` entries of ``np.linspace(start, stop, n)``, bit for
    bit, without computing the other ``n - k``: a call tracks its frames on
    the grid of its whole ``[start, stop]`` range (24 hours by default) and
    keeps only the tracked prefix. The rule is numpy's own: entry i is
    ``i * step + start`` with ``step = (stop - start) / (n - 1)`` (0 for
    n = 1), and the last of n > 1 entries is ``stop`` itself. Past n
    (``k > n``) the same rule goes on, as ``track_resumable``'s grid has it.
    A step that underflows to zero, which numpy computes another way, takes
    ``np.linspace``."""
    step = (stop - start) / (n - 1) if n > 1 else 0.0
    if step == 0 and n > 1:
        return np.linspace(start, stop, n)[:k]
    ts = np.arange(k, dtype=np.float64) * step + start
    if k == n > 1:
        ts[-1] = stop
    return ts


class IJ(NamedTuple):
    """A raw (row, col) frame index, 0-based: the ``CartesianIndex`` analog."""

    i: int
    j: int


def _check_choice(name: str, value, allowed: tuple) -> None:
    """Enum-like kwargs fail loudly on typos."""
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


def _check_stream(stream: str, roi_frames) -> None:
    """The streaming choices of ``track``, ``track_batch`` and ``track_multi``:
    ``"auto"`` (ROI when the crops are under half the frame, the same rule as
    the JAX package's), ``"roi"`` and ``"full"``; and a positive
    ``roi_frames`` or ``None``."""
    _check_choice("stream", stream, ("auto", "roi", "full"))
    if roi_frames is not None and int(roi_frames) < 1:
        raise ValueError(f"roi_frames must be None or a positive frame count, got {roi_frames!r}")


def _resolve_guess(start_location, sar: float, frame_shape) -> tuple[int, int]:
    """Start-location resolution (reference: src/PawsomeTracker.jl:74-90)."""
    if start_location is None:
        return center_guess(frame_shape)
    if isinstance(start_location, IJ):
        return (int(start_location.i), int(start_location.j))
    if isinstance(start_location, np.ndarray) and start_location.shape == (2,):
        start_location = tuple(start_location.tolist())  # (x, y) like a tuple
    if isinstance(start_location, Sequence) and len(start_location) == 2:
        x, y = start_location
        # x is in display pixels; divide by SAR to get the raw column.
        # np.round matches Julia's round-half-even.
        return (int(np.round(y)), int(np.round(x / sar)))
    raise TypeError(f"invalid start_location: {start_location!r}")


def _initial_position(frame0: np.ndarray, guess, auto: bool, spec, fill: int,
                      subpixel: bool = False, *, device, engine: str = "auto", timer):
    """Snap onto the target in frame 1. Even with a user-provided location the
    tracker runs one step, so ``positions[0]`` is the *detected* position near
    the given location (reference: src/PawsomeTracker.jl:92-107).
    Returns ``(pos int32 [2], offsets float32 [2])`` as numpy arrays; the
    wait for them is ``timer``'s span ``snap.wait``."""
    # a C-ordered copy: frame 1 may be a read-only view, or strided
    frame = torch.from_numpy(np.array(frame0, order="C")).to(device)
    g = np.asarray(guess, np.int32)
    fns = tracker_fns(autodetect_spec(spec) if auto else spec, device, engine)
    if subpixel:
        pos, off = fns.snap_sub(frame, g, fill)
        with timer.span("snap.wait"):
            return pos.cpu().numpy(), off.cpu().numpy()
    pos = fns.snap(frame, g, fill)
    with timer.span("snap.wait"):
        return pos.cpu().numpy(), np.zeros(2, np.float32)


def _scan_fn_for(spec, engine: str, device, subpixel: bool = False):
    """The chunk scan: the CUDA kernel on the card for ``"auto"`` and
    ``"pallas"`` (the plain version on the CPU), the plain PyTorch scan for
    ``"xla"``. With ``subpixel``, the bounded subpixel scan over the whole
    frame. No fallback: a kernel that cannot run raises."""
    fns = tracker_fns(spec, device, engine)
    return full_frame_sub_scan(fns.scan_sub, spec.frame_shape, device) if subpixel else fns.scan


def _views_available() -> bool:
    """True when the port's native layer serves zero-copy views of retained
    frames (``pawsio_retained_ptr``), which the diagnostics-on retained-ring
    path needs; probed before the open, so that a library without them never
    gets a retention-sized ring it cannot use."""
    from .io.native_io import _load

    try:
        return hasattr(_load(), "pawsio_retained_ptr")
    except (OSError, AttributeError):  # a library that does not load
        return False


def _auto_ring_gate(file, roi_frames: int, depth_gate: int, lanes: int = 1, info=None,
                    zero_copy: bool = False) -> int:
    """Memory-aware depth gate for ``pipeline_depth="auto"`` ring sizing: when
    the frame size is known before the open (array input, the caller's probe
    ``info``, or a native header probe), clamp the gate so that the retained
    decode rings ((gate+2)*K frames each, one per lane of ``lanes`` videos)
    keep to ``PAWS_RING_BUDGET_MB``, the bound :func:`.pipeline.auto_depth_cap`
    puts on the depth at run time. An input that cannot be probed keeps the
    gate. ``info``: a :class:`~.io.decode.VideoInfo` the caller has already
    probed (``track_batch`` probes each input once), so the file is not read
    again. ``zero_copy``: the input is an array whose chunks are served as
    views (no ring), so nothing is bounded."""
    if zero_copy:
        return depth_gate
    shape = None
    if info is not None:
        if info.height > 0 and info.width > 0:
            shape = (int(info.height), int(info.width))
    elif hasattr(file, "shape") and getattr(file, "ndim", 0) >= 3:
        shape = (int(file.shape[1]), int(file.shape[2]))
    else:
        from .io.native_io import native_probe

        try:
            probed = native_probe(file)
            if probed.height > 0 and probed.width > 0:
                shape = (int(probed.height), int(probed.width))
        except (OSError, RuntimeError, AttributeError):  # no native layer, or unreadable
            shape = None
    if shape is None:
        return depth_gate
    return min(depth_gate, auto_depth_cap(shape, roi_frames, lanes=lanes))


def _resolve_roi_frames(roi_frames, pipeline_depth: int, speculate: str = "predict") -> int:
    """The ROI chunk length K. ``depth == 0`` runs contain geometry whatever
    ``speculate`` says (as the pipeline derives its mode), so callers pass
    their raw arguments. Predict-mode crops grow with neither depth nor K, so
    a longer chunk spreads the host's work per chunk: 12. In contain mode K
    goes straight into the crop's size: 8, shrinking with the depth to hold
    the crop size."""
    if roi_frames is not None:
        return int(roi_frames)
    if speculate == "predict" and int(pipeline_depth) > 0:
        return 12
    return max(1, 8 // (int(pipeline_depth) + 1))


def _track_one(
    file,
    start: float,
    stop: float,
    target_width: float,
    start_location,
    window_size: tuple[int, int],
    darker_target: bool,
    fps: float,
    dia,
    *,
    device: torch.device,
    sar: float | None = None,
    backend: str = "auto",
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    engine: str = "auto",
    stream: str = "auto",
    roi_frames: int | None = DEFAULT_ROI_FRAMES,
    pipeline_depth: int | str = DEFAULT_PIPELINE_DEPTH,
    speculate: str = "predict",
    subpixel: bool = False,
    decode_workers: int | None = None,
    fast_decode: bool | None = None,
    progress=None,
    input_fps: float | None = None,
):
    """Track one file (reference pipeline: src/PawsomeTracker.jl:148-174),
    streaming crops or full frames."""
    timer = Timer(entry="track", videos=1)
    t = stop - start
    # length-based timestamp range: step = t/(n-1), slightly != 1/fps by design
    # (reference: src/PawsomeTracker.jl:149-152)
    n = int(np.round(fps * t))
    if n < 1:
        raise ValueError(f"no frames to track in [{start}, {stop}] at fps={fps}")

    if pipeline_depth == "auto" and speculate == "contain":
        # contain-mode crops grow with the depth: "auto" stays at depth 1
        pipeline_depth = 1
    if pipeline_depth == "auto":
        depth_gate = AUTO_DEPTH_MAX
    else:
        pipeline_depth = depth_gate = max(0, int(pipeline_depth))
    roi_frames = _resolve_roi_frames(roi_frames, depth_gate, speculate)
    # size the native decode ring so the ROI pipeline can retain its chunks
    # in flight for a replay: only where that path can run (ROI possible,
    # predict mode, and with a diagnostic file a library serving views)
    retention_possible = (
        stream != "full" and depth_gate > 0 and speculate == "predict"
        and (isinstance(dia, Dont) or _views_available())
    )
    # an array whose chunks are served as views (from its start's frame on)
    zero_copy_input = view_origin(file, start=start, fps=fps, input_fps=input_fps) is not None
    if pipeline_depth == "auto" and stream != "full":
        depth_gate = _auto_ring_gate(file, roi_frames, depth_gate, zero_copy=zero_copy_input)
    ring = (depth_gate + 2) * roi_frames + 8 if retention_possible else None
    src = open_source(
        file, start=start, stop=stop, fps=fps, backend=backend, prefetch=ring,
        workers=decode_workers, input_fps=input_fps, fast_decode=fast_decode,
    )
    prefetchers: list = []  # joined in finally BEFORE src.close()
    try:
        sar_val = src.info.sar if sar is None else float(sar)

        if progress is not None:
            # with the open-ended default stop, n is the 24-hour bound:
            # estimate the expected total from the container frame count
            est = n - 1
            fc = getattr(src.info, "frame_count", 0) or 0
            nf = getattr(src.info, "fps", 0) or 0
            if stop >= DEFAULT_MAX_DURATION_SECONDS and fc and nf:
                est = min(est, max(int(round(fc * fps / nf)) - 1, 1))
            user_cb, est_total = progress, est

            def progress(done, _t, _cb=user_cb, _est=est_total):
                _cb(done, _est)

        with timer.section("setup"):
            with timer.span("frame1"):
                frame0 = src.read()
            if frame0 is None:
                raise EOFError(f"no frames decoded from {file}")
            frame_shape = frame0.shape
            dia.update_ratio(frame_shape)
            with timer.span("mode", lane=0):
                fill = mode_u8_host(frame0)  # mode of FIRST frame, used for all frames
            spec = make_spec(frame_shape, window_size, target_width, darker_target)
            guess = _resolve_guess(start_location, sar_val, frame_shape)
        with timer.section("snap"):
            pos, off0 = _initial_position(frame0, guess, start_location is None, spec, fill,
                                          subpixel, device=device, engine=engine, timer=timer)

        positions = [np.asarray(pos)]
        offsets = [off0.reshape(1, 2)]
        last_frame = 1

        # ROI streaming for large frames: only a crop around the predicted
        # position goes to the card per frame, and the positions equal the
        # full-frame path's (the pipeline checks every window the scan read)
        mode = speculate if depth_gate > 0 else "contain"
        ch, cw, _ = roi_geometry(spec, roi_frames, depth_gate, mode)
        use_roi = stream == "roi" or (
            stream == "auto" and ch * cw * 2 < frame_shape[0] * frame_shape[1])

        stats = {"stream": "roi" if use_roi else "full"}
        if n > 1 and use_roi:
            # with the native decoder the crops are cut in C++ from its ring,
            # so full frames never enter Python; with diagnostics that needs
            # views of retained frames too
            native_roi = hasattr(src, "read_roi_chunk") and (
                isinstance(dia, Dont) or getattr(src, "can_view_retained", False))
            pos_blocks, off_blocks, tracked = run_roi_pipeline(
                src,
                spec,
                np.asarray(pos),
                fill,
                n - 1,
                roi_frames=roi_frames,
                depth=pipeline_depth,
                engine=engine,
                subpixel=subpixel,
                dia=dia,
                timer=timer,
                native_roi=native_roi,
                prefetchers=prefetchers,
                device=device,
                speculate=speculate,
                progress=progress,
                auto_cap=depth_gate if pipeline_depth == "auto" else None,
                stats=stats,
            )
            positions.extend(pos_blocks)
            offsets.extend(off_blocks)
            last_frame += tracked
        elif n > 1:
            pos_blocks, off_blocks, tracked = run_full_pipeline(
                src,
                np.asarray(pos),
                fill,
                n - 1,
                chunk_size=chunk_size,
                # full-frame chunks are memory-heavy: "auto" keeps this at
                # most 3 deep, bounded by the ring budget (4K drops to 1)
                depth=min(3, auto_depth_cap(frame_shape, chunk_size))
                if pipeline_depth == "auto" else pipeline_depth,
                scan=_scan_fn_for(spec, engine, device, subpixel),
                subpixel=subpixel,
                dia=dia,
                timer=timer,
                prefetchers=prefetchers,
                device=device,
                progress=progress,
                stats=stats,
            )
            positions.extend(pos_blocks)
            offsets.extend(off_blocks)
            last_frame += tracked
        stats["sections"] = dict(timer.totals)
    finally:
        for p in prefetchers:
            p.close()
        src.close()
    timer.finish(stats)
    # the record carries the numbers as ``paws_stats`` for a handler
    logger.debug("track %s: %d frames on %s, %s", file, last_frame, device, stats,
                 extra={"paws_stats": stats})

    ij = np.concatenate([p.reshape(-1, 2) for p in positions], axis=0)
    if subpixel:
        off_all = np.concatenate(offsets, axis=0)
        sz = np.array(frame_shape) - 1
        ij_f = np.clip(ij[:last_frame].astype(np.float64) + off_all[:last_frame], 0, sz)
        return grid_prefix(start, stop, n, last_frame), ij_f
    return grid_prefix(start, stop, n, last_frame), ij[:last_frame]


def track(
    file,
    *,
    start=None,
    stop=None,
    target_width: float = 25,
    start_location=None,
    window_size=None,
    darker_target: bool = True,
    fps: float = 24,
    diagnostic_file: str | None = None,
    sar: float | None = None,
    backend: str = "auto",
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    engine: str = "auto",
    stream: str = "auto",
    roi_frames: int | None = DEFAULT_ROI_FRAMES,
    pipeline_depth: int | str = DEFAULT_PIPELINE_DEPTH,
    speculate: str = "predict",
    subpixel: bool = False,
    decode_workers: int | None = None,
    fast_decode: bool | None = None,
    progress=None,
    input_fps: float | None = None,
    device=None,
):
    """Track a blob-like target in a video ``file`` (or list of segment files).

    ``file`` may also be an in-memory uint8 frame array ``[T, H, W]`` (gray)
    or ``[T, H, W, 3]`` (RGB); ``input_fps`` states the array's native rate
    (default ``None``: the frames are at ``fps`` already). Lists may mix file
    paths and arrays per segment.

    Keyword defaults as in the reference: ``start=0``, ``stop=86399.999``,
    ``target_width=25`` (FWHM of the DoG center Gaussian),
    ``start_location=None`` (auto-detect), ``window_size`` from
    :func:`guess_window_size`, ``darker_target=True``, ``fps=24``,
    ``diagnostic_file=None``.

    Extensions, as in the JAX package: ``sar`` overrides the probed sample
    aspect ratio; ``backend`` picks the decoder (``auto``/``native``/
    ``opencv``); ``chunk_size`` sets the frames per device scan;
    ``subpixel`` adds parabolic peak refinement to the returned (float)
    positions; ``decode_workers`` and ``fast_decode`` tune the native decoder;
    ``progress`` is an optional ``callback(frames_done, frames_expected)``
    called after each chunk of the current file.

    ``engine``: ``"auto"`` and ``"pallas"`` run a hand-written CUDA kernel
    on the card (the plain version on the CPU): ``"pallas"`` the one the
    window's shape picks, ``"auto"`` on the ROI path the one measured fastest
    for the crop on this card and held to the plain version there, once per
    card and geometry (``pipeline.pick_bounded_engine``; a kernel that differs
    raises); ``"xla"`` runs the plain PyTorch scan. ``stream`` forces full-frame or ROI streaming (``"auto"``:
    ROI when the crop is under half the frame, as in the JAX package);
    ``roi_frames``, ``pipeline_depth`` and ``speculate`` tune the speculative
    ROI pipeline (see :mod:`.pipeline`: depth 0 is synchronous, ``"auto"``
    adapts at run time; the positions are the same either way), and
    ``pipeline_depth`` sets how many chunks the host runs ahead of the card
    on full frames too.

    ``device`` (keyword-only): where the tracker runs. ``None`` is the CUDA
    card and raises when there is none; ``"cpu"`` runs the plain PyTorch
    version on the host.

    For a list of ``file``s the per-file ``start``/``stop``/``start_location``
    may be lists of the same length; a ``None`` start_location in segment k>0
    resumes from the previous segment's last position
    (reference: src/PawsomeTracker.jl:203-206).
    """
    _check_choice("speculate", speculate, ("predict", "contain"))
    _check_choice("backend", backend, ("auto", "native", "opencv"))
    _check_choice("engine", engine, ("auto", "pallas", "xla"))
    _check_stream(stream, roi_frames)
    dev = resolve_device(device)
    if window_size is None:
        window_size = guess_window_size(target_width)
    window_size = fix_window_size(window_size)
    kw = dict(
        target_width=target_width, window_size=window_size, darker_target=darker_target,
        fps=fps, sar=sar, backend=backend, chunk_size=chunk_size, engine=engine,
        stream=stream, roi_frames=roi_frames, pipeline_depth=pipeline_depth, speculate=speculate,
        subpixel=subpixel, decode_workers=decode_workers, fast_decode=fast_decode,
        progress=progress, input_fps=input_fps, device=dev,
    )

    if isinstance(file, (list, tuple)) and not isinstance(file, IJ):
        return _track_many(list(file), start=start, stop=stop, start_location=start_location,
                           diagnostic_file=diagnostic_file, **kw)

    start = 0.0 if start is None else float(start)
    stop = DEFAULT_MAX_DURATION_SECONDS if stop is None else float(stop)
    with diagnose(diagnostic_file, darker_target, fps) as dia:
        return _track_one(file, start, stop, start_location=start_location, dia=dia, **kw)


def _track_many(files, *, start, stop, start_location, diagnostic_file, fps, darker_target,
                **kw):
    """Segmented videos: chain each segment's start from the previous
    segment's final position (reference: src/PawsomeTracker.jl:181-214)."""
    nfiles = len(files)
    if start is not None and not isinstance(start, (list, tuple, np.ndarray)):
        start = [start] * nfiles  # scalar broadcast (convenience over reference)
    if stop is not None and not isinstance(stop, (list, tuple, np.ndarray)):
        stop = [stop] * nfiles
    starts = [0.0] * nfiles if start is None else [float(s) for s in start]
    stops = [DEFAULT_MAX_DURATION_SECONDS] * nfiles if stop is None else [float(s) for s in stop]
    if start_location is None:
        locs = [None] * nfiles
    elif isinstance(start_location, IJ) or (
        isinstance(start_location, tuple)
        and len(start_location) == 2
        and all(isinstance(v, (int, float, np.integer, np.floating)) for v in start_location)
    ):
        # one location seeds segment 1; later segments chain from the
        # previous end
        locs = [start_location] + [None] * (nfiles - 1)
    else:
        locs = list(start_location)
    if not (len(starts) == len(stops) == len(locs) == nfiles):
        raise ValueError(
            f"array length mismatch: files={nfiles}, start={len(starts)}, "
            f"stop={len(stops)}, start_location={len(locs)}"
        )

    tss, ijs = [], []
    with diagnose(diagnostic_file, darker_target, fps) as dia:
        end_location = None
        for f, t0, t1, loc in zip(files, starts, stops, locs):
            loc = loc if loc is not None else end_location
            ts_i, ij_i = _track_one(f, t0, t1, start_location=loc, dia=dia, fps=fps,
                                    darker_target=darker_target, **kw)
            tss.append(ts_i)
            ijs.append(ij_i)
            end_location = IJ(int(np.round(ij_i[-1][0])), int(np.round(ij_i[-1][1])))

    # merged timestamps assume all segments share segment 1's step: the
    # reference's uniform-fps convention (src/PawsomeTracker.jl:209-211)
    n = sum(len(t) for t in tss)
    step = (tss[0][1] - tss[0][0]) if len(tss[0]) > 1 else 1.0 / fps
    ts = tss[0][0] + step * np.arange(n)
    ij = np.concatenate(ijs, axis=0)
    return ts, ij
