"""Host-side video decode layer.

Host replacement for the reference's decode stack (an out-of-process
``ffmpeg -ss <start> -i <file> -t <t> -vf fps=<fps> -f matroska -`` pipe decoded
to GRAY8 by libav — reference: src/PawsomeTracker.jl:155-157). Here decode runs
on the host, overlapped with device compute via a background prefetch thread,
and feeds uint8 grayscale frame *chunks* ``[T, H, W]`` to the device scan.

Two backends implement the same semantics:

- :class:`OpenCVFrameSource` — cv2.VideoCapture (FFMPEG backend), pure Python.
- the native C++ libav decoder in ``io/native`` (see :mod:`.native_io`), which
  decodes straight to GRAY8 with swscale like the reference does and skips the
  BGR round-trip.

The fps resampling reproduces ffmpeg's ``fps`` filter (round=near): each input
frame at shifted time ``t`` is assigned output slot ``round(t*fps)`` (half away
from zero); when consecutive input frames map to slots ``n1 < n2`` the first
frame is emitted for every slot in ``[n1, n2)`` (duplication); frames mapping
to an already-filled slot are dropped; the final frame is emitted once at EOF.

Input timestamps: the OpenCV backend uses the frame counter and the
container's nominal rate (exact rational arithmetic) while the stream looks
constant-frame-rate, and switches permanently to the container's per-frame pts
(``CAP_PROP_POS_MSEC``) the first time a frame's pts deviates from the counter
by more than half an input interval (variable-frame-rate content). The native
backend always uses real per-frame pts and is authoritative for VFR: OpenCV's
own demux layer can duplicate/drop frames around irregular timestamps, so the
fallback is best-effort there (tested to agree on resampling *structure*), and
it emits a one-time ``logging`` warning per source when VFR content activates
pts mode, pointing at the native backend.
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
from dataclasses import dataclass
from fractions import Fraction

import numpy as np

from ..utils.profiling import OFF

logger = logging.getLogger(__name__)

# one-time flags: fast_decode on a non-native path warns once per process,
# not once per open (a 100-file batch would otherwise emit 100 copies)
_warned_fast_opencv = False
_warned_fast_array = False

__all__ = [
    "VideoInfo",
    "probe",
    "OpenCVFrameSource",
    "ArrayFrameSource",
    "open_source",
    "ChunkPrefetcher",
    "ChunkRing",
    "fps_slot",
    "view_origin",
]


@dataclass(frozen=True)
class VideoInfo:
    """Container/stream metadata needed by the tracker."""

    width: int
    height: int
    fps: float  # native frame rate
    sar: float  # sample (pixel) aspect ratio; display width = width * sar
    frame_count: int  # container frame count (0 if unknown)

    @property
    def frame_shape(self) -> tuple[int, int]:
        return (self.height, self.width)


def _cv2():
    import cv2

    return cv2


def _info_from_cap(cv2, cap) -> VideoInfo:
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = float(cap.get(cv2.CAP_PROP_FPS)) or 24.0
    num = cap.get(getattr(cv2, "CAP_PROP_SAR_NUM", -1)) if hasattr(cv2, "CAP_PROP_SAR_NUM") else 0
    den = cap.get(getattr(cv2, "CAP_PROP_SAR_DEN", -1)) if hasattr(cv2, "CAP_PROP_SAR_DEN") else 0
    sar = float(Fraction(int(num), int(den))) if num and den else 1.0
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    return VideoInfo(width=width, height=height, fps=fps, sar=sar, frame_count=max(count, 0))


def probe(path) -> VideoInfo:
    """Probe stream geometry + SAR (analog of VideoIO ``aspect_ratio``,
    reference: src/PawsomeTracker.jl:79-84). For an in-memory frame array the
    geometry comes from its shape (``fps=0.0`` — the native rate is the
    caller's ``input_fps``, unknown here; square pixels).

    Prefers the native libavformat header probe when built: it reads the
    container header only (no decoder open, no frame decode), so a B-video
    ``track_batch`` pays one cheap header read per file for bucketing instead
    of a full cv2 demux open per file on top of the decode open."""
    if is_frame_stack(path):
        shape = tuple(path.shape)
        if shape[0] == 0:
            raise ValueError(f"frame array must be [T, H, W](, 3), got shape {shape}")
        return VideoInfo(width=shape[2], height=shape[1], fps=0.0,
                         sar=1.0, frame_count=shape[0])
    try:
        from .native_io import native_available, native_probe

        if native_available():
            info = native_probe(path)
            # frame_count 0 = the container header carries no per-stream
            # count AND the (fresh) native duration estimate failed — or a
            # stale prebuilt .so predates that estimate. Fall through to the
            # cv2 probe, whose computed count the batch progress estimation
            # relies on; every other field is authoritative from libav.
            if info.frame_count > 0:
                return info
    except Exception:
        pass  # fall through to the cv2 probe (native layer unbuildable)
    cv2 = _cv2()
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"could not open video: {path}")
    try:
        return _info_from_cap(cv2, cap)
    finally:
        cap.release()


def fps_slot(t, fps) -> int:
    """ffmpeg fps-filter slot assignment with round=near (half away from zero).

    ``t`` and ``fps`` may be :class:`~fractions.Fraction` for exact arithmetic
    at half-slot boundaries — ffmpeg itself uses integer rational rescaling
    (``av_rescale_q_rnd`` with ``AV_ROUND_NEAR_INF``), and the native backend
    mirrors that; floats are accepted for convenience.
    """
    x = t * fps
    return int(math.floor(x + Fraction(1, 2))) if x >= 0 else -int(math.floor(-x + Fraction(1, 2)))


class _ResamplingSource:
    """Shared ffmpeg-``fps``-filter resampler over a backend ``_next_input``.

    Subclasses provide decode (``_next_input() -> (gray, t') | None``) plus the
    attributes ``fps``, ``duration``, ``_fps_frac`` and ``info``; this base
    turns the input timeline into the output slot grid (module docstring) via
    :meth:`read`/:meth:`read_chunk`.
    """

    def _init_resampler_state(self):
        # resampler state: the pending (frame, slot) not yet emitted
        self._pending: tuple[np.ndarray, int] | None = None
        self._emit_slot = 0  # next output slot to produce
        self._flushed = False
        self._prev_gray: np.ndarray | None = None

    # -- fps-filter resampling ---------------------------------------------
    def read(self) -> np.ndarray | None:
        """Next fps-resampled GRAY8 frame ``[H, W] uint8``, or None at EOF."""
        while True:
            if self._pending is not None:
                frame, slot = self._pending
                if self._emit_slot < slot:
                    # duplicate previous frame to fill the gap
                    out = self._prev_gray if self._prev_gray is not None else frame
                    self._emit_slot += 1
                    if (self._emit_slot - 1) / self.fps >= self.duration:
                        return None
                    return out
            nxt = self._next_input()
            if nxt is None:
                if self._pending is not None and not self._flushed:
                    self._flushed = True
                    frame, slot = self._pending
                    self._prev_gray = frame
                    self._emit_slot = max(self._emit_slot, slot) + 1
                    if (self._emit_slot - 1) / self.fps >= self.duration:
                        return None
                    return frame
                return None
            gray, tp = nxt
            slot = fps_slot(tp, self._fps_frac)
            if self._pending is None:
                # first frame: anchor the output timeline at its slot
                self._pending = (gray, max(slot, 0))
                self._emit_slot = max(slot, 0)
                self._prev_gray = None
                continue
            pframe, pslot = self._pending
            if slot <= pslot:
                # maps to the same slot: the pending frame covers zero output
                # slots, so ffmpeg drops it and the newer frame takes over
                self._pending = (gray, pslot)
                continue
            # emit pending for its slot now; duplicates (if any) flow from the top
            self._pending = (gray, slot)
            self._prev_gray = pframe
            if self._emit_slot == pslot:
                self._emit_slot += 1
                if (self._emit_slot - 1) / self.fps >= self.duration:
                    return None
                return pframe

    def read_chunk(self, n: int, out: np.ndarray | None = None) -> np.ndarray:
        """Up to ``n`` frames stacked ``[k, H, W] uint8`` (k=0 at EOF).
        ``out`` is an optional reusable destination buffer."""
        if out is None or out.shape[0] < n:
            out = np.empty((n, self.info.height, self.info.width), np.uint8)
        k = 0
        for _ in range(n):
            f = self.read()
            if f is None:
                break
            out[k] = f
            k += 1
        return out[:k]

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class OpenCVFrameSource(_ResamplingSource):
    """Iterates fps-resampled GRAY8 frames of ``path`` over ``[start, stop)``.

    Mirrors the reference decode pipeline semantics: seek to ``start``, clamp
    duration to ``stop - start``, resample to ``fps``
    (reference: src/PawsomeTracker.jl:155).
    """

    def __init__(self, path: str, *, start: float = 0.0, stop: float = math.inf, fps: float = 24.0):
        cv2 = _cv2()
        self.path = str(path)
        self.start = float(start)
        self.stop = float(stop)
        self.fps = float(fps)
        self.duration = self.stop - self.start
        self.cap = cv2.VideoCapture(self.path)
        if not self.cap.isOpened():
            raise IOError(f"could not open video: {self.path}")
        # read props off the already-open capture: probe(path) would open and
        # demux the same file a second time per source (costly in batch mode)
        self.info = _info_from_cap(cv2, self.cap)
        self._cv2_mod = cv2
        self._native_fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 24.0
        # exact rationals for slot assignment (see fps_slot)
        self._native_frac = Fraction(self._native_fps).limit_denominator(1001000)
        self._fps_frac = Fraction(self.fps).limit_denominator(1001000)
        self._start_frac = Fraction(self.start).limit_denominator(1001000)
        self._in_idx = 0  # next input frame index (in native timeline)
        if self.start > 0:
            # coarse container seek, then decode-and-discard up to `start`
            # (ffmpeg's accurate -ss behavior)
            self.cap.set(cv2.CAP_PROP_POS_MSEC, max(0.0, (self.start - 2.0) * 1000.0))
            landed = self.cap.get(cv2.CAP_PROP_POS_FRAMES)
            self._in_idx = int(landed) if landed and landed > 0 else 0
        self._init_resampler_state()
        self._pts_mode = False  # sticky: container pts proved non-CFR

    # -- raw decode ---------------------------------------------------------
    def _next_input(self):
        """Next decoded gray frame at shifted time ``t' = t - start``, skipping
        pre-start frames; returns (gray, t') or None at EOF / past duration."""
        cv2 = self._cv2_mod
        while True:
            ok, frame = self.cap.read()
            if not ok:
                return None
            t_count = Fraction(self._in_idx) / self._native_frac
            self._in_idx += 1
            msec = float(self.cap.get(cv2.CAP_PROP_POS_MSEC) or 0.0)
            if msec > 0:
                t_pts = Fraction(round(msec * 1000), 1000000)
                if not self._pts_mode and (
                    abs(t_pts - t_count) * self._native_frac > Fraction(1, 2)
                ):
                    # PTS-true decode: the container pts disagrees with the
                    # constant-frame-rate counter — VFR content; trust pts
                    # from here on (sticky so the timeline stays consistent)
                    self._pts_mode = True
                    # the OpenCV backend is BEST-EFFORT on VFR content:
                    # cv2's demux layer can duplicate/drop frames around
                    # irregular timestamps, so frame selection may diverge
                    # from ffmpeg `-vf fps` semantics. The native libav
                    # decoder is authoritative — tell the user once.
                    logger.warning(
                        "%s: variable-frame-rate timestamps detected; the "
                        "OpenCV fallback decoder is best-effort on VFR "
                        "content and may select different frames than "
                        "ffmpeg's fps filter. Build the native libav "
                        "backend (pawsometracker_tpu_torch/io/native) for exact "
                        "VFR frame selection.",
                        self.path,
                    )
                t = t_pts if self._pts_mode else t_count
            else:
                t = t_count
            tp = t - self._start_frac
            if tp < Fraction(-1, 2) / self._native_frac:
                continue  # still before start: decode-and-discard
            if float(tp) >= self.duration:
                return None
            if frame.ndim == 3:
                gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            else:
                gray = frame
            return gray, tp

    def close(self):
        self.cap.release()


def _rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luma of channels-last RGB uint8 (integer arithmetic, round-half-up
    like swscale/cv2's fixed-point path)."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)


def is_frame_stack(obj) -> bool:
    """True for anything that duck-types as a ``[T, H, W]``/``[T, H, W, C]``
    frame stack: indexable with a 3-/4-D ``shape`` and a ``dtype`` — ndarrays,
    ``np.memmap``, h5py/zarr datasets. Frames are materialized one
    at a time (``obj[k]``), so lazy datasets stream with bounded memory."""
    return (
        not isinstance(obj, (str, bytes, os.PathLike))
        and hasattr(obj, "shape")
        and hasattr(obj, "dtype")
        and hasattr(obj, "__getitem__")
        and len(getattr(obj, "shape", ())) in (3, 4)
    )


def _frac(x) -> Fraction:
    """A rate or a time as the resampler holds it (module docstring)."""
    return Fraction(float(x)).limit_denominator(1001000)


def view_origin(frames, *, start: float = 0.0, fps: float = 24.0,
                input_fps: float | None = None) -> int | None:
    """The input frame ``k0`` from which :class:`ArrayFrameSource` serves views
    of ``frames`` over ``[start, ...)`` at ``fps``, or None where it walks the
    exact per-frame resampler.

    Views need a plain 3-D ``np.ndarray`` (``np.memmap`` included) whose
    columns lie 1 byte apart (the native copies' layout: not a mirrored,
    column-strided or Fortran-ordered array) at the output rate
    (``input_fps`` None, or equal to ``fps`` as the resampler's fractions see
    it) and ``start * fps`` within LESS than half a slot of an
    integer ``k0 >= 0``. Then every gate of the resampler is exact: the keep
    window ``tp >= -1/(2 fps)`` first keeps input frame ``k0``, each kept frame
    ``k0 + m`` takes slot ``round(m + k0 - start * fps) = m`` (anchored at
    ``max(slot, 0) = 0``), so nothing is dropped or repeated, and output frame
    ``m`` is input frame ``k0 + m``. A half-slot tie, a negative ``k0``, RGB or
    lazy stacks and resampled arrays keep the walk. ``track``, ``track_batch``
    and ``track_resumable``'s slices all decide by this one rule."""
    if not (isinstance(frames, np.ndarray) and frames.ndim == 3 and frames.strides[2] == 1):
        return None
    fps_frac = _frac(fps)
    if input_fps is not None and _frac(input_fps) != fps_frac:
        return None
    x = _frac(start) * fps_frac
    k0 = round(x)
    if k0 < 0 or abs(x - k0) >= Fraction(1, 2):
        return None
    return int(k0)


class ArrayFrameSource(_ResamplingSource):
    """In-memory frames ``[T, H, W]`` (GRAY8) or ``[T, H, W, 3]`` (RGB) uint8
    as a frame source — for recordings that never were video files (HDF5/zarr
    datasets, TIFF stacks, camera SDKs).

    The array's native timeline is ``k / input_fps`` and the same exact
    fps-filter resampling as the file backends maps it onto the requested
    output ``fps`` grid; ``input_fps=None`` means the frames are already
    sampled at ``fps`` (pure passthrough apart from ``start``/``stop``
    clamping). RGB input is reduced to BT.601 luma; ``sar`` defaults to the
    square pixels an array implies.

    ``frames`` may be any lazily-indexable stack (:func:`is_frame_stack`:
    h5py/zarr datasets, ``np.memmap``); frames materialize ONE AT A TIME, so
    an 8-hour dataset streams with the same bounded memory as a video file.
    """

    #: serve views where :func:`view_origin` allows them; a test hook, which
    #: ``False`` turns into the per-frame resampler for every new source
    views_allowed = True

    def __init__(self, frames, *, start: float = 0.0, stop: float = math.inf,
                 fps: float = 24.0, input_fps: float | None = None, sar: float = 1.0):
        if not is_frame_stack(frames):
            frames = np.asarray(frames)  # lists / sequences of frames
        shape = tuple(frames.shape)
        if np.dtype(frames.dtype) != np.uint8:
            raise TypeError(f"frame array must be uint8, got {frames.dtype}")
        if len(shape) not in (3, 4) or (len(shape) == 4 and shape[-1] not in (1, 3)):
            raise ValueError(
                "frame array must be [T, H, W] gray or [T, H, W, 1|3], got "
                f"shape {shape}"
            )
        if shape[0] == 0:
            raise ValueError("empty frame array")
        self.frames = frames
        self.start = float(start)
        self.stop = float(stop)
        self.fps = float(fps)
        self.duration = self.stop - self.start
        in_fps = self.fps if input_fps is None else float(input_fps)
        if in_fps <= 0:
            raise ValueError(f"input_fps must be > 0, got {input_fps}")
        t_total, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        self.info = VideoInfo(width=w, height=h, fps=in_fps, sar=float(sar),
                              frame_count=t_total)
        self._native_frac = Fraction(in_fps).limit_denominator(1001000)
        self._fps_frac = Fraction(self.fps).limit_denominator(1001000)
        self._start_frac = Fraction(self.start).limit_denominator(1001000)
        self._in_idx = 0
        self._init_resampler_state()
        # Zero-copy passthrough: where the start maps 1:1 onto the output grid
        # (view_origin), output frame m is input frame k0 + m, so reads serve
        # read-only VIEWS of the backing array instead of 2 MB/frame copies —
        # the dominant host cost for in-memory tracking, and for every slice of
        # track_resumable past the first. Resampling, off-grid starts, RGB and
        # lazy stacks keep the exact per-frame resampler.
        k0 = (view_origin(self.frames, start=self.start, fps=self.fps, input_fps=input_fps)
              if self.views_allowed else None)
        self.serves_views = k0 is not None
        if self.serves_views:
            avail = max(0, t_total - k0)
            if math.isinf(self.duration):
                n_out = avail
            else:
                # output frame m is emitted iff BOTH resampler gates pass for
                # input frame k0 + m, evaluated with the EXACT expressions those
                # gates use — the input keep check float(Fraction(k0 + m) /
                # native_frac - start_frac) < duration (_next_input) and the
                # emit clamp m/fps < duration (read) — so the two paths cannot
                # disagree even by 1 ulp at a boundary (m/fps and the Fraction
                # form differ by 1 ulp for NTSC-style rates; a Fraction round
                # trip of the duration would break tiny durations:
                # limit_denominator(1e-9) == 0)
                def _emitted(m: int) -> bool:
                    tp = Fraction(k0 + m) / self._native_frac - self._start_frac
                    return float(tp) < self.duration and m / self.fps < self.duration

                n_out = min(avail, max(0, math.ceil(self.duration * self.fps)))
                while n_out > 0 and not _emitted(n_out - 1):
                    n_out -= 1
                while n_out < avail and _emitted(n_out):
                    n_out += 1
            # served views are read-only: the flag set once, on a view of the
            # whole array, which every frame and chunk sliced from it inherits
            self._zc_frames = self.frames.view()
            self._zc_frames.flags.writeable = False
            self._zc_k0 = k0
            self._zc_n = n_out
            self._zc_pos = 0

    def _next_input(self):
        while self._in_idx < self.frames.shape[0]:
            idx = self._in_idx
            self._in_idx += 1
            t = Fraction(idx) / self._native_frac
            tp = t - self._start_frac
            if tp < Fraction(-1, 2) / self._native_frac:
                continue  # still before start (same keep window as the decoders)
            if float(tp) >= self.duration:
                return None
            f = np.asarray(self.frames[idx])  # ONE frame materializes
            if f.ndim == 3:
                f = f[..., 0] if f.shape[-1] == 1 else _rgb_to_gray_u8(f)
            return f, tp
        return None

    # -- zero-copy passthrough overrides (see serves_views) ----------------
    def read(self) -> np.ndarray | None:
        if not self.serves_views:
            return super().read()
        if self._zc_pos >= self._zc_n:
            return None
        f = self._zc_frames[self._zc_k0 + self._zc_pos]  # VIEW of the backing array
        self._zc_pos += 1
        return f

    def read_chunk(self, n: int, out: np.ndarray | None = None) -> np.ndarray:
        """Zero-copy: up to ``n`` frames as a read-only VIEW ``[k, H, W]`` of
        the backing array (``out`` ignored; the caller's array stays
        writable, and the prefetcher's ring never pools a view). The JAX
        package's views are writable: a deliberate divergence, so that no
        consumer can write into the caller's frames."""
        if not self.serves_views:
            return super().read_chunk(n, out)
        k = max(0, min(int(n), self._zc_n - self._zc_pos))
        at = self._zc_k0 + self._zc_pos
        view = self._zc_frames[at : at + k]
        self._zc_pos += k
        return view


def open_source(
    path,
    *,
    start: float = 0.0,
    stop: float = math.inf,
    fps: float = 24.0,
    backend: str = "auto",
    prefetch: int | None = None,
    workers: int | None = None,
    input_fps: float | None = None,
    fast_decode: bool | None = None,
):
    """Open a frame source, preferring the native libav decoder when built.

    ``path`` may also be an in-memory uint8 frame array ``[T, H, W]`` (or RGB
    ``[T, H, W, 3]``) — see :class:`ArrayFrameSource`; ``input_fps`` states
    that array's native rate (default: already at ``fps``), and the
    backend/worker knobs don't apply.
    ``prefetch`` sizes the native decode-ahead ring (frames); the speculative
    ROI pipeline needs it large enough to also RETAIN its in-flight chunks.

    ``workers`` > 1 (default: the ``PAWSIO_DECODE_WORKERS`` env var) decodes
    the video with that many cooperating native decoders over interleaved
    keyframe-seek spans — bit-identical frames, ~Wx throughput on multi-core
    hosts (see :mod:`.parallel_decode`). The parallel source serves full
    frames only (no C++ retained-crop ring), so it suits decode-bound
    workloads; single-worker sources keep the in-ring ROI fast path.

    ``fast_decode=True`` asks the native decoder to skip the h264 in-loop
    deblocking filter (~10-30% faster on decode-bound hosts). Decoded pixels
    are NOT bit-exact vs a spec decode — the zero-sum DoG argmax is robust to
    the difference (tracks stay inside the <1 px oracle) but cross-backend
    parity comparisons must leave it off. Native-decoder knob only: the
    OpenCV fallback logs a one-time warning and decodes normally, and
    in-memory frame arrays log a one-time no-op warning. Default
    ``None`` follows the ``PAWSIO_FAST_DECODE`` env var."""
    if isinstance(path, np.ndarray) or is_frame_stack(path):
        # any ndarray routes here so a wrong-shaped one gets the shape error,
        # not a "could not open video" from the file backends
        if fast_decode:
            global _warned_fast_array
            if not _warned_fast_array:
                _warned_fast_array = True
                logger.warning(
                    "fast_decode requested for an in-memory frame array — "
                    "there is nothing to decode; the knob is a no-op here"
                )
        return ArrayFrameSource(path, start=start, stop=stop, fps=fps,
                                input_fps=input_fps)
    if workers is None:
        try:
            workers = int(os.environ.get("PAWSIO_DECODE_WORKERS", "1"))
        except ValueError:
            workers = 1
    if backend in ("auto", "native"):
        try:
            from .native_io import NativeFrameSource, native_available

            if native_available():
                if workers and workers > 1:
                    from .parallel_decode import ParallelNativeSource

                    return ParallelNativeSource(
                        path, start=start, stop=stop, fps=fps, workers=workers,
                        fast=fast_decode,
                    )
                return NativeFrameSource(
                    path, start=start, stop=stop, fps=fps,
                    prefetch=8 if prefetch is None else prefetch,
                    fast=fast_decode,
                )
            if backend == "native":
                # an EXPLICIT native request must fail loudly, not silently
                # fall back to the best-effort OpenCV frame selection
                raise IOError(
                    "backend='native' requested but the native decode layer "
                    "is unavailable (libpawsio.so missing and unbuildable)"
                )
        except Exception:
            if backend == "native":
                raise
    if fast_decode:
        global _warned_fast_opencv
        if not _warned_fast_opencv:
            _warned_fast_opencv = True
            logger.warning(
                "fast_decode requested but the OpenCV fallback decoder is in "
                "use (native libpawsio unavailable or backend='opencv') — "
                "decoding normally; fast decode is a native-decoder knob"
            )
    return OpenCVFrameSource(path, start=start, stop=stop, fps=fps)


class ChunkRing:
    """The buffers ``[rows, H, W]`` one frame stream's chunks land in, each
    handed out again once the consumer has returned it (:meth:`recycle`) and
    the event of its last copy to the card (:meth:`copied`), where one was
    given, has completed; so steady state runs on as many buffers as the flow
    holds, with no fresh page-faulting allocation a chunk.

    ``alloc(shape)`` makes a uint8 buffer (``np.empty``; pinned memory for the
    full-frame engine on the card). A decoder or the resampler writes the
    frames into the buffer itself; a source that serves views of the
    caller's array hands them back as they are, or, with ``copy(src, dst)``
    given (the engine's native copy on the card), copied into the buffer.
    Views are never pooled: a buffer of the caller's frames must not be
    handed out to be written."""

    def __init__(self, alloc=None, copy=None):
        self._alloc = alloc or (lambda shape: np.empty(shape, np.uint8))
        self._copy = copy
        self._free: queue.SimpleQueue = queue.SimpleQueue()  # (buffer, event or None)
        self._mine: dict = {}  # data address -> the ring's buffer there
        self._events: dict = {}  # data address -> the event of its last copy to the card
        #: buffers made (observability: tests)
        self.made = 0

    def holds(self, chunk: np.ndarray) -> bool:
        """Whether ``chunk`` lies at the start of a buffer of the ring."""
        return chunk.ctypes.data in self._mine

    def _take(self, shape, timer) -> np.ndarray:
        try:
            buf, event = self._free.get_nowait()
        except queue.Empty:
            buf, event = self._alloc(shape), None
            self._mine[buf.ctypes.data] = buf
            self.made += 1
        if event is not None:
            with timer.span("ring.wait"):
                event.synchronize()  # the buffer is free once its copy to the card is done
        return buf

    def read(self, source, k: int, rows: int, timer=OFF) -> np.ndarray:
        """The source's next up to ``k`` frames, in a buffer of ``rows``
        frames of the ring, or views of the caller's array without ``copy``.
        ``timer``'s spans: ``stage.read`` (the source's read), ``stage.copy``
        (the copy of viewed frames in, its ``form`` what ``copy`` returned),
        ``ring.wait`` (a buffer's last copy to the card)."""
        if self._copy is None and getattr(source, "serves_views", False):
            with timer.span("stage.read"):
                return source.read_chunk(k)
        buf = self._take((rows,) + tuple(source.info.frame_shape), timer)
        with timer.span("stage.read"):
            chunk = source.read_chunk(k, out=buf)
        if len(chunk) and chunk.ctypes.data != buf.ctypes.data and self._copy is not None:
            with timer.span("stage.copy") as span:  # frames served as views: copied in
                span.note(form=self._copy(chunk, buf[:len(chunk)]))
            chunk = buf[:len(chunk)]
        if not self.holds(chunk) or len(chunk) == 0:
            self._free.put((buf, None))
        return chunk

    def copied(self, chunk: np.ndarray, event) -> None:
        """Mark ``chunk``'s buffer with the event of its copy to the card."""
        self._events[chunk.ctypes.data] = event

    def recycle(self, chunk: np.ndarray) -> None:
        """Take ``chunk``'s buffer back (a chunk that is not in one, a view,
        is let go); it is handed out again once the event :meth:`copied` gave
        it has completed."""
        at = chunk.ctypes.data
        if at in self._mine:
            self._free.put((self._mine[at], self._events.pop(at, None)))


class ChunkPrefetcher:
    """Background decode-ahead: a bounded queue of frame chunks.

    The host decodes the next chunk while the device tracks the current one —
    the analog of the reference's out-of-process ffmpeg pipe overlapping
    decode with compute (reference: src/PawsomeTracker.jl:155-157). The chunks
    land in ``ring`` (:class:`ChunkRing`; a plain one by default, the
    full-frame engine's pinned one on the card), and the consumer hands each
    back with :meth:`recycle` once it is done with it.

    ``timer``, the call's :class:`~..utils.profiling.Timer` (None: no spans),
    records the consumer's waits for a chunk (``prefetch.wait``), and on the
    thread, whose spans take as parent the span that made the prefetcher, the
    ring's spans and its blocked hand-overs (``prefetch.full``); each with the
    stream's ``lane``.
    """

    def __init__(self, source, chunk_size: int, max_frames: int | None = None, depth: int = 2,
                 ring: ChunkRing | None = None, timer=None, lane: int = 0):
        self.source = source
        self.chunk_size = int(chunk_size)
        self.max_frames = max_frames
        self.ring = ChunkRing() if ring is None else ring
        self.timer = OFF if timer is None else timer
        self.lane = lane
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(self.timer.current(),),
                                        name=f"paws-prefetch-{lane}", daemon=True)
        self._thread.start()

    def recycle(self, chunk: np.ndarray):
        """Return a consumed chunk's buffer to the ring for reuse."""
        self.ring.recycle(chunk)

    def _run(self, parent: int):
        timer = self.timer
        timer.adopt(parent)
        try:
            remaining = self.max_frames if self.max_frames is not None else math.inf
            while remaining > 0 and not self._stop.is_set():
                k = int(min(self.chunk_size, remaining))
                chunk = self.ring.read(self.source, k, self.chunk_size, timer)
                if chunk.shape[0] == 0:
                    break
                remaining -= chunk.shape[0]
                try:
                    self._q.put_nowait(chunk)
                    continue
                except queue.Full:
                    pass
                with timer.span("prefetch.full", lane=self.lane):
                    while not self._stop.is_set():
                        try:
                            self._q.put(chunk, timeout=0.1)
                            break
                        except queue.Full:
                            pass
        except BaseException as e:  # surface decode errors to the consumer
            self._err = e
        finally:
            while True:  # sentinel must land even if the queue is full
                try:
                    self._q.put(None, timeout=0.1)
                    break
                except queue.Full:
                    # evict only when closing — a live consumer will drain
                    if self._stop.is_set():
                        try:
                            self._q.get_nowait()
                        except queue.Empty:
                            pass

    def __iter__(self):
        while True:
            with self.timer.span("prefetch.wait", lane=self.lane):
                item = self._q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self):
        """Stop and JOIN the producer thread. Must be called before closing
        the underlying source: otherwise the thread may still be inside
        ``source.read_chunk`` when the source (for the native backend, a C++
        decoder) is destroyed — a use-after-free. The join therefore blocks
        until the thread actually exits (decode of one chunk can take minutes
        on wedged I/O, but returning with the thread alive would trade a slow
        close for a segfault)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()  # unblock a full-queue put()
            except queue.Empty:
                pass
            self._thread.join(timeout=1.0)
