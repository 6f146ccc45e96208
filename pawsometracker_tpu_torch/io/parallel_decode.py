"""Multi-segment parallel decode: W workers, one video, bit-identical frames.

The reference's decode is a single out-of-process ffmpeg pipe (reference:
src/PawsomeTracker.jl:155-157) — one core's worth of decode throughput. On a
multi-core host the tracker is decode-bound at 1080p (the device scan is >10x
faster than one core can decode), so this module parallelizes decode of ONE
video across cores:

- The output frame grid is split into *spans* of consecutive output slots.
  Span boundaries are planned from a demux-only keyframe index
  (``pawsio_keyframes``): a boundary sits at ``slot(keyframe) + 1`` so each
  worker's entry — including its verification lead frame at the keyframe's
  own slot — starts decoding exactly AT a keyframe, with zero decode-discard
  (mid-GOP entries would otherwise decode and throw away up to a whole GOP
  per span). Tiny spans are coalesced, GOPs longer than ``span_frames`` are
  split (interior entries pay the usual keyframe-seek discard), and fixed
  spans continue past the last keyframe or when no index is available.
  Workers pull span indices from a shared counter (dynamic load balancing)
  and decode each span with their OWN native decoder.
- Completed spans land in a bounded reorder buffer; the consumer reads frames
  strictly in order. Flow control: at most ``workers + 2`` spans may be open
  (decoding or buffered) at once, and they are always the lowest unconsumed
  indices, so the consumer's next span is never starved by later ones.
- Each worker decoder is pinned to ONE codec thread (``pawsio_open2``): W
  workers use W cores, instead of W oversubscribed libav frame-thread pools.

**Why mid-stream starts are bit-identical** to the single-decoder stream: the
fps resampler assigns each input frame the output slot ``round(t*fps)`` with
exact rational arithmetic and shows, at every slot, the last input frame whose
claimed slot is <= it (pawsio.cpp read_resampled). That selection is per-slot
stateless, and a span worker keeps the single stream's slot grid EXACTLY: it
opens with the GLOBAL ``(start, stop)`` plus an integer slot offset
(``pawsio_open_span``), so slot rounding can never diverge (re-deriving the
grid from ``start + a/fps`` would shift round-half ties by fractional ticks —
caught by the 24->18 fps parity test). The one remaining requirement is that
the input frame "held" into the span's first slot is still decoded: the
accurate-seek discard keeps frames up to half an input interval before the
span window, which covers the holder whenever ``native_fps >= fps`` on CFR
content (for upsampling or wildly VFR input the holder can predate the
window), hence the CFR pre-guard in :func:`parallel_ok` — and because the
pre-guard cannot see local VFR gaps, every boundary is ALSO verified at
runtime (holder pts + pixel equality, span 0 grid check) with an exact
sequential fallback. Parity is enforced by tests on h264 B-frame content and
randomized VFR streams (tests/test_parallel_decode.py, tools/fuzz.py).
"""

from __future__ import annotations

import math
import threading
from collections import deque

import numpy as np

from ..ops.roi_crop import crop_with_fill
from .decode import VideoInfo  # noqa: F401  (re-export convenience)

__all__ = ["ParallelNativeSource", "parallel_ok"]

DEFAULT_SPAN_FRAMES = 64


def parallel_ok(info, fps: float) -> bool:
    """True when multi-segment decode is safe for this stream: the span-start
    holder guarantee needs the input rate at or above the output rate (see
    module docstring).

    NOTE: ``info.fps`` is the container's guessed/average rate, so this
    pre-guard covers CFR content only. VFR that slips past it is still SAFE:
    every span boundary is verified at runtime (holder pts + pixels, plus
    span 0's grid check), and any divergence falls back to an exact
    sequential decode — correct always, parallel only when provably aligned."""
    return info.fps + 1e-6 >= fps


class _Span:
    __slots__ = ("idx", "frames", "pos", "event", "error", "entry_check",
                 "lead_pts", "tail_pts", "tail_slot")

    def __init__(self, idx: int):
        self.idx = idx
        self.frames: np.ndarray | None = None  # [got, H, W] view (got <= span)
        self.pos = 0  # frames already consumed
        self.event = threading.Event()
        self.error: BaseException | None = None
        #: for idx > 0: this worker's decode of the PREVIOUS span's last slot.
        #: The consumer verifies the mid-stream entry reproduced the
        #: sequential stream TWO ways: the holder pts of that slot must equal
        #: the previous span's tail holder pts (catches grid shifts even
        #: through byte-identical static frames), and the pixels must match
        #: (belt and braces). Any divergence falls back to sequential decode.
        self.entry_check: np.ndarray | None = None
        self.lead_pts: int | None = None
        self.tail_pts: int | None = None
        #: global output slot of the span's last frame — the consumer checks
        #: span 0's grid alignment with it (a leading VFR gap past `start`
        #: makes the decoder SKIP slots, so delivery index != slot number)
        self.tail_slot: int | None = None


class ParallelNativeSource:
    """Drop-in frame source (``info`` / ``read`` / ``read_chunk`` / ``close``)
    that decodes one video with ``workers`` cooperating native decoders.

    Frames are bit-identical to ``NativeFrameSource(path, start, stop, fps)``
    read sequentially. The retained-ROI protocol (``read_roi_chunk_retained``
    / ``advance_retained`` / ``recrop`` / ``release``) is also provided —
    retention is numpy views into the span buffers (a span's memory lives
    until its last retained frame is released), so the speculative predict
    pipeline runs at full parallel-decode speed on multi-core hosts. Crops
    are numpy copies here rather than C++-ring crops; the decoded frames
    already live in Python-side span buffers either way.
    """

    def __init__(
        self,
        path: str,
        *,
        start: float = 0.0,
        stop: float = math.inf,
        fps: float = 24.0,
        workers: int = 2,
        span_frames: int = DEFAULT_SPAN_FRAMES,
        threads_per_worker: int = 1,
        keyframe_align: bool = True,
        fast: bool | None = None,
    ):
        from .native_io import NativeFrameSource, native_probe

        self.path = str(path)
        self.start = float(start)
        self.stop = float(stop)
        self.fps = float(fps)
        self.info = native_probe(self.path)
        self._src_cls = NativeFrameSource
        self._span_frames = int(span_frames)
        self._threads_per_worker = int(threads_per_worker)
        self._fast = fast
        W = max(1, int(workers))
        if not parallel_ok(self.info, self.fps):
            W = 1  # upsampling/VFR-risky: keep the single-decoder guarantee
        if W > 1:
            from .native_io import _load

            lib = _load()
            # the span machinery needs BOTH the slot0 entry point and the
            # slot/pts introspection used by boundary + grid verification
            if not (hasattr(lib, "pawsio_open_span") and hasattr(lib, "pawsio_last_slot")):
                W = 1  # stale prebuilt .so: degrade at open, not mid-stream
        self.workers = W
        #: retained-ROI window: numpy frame views into span buffers (a span's
        #: memory lives until its last retained frame is released). Python
        #: retention has no fixed ring, so advertise effectively-unbounded
        #: capacity to the pipelines' ring-sizing gates.
        self._retained: deque = deque()
        self.ring_frames = 1 << 30
        self._seq = None
        self._threads: list[threading.Thread] = []
        if W == 1:
            # degenerate case: one plain sequential decoder, no spans at all
            # (span entry at slot0 needs the holder guarantee; a single
            # decoder from `start` needs nothing)
            self._seq = NativeFrameSource(
                self.path, start=self.start, stop=self.stop, fps=self.fps, prefetch=0,
                fast=fast,
            )
            return

        # request cap in output slots — derived with the DECODER'S OWN stop
        # predicate ((emit_slot - 1)/fps >= duration, double math), so the
        # two can never disagree by a ulp (round() undercounted fractional
        # stops by one frame; a plain ceil-epsilon could still diverge on
        # adversarial durations).
        # True EOF is discovered from short spans; speculative claims past EOF
        # are bounded by the open-span budget (at most workers+2 wasted opens).
        if math.isfinite(stop):
            d_dur = self.stop - self.start
            n = max(0, int(math.ceil(self.fps * d_dur)) + 2)
            while n > 0 and (n - 1) / self.fps >= d_dur:
                n -= 1
            self._slot_limit = n
        else:
            self._slot_limit = None

        # span plan: boundaries at keyframes when an index is available (each
        # worker's entry — including its verification lead frame at the
        # keyframe's own slot — then decodes with ZERO pre-window discard).
        # Oversized GOPs are split into fixed-size interior spans (those pay
        # the usual keyframe-seek discard); past the last keyframe, fixed
        # spans continue at span_frames.
        self._starts = [0]
        self._hints = [-1.0]
        if self.workers > 1 and keyframe_align:
            self._plan_spans()

        self._lock = threading.Lock()
        self._error: BaseException | None = None
        self._spans: dict[int, _Span] = {}
        self._next_ticket = 0  # next span index a worker may claim
        self._eof_slot: int | None = None  # first slot known not to exist
        self._stop_flag = False
        # open-span budget: decoding + buffered spans (consumer releases)
        self._budget = threading.Semaphore(W + 2)
        self._consumed_until = 0  # absolute frames fully consumed
        self._cur: _Span | None = None
        self._prev_tail: np.ndarray | None = None  # last served frame (view)
        self._prev_tail_pts: int | None = None  # its holder pts (span chain)
        self._eof_confirmed = False  # a VERIFIED short/empty span ended the stream
        self._threads = [
            threading.Thread(target=self._worker, daemon=True) for _ in range(W)
        ]
        for t in self._threads:
            t.start()

    def _plan_spans(self):
        """Build keyframe-aligned span boundaries: ``slot(kf) + 1`` per
        keyframe (so the entry lead frame at ``slot(kf)`` decodes from the
        keyframe itself, zero discard), tiny spans coalesced, giant GOPs
        split at ``span_frames``. Fixed spans continue past the last
        keyframe; on any probe failure the fixed plan stands."""
        import math as _math

        from .native_io import native_keyframes

        try:
            kfs = native_keyframes(self.path)
        except Exception:
            return
        if kfs.size < 2:
            return
        S = self._span_frames
        min_span = max(4, S // 4)
        starts, hints = self._starts, self._hints
        # boundary margin past the keyframe timestamp: index timestamps are
        # typically DTS (pts = dts + B-frame delay), and a boundary whose
        # lead-slot holder PREDATES the keyframe would trip verification on
        # every span. Pushing the boundary ~half an output slot plus a few
        # input intervals later keeps the holder at/after the keyframe; the
        # worker still enters AT the keyframe (seek hint), so the only cost
        # is a few decoded-and-replaced frames, never a discard.
        native = max(self.info.fps, self.fps)
        margin = 0.5 / self.fps + 4.5 / native
        for t_kf in kfs:
            x = (t_kf + margin - self.start) * self.fps
            # ties-away-from-zero like the C++ resampler's AV_ROUND_NEAR_INF
            # (Python round() is banker's and misplaces every exact half-slot
            # boundary, e.g. all of them on 48->24 content)
            a = int(_math.floor(x + 0.5 + 1e-9)) + 1
            if a - starts[-1] < min_span:
                continue  # coalesce (also skips keyframes before `start`)
            if self._slot_limit is not None and a >= self._slot_limit:
                break
            while a - starts[-1] > S:  # split a giant GOP at span_frames
                starts.append(starts[-1] + S)
                hints.append(-1.0)
            if a > starts[-1]:
                if a - starts[-1] >= min_span:
                    starts.append(a)
                    hints.append(float(t_kf))
                else:
                    # the split left a sliver (< min_span) before the
                    # keyframe: a worker would pay a full decoder open for a
                    # handful of frames. Move the last synthetic boundary
                    # onto the keyframe instead (the previous span grows by
                    # the sliver; the boundary gains the exact seek hint).
                    # Reaching here implies the split loop ran, so the last
                    # boundary is synthetic (hint -1), never a keyframe one.
                    starts[-1] = a
                    hints[-1] = float(t_kf)

    def _span_start(self, ticket: int) -> int:
        if ticket < len(self._starts):
            return self._starts[ticket]
        return self._starts[-1] + (ticket - len(self._starts) + 1) * self._span_frames

    def _span_hint(self, ticket: int) -> float:
        return self._hints[ticket] if ticket < len(self._hints) else -1.0

    def _ticket_of(self, slot: int) -> int:
        """The span ticket covering output ``slot``."""
        import bisect

        if slot < self._starts[-1]:
            return bisect.bisect_right(self._starts, slot) - 1
        return len(self._starts) - 1 + (slot - self._starts[-1]) // self._span_frames

    # ---- worker side -----------------------------------------------------

    def _claim(self) -> _Span | None:
        """Reserve the next span ticket (budget already acquired)."""
        with self._lock:
            if self._stop_flag:
                return None
            a = self._span_start(self._next_ticket)
            if self._eof_slot is not None and a >= self._eof_slot:
                return None
            if self._slot_limit is not None and a >= self._slot_limit:
                return None
            span = _Span(self._next_ticket)
            self._next_ticket += 1
            self._spans[span.idx] = span
            return span

    def _worker(self):
        while True:
            self._budget.acquire()
            span = self._claim()
            if span is None:
                self._budget.release()
                return
            try:
                got = self._decode_span(span)
            except BaseException as e:
                span.error = e
                self._error = e
                span.event.set()
                return
            span.event.set()
            if got < self._span_count(span.idx):
                with self._lock:
                    first = self._span_start(span.idx) + got
                    if self._eof_slot is None or first < self._eof_slot:
                        self._eof_slot = first

    def _span_count(self, idx: int) -> int:
        """Requested output slots for span ``idx`` (the last span is short)."""
        a = self._span_start(idx)
        n = self._span_start(idx + 1) - a
        if self._slot_limit is not None:
            n = min(n, self._slot_limit - a)
        return max(0, n)

    def _decode_span(self, span: _Span) -> int:
        a = self._span_start(span.idx)
        want = self._span_count(span.idx)
        if want == 0:
            span.frames = np.empty((0,) + self.info.frame_shape, np.uint8)
            return 0
        # non-first spans enter ONE slot early: the extra frame re-decodes the
        # previous span's last slot for the consumer's boundary verification
        lead = 1 if span.idx > 0 else 0
        # GLOBAL (start, stop) + slot offset: the decoder keeps the single
        # stream's slot grid (no per-worker start rounding) and seeks to the
        # keyframe before slot a's time — bit-exact mid-stream entry. The
        # global stop also keeps the resampler's EOF flush identical.
        src = self._src_cls(
            self.path,
            start=self.start,
            stop=self.stop,
            fps=self.fps,
            prefetch=0,  # synchronous ring-less decode inside this thread
            threads=self._threads_per_worker,
            fast=self._fast,
            slot0=a - lead,
            # keyframe-aligned spans: seek to the keyframe ITSELF (its slot is
            # a-1, the lead frame) — zero decode-discard on entry
            seek_hint=self._span_hint(span.idx) if lead else -1.0,
        )
        try:
            if lead:
                head = src.read_chunk(1)
                span.entry_check = head[0] if head.shape[0] else None
                span.lead_pts = src.last_pts if head.shape[0] else None
            chunk = src.read_chunk(want)
            span.tail_pts = src.last_pts if chunk.shape[0] else span.lead_pts
            span.tail_slot = src.last_slot if chunk.shape[0] else None
        finally:
            src.close()
        span.frames = chunk
        return chunk.shape[0]

    # ---- consumer side ---------------------------------------------------

    def _next_span(self) -> _Span | None:
        """The span holding the next unconsumed frame, decoded; None at EOF."""
        import time

        while True:
            idx = self._ticket_of(self._consumed_until)
            with self._lock:
                if self._stop_flag:
                    return None
                # NOTE: worker-declared _eof_slot is deliberately NOT checked
                # here — a span that missed its held frame can report a bogus
                # early EOF, so EOF authority comes only from a span whose
                # boundary the consumer has VERIFIED (see _consume). Workers
                # still use _eof_slot to stop claiming further spans.
                if self._slot_limit is not None and self._consumed_until >= self._slot_limit:
                    return None
                span = self._spans.get(idx)
            if span is None:
                # not claimed yet (budget starvation is impossible: open spans
                # are the lowest unconsumed indices) — yield briefly
                if not any(t.is_alive() for t in self._threads):
                    if self._error is not None:
                        raise self._error
                    return None  # workers exited (limit/EOF) without this span
                time.sleep(0.002)
                continue
            if not span.event.wait(timeout=0.25):
                continue  # periodic re-check of eof/stop
            if span.error is not None:
                raise span.error
            return span

    def _release_span(self, span: _Span):
        with self._lock:
            self._spans.pop(span.idx, None)
        self._budget.release()

    def _consume(self, n: int, sink) -> int:
        """Advance the in-order stream by up to ``n`` frames, handing each
        contiguous block to ``sink`` as a numpy view (the view keeps its span
        buffer alive, so retaining it is safe)."""
        got = 0
        while got < n:
            if self._seq is not None:
                want = n - got
                chunk = self._seq.read_chunk(want)  # fresh array: retainable
                if chunk.shape[0]:
                    sink(chunk)
                    self._prev_tail = chunk[-1]
                got += int(chunk.shape[0])
                if chunk.shape[0] < want:
                    break  # EOF
                continue
            span = self._cur
            if span is None or span.pos >= span.frames.shape[0]:
                if span is not None:
                    short = span.frames.shape[0] < self._span_count(span.idx)
                    self._prev_tail_pts = span.tail_pts
                    self._release_span(span)
                    self._cur = None
                    if short:
                        self._eof_confirmed = True  # boundary verified at adoption
                        break  # EOF inside this span
                if self._eof_confirmed:
                    break  # don't wait on doomed past-EOF workers
                span = self._next_span()
                if span is None:
                    break
                # boundary verification: the worker re-decoded the previous
                # span's last slot on its way in. Two independent equalities
                # must hold against what we actually served there: the HOLDER
                # PTS (catches slot-grid shifts even when frames are
                # byte-identical — static scenes, camera stalls) and the
                # pixels. Any divergence (VFR gap past the CFR guard,
                # container oddity) falls back to an exact sequential decode
                # — slower once, never wrong. Runs for EMPTY spans too: an
                # entry that missed the held frame entirely produces a bogus
                # early EOF, so a span only gains EOF authority by verifying.
                if span.idx > 0 and self._prev_tail is not None:
                    pts_ok = (
                        span.lead_pts is not None
                        and self._prev_tail_pts is not None
                        and span.lead_pts == self._prev_tail_pts
                    )
                    pix_ok = span.entry_check is not None and np.array_equal(
                        span.entry_check, self._prev_tail
                    )
                    if not (pts_ok and pix_ok):
                        self._go_sequential()
                        continue
                if span.frames.shape[0] == 0:
                    self._eof_confirmed = True
                    self._release_span(span)  # free its budget permit
                    break  # VERIFIED empty span: genuine EOF
                # span 0 has no boundary to verify; its grid alignment is
                # checked directly: with no skipped slots the last frame's
                # slot equals start + count - 1 (the probe-free replacement
                # for leading-gap detection)
                if span.idx == 0 and span.tail_slot is not None:
                    expect = self._span_start(0) + span.frames.shape[0] - 1
                    if span.tail_slot != expect:
                        self._go_sequential()
                        continue
                self._cur = span
            take = min(n - got, span.frames.shape[0] - span.pos)
            blk = span.frames[span.pos : span.pos + take]
            sink(blk)
            self._prev_tail = blk[-1]
            span.pos += take
            self._consumed_until += take
            got += take
        return got

    def _go_sequential(self):
        """Verified divergence at a span boundary: stop the workers and
        continue through ONE sequential decoder fast-forwarded from the
        stream start to the consumer position."""
        with self._lock:
            self._stop_flag = True
        for _ in self._threads:
            self._budget.release()
        for t in self._threads:
            t.join()
        self._spans.clear()
        self._cur = None
        seq = self._src_cls(
            self.path, start=self.start, stop=self.stop, fps=self.fps, prefetch=0,
            fast=self._fast,
        )
        skip = self._consumed_until
        H, W = self.info.frame_shape
        buf = np.empty((min(64, max(skip, 1)), H, W), np.uint8)
        while skip > 0:
            k = seq.read_chunk(min(64, skip), out=buf).shape[0]
            if k == 0:
                break
            skip -= k
        self._seq = seq

    def read_chunk(self, n: int, out: np.ndarray | None = None) -> np.ndarray:
        if self._retained:  # mirror pawsio: no plain reads over a live window
            raise IOError("non-retained read while frames are retained; release them first")
        if self._seq is not None:
            return self._seq.read_chunk(n, out=out)
        H, W = self.info.frame_shape
        if out is None or out.shape[0] < n:
            out = np.empty((n, H, W), np.uint8)
        state = [0]

        def sink(blk):
            g = state[0]
            out[g : g + blk.shape[0]] = blk
            state[0] = g + blk.shape[0]

        got = self._consume(n, sink)
        return out[:got]

    def read(self) -> np.ndarray | None:
        chunk = self.read_chunk(1)
        return chunk[0] if chunk.shape[0] else None

    # ---- retained-ROI protocol (mirrors NativeFrameSource's C++ ring) ------

    def advance_retained(self, n: int) -> int:
        """Pull up to ``n`` frames into the retained window without cropping."""
        return self._consume(n, lambda blk: self._retained.extend(blk))

    def _crop(self, frame, origin, ch, cw, fill, out):
        crop_with_fill(frame, origin, ch, cw, fill, out=out)

    @staticmethod
    def _origin_at(origin, i):
        """Origin for frame ``i``: per-frame ``[n, 2]`` array or one pair."""
        if isinstance(origin, np.ndarray) and origin.ndim == 2:
            return origin[i]
        return origin

    def read_roi_chunk_retained(
        self, n: int, origin, ch: int, cw: int, fill: int, out: np.ndarray | None = None
    ) -> np.ndarray:
        if out is None or out.shape[0] < n:
            out = np.empty((n, ch, cw), np.uint8)
        base = len(self._retained)
        k = self.advance_retained(n)
        for i in range(k):
            self._crop(self._retained[base + i], self._origin_at(origin, i),
                       ch, cw, fill, out[i])
        return out[:k]

    def read_roi_chunk(
        self, n: int, origin, ch: int, cw: int, fill: int, out: np.ndarray | None = None
    ) -> np.ndarray:
        """Crop-and-forget (contain mode): callers in this mode never retain,
        so the frames this call pulled are exactly the oldest and may be
        released immediately."""
        if self._retained:  # releasing after the crop would pop OLD frames
            raise IOError("read_roi_chunk while frames are retained; release them first")
        got = self.read_roi_chunk_retained(n, origin, ch, cw, fill, out=out)
        self.release(got.shape[0])
        return got

    def recrop(
        self, first: int, k: int, origin, ch: int, cw: int, fill: int,
        out: np.ndarray | None = None,
    ) -> np.ndarray:
        """Crop retained frames ``[first, first+k)`` (0 = oldest retained) at
        a new origin (one pair or per-frame ``[k, 2]``) — the
        mispredict-replay path."""
        if out is None or out.shape[0] < k:
            out = np.empty((k, ch, cw), np.uint8)
        m = max(0, min(int(k), len(self._retained) - int(first)))
        for i in range(m):
            self._crop(self._retained[int(first) + i], self._origin_at(origin, i),
                       ch, cw, fill, out[i])
        return out[:m]

    def release(self, n: int):
        """Free the ``n`` oldest retained frames (span buffers are reclaimed
        once their last retained view is dropped)."""
        for _ in range(min(int(n), len(self._retained))):
            self._retained.popleft()

    def close(self):
        if self._seq is not None:
            self._seq.close()
            self._seq = None
        if not self._threads:
            return
        with self._lock:
            self._stop_flag = True
        # unblock any worker waiting on the budget, then join
        for _ in self._threads:
            self._budget.release()
        for t in self._threads:
            t.join()
        if self._cur is not None:
            self._release_span(self._cur)
            self._cur = None
        self._spans.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
