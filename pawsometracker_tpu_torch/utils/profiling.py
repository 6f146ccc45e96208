"""The port's one tracing mechanism: :class:`Timer`, and :func:`trace` around it.

A :class:`Timer` is made once per entry call. Its sections (:meth:`Timer.section`)
keep one wall-clock total per name, which every call reports as
``paws_stats["sections"]``. When a ``torch.profiler`` session is active as the
timer is made, it is also a span recorder: each section, and each
:meth:`Timer.span`, records a :class:`Span` stamped with ``time.time_ns()``,
the clock the profiler stamps its own events with, so spans and the session's
device intervals line up with no calibration. The spans stay in memory and go
out once, at the end of the call, as ``paws_stats["spans"]``. Without a
session :meth:`Timer.span` returns one shared do-nothing context manager.

``trace`` captures a ``torch.profiler`` trace (host and CUDA activity) of the
block into a Chrome-trace file, the program's spans among its events.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import NamedTuple

__all__ = ["trace", "Timer", "Span"]

#: span ids and call ids, per process (``next`` on a count is atomic under the GIL)
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)


class Span(NamedTuple):
    """One recorded span: its name, start and end in ``time.time_ns()``
    nanoseconds, its id, the id of the span that caused it (0 for a call's
    root), the call id every span of one entry call shares, the name of the
    thread it ran on, and small attributes (a dispatch's ``seq``, a ``lane``,
    a ``shard``), or None."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    call: int
    thread: str
    attrs: dict | None


class Spans(list):
    """A call's spans; its repr is a count, so a record that logs them stays
    one line."""

    def __repr__(self):
        return f"<{len(self)} spans>"


class _Off:
    """The shared do-nothing span of a timer that records none."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs):
        pass


_OFF = _Off()
_new_span = tuple.__new__  # a Span without NamedTuple's argument handling


class _Open:
    """A span being recorded on the thread that entered it."""

    __slots__ = ("timer", "name", "attrs", "id", "parent", "start", "stack", "thread")

    def __init__(self, timer, name, attrs):
        self.timer, self.name, self.attrs = timer, name, attrs or None

    def __enter__(self):
        self.stack, self.thread = self.timer._here()
        self.parent = self.stack[-1]
        self.id = next(_span_ids)
        self.stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        self.timer.spans.append(_new_span(Span, (self.name, self.start, end, self.id, self.parent,
                                                 self.timer.call, self.thread, self.attrs)))
        return False

    def note(self, **attrs):
        """Add ``attrs`` learnt inside the span (a copy's ``form``)."""
        self.attrs = {**(self.attrs or {}), **attrs}


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is active (torch's own fast
    Python flag, or its C++ state)."""
    import torch

    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
                or torch._C._autograd._profiler_enabled())


class Timer:
    """Wall-clock section totals for host-side pipeline accounting and, under
    a profiler session, the call's spans.

    ``Timer(**attrs)`` under a session opens the call's root span ``call``
    with ``attrs`` on the thread that makes it; :meth:`finish` closes it and
    hands the spans out. Each thread keeps its own stack of open spans; a
    thread another one starts takes the span given to :meth:`adopt` as its
    spans' parent."""

    def __init__(self, **attrs):
        self.totals: dict[str, float] = {}
        self.spans: Spans | None = None
        self.call = 0
        if not _profiling():
            return
        self.spans = Spans()
        self.call = next(_call_ids)
        self._local = threading.local()
        self._root = _Open(self, "call", attrs)
        self._root.__enter__()

    def _here(self) -> tuple:
        """This thread's stack of open span ids and its name."""
        local = self._local
        try:
            return local.stack, local.name
        except AttributeError:
            local.stack, local.name = [0], threading.current_thread().name
            return local.stack, local.name

    @contextlib.contextmanager
    def section(self, name: str):
        """Add the block's wall time to ``totals[name]``; and record it as a
        span of that name when recording."""
        t0 = time.perf_counter()
        try:
            if self.spans is None:
                yield
            else:
                with _Open(self, name, None):
                    yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def span(self, name: str, **attrs):
        """A span of the block, with ``attrs``, and any its ``note`` adds
        inside it; it adds nothing to ``totals``. When not recording, one
        shared context manager that does nothing."""
        if self.spans is None:
            return _OFF
        return _Open(self, name, attrs)

    def current(self) -> int:
        """The id of the innermost open span on this thread (0: none)."""
        return 0 if self.spans is None else self._here()[0][-1]

    def adopt(self, parent: int) -> None:
        """Make ``parent`` (a :meth:`current` from the thread that started this
        one) the parent of this thread's spans."""
        if self.spans is not None:
            self._local.stack, self._local.name = [parent], threading.current_thread().name

    def finish(self, stats: dict) -> None:
        """End the call: close its root span, with the stream of ``stats``,
        and put the spans in ``stats["spans"]``. Nothing without a session."""
        if self.spans is None:
            return
        self._root.attrs = {**(self._root.attrs or {}), "stream": stats.get("stream")}
        self._root.__exit__(None, None, None)
        stats["spans"] = self.spans


class _OffTimer(Timer):
    """A timer that records nothing, whatever session is active."""

    def __init__(self):
        self.totals, self.spans, self.call = {}, None, 0


#: the timer of code run without a call's timer
OFF = _OffTimer()


class _SpanLog(logging.Handler):
    """Collects the spans of the port's ``paws_stats`` records."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.spans: list = []

    def emit(self, record):
        stats = getattr(record, "paws_stats", None)
        if stats is not None:
            self.spans.extend(stats.get("spans", ()))


def _chrome_events(spans, base_ns: int) -> list:
    """``spans`` as Chrome-trace complete events on a trace whose times are
    microseconds after ``base_ns``: one process, one track a thread."""
    pid = "pawsometracker spans"
    tids: dict = {}
    events = []
    for s in spans:
        tid = tids.setdefault(s.thread, len(tids))
        args = {"id": s.id, "parent": s.parent, "call": s.call, **(s.attrs or {})}
        events.append({"ph": "X", "cat": "paws", "name": s.name, "pid": pid, "tid": tid,
                       "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}} for name, tid in tids.items()]
    return events


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of everything inside the block into
    ``log_dir/trace.json``, with the spans of the port's calls made inside it
    (read from their ``paws_stats`` records, so the port's logger is at debug
    level meanwhile) as complete events, one track a thread."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    log = logging.getLogger("pawsometracker_tpu_torch")
    handler, level = _SpanLog(), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_chrome_events(handler.spans, int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)
