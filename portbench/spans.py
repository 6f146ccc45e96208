"""What the span readers share: the spans a call's record carries, its
controller's thread, the spans under a span, and interval arithmetic.

The program records spans (``paws_stats["spans"]``: name, ``start_ns``,
``end_ns``, ``id``, ``parent``, ``call``, ``thread``, ``attrs``) only when a
profiler session is active as a call starts, which a ``--trace 1`` run's is.
Their times are ``time.time_ns()``, the clock of the session's device
intervals, so both are read with no offset. A program that records no spans
gives the readers nothing: each then returns None.
"""

from __future__ import annotations


def calls_with_spans(rec, stream: str | None = None) -> list:
    """``[(call, spans, controller thread), ...]``: the window's calls whose
    record carries spans (on ``stream`` only, when given); the controller is
    the thread of the call's root span ``call``."""
    out = []
    for c in rec.calls:
        st = c.get("stats")
        spans = None if st is None else st.get("spans")
        if not spans or (stream is not None and st.get("stream") != stream):
            continue
        root = next((s for s in spans if s.name == "call"), None)
        if root is not None:
            out.append((c, spans, root.thread))
    return out


def dur_ns(s) -> int:
    return s.end_ns - s.start_ns


def under(spans, top, thread=None) -> list:
    """The spans below ``top`` (its descendants), on ``thread`` only when given."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out, todo = [], [top.id]
    while todo:
        for s in kids.get(todo.pop(), ()):
            todo.append(s.id)
            if thread is None or s.thread == thread:
                out.append(s)
    return out


def merged(pairs) -> list:
    """The union of ``(start, end)`` pairs as sorted, disjoint ``[start, end]``."""
    out = []
    for s, e in sorted(pairs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def length(ivs) -> int:
    return sum(e - s for s, e in ivs)


def intersect(a, b) -> list:
    """The intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out
