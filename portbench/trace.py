"""From a ``torch.profiler`` session to device intervals, busy time and the
breakdown the result line carries.

The session records CUDA activity only (kernels, copies, sets), so the host
pays no per-operation tracing cost. Busy time is the union of the device's
intervals: a copy on a side stream that overlaps a kernel counts once.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Interval:
    start_ns: int
    end_ns: int
    device: int
    name: str
    kind: str  # "kernel", "memcpy", "memset"


def _kind(event, name: str) -> str:
    act = ""
    if hasattr(event, "activity_type"):
        act = str(event.activity_type()).lower()
    if "memcpy" in act or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in act or name.startswith("Memset"):
        return "memset"
    return "kernel"


def device_intervals(prof) -> list:
    """Every device activity of a finished session, as :class:`Interval` s
    sorted by start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            s, d = int(e.start_ns()), int(e.duration_ns())
        else:
            s, d = int(e.start_us()) * 1000, int(e.duration_us()) * 1000
        if d <= 0:
            continue
        name = e.name()
        out.append(Interval(s, s + d, int(e.device_index()), name, _kind(e, name)))
    out.sort(key=lambda iv: iv.start_ns)
    return out


def merged(intervals) -> list:
    """The union of ``intervals`` as sorted, disjoint ``[start_ns, end_ns]``."""
    spans = []
    for iv in sorted(intervals, key=lambda iv: iv.start_ns):
        if spans and iv.start_ns <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], iv.end_ns)
        else:
            spans.append([iv.start_ns, iv.end_ns])
    return spans


def union_s(intervals) -> float:
    """Seconds covered by at least one of ``intervals``."""
    return sum(e - s for s, e in merged(intervals)) / 1e9


def busy_s(intervals, devices) -> float:
    """The mean over ``devices`` of each one's busy seconds."""
    return sum(union_s([iv for iv in intervals if iv.device == d]) for d in devices) / len(devices)


def top_ops(intervals, n: int = 10) -> list:
    """``[[name, seconds], ...]``: the n device operations that took most time
    in all, longest first."""
    total: dict = {}
    for iv in intervals:
        key = iv.name[:120]
        total[key] = total.get(key, 0.0) + (iv.end_ns - iv.start_ns) / 1e9
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(intervals, calls, offset_ns: int, entry: str, n: int = 10) -> list:
    """``[[what the host was doing, seconds], ...]``: the n longest spans in
    which no card was busy, between the first call's start and the last one's
    end, each named by where the host was: between calls, in a call's set-up
    (its ``setup``, ``snap`` and ``buffers`` sections, which come first), or
    in its pipeline. ``offset_ns``: the device clock less the host's."""
    if not calls:
        return []
    lo, hi = calls[0]["start_ns"] + offset_ns, calls[-1]["end_ns"] + offset_ns
    gaps, prev = [], lo
    for s, e in merged(intervals) + [[hi, hi]]:
        if s > prev and prev < hi:
            gaps.append((prev, min(s, hi)))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) // 2 - offset_ns
        label = "harness, between calls"
        for c in calls:
            if c["start_ns"] <= mid <= c["end_ns"]:
                sec = (c.get("stats") or {}).get("sections", {})
                head = sum(sec.get(k, 0.0) for k in ("setup", "snap", "buffers"))
                into = (mid - c["start_ns"]) / 1e9
                label = (f"{entry} call, set-up (setup, snap, buffers)" if into < head
                         else f"{entry} call, pipeline")
                break
        out.append([label, (b - a) / 1e9])
    return out
