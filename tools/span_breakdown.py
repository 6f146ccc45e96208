"""Where a traced benchmark run's idle card time goes, by the program's spans.

    python3 tools/span_breakdown.py --cell track-roi-1080 --seeds 11 12 13 \
        [--seconds 51] [--out build/spans_track-roi-1080.json]

On a machine with the cards the cell asks for. Each seed is one traced run of
the cell through the benchmark's own harness (``portbench/harness.py``, the
metrics of ``BENCHMARK.json``), from which this reads, beside the result
line's metrics:

- per card, the card's idle time inside the window's calls, by the
  controller's innermost span (``no span below pipeline`` where that is
  ``call`` or ``pipeline``, ``outside the call span`` where the harness's call
  wall holds no span);
- the spans a dispatch (ROI) or a chunk launch (full frames) records;
- the checks that hold the span readings against the remainders they split;
- the offset between ``time.time_ns()`` and the device trace that the
  harness's own marker gives (its session's first device event, a
  ``zeros(1).add_(1)`` after a host stamp).

Once a process it also times a span with recording on (under a profiler
session of CUDA activity, as the harness's) and off, and brackets the offset
between ``time.time_ns()`` and the device trace's clock without the
marker's own launch latency: in one session, tiny kernels each launched
between two host stamps ``t0`` and ``t1``, the card idle before each; a
kernel cannot start before its launch began, so the offset is at most the
least ``start - t0``, and at least the least ``start - t1`` less the time the
card takes to start a kernel it has been handed. It also repeats the
harness's marker in fresh sessions (:func:`clock_probe`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import frames, harness  # noqa: E402
from portbench import trace as tracing  # noqa: E402
from portbench.spans import calls_with_spans, dur_ns, intersect, length, merged  # noqa: E402

NO_SPAN = "no span below pipeline"
OUTSIDE = "outside the call span"


def innermost(spans, ctl, lo, hi) -> list:
    """``[[start, end, name], ...]`` covering ``[lo, hi]``: the controller
    thread's innermost open span at each moment."""
    own = sorted((s for s in spans if s.thread == ctl), key=lambda s: (s.start_ns, -s.end_ns))
    out, stack, t = [], [], lo

    def emit(upto):
        nonlocal t
        if upto > t:
            name = stack[-1].name if stack else OUTSIDE
            out.append([t, upto, NO_SPAN if name in ("call", "pipeline") else name])
            t = upto

    for s in own:
        while stack and stack[-1].end_ns <= s.start_ns:
            emit(stack[-1].end_ns)
            stack.pop()
        emit(max(s.start_ns, t))
        stack.append(s)
    while stack:
        emit(stack[-1].end_ns)
        stack.pop()
    emit(hi)
    return [p for p in out if p[0] >= lo and p[1] <= hi]


def idle_by_span(rec) -> dict:
    """Per card, ``{name: idle seconds}`` inside the calls, and the total."""
    parts = []
    for c, spans, ctl in calls_with_spans(rec):
        parts += innermost(spans, ctl, c["start_ns"], c["end_ns"])
    parts.sort()
    inside = merged((c["start_ns"], c["end_ns"]) for c, _, _ in calls_with_spans(rec))
    out = {}
    for d in rec.cards:
        busy = merged((iv.start_ns, iv.end_ns) for iv in rec.intervals if iv.device == d)
        idle = [[a, b] for a, b in _minus(inside, busy)]
        by, j = {}, 0
        for a, b, name in parts:
            while j < len(idle) and idle[j][1] <= a:
                j += 1
            k = j
            while k < len(idle) and idle[k][0] < b:
                by[name] = by.get(name, 0) + max(0, min(b, idle[k][1]) - max(a, idle[k][0]))
                k += 1
        out[d] = {"idle_s": length(idle) / 1e9,
                  "by_span_s": {k: v / 1e9 for k, v in sorted(by.items(), key=lambda kv: -kv[1])}}
    return out


def _minus(a, b) -> list:
    """``a`` less ``b``, both sorted and disjoint."""
    out = []
    for s, e in a:
        cur = s
        for bs, be in intersect([[s, e]], b):
            if bs > cur:
                out.append([cur, bs])
            cur = be
        if cur < e:
            out.append([cur, e])
    return out


def counts(rec) -> dict:
    """Spans a dispatch (ROI) or a chunk launch (full frames), the
    per-dispatch time of the lanes' waits for their prefetchers, and the
    staging copies (``stage.copy``) by their ``form``."""
    out = {}
    forms: dict = {}
    for _, spans, _ in calls_with_spans(rec):
        for s in spans:
            if s.name == "stage.copy":
                form = str((s.attrs or {}).get("form"))
                forms[form] = forms.get(form, 0) + 1
    if forms:
        out["stage_copy_forms"] = forms
    for stream, base in (("roi", "dispatches"), ("full", "groups")):
        calls = calls_with_spans(rec, stream)
        n = sum(c["stats"].get(base, 0) for c, _, _ in calls)
        if n:
            out[f"spans_per_{base}"] = sum(len(s) for _, s, _ in calls) / n
            out[f"prefetch_wait_us_per_{base}"] = sum(
                dur_ns(s) for _, spans, ctl in calls for s in spans
                if s.name == "prefetch.wait" and s.thread == ctl) / 1e3 / n
            out["spans_per_call"] = sum(len(s) for _, s, _ in calls) / len(calls)
    return out


def span_cost(n: int = 200_000) -> dict:
    """ns a span costs with recording off, and on under a session of CUDA
    activity (the harness's), each the best of 3 loops of ``n``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pawsometracker_tpu_torch.utils.profiling import Timer

    def loop(timer):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter_ns()
            for i in range(n):
                with timer.span("x", seq=i):
                    pass
            best = min(best, (time.perf_counter_ns() - t0) / n)
            if timer.spans is not None:
                timer.spans.clear()
        return best

    off = loop(Timer())
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    with profile(activities=acts):
        on = loop(Timer())
    return {"off_ns": off, "on_ns": on}


def _kernels(prof) -> list:
    """``[(start_ns, name), ...]`` of a finished session's device events."""
    from torch.autograd import DeviceType

    return sorted((int(e.start_ns()) if hasattr(e, "start_ns") else int(e.start_us()) * 1000,
                   e.name()) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)


def clock_probe(k: int = 100, markers: int = 10) -> dict:
    """The bracket (us): ``start - t0`` and ``start - t1`` of ``k`` kernels
    launched 2 ms apart, each matched to the launch whose ``t0`` is the last
    before its start (+1 ms), the least and the median. And the harness's
    marker ``markers`` times, each in a fresh session: its fill kernel's
    start less the stamp, and whether the session's first device event was
    that kernel."""
    import bisect
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    stamps = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(k):
            torch.cuda.synchronize()
            time.sleep(0.002)
            t0 = time.time_ns()
            torch.cuda._sleep(100)
            stamps.append((t0, time.time_ns()))
        torch.cuda.synchronize()
    t0s = [t0 for t0, _ in stamps]
    a0, a1 = [], []
    for start, _ in _kernels(prof):
        i = bisect.bisect_right(t0s, start + 1_000_000) - 1
        if i >= 0:
            a0.append((start - stamps[i][0]) / 1e3)
            a1.append((start - stamps[i][1]) / 1e3)
    out = {"kernels": len(a0), "of": k, "after_t0_us": [min(a0), statistics.median(a0)],
           "after_t1_us": [min(a1), statistics.median(a1)],
           "launch_us": statistics.median((t1 - t0) / 1e3 for t0, t1 in stamps), "markers": []}
    for _ in range(markers):
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        torch.cuda.synchronize()
        mark_ns = time.time_ns()
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.stop()
        evs = _kernels(prof)
        fill = [t for t, name in evs if "Fill" in name]
        out["markers"].append({"events": len(evs),
                               "first_us": (evs[0][0] - mark_ns) / 1e3 if evs else None,
                               "fill_us": (fill[0] - mark_ns) / 1e3 if fill else None})
    return out


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    started = harness.process_start()
    out = {"cell": args.cell, "card": card(), "runs": []}
    seen = {}
    load, gaps = frames.load_module, tracing.idle_gaps

    class Capture:
        @staticmethod
        def read(rec):
            seen["rec"] = rec

    def idle_gaps(intervals, calls, offset_ns, *a, **k):  # the harness's marker offset
        seen["offset_ns"] = offset_ns
        return gaps(intervals, calls, offset_ns, *a, **k)

    frames.load_module = lambda kind, name: Capture if name == "_capture" else load(kind, name)
    tracing.idle_gaps = idle_gaps
    specs = harness.metrics_of(args.cell, True) + [{"name": "_capture", "unit": "-"}]
    for seed in args.seeds:
        result = harness.run(args.cell, seed, args.seconds, True, started=started,
                             metric_specs=specs)
        rec = seen.pop("rec")
        m = {k: v["value"] for k, v in result["metrics"].items()}
        run = {"seed": seed, "correct": result["correct"], "metrics": m,
               "marker_offset_us": seen.pop("offset_ns") / 1e3,
               "busy_s": result["device"]["busy_s"], "window_s": result["device"]["window_s"],
               "calls": len(rec.calls), "idle": idle_by_span(rec), **counts(rec)}
        checks = {}
        if "full.wait_ms_per_chunk" in m and "full.queue_wait_ms_per_chunk" in m:
            checks["queue_wait <= wait"] = m["full.queue_wait_ms_per_chunk"] \
                <= m["full.wait_ms_per_chunk"]
        if "roi.outside_us_per_dispatch" in m and "roi.self_us_per_dispatch" in m:
            checks["self <= outside"] = m["roi.self_us_per_dispatch"] \
                <= m["roi.outside_us_per_dispatch"]
        if "roi.crop_us_per_dispatch" in m and "prefetch_wait_us_per_dispatches" in run:
            checks["crop >= lanes' prefetch.wait"] = m["roi.crop_us_per_dispatch"] \
                >= run["prefetch_wait_us_per_dispatches"]
        run["checks"] = checks
        out["runs"].append(run)
        print(json.dumps(run), flush=True)
    out["span_cost"] = span_cost()
    out["clock"] = clock_probe()
    print(json.dumps({"card": out["card"], "span_cost": out["span_cost"], "clock": out["clock"]}),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
