"""``roi.self_us_per_dispatch``: the ROI controller's loop outside every
named span, in us a dispatch.

Per ROI call, the ``pipeline`` span's self time: its duration less the union
of its descendants on the controller thread (``dispatch``, ``drain``,
``replay`` and the sections and spans below them); summed over the window's
ROI calls, over their dispatches.
"""

from portbench.spans import calls_with_spans, dur_ns, intersect, length, merged, under


def read(rec):
    calls = calls_with_spans(rec, "roi")
    dispatches = sum(c["stats"]["dispatches"] for c, _, _ in calls)
    if not dispatches:
        return None
    self_ns = 0
    for _, spans, ctl in calls:
        for p in spans:
            if p.name == "pipeline" and p.thread == ctl:
                kids = merged((s.start_ns, s.end_ns) for s in under(spans, p, ctl))
                self_ns += dur_ns(p) - length(intersect(kids, [[p.start_ns, p.end_ns]]))
    return self_ns / 1e3 / dispatches
