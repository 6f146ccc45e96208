"""``device.idle_named_pct``: how much of the card's idle time inside the
calls the program's spans name, in %.

Per card: of the time inside the window's calls (the harness's call walls)
in which the card ran nothing (no device interval), the share in which the
controller thread was inside a span other than ``call`` and ``pipeline``;
the mean over the cards the cell uses. Spans and device intervals are on one
clock, read with no offset.
"""

from portbench.spans import calls_with_spans, intersect, length, merged


def read(rec):
    calls = calls_with_spans(rec)
    if not rec.cards or not calls:
        return None
    inside = merged((c["start_ns"], c["end_ns"]) for c, _, _ in calls)
    named = intersect(inside, merged((s.start_ns, s.end_ns) for _, spans, ctl in calls
                                     for s in spans if s.thread == ctl
                                     and s.name not in ("call", "pipeline")))
    shares = []
    for d in rec.cards:
        busy = merged((iv.start_ns, iv.end_ns) for iv in rec.intervals if iv.device == d)
        idle = length(inside) - length(intersect(inside, busy))
        if idle <= 0:
            continue
        shares.append((length(named) - length(intersect(named, busy))) / idle)
    return 100.0 * sum(shares) / len(shares) if shares else None
