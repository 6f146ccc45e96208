"""``mesh.shard_us_per_dispatch``: the controller's serial per-shard host
work, in us a dispatch.

The ``shard.*`` spans below each ROI call's ``pipeline`` span (each shard's
turn of the copies in, the launch, the results' copies back and the wait
for them, ``pipeline.py``'s ``_ShardedEngine`` and its engines), their
durations summed over the window's ROI calls, over their dispatches.
"""

from portbench.spans import calls_with_spans, dur_ns, under


def read(rec):
    calls = calls_with_spans(rec, "roi")
    dispatches = sum(c["stats"]["dispatches"] for c, _, _ in calls)
    if not dispatches:
        return None
    total = sum(dur_ns(s) for _, spans, _ in calls for p in spans if p.name == "pipeline"
                for s in under(spans, p) if s.name.startswith("shard."))
    return total / 1e3 / dispatches
