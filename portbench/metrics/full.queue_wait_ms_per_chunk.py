"""``full.queue_wait_ms_per_chunk``: the full-frame controller's wait for the
prefetcher, in ms a chunk.

The controller thread's ``prefetch.wait`` spans (its ``next()`` on the
prefetcher's queue, ``ChunkPrefetcher.__iter__``) over the window's
full-frame calls, summed, over their chunk launches (``groups``): the base of
``full.wait_ms_per_chunk``, so the two compare directly.
"""

from portbench.spans import calls_with_spans, dur_ns


def read(rec):
    calls = [(c, spans, ctl) for c, spans, ctl in calls_with_spans(rec, "full")
             if c["stats"].get("groups")]
    groups = sum(c["stats"]["groups"] for c, _, _ in calls)
    if not groups:
        return None
    wait = sum(dur_ns(s) for _, spans, ctl in calls for s in spans
               if s.name == "prefetch.wait" and s.thread == ctl)
    return wait / 1e6 / groups
