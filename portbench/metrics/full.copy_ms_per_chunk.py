"""``full.copy_ms_per_chunk``: the staging copy, in ms a chunk.

The program's ``stage.copy`` spans (the prefetch thread's native copy of a
chunk's viewed frames into the pinned staging ring, ``io/decode.py``
``ChunkRing.read``) over the window's full-frame calls: their summed
durations over their count.
"""

from portbench.spans import calls_with_spans, dur_ns


def read(rec):
    copies = [dur_ns(s) for _, spans, _ in calls_with_spans(rec, "full")
              for s in spans if s.name == "stage.copy"]
    if not copies:
        return None
    return sum(copies) / len(copies) / 1e6
