"""``roi.replays_per_dispatch``: mispredicted chunks, a share of the dispatches.

Over the window's calls on the ROI stream: the chunks the speculative
pipeline dispatched again because the target left the crop its prediction
placed, over all its dispatches, the replayed ones included.
"""


def read(rec):
    calls = [c for c in rec.calls if c["stats"] is not None and c["stats"]["stream"] == "roi"]
    dispatches = sum(c["stats"]["dispatches"] for c in calls)
    if not dispatches:
        return None
    return sum(c["stats"]["replays"] for c in calls) / dispatches
