"""``roi.outside_us_per_dispatch``: the ROI controller's own Python, in us a dispatch.

Over the window's calls on the ROI stream: the call's wall time on the
harness's clock less every timer section the program recorded, summed, over
the dispatches (``pipeline.SpeculativePipeline``'s count, replays included).
"""


def read(rec):
    calls = [c for c in rec.calls if c["stats"] is not None and c["stats"]["stream"] == "roi"]
    dispatches = sum(c["stats"]["dispatches"] for c in calls)
    if not dispatches:
        return None
    outside = sum(c["wall_s"] - sum(c["stats"]["sections"].values()) for c in calls)
    return 1e6 * outside / dispatches
