"""``roi.crop_us_per_dispatch``: the ROI lanes' crops, in us a dispatch.

The program's ``crop`` section (the native crop of ``csrc/roi_crop.cpp``,
replays' crops included) over the window's ROI calls, over their dispatches.
"""


def read(rec):
    calls = [c for c in rec.calls if c["stats"] is not None and c["stats"]["stream"] == "roi"]
    dispatches = sum(c["stats"]["dispatches"] for c in calls)
    if not dispatches:
        return None
    return 1e6 * sum(c["stats"]["sections"].get("crop", 0.0) for c in calls) / dispatches
