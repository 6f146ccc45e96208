"""``scan.roofline_pct``: the tracker scan's share of its roofline, in %.

The least time, at the card's peaks (``peaks.py``), of the scan work the
window's calls needed, as the configuration's entry module counts it
(``work``: for one disc a video, the snap of frame 1 and one step a later
frame; replays, padding and second snaps are work the inputs do not need);
over the device time of every CUDA kernel in the window, whatever its name.
Nothing to read without kernels.
"""

from portbench import frames
from portbench.peaks import cost


def read(rec):
    kernel_s = sum(iv.end_ns - iv.start_ns for iv in rec.intervals if iv.kind == "kernel") / 1e9
    if kernel_s <= 0:
        return None
    entry = frames.load_module("entries", rec.config["entry"])
    need = 0.0
    for c in rec.calls:
        if c["out"] is None:
            continue
        bounded = c["stats"] is not None and c["stats"]["stream"] == "roi"
        for w in entry.work(rec.config, c["videos"], c["out"], bounded):
            need += cost(**w)["bound_s"]
    return 100.0 * need / kernel_s
