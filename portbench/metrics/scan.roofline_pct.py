"""``scan.roofline_pct``: the tracker scan's share of its roofline, in %.

The least time, at the card's peaks (``peaks.py``), of the scan work the
window's calls needed: for each target of each video of each call, the snap
of frame 1 (a quarter-frame window when it autodetects, else the configured
one) and one step a later frame at the configured window and taps; over the
device time of every CUDA kernel in the window, whatever its name. Replays,
padding and the second snap a batch makes where any video autodetects are
work the inputs do not need, and are not counted. Nothing to read without
kernels.
"""

from portbench.peaks import cost
from portbench.reference.tracker import taps


def read(rec):
    kernel_s = sum(iv.end_ns - iv.start_ns for iv in rec.intervals if iv.kind == "kernel") / 1e9
    if kernel_s <= 0:
        return None
    cfg = rec.config
    H, W = int(cfg["height"]), int(cfg["width"])
    r = int(cfg["window_size"]) // 2
    L = taps(float(cfg["target_width"]), True)[2]
    need = 0.0
    for c in rec.calls:
        if c["out"] is None:
            continue
        bounded = c["stats"] is not None and c["stats"]["stream"] == "roi"
        for (ts, ij), (frames, auto) in zip(c["out"], c["videos"]):
            lanes = ij.shape[1] if ij.ndim == 3 else 1  # targets of one video
            snap = (H // 4 // 2, W // 4 // 2) if auto else (r, r)
            need += cost(snap, L, 1, lanes=lanes)["bound_s"]
            need += cost((r, r), L, len(ij) - 1, bounded=bounded, lanes=lanes)["bound_s"]
    return 100.0 * need / kernel_s
