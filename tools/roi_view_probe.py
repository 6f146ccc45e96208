#!/usr/bin/env python3
"""What serving read-only views costs the ROI path, within one process.

    python3 tools/roi_view_probe.py [--runs 10] [--device cpu --frames 24]

Draws ``chip_smoke.py``'s 1080p bench clip and, in one process so that the
host's speed and the clip's pages are the same for both, times:

- ``track()`` on ROI (``stream="auto"``: 185x185 crops), alternating runs
  whose array sources serve read-only views (as shipped) with runs whose
  views are writable (the flag set back on each source's view), each run's
  wall time and timer sections (``paws_stats``);
- the chunk crop alone (``ops/roi_crop.py::crop_lanes_native``) over
  the clip's 12-frame chunks at the track's origins, from read-only and from
  writable views, alternating;
- frame 1's copy before its upload (``np.array(frame, order="C")``).

Prints the card's name and power limit, each median, the ratio, and, last,
one JSON object of the same numbers (also written to ``build/roi_view_probe.json``). ``--device
cpu`` rehearses it on the host (no time it prints is the card's).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the clip and the stats handler)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10, help="timed runs of each kind")
    ap.add_argument("--device", default=None, help="cpu to rehearse; the card by default")
    ap.add_argument("--frames", type=int, default=None, help="cut the clip to this many frames")
    args = ap.parse_args()

    import torch

    from pawsometracker_tpu_torch import IJ, track
    from pawsometracker_tpu_torch.io import decode
    from pawsometracker_tpu_torch.ops import roi_crop

    if args.device is None and not torch.cuda.is_available():
        print("roi_view_probe: no CUDA device; pass --device cpu to rehearse", file=sys.stderr)
        return 2
    card = cs.card_line() if args.device is None else f"rehearsal on {args.device}"
    print(card, flush=True)
    frames, truth = cs.synth_clip()
    frames = frames[:args.frames]
    stats_log = cs.StatsLog()
    logger = logging.getLogger("pawsometracker_tpu_torch")
    logger.addHandler(stats_log)
    logger.setLevel(logging.DEBUG)
    kw = dict(fps=cs.FPS, target_width=cs.TARGET_WIDTH, window_size=cs.WINDOW,
              device=args.device, start_location=IJ(int(truth[0][0]), int(truth[0][1])))
    init = decode.ArrayFrameSource.__init__

    def writable_init(self, *a, **k):
        init(self, *a, **k)
        if self.serves_views:
            self._zc_frames.flags.writeable = True

    def run(writable: bool) -> dict:
        decode.ArrayFrameSource.__init__ = writable_init if writable else init
        try:
            stats_log.all.clear()
            t0 = time.perf_counter()
            ij = track(frames, **kw)[1]
            if args.device is None:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            decode.ArrayFrameSource.__init__ = init
        st = stats_log.all[-1]
        sec = dict(st.get("sections", {}))
        sec["outside the sections"] = wall - sum(sec.values())
        return {"wall_s": wall, "ij": ij, "dispatches": st.get("dispatches", 1),
                "sections_s": sec}

    want = run(False)["ij"]  # warm-up: the kernel build, the engine choice
    rows = {"read-only": [], "writable": []}
    for i in range(args.runs):
        for kind in (("read-only", "writable") if i % 2 == 0 else ("writable", "read-only")):
            r = run(kind == "writable")
            if not np.array_equal(r.pop("ij"), want):
                raise SystemExit(f"{kind} views give other positions")
            rows[kind].append(r)

    # the crop alone, at the track's origins, from the two kinds of view (the
    # native crop on the card, the plain one in a rehearsal)
    crop = roi_crop.lane_cropper(args.device or "cuda")
    K, ch = 12, 185
    origins = np.clip(np.asarray(want, np.int64) - ch // 2, 0, None)
    out = np.empty((1, K, ch, ch), np.uint8)
    ro = frames.view()
    ro.flags.writeable = False
    starts = range(1, len(frames) - K + 1, K)
    crop_us = {"read-only": [], "writable": []}
    for i in range(max(args.runs, 10)):
        for kind in (("read-only", "writable") if i % 2 == 0 else ("writable", "read-only")):
            src = ro if kind == "read-only" else frames
            t0 = time.perf_counter()
            for s in starts:
                crop([src[s:s + K]], [K], origins[None, s:s + K], [128], out)
            crop_us[kind].append(1e6 * (time.perf_counter() - t0) / len(starts))
    copy_ms = []
    for _ in range(50):
        t0 = time.perf_counter()
        np.array(ro[0], order="C")
        copy_ms.append(1e3 * (time.perf_counter() - t0))

    def med(kind, key):
        return statistics.median(
            1e6 * r["sections_s"].get(key, 0.0) / max(r["dispatches"], 1) for r in rows[kind])

    keys = sorted({k for kind in rows for r in rows[kind] for k in r["sections_s"]})
    record = {"card": card, "runs": args.runs, "frame1_copy_ms": statistics.median(copy_ms)}
    for kind in rows:
        record[kind] = {
            "frames_per_s": statistics.median(len(frames) / r["wall_s"] for r in rows[kind]),
            "us_per_chunk": {k: med(kind, k) for k in keys},
            "crop_alone_us_per_chunk": statistics.median(crop_us[kind])}
        print(f"{kind} views: track ROI {record[kind]['frames_per_s']:.1f} frames/s, us a chunk: "
              + ", ".join(f"{k} {v:.1f}" for k, v in record[kind]["us_per_chunk"].items())
              + f"; the crop alone {record[kind]['crop_alone_us_per_chunk']:.1f} us a chunk",
              flush=True)
    record["read_only_over_writable"] = (record["read-only"]["frames_per_s"]
                                         / record["writable"]["frames_per_s"])
    print(f"read-only / writable frames/s {record['read_only_over_writable']:.3f}x; frame 1's"
          f" copy {record['frame1_copy_ms']:.3f} ms")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "roi_view_probe.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
