#!/usr/bin/env python3
"""Where the host's time goes in one ROI call of the port, by Python function.

    python3 tools/roi_host_profile.py [--device cpu] [--frames N] [--top 20]

Draws ``chip_smoke.py``'s 1080p clips (``track_batch``'s four videos, each a
disc on its own background, ``track_multi``'s clip with four discs; ``--frames``
long, 160 by default; and ``track()``'s 480-frame bench clip), runs
``track_batch``, ``track_multi`` and ``track_resumable`` (the bench clip in
``chip_smoke.py``'s 4 slices of 120 frames, a fresh checkpoint each call) once
each on ``stream="auto"`` (the ROI pipeline at 1080p) to warm up, then once
more under ``cProfile``, and prints for each call its wall time, its timer
sections (the ``paws_stats`` it logs, summed over the slices of
``track_resumable``), and the functions with the most time of their own and
the most time in all. ``cProfile`` adds a cost to every Python call, so its
shares show where to look and are not timings. Runs on the card unless
``--device cpu`` is given (a rehearsal at a few frames: the plain version is
slow there).
"""

from __future__ import annotations

import argparse
import cProfile
import io
import logging
import os
import pstats
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the clips and the stats handler)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu for a rehearsal; the card by default")
    ap.add_argument("--frames", type=int, default=160, help="frames of each clip")
    ap.add_argument("--top", type=int, default=20, help="functions listed per table")
    args = ap.parse_args()

    import torch

    from pawsometracker_tpu_torch import IJ, track_batch, track_multi, track_resumable

    if args.device is None:
        if not torch.cuda.is_available():
            print("roi_host_profile: no CUDA device; pass --device cpu to rehearse",
                  file=sys.stderr)
            return 2
        print(cs.card_line())
    n = args.frames
    paths = [cs.circle_path(n, b * np.pi / 2) for b in range(4)]
    clips = [cs.draw_discs(np.full((n, cs.H, cs.W), bg, np.uint8), [p])
             for p, bg in zip(paths, cs.BATCH_FILLS)]
    multi = cs.draw_discs(np.full((n, cs.H, cs.W), 128, np.uint8), paths)
    locs = [IJ(int(p[0][0]), int(p[0][1])) for p in paths]
    kw = dict(fps=cs.FPS, target_width=cs.TARGET_WIDTH, window_size=cs.WINDOW,
              device=args.device)
    stats_log = cs.StatsLog()
    port_logger = logging.getLogger("pawsometracker_tpu_torch")
    port_logger.addHandler(stats_log)
    port_logger.setLevel(logging.DEBUG)
    bench, truth = cs.synth_clip()
    work = tempfile.TemporaryDirectory(prefix="roi_host_profile_", dir=os.path.join(ROOT, "build"))
    checkpoint = os.path.join(work.name, "cp.npz")

    def resumable():
        if os.path.exists(checkpoint):
            os.remove(checkpoint)
        track_resumable(bench, checkpoint_path=checkpoint, checkpoint_every=cs.CHECKPOINT_EVERY,
                        start_location=IJ(int(truth[0][0]), int(truth[0][1])), **kw)

    for name, call in (("track_batch", lambda: track_batch(clips, start_location=locs, **kw)),
                       ("track_multi", lambda: track_multi(multi, locs, **kw)),
                       ("track_resumable", resumable)):
        call()  # warm-up: kernel build, caches, allocator
        prof = cProfile.Profile()
        stats_log.all.clear()
        t0 = time.perf_counter()
        prof.enable()
        call()
        prof.disable()
        wall = time.perf_counter() - t0
        sections: dict = {}
        for st in stats_log.all:  # one a call, one a slice for track_resumable
            for k, v in st.get("sections", {}).items():
                sections[k] = round(sections.get(k, 0.0) + 1e3 * v, 2)
        print(f"\n== {name} on {stats_log.all[-1].get('stream')}: wall {1e3 * wall:.1f} ms under"
              f" cProfile, {len(stats_log.all)} track() run(s),"
              f" {sum(st.get('dispatches', 0) for st in stats_log.all)} dispatches,"
              f" sections (ms): {sections}")
        for key in ("tottime", "cumulative"):
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats(key).print_stats(args.top)
            lines = out.getvalue().splitlines()
            start = next(i for i, line in enumerate(lines) if line.lstrip().startswith("ncalls"))
            print(f"-- by {key}")
            print("\n".join(line.replace(ROOT + "/", "") for line in lines[start:] if line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
