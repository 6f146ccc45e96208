#!/usr/bin/env python3
"""How often the measured engine choice flips between fresh processes on one card.

    python3 tools/engine_pick_stability.py [--runs 6] [--target-width 25] [--window 41]
                                           [--sweep 30,35,38]

Each run is a fresh process with an empty engine cache (a
``$PAWSOMETRACKER_CACHE`` of its own under ``build/``), as a user's first call
on a card is: it runs ``pick_bounded_engine`` and ``pick_bounded_engine_batch``
(B = 4) on the crop that the ROI pipeline cuts at 1080p for this target width
and window (185x185 for the bench's ``target_width=25``, window 41), with and
without subpixel, so each one measures ``dog_scan`` and ``dog_scan_tiled``
against the plain version and chooses; and ``pick_bounded_engine`` (one chain,
no subpixel) on the crop of each target width of ``--sweep`` at its default
window (``guess_window_size``; empty for none). The kernel library is built
once, in the checkout's ``build/kernels``, and shared by the runs.

Prints the card's name and power limit, one line per run and geometry (the
pick, both times and their ratio against the margin) and, per geometry, how
many runs picked each kernel and the ratio's least, median and largest
value; writes all of it to ``build/engine_pick_stability.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 1080, 1920
ROI_K = 12
B = 4


def child(target_width: int, window: int, sweep: list) -> None:
    sys.path.insert(0, ROOT)
    from pawsometracker_tpu_torch import pipeline as pl
    from pawsometracker_tpu_torch.models.dog_tracker import make_spec
    from pawsometracker_tpu_torch.ops.dog_kernel import guess_window_size

    spec = make_spec((H, W), window, target_width, True)
    ch, cw, _ = pl.roi_geometry(spec, ROI_K, 7, "predict")
    rspec = make_spec((ch, cw), spec.window_size, target_width, True)
    out = {}
    for batch in (None, B):
        for sub in (False, True):
            label = f"{ch}x{cw} " + ("L=1" if batch is None else f"B={batch}") \
                + (" +subpixel" if sub else "")
            if batch is None:
                _, info = pl.pick_bounded_engine(rspec, ROI_K, subpixel=sub)
            else:
                _, info = pl.pick_bounded_engine_batch(rspec, ROI_K, batch, subpixel=sub)
            out[label] = info
    for tw in sweep:
        spec = make_spec((H, W), guess_window_size(tw), tw, True)
        ch, cw, _ = pl.roi_geometry(spec, ROI_K, 7, "predict")
        rspec = make_spec((ch, cw), spec.window_size, tw, True)
        out[f"tw={tw} {ch}x{cw} L=1"] = pl.pick_bounded_engine(rspec, ROI_K)[1]
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--target-width", type=int, default=25)
    ap.add_argument("--window", type=int, default=41)
    ap.add_argument("--sweep", default="30,35,38",
                    help="target widths whose default-window crops are picked too")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    sweep = [int(t) for t in a.sweep.split(",") if t]
    if a.child:
        child(a.target_width, a.window, sweep)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    card = card[0] if card else "unknown card"
    print(card, flush=True)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    sys.path.insert(0, ROOT)
    from pawsometracker_tpu_torch.pipeline import ENGINE_MARGIN

    runs = []
    for i in range(a.runs):
        cache = tempfile.mkdtemp(prefix="engine_pick_", dir=build)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                            "--target-width", str(a.target_width), "--window", str(a.window),
                            "--sweep", a.sweep],
                           env=dict(os.environ, PAWSOMETRACKER_CACHE=cache), capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return 1
        infos = json.loads(r.stdout.strip().splitlines()[-1])
        for label, info in infos.items():
            ratio = info["dog_scan_tiled_ms"] / info["dog_scan_ms"]
            print(f"run {i} {label}: pick {info['kernel']}, dog_scan {info['dog_scan_ms']} ms,"
                  f" dog_scan_tiled {info['dog_scan_tiled_ms']} ms, ratio {ratio:.4f}"
                  f" (margin {ENGINE_MARGIN})", flush=True)
        runs.append(infos)
    summary = {}
    for label in runs[0]:
        picks = [r[label]["kernel"] for r in runs]
        ratios = [r[label]["dog_scan_tiled_ms"] / r[label]["dog_scan_ms"] for r in runs]
        summary[label] = {"picks": {k: picks.count(k) for k in sorted(set(picks))},
                          "ratio_min": min(ratios), "ratio_median": statistics.median(ratios),
                          "ratio_max": max(ratios), "margin": ENGINE_MARGIN}
        print(f"{label}: {summary[label]}", flush=True)
    with open(os.path.join(build, "engine_pick_stability.json"), "w") as f:
        json.dump({"card": card, "runs": runs, "summary": summary}, f, indent=1)
    print(json.dumps({"card": card, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
