#!/usr/bin/env python3
"""Time the host work of two checkouts of the port on one card, in turns.

    python3 tools/host_path_ab.py --parent DIR [--order parent,change,change,parent]
                                  [--runs 3] [--cells "track ROI,track"]
                                  [--device cpu --frames 14]

Each turn is a fresh process that imports ``pawsometracker_tpu_torch`` from
one checkout (``change`` is this one, ``parent`` is ``--parent``, for example
a ``git archive`` of the parent commit unpacked under ``build/``, which
``.gitignore`` lists), builds its kernels into a build directory of its own
and keeps its engine decisions in a cache of its own. It draws
``chip_smoke.py``'s 1080p clips and drives through the public entry points
the four ROI cells of ``chip_smoke.py`` phase 3 on ``stream="auto"``:
``track`` ROI (185x185 crops), ``track`` of the large target ROI
(``target_width=60``, 461x461), ``track_batch`` ROI (4 videos) and
``track_multi`` ROI (4 targets); ``track_resumable`` ROI (the bench clip in 4
slices of 120 frames); the four full-frame cells on ``stream="full"``:
``track``, ``track`` of the large target, ``track_batch`` and ``track_multi``;
and ``track resampled``, ``track`` on full frames of the bench clip with each
frame twice at ``input_fps`` 48, which the resampler walks (every other frame
kept), so its frames are written into the prefetcher's buffers as a decoder's
are. ``--cells`` picks some of them. Each cell runs once to warm up, then
``--runs`` times; each run's wall time and the timer sections the call logs
(``paws_stats``, summed over the slices of ``track_resumable``) are kept.
Every turn's positions and ``ts`` must equal the first turn's.

Host speed drifts within a call, and a fresh process may run faster or
slower as a whole, so each cell's line also gives, for each pair of turns
in the order (turns 0-1, 2-3, ...), the change's turn median over the
parent's: with an order such as ``p,c,c,p,c,p,p,c`` every pair holds one
turn of each and a drift cancels. Two checkouts of the same tree give the
spread a null difference shows. The state each checkout's turns ran in, the
hash of its built kernel libraries and its engine decisions, is printed
beside them.

Prints the card's name and power limit, one line per cell with each
checkout's median frames/s over its runs (each turn's median beside it) and
the medians of its set-up (ms a call) and of outside the sections, crop,
device and upload (us a chunk), the pairs' ratios, and, last, one JSON object
of the same numbers. Writes ``build/host_path_ab.json``. ``--device cpu --frames N``
rehearses it on the host with each clip cut to N frames (the plain version is
slow there, and no time it prints is the card's).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("track ROI", "track large target ROI", "track_batch ROI", "track_multi ROI",
         "track_resumable ROI", "track", "track large target", "track_batch", "track_multi",
         "track resampled")
#: the timer sections read a chunk (the rest are once a call)
PER_CHUNK = ("outside the sections", "crop", "device", "upload", "aim", "drain")


def _chip_smoke():
    """``chip_smoke.py`` of this checkout, for its clips and its stats handler."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str, out_path: str, runs: int, device, n, cells) -> int:
    """One turn: ``cells`` on the checkout at ``root``, on ``device`` (the card
    when None), each clip cut to ``n`` frames when given, written to
    ``out_path``."""
    import numpy as np
    import torch

    cs = _chip_smoke()
    sys.path.insert(0, root)
    from pawsometracker_tpu_torch import IJ, track, track_batch, track_multi, track_resumable

    stats_log = cs.StatsLog()
    port_logger = logging.getLogger("pawsometracker_tpu_torch")
    port_logger.addHandler(stats_log)
    port_logger.setLevel(logging.DEBUG)
    cut = slice(None, n)
    frames, truth = cs.synth_clip()
    large = cs.synth_large()[0][cut]
    frames = frames[cut]
    clips, truths = cs.synth_batch()
    clips = [c[cut] for c in clips]
    multi, multi_truths = cs.synth_multi()
    multi = multi[cut]
    doubled = np.repeat(frames, 2, axis=0)  # at input_fps 2 * FPS: the walk keeps every other
    roi = dict(fps=cs.FPS, target_width=cs.TARGET_WIDTH, window_size=cs.WINDOW, device=device)
    start = IJ(int(truth[0][0]), int(truth[0][1]))
    full = dict(roi, stream="full")
    cp = os.path.join(os.path.dirname(out_path), "host_ab_resumable.npz")

    def resumable():
        if os.path.exists(cp):
            os.remove(cp)
        return track_resumable(frames, checkpoint_path=cp, start_location=start,
                               checkpoint_every=cs.CHECKPOINT_EVERY, **roi)

    calls = {
        "track ROI": (len(frames), lambda: track(frames, start_location=start, **roi)),
        "track large target ROI": (len(large), lambda: track(
            large, start_location=start, fps=cs.FPS, target_width=cs.LARGE_TW, device=device)),
        "track_batch ROI": (sum(map(len, clips)), lambda: track_batch(
            clips, start_location=[IJ(int(t[0][0]), int(t[0][1])) for t in truths], **roi)),
        "track_multi ROI": (len(multi), lambda: track_multi(
            multi, [IJ(int(t[0][0]), int(t[0][1])) for t in multi_truths], **roi)),
        "track_resumable ROI": (len(frames), resumable),
        "track": (len(frames), lambda: track(frames, start_location=start, **full)),
        "track large target": (len(large), lambda: track(
            large, start_location=start, fps=cs.FPS, target_width=cs.LARGE_TW, stream="full",
            device=device)),
        "track_batch": (sum(map(len, clips)), lambda: track_batch(
            clips, start_location=[IJ(int(t[0][0]), int(t[0][1])) for t in truths], **full)),
        "track_multi": (len(multi), lambda: track_multi(
            multi, [IJ(int(t[0][0]), int(t[0][1])) for t in multi_truths], **full)),
        "track resampled": (len(frames), lambda: track(
            doubled, start_location=start, input_fps=2 * cs.FPS, **full)),
    }
    out = {"cells": {}}
    for cell in cells:
        n_frames, call = calls[cell]
        result = call()  # warm-up: the kernel build, the engine choice, caches
        if device is None:
            torch.cuda.synchronize()
        pairs = result if isinstance(result, list) else [result]
        digest = hashlib.sha256()
        for ts, ij in pairs:
            digest.update(np.ascontiguousarray(ts).tobytes())
            digest.update(np.ascontiguousarray(ij).tobytes())
        rows = []
        for _ in range(runs):
            stats_log.all.clear()
            t0 = time.perf_counter()
            call()
            if device is None:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sts = list(stats_log.all) or [{}]  # a call's records (one a slice)
            sec = {}
            for st in sts:
                for k, v in st.get("sections", {}).items():
                    sec[k] = sec.get(k, 0.0) + v
            sec["outside the sections"] = wall - sum(sec.values())
            disp = [st["dispatches"] for st in sts if "dispatches" in st]
            # a full-frame call's chunks: its frames after the first over the chunk
            chunk = cs.MULTI_CHUNK if cell == "track_multi" else cs.CHUNK
            chunks = sum(disp) if disp else math.ceil((n_frames - 1) / chunk)
            rows.append({"wall_s": wall, "frames_per_s": n_frames / wall,
                         "dispatches": chunks, "sections_s": sec,
                         "stream": sts[-1].get("stream"), "calls": len(sts)})
        out["cells"][cell] = {"digest": digest.hexdigest(), "runs": rows}
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def slot_state(out_dir: str, who: str) -> dict:
    """The state ``who``'s turns ran in: a hash of the kernel libraries built
    in its build directory, and the engine decisions in its cache."""
    digest = hashlib.sha256()
    build = os.path.join(out_dir, f"host_ab_{who}")
    for name in sorted(os.listdir(build)) if os.path.isdir(build) else []:
        if name.endswith(".so"):
            with open(os.path.join(build, name), "rb") as f:
                digest.update(name.encode() + f.read())
    try:
        with open(os.path.join(out_dir, f"host_ab_cache_{who}", "engine_cache_torch.json")) as f:
            engine = {key: entry.get("engine") for key, entry in json.load(f).items()}
    except (OSError, ValueError, AttributeError):
        engine = None
    return {"kernels": digest.hexdigest()[:16], "engine": engine}


def summarize(runs: list) -> dict:
    """Medians over ``runs``: frames/s, set-up and upload ms a call, sections us
    a chunk."""
    row = {"frames_per_s": statistics.median(r["frames_per_s"] for r in runs),
           "setup_ms_per_call": statistics.median(1e3 * r["sections_s"].get("setup", 0.0)
                                                  for r in runs),
           "upload_ms_per_call": statistics.median(1e3 * r["sections_s"].get("upload", 0.0)
                                                   for r in runs)}
    for k in PER_CHUNK:
        row[f"{k} us_per_chunk"] = statistics.median(
            1e6 * r["sections_s"].get(k, 0.0) / max(r["dispatches"] or 1, 1) for r in runs)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the other checkout (e.g. the parent commit's)")
    ap.add_argument("--order", default=None,
                    help="turns, comma-separated (default parent,change,change,parent)")
    ap.add_argument("--runs", type=int, default=3, help="timed runs of each cell a turn")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="cells, comma-separated (default all: " + ", ".join(CELLS) + ")")
    ap.add_argument("--device", default=None, help="cpu to rehearse; the card by default")
    ap.add_argument("--frames", type=int, default=None, help="cut each clip to this many frames")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    cells = [c.strip() for c in args.cells.split(",")]
    unknown = sorted(set(cells) - set(CELLS))
    if unknown:
        ap.error(f"unknown cells {unknown}; the cells are {list(CELLS)}")
    if args.worker:
        return worker(os.path.abspath(args.worker[0]), args.worker[1], args.runs, args.device,
                      args.frames, cells)
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("host_path_ab: no CUDA device; pass --device cpu to rehearse", file=sys.stderr)
        return 2
    roots = {"change": ROOT}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    order = (args.order or ("parent,change,change,parent" if args.parent else "change")).split(",")
    card = _chip_smoke().card_line() if args.device is None else f"rehearsal on {args.device}"
    print(card, flush=True)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    turns = []
    for n, who in enumerate(order):
        out = os.path.join(out_dir, f"host_ab_turn{n}.json")
        env = dict(os.environ, PAWS_KERNEL_BUILD_DIR=os.path.join(out_dir, f"host_ab_{who}"),
                   PAWSOMETRACKER_CACHE=os.path.join(out_dir, f"host_ab_cache_{who}"))
        t0 = time.perf_counter()
        extra = (["--device", args.device] if args.device else []) + (
            ["--frames", str(args.frames)] if args.frames else [])
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--runs", str(args.runs),
                            "--cells", ",".join(cells), *extra, "--worker", roots[who], out],
                           env=env)
        if r.returncode != 0:
            raise SystemExit(f"turn {n} ({who}) failed with {r.returncode}")
        with open(out) as f:
            turns.append((who, json.load(f)))
        print(f"turn {n}: {who} ({roots[who]}) in {time.perf_counter() - t0:.1f} s", flush=True)
    state = {who: slot_state(out_dir, who) for who in roots}
    for who in roots:
        print(f"{who}: kernels {state[who]['kernels']}, engine decisions"
              f" {state[who]['engine']}", flush=True)
    pairs = [(i, i + 1) for i in range(0, len(order) - 1, 2)
             if {order[i], order[i + 1]} == {"change", "parent"}]
    summary = {}
    for cell in cells:
        want = turns[0][1]["cells"][cell]["digest"]
        for n, (who, res) in enumerate(turns):
            if res["cells"][cell]["digest"] != want:
                raise SystemExit(f"{cell}: turn {n} ({who}) gives other positions or ts than"
                                 " turn 0")
        row = {}
        for who in roots:
            mine = [res["cells"][cell]["runs"] for w, res in turns if w == who]
            row[who] = dict(summarize([r for runs in mine for r in runs]),
                            turn_frames_per_s=[statistics.median(r["frames_per_s"] for r in runs)
                                               for runs in mine])
        if pairs:
            turn_median = [statistics.median(r["frames_per_s"] for r in res["cells"][cell]["runs"])
                           for _, res in turns]
            ratios = [turn_median[i if order[i] == "change" else j]
                      / turn_median[j if order[i] == "change" else i] for i, j in pairs]
            row["pair_ratios"] = ratios
        summary[cell] = row
        line = f"{cell}:"
        for who in roots:
            v = row[who]
            line += (f" {who} {v['frames_per_s']:.1f} frames/s (turns "
                     + ", ".join(f"{x:.1f}" for x in v["turn_frames_per_s"])
                     + f"), set-up {v['setup_ms_per_call']:.2f} ms, upload"
                     f" {v['upload_ms_per_call']:.2f} ms a call, us a chunk: "
                     + ", ".join(f"{k} {v[f'{k} us_per_chunk']:.1f}" for k in PER_CHUNK) + ";")
        if "parent" in roots:
            line += (f" change/parent frames/s"
                     f" {row['change']['frames_per_s'] / row['parent']['frames_per_s']:.3f}x")
        if pairs:
            line += (f"; pairs {statistics.median(ratios):.3f}x (median; "
                     + ", ".join(f"{x:.3f}" for x in ratios)
                     + f"; {sum(x > 1 for x in ratios)} of {len(ratios)} above 1)")
        print(line, flush=True)
    record = {"card": card, "order": order, "runs_per_turn": args.runs, "state": state,
              "cells": summary}
    with open(os.path.join(out_dir, "host_path_ab.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
