#!/usr/bin/env python3
"""``track_batch`` over a mesh of every card of the machine, beside ``mesh=None``.

    python3 tools/mesh_cards.py [--reps 5] [--device cpu --frames N]

Draws ``chip_smoke.py``'s four 1080p ``track_batch`` clips (``--frames`` caps
their length) and runs ``track_batch`` on them over each mesh of
``chip_smoke.mesh_list`` (``make_mesh()`` over every card, 2 and 4 data
shards on cuda:0, and 2 cards where there are more than two), on full frames
and on ROI (``stream="auto"``), the same three ways as ``chip_smoke.py``
(start locations given, lane 2 autodetected, subpixel). Each run must equal
the ``mesh=None`` run, launch the kernel once a data shard for each launch of
that run, and never run the plain version. Then ``sharded_pallas_bounded``
against its plain version at the batch ROI chunk shape (185x185, B = 4,
T = 12) on each mesh, and the space-sharded whole-frame detector against the
unsharded one on ``chip_smoke.space_meshes`` (plus 2 data x 2 space over four
cards where there are four). Then, in turns over ``--reps`` rounds, end-to-end
frames/s of ``mesh=None`` and each mesh on both streams (median and range),
the wall time a ``sharded_pallas_bounded`` call with every card
synchronised, and a ``torch.profiler`` busy share (device time summed over the
cards, over the wall) of one ROI call per mesh. Prints each card's name and
power limit and one JSON record as its last line (also written to
``build/mesh_cards.json``); exits non-zero on any failure.

``--device cpu`` rehearses it on the host: meshes of ``cpu`` entries, the
plain version, no timing of the card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the clips, meshes and checks of chip_smoke.py)

#: the three ways chip_smoke.py drives track_batch
VARIANTS = ("start_location", "lane 2 autodetect", "subpixel")


def cards() -> list:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None, help="cpu: rehearse on the host")
    ap.add_argument("--frames", type=int, default=None, help="cap the clips' length")
    args = ap.parse_args(argv)

    import torch

    from pawsometracker_tpu_torch import IJ, make_mesh, track_batch
    from pawsometracker_tpu_torch.models import dog_tracker
    from pawsometracker_tpu_torch.models.dog_tracker import make_spec
    from pawsometracker_tpu_torch.ops import tracker_kernel as tk
    from pawsometracker_tpu_torch.parallel.mesh import (global_detect_batch,
                                                        sharded_pallas_bounded)
    from pawsometracker_tpu_torch.ops.roi_crop import crop_with_fill
    from pawsometracker_tpu_torch.pipeline import roi_geometry

    on_cpu = args.device == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        print("mesh_cards: no CUDA device (pass --device cpu to rehearse)", file=sys.stderr)
        return 2
    record: dict = {"cards": [] if on_cpu else cards(),
                    "device_count": 0 if on_cpu else torch.cuda.device_count()}
    for line in record["cards"]:
        print(line, flush=True)
    stats_log = cs.StatsLog()
    port_logger = logging.getLogger("pawsometracker_tpu_torch")
    port_logger.addHandler(stats_log)
    port_logger.setLevel(logging.DEBUG)
    plain_runs = cs.count_plain_runs(tk, dog_tracker)
    if on_cpu:
        meshes = {"cpu x2": make_mesh(devices=["cpu"] * 2),
                  "cpu x4": make_mesh(devices=["cpu"] * 4)}
        space = {"cpu x4, space 2": make_mesh(devices=["cpu"] * 4, space=2)}
        dev = torch.device("cpu")
    else:
        tk._lib()
        meshes = cs.mesh_list(make_mesh, 4)
        space = cs.space_meshes(make_mesh)
        if torch.cuda.device_count() >= 4:
            space["4 cards, space 2"] = make_mesh(4, space=2)
        dev = torch.device("cuda", 0)
    device_kw = {"device": "cpu"} if on_cpu else {}
    clips, truths = cs.synth_batch()
    if args.frames:
        clips = [c[:args.frames] for c in clips]
    lens = [len(c) for c in clips]
    locs = [IJ(int(t[0][0]), int(t[0][1])) for t in truths]
    variants = {"start_location": dict(start_location=locs),
                "lane 2 autodetect": dict(start_location=locs[:2] + [None] + locs[3:]),
                "subpixel": dict(start_location=locs, subpixel=True)}
    streams = {"full": dict(fps=cs.FPS, target_width=cs.TARGET_WIDTH, window_size=cs.WINDOW,
                            stream="full"),
               "ROI": dict(fps=cs.FPS, target_width=cs.TARGET_WIDTH, window_size=cs.WINDOW)}
    ok_all = True

    def run(stream, mesh, variant):
        """One call; its output, launches, plain runs, stats and wall seconds."""
        before, plain_before = tk.launches, plain_runs["n"]
        stats_log.last = None
        t0 = time.perf_counter()
        out = track_batch(clips, mesh=mesh, **streams[stream], **variants[variant], **device_kw)
        if not on_cpu:
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
        return (out, tk.launches - before, plain_runs["n"] - plain_before,
                stats_log.last or {}, time.perf_counter() - t0)

    # ---- equality and launches ------------------------------------------------
    checks = {}
    for stream in streams:
        for variant in VARIANTS:
            want, n_none, _, _, _ = run(stream, None, variant)
            for label, mesh in meshes.items():
                out, n, n_plain, st, wall = run(stream, mesh, variant)
                shards = mesh.shape["data"]
                sub = variant == "subpixel"
                equal = all(cs.same(a[1], w[1], sub) and np.array_equal(a[0], w[0])
                            for a, w in zip(out, want))
                # the ROI controller's dispatches are the run's own
                snaps = 2 if "autodetect" in variant else 1
                want_n = (shards * (snaps + st.get("dispatches", -1)) if stream == "ROI"
                          else shards * n_none)
                ok = (equal and (on_cpu or (n == want_n and n_plain == 0))
                      and st.get("shards") == shards and [len(o[1]) for o in out] == lens)
                ok_all &= ok
                checks[f"{stream} {label} {variant}"] = {
                    "shards": shards, "launches": n, "want_launches": want_n,
                    "mesh_none_launches": n_none, "plain_runs": n_plain,
                    "equals_mesh_none": equal, "stream": st.get("stream"),
                    "dispatches": st.get("dispatches"), "ok": ok}
                print(f"track_batch {stream} mesh={label} ({variant}): {shards} shard(s),"
                      f" launches={n} (want {want_n}; mesh=None {n_none}), plain runs={n_plain},"
                      f" equals mesh=None={equal}, {wall:.3f} s -> {'ok' if ok else 'FAIL'}",
                      flush=True)
    record["checks"] = checks

    # ---- sharded_pallas_bounded and the space-sharded detector ---------------
    spec = make_spec((cs.H, cs.W), cs.WINDOW, cs.TARGET_WIDTH, True)
    ch, cw, _ = roi_geometry(spec, cs.ROI_K, 7, "predict")
    rspec = make_spec((ch, cw), spec.window_size, spec.target_width, True)
    lane_frames = [None if b == 2 else c for b, c in enumerate(clips)]
    crops, pos0, fills, bnd = cs.roi_lanes(lane_frames, truths, cs.BATCH_FILLS, spec, dev,
                                           roi_geometry, crop_with_fill)
    bnds = (bnd["deltas"], bnd["lo"], bnd["hi"])
    sharded = {}
    for label, mesh in meshes.items():
        for sub in (False, True):
            fn = sharded_pallas_bounded(rspec, mesh, subpixel=sub)
            before = tk.launches
            got = fn(crops, pos0, fills, *bnds)
            n = tk.launches - before
            want = sharded_pallas_bounded(rspec, mesh, interpret=True, subpixel=sub)(
                crops, pos0, fills, *bnds)
            got, want = (got, want) if sub else ((got,), (want,))
            equal = all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want))
            shards = mesh.shape["data"]
            ok = equal and (on_cpu or n == shards)
            ok_all &= ok
            name = f"{label} {'bounded+subpixel' if sub else 'bounded'}"
            sharded[name] = {"shards": shards, "launches": n, "equals_plain": equal, "ok": ok,
                             "fn": (fn, mesh)}
            print(f"sharded_pallas_bounded {name}: 185x185 B=4 T={cs.ROI_K}, launches={n}"
                  f" (want {shards}), equals its plain version={equal}"
                  f" -> {'ok' if ok else 'FAIL'}", flush=True)
    frames0 = torch.from_numpy(np.stack([c[0] for c in clips])).to(dev)
    fills0 = torch.tensor(cs.BATCH_FILLS, dtype=torch.uint8, device=dev)
    unsharded = global_detect_batch(spec)(frames0, fills0).cpu().numpy()
    detect = {}
    for label, mesh in space.items():
        equal = bool(np.array_equal(np.asarray(global_detect_batch(spec, mesh)(frames0, fills0)),
                                    unsharded))
        ok_all &= equal
        detect[label] = {"shape": dict(mesh.shape), "equals_unsharded": equal}
        print(f"global_detect_batch {label} {dict(mesh.shape)}: 1080p B=4, equals the unsharded"
              f" detector={equal} -> {'ok' if equal else 'FAIL'}", flush=True)
    record["detect"] = detect

    # ---- timing, in turns -----------------------------------------------------
    walls = {f"{stream} {label}": [] for stream in streams for label in ["mesh=None", *meshes]}
    for _ in range(args.reps):
        for stream in streams:
            for label in ["mesh=None", *meshes]:
                walls[f"{stream} {label}"].append(
                    run(stream, meshes.get(label), "start_location")[4])
    total = sum(lens)
    e2e = {k: {"frames_per_s": total / statistics.median(v),
               "range": [total / max(v), total / min(v)], "runs_s": v} for k, v in walls.items()}
    for k, v in e2e.items():
        print(f"e2e track_batch {k}: {v['frames_per_s']:.1f} frames/s summed over 4 videos"
              f" (median of {len(walls[k])}; {v['range'][0]:.1f}-{v['range'][1]:.1f})",
              flush=True)
    record["e2e"] = e2e
    if not on_cpu:
        for name, entry in sharded.items():
            fn, mesh = entry.pop("fn")
            devs = set(mesh.data_devices())
            fn(crops, pos0, fills, *bnds)
            for d in devs:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            for _ in range(50):
                fn(crops, pos0, fills, *bnds)
            for d in devs:
                torch.cuda.synchronize(d)
            entry["wall_ms"] = 1e3 * (time.perf_counter() - t0) / 50
            print(f"sharded_pallas_bounded {name}: wall {entry['wall_ms']:.4f} ms a call"
                  " (every card synchronised)", flush=True)
        record["profile"] = {}
        for label in ["mesh=None", *meshes]:
            mesh = meshes.get(label)
            prof = cs.profile_busy(lambda: track_batch(clips, mesh=mesh, **streams["ROI"],
                                                       **variants["start_location"]))
            record["profile"][label] = prof
            cs.log_profile(f"track_batch ROI {label}", prof)
    for entry in sharded.values():
        entry.pop("fn", None)
    record["sharded_pallas_bounded"] = sharded
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "mesh_cards.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps({"ok": bool(ok_all), "device_count": record["device_count"],
                      "e2e_frames_per_s": {k: v["frames_per_s"] for k, v in e2e.items()}}))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
