#!/usr/bin/env python3
"""Time the port's dog_scan_tiled (and dog_scan) kernels in two checkouts on one card, in turns.

    python3 tools/dog_scan_tiled_ab.py [--parent DIR] [--variant DIR]
                                       [--order parent,change,change,parent] [--clusters 8,16]
                                       [--kernel dog_scan|dog_scan_tiled]

Each turn is a fresh process that imports ``pawsometracker_tpu_torch`` from
one checkout (``change`` is this one, ``parent`` is ``--parent``, for example
a ``git archive`` of the parent commit unpacked under ``build/``, ``variant``
is ``--variant``, a patched copy of this one), builds its
``csrc/dog_scan.cu`` and times ``dog_scan_tiled`` through the public wrappers
(``dog_scan_cuda``, ``dog_scan_batch_cuda``) with CUDA events behind a queued
sleep of the card. The shapes are those the tiled kernel takes at 1080p:

- the quarter-frame autodetect snap (271x481 window, L = 65, T = 1), one lane
  and 4 lanes;
- 64-frame chunk scans at the default windows of ``target_width`` 40, 60 and
  100 (69x69, L = 101; 105x105, L = 149; 173x173, L = 245), unbounded and
  bounded with subpixel offsets, one lane and 4 lanes with their own frames;
- the 12-frame bounded chunks of the ROI crops ``track`` cuts at 1080p for
  ``target_width`` 60 (461x461), one lane ± subpixel and 4 lanes with their
  own crops ± subpixel, and for 30, 35 and 38 (233x233, 269x269, 297x297; one
  lane), each on the shape rule's kernel (``dog_scan`` at 30 and 35);
- and two shapes of ``dog_scan``: the bench shape's 64-frame chunk (41x41,
  ``target_width=25``, one lane, unbounded) and the 185x185 ROI crop's 12-frame
  bounded chunk that ``track`` launches at 1080p (one lane).

Every case goes to the kernel it is named for: by name (the wrappers'
``kernel=``) in checkouts whose wrappers take it (PR 10 on), else it must be
the shape rule's (``kernel_for``); with ``--kernel`` every case goes to the
kernel named there (a case whose window that kernel cannot take in a
checkout is skipped there, and a checkout whose wrappers take no
``kernel=`` refuses): so either kernel can be timed at the other's shapes,
``dog_scan_tiled`` on the bench shape and the 185x185 crop, ``dog_scan`` at
the large targets' windows where it takes them. The positions and offsets of
every turn must equal those of the first, for the cases the first ran. Each
chunk case is also timed at T = 1, which splits its time into a cost per step
and a fixed cost per launch, and each case's host time per launch (the
wrapper's Python and the launch call) is read on the host clock while the
card is busy. With ``--clusters`` the turns of checkouts that can force the
cluster size of the case's kernel (``tiled_cluster``; ``scan_cluster`` from
PR 11 on) also time each case with each of the sizes given that the card can
run there. Prints the card's name and power limit, one line per case and
turn, the medians per checkout, and writes ``build/dog_scan_tiled_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 1080, 1920
CHUNK = 64
SEED = 0
#: H100 SXM published peaks: f32 outside the tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
N_SMS = 132


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int):
    """Card time per call: CUDA events around ``reps`` calls queued behind a
    sleep of the card (~0.2 ms a call), so the card runs them back to back;
    and the host's time per call, read while the card sleeps."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000 * reps)
    t0.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = 1e6 * (time.perf_counter() - h0) / reps
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, host_us


def cost(radii, L, T, lanes):
    """Direct-tap FLOPs of ``lanes`` chains of T steps and the least times:
    the whole card (f32 peak or HBM) and one chain's steps on one SM."""
    wh, ww = 2 * radii[0] + 1, 2 * radii[1] + 1
    flops = T * (2 * 2 * wh * (ww + L - 1) * L + 2 * 2 * wh * ww * L)
    nbytes = T * (wh + L - 1) * (ww + L - 1)
    t_ops, t_bytes = lanes * flops / PEAK_F32_FLOPS, lanes * nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "sm_bound_ms": 1e3 * flops / (PEAK_F32_FLOPS / N_SMS)}


def disc_frames(n, lanes, radius, dev):
    """``lanes`` clips of n 1080p frames on the device: a dark disc (gray 30)
    of ``radius`` on 128-gray, moving 3 px down and 2 px left a frame from
    lane-dependent starts; and the paths."""
    import torch

    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    frames = torch.full((lanes, n, H, W), 128, dtype=torch.uint8, device=dev)
    paths = []
    for b in range(lanes):
        path = [(400 + 40 * b + 3 * t, 1100 - 60 * b - 2 * t) for t in range(n)]
        for t, (i, j) in enumerate(path):
            frames[b, t][(yy - i) ** 2 + (xx - j) ** 2 <= radius ** 2] = 30
        paths.append(path)
    return frames, paths


def worker(out_path: str, clusters: list, kernel: str | None = None) -> int:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from pawsometracker_tpu_torch.models.dog_tracker import autodetect_spec, make_spec
    from pawsometracker_tpu_torch.ops import tracker_kernel as tk
    from pawsometracker_tpu_torch.ops.dog_kernel import guess_window_size

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    limit = tk._smem_limit(0)
    if kernel is not None and not hasattr(tk, "kernels_for"):
        raise SystemExit(f"{ROOT}: its wrappers take no kernel=, so --kernel cannot force one")
    cases = {}
    snap_spec = autodetect_spec(make_spec((H, W), 41, 25, True))
    frames, paths = disc_frames(1, 4, 12, dev)
    centre = [H // 2 - 1, W // 2 - 1]
    for lanes in (1, 4):
        cases[f"snap quarter-frame B={lanes}"] = (snap_spec, frames[:lanes], [centre] * lanes,
                                                  None, False)
    del frames
    for tw in (40, 60, 100):
        spec = make_spec((H, W), guess_window_size(tw), tw, True)
        frames, paths = disc_frames(CHUNK, 4, tw // 2, dev)
        truth = np.array(paths)
        deltas = rng.integers(-3, 4, size=(4, CHUNK, 2))
        lo = np.maximum(truth - rng.integers(0, 16, size=(4, CHUNK, 2)), 0)
        hi = np.minimum(truth + rng.integers(0, 16, size=(4, CHUNK, 2)), [H - 1, W - 1])
        bnd = {k: torch.tensor(v, dtype=torch.int32, device=dev)
               for k, v in (("deltas", deltas), ("lo", lo), ("hi", hi))}
        starts = [list(p[0]) for p in paths]
        for lanes in (1, 4):
            b = {k: v[:lanes].contiguous() for k, v in bnd.items()}
            cases[f"target_width={tw} T=64 unbounded B={lanes}"] = (
                spec, frames[:lanes], starts[:lanes], None, False)
            cases[f"target_width={tw} T=64 bounded+subpixel B={lanes}"] = (
                spec, frames[:lanes], starts[:lanes], b, True)
        if tw == 60:
            large = (spec, frames, paths)
    # the ROI crops' bounded 12-frame chunks (boxes inside the crop, no rebase), each lane's
    # crop about its disc's start; at target_width 60 also 4 lanes, and with subpixel offsets
    from pawsometracker_tpu_torch.pipeline import roi_geometry

    case_kernel = {}

    def crop_chunk(spec, frames, paths, lanes):
        ch, cw, _ = roi_geometry(spec, 12, 7, "predict")
        crops = torch.stack([frames[b, :12, paths[b][0][0] - ch // 2:paths[b][0][0] - ch // 2 + ch,
                                    paths[b][0][1] - cw // 2:paths[b][0][1] - cw // 2 + cw]
                             for b in range(lanes)]).contiguous()
        box = {"deltas": torch.zeros((lanes, 12, 2), dtype=torch.int32, device=dev),
               "lo": torch.zeros((lanes, 12, 2), dtype=torch.int32, device=dev),
               "hi": torch.tensor([ch - 1, cw - 1], dtype=torch.int32,
                                  device=dev).expand(lanes, 12, 2).contiguous()}
        rspec = make_spec((ch, cw), spec.window_size, spec.target_width, True)
        return rspec, crops, [[ch // 2, cw // 2]] * lanes, box, f"{ch}x{cw}"

    spec, frames, paths = large
    for lanes in (1, 4):
        rspec, crops, starts, box, size = crop_chunk(spec, frames, paths, lanes)
        for sub in (False, True):
            cases[f"ROI {size} T=12 bounded{'+subpixel' if sub else ''} B={lanes}"] = (
                rspec, crops, starts, box, sub)
    del frames, large
    for tw in (30, 35, 38):
        spec = make_spec((H, W), guess_window_size(tw), tw, True)
        frames, paths = disc_frames(12, 1, tw // 2, dev)
        rspec, crops, starts, box, size = crop_chunk(spec, frames, paths, 1)
        name = f"ROI target_width={tw} {size} T=12 bounded B=1"
        cases[name] = (rspec, crops, starts, box, False)
        case_kernel[name] = tk.kernel_for(rspec.radii, rspec.kernel_len, limit)
    del frames
    # dog_scan: the bench chunk, and a 185x185 crop's bounded chunk (boxes inside the crop)
    bench = make_spec((H, W), 41, 25, True)
    frames, paths = disc_frames(CHUNK, 1, 12, dev)
    cases["dog_scan bench T=64 unbounded B=1"] = (bench, frames, [list(paths[0][0])], None, False)
    crop = make_spec((185, 185), 41, 25, True)
    r0, c0 = paths[0][0][0] - 92, paths[0][0][1] - 92  # the disc starts at the crop's centre
    crops = frames[:, :12, r0:r0 + 185, c0:c0 + 185].contiguous()
    box = {"deltas": torch.zeros((1, 12, 2), dtype=torch.int32, device=dev),
           "lo": torch.zeros((1, 12, 2), dtype=torch.int32, device=dev),
           "hi": torch.full((1, 12, 2), 184, dtype=torch.int32, device=dev)}
    cases["dog_scan ROI 185x185 T=12 bounded B=1"] = (
        crop, crops, [[92, 92]], box, False)

    # every argument on the card before any timing: a host-to-device copy inside
    # the timed calls would wait for the queued work and time the host
    by_name = hasattr(tk, "kernels_for")  # the wrappers take kernel=

    def kernel_of(case):
        return kernel or case_kernel.get(case) or ("dog_scan" if case.startswith("dog_scan ")
                                                   else "dog_scan_tiled")

    args = {}
    for case, (spec, fr, starts, b, sub) in cases.items():
        lanes = fr.shape[0]
        kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True, subpixel=sub,
                  **({"kernel": kernel_of(case)} if by_name else {}))
        pos0 = torch.tensor(starts, dtype=torch.int32, device=dev)
        fills = torch.full((lanes,), 128, dtype=torch.uint8, device=dev)
        for steps in {fr.shape[1], 1}:
            frs = fr[:, :steps].contiguous()
            box = {k: v[:, :steps].contiguous() for k, v in (b or {}).items()}
            if lanes == 1:
                args[case, steps] = (tk.dog_scan_cuda, (frs[0], pos0[0], 128),
                                     dict(kw, **{k: v[0] for k, v in box.items()}))
            else:
                args[case, steps] = (tk.dog_scan_batch_cuda, (frs, pos0, fills), dict(kw, **box))

    def run(case, steps):
        fn, a, kw = args[case, steps]
        return fn(*a, **kw)

    knob = {"dog_scan_tiled": "tiled_cluster", "dog_scan": "scan_cluster"}
    result = {"card": card_line(), "torch": torch.__version__, "cases": {}}
    for case, (spec, fr, starts, b, sub) in cases.items():
        L = spec.kernel_len
        want = kernel_of(case)
        if by_name:
            if want not in tk.kernels_for(spec.radii, L, limit):
                print(f"  {case}: {want} does not take this window here, skipped", flush=True)
                continue
        elif tk.kernel_for(spec.radii, L, limit) != want:
            raise SystemExit(f"{case}: kernel_for picks {tk.kernel_for(spec.radii, L, limit)},"
                             f" not {want}")
        lanes, steps = fr.shape[0], fr.shape[1]
        entry = {"radii": list(spec.radii), "L": L, "T": steps, "lanes": lanes,
                 **cost(spec.radii, L, steps, lanes), "by_cluster": {}}
        for c in [None] + (clusters if hasattr(tk, knob[want]) else []):
            if c is not None:
                setattr(tk, knob[want], c)
            try:
                out = run(case, steps)
            except RuntimeError as e:  # a forced size the card cannot run at this window
                print(f"  {case}: C={c} cannot run ({e}), skipped", flush=True)
                setattr(tk, knob[want], None)
                continue
            torch.cuda.synchronize()
            outs = [o.cpu().numpy().tolist() for o in (out if sub else (out,))]
            ms, host_us = device_ms(lambda: run(case, steps), reps=200 if steps == 1 else 5)
            rec = {"ms": ms, "host_us": host_us, "out": outs}
            if steps > 1:
                ms1, _ = device_ms(lambda: run(case, 1), reps=200)
                step_us = 1e3 * (ms - ms1) / (steps - 1)
                rec.update(ms_T1=ms1, us_per_step=step_us, fixed_us=1e3 * ms1 - step_us)
            if want == "dog_scan_tiled" and hasattr(tk, "tile_plan"):
                plan = tk._tiled_plan(spec.radii, L, limit, sub, 0)
                rec["plan"] = plan._asdict()
                rec["cluster_sm_bound_ms"] = entry["sm_bound_ms"] / plan.cluster
            if want == "dog_scan" and hasattr(tk, "scan_plan"):
                plan = tk._scan_plan(spec.radii, L, limit, lanes, 0)
                rec["plan"] = plan._asdict()
                rec["cluster_sm_bound_ms"] = entry["sm_bound_ms"] / plan.cluster
            entry["by_cluster"]["auto" if c is None else str(c)] = rec
            if c is not None:
                setattr(tk, knob[want], None)
        cases_out = result["cases"]
        cases_out[case] = entry
        print(f"  {case}: " + ", ".join(
            f"C={k} {v['ms']:.4f} ms" + (f" ({v['us_per_step']:.2f} us/step, fixed"
                                         f" {v['fixed_us']:.2f} us)" if "ms_T1" in v else "")
            + f", host {v['host_us']:.0f} us" for k, v in entry["by_cluster"].items()), flush=True)
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of the parent's checkout")
    ap.add_argument("--variant", help="root of a patched copy of this checkout")
    ap.add_argument("--order", default=None,
                    help="turns, comma-separated (default parent,change,change,parent with "
                         "--parent, else change)")
    ap.add_argument("--clusters", default="", help="cluster sizes to force in the change's turns")
    ap.add_argument("--kernel", choices=["dog_scan", "dog_scan_tiled"],
                    help="launch every case on this kernel (skipping windows it cannot take)")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    clusters = [int(c) for c in args.clusters.split(",") if c]
    if args.worker:
        global ROOT
        ROOT = os.path.abspath(args.worker[0])
        return worker(args.worker[1], clusters, args.kernel)
    import torch

    if not torch.cuda.is_available():
        print("dog_scan_tiled_ab: no CUDA device", file=sys.stderr)
        return 2
    roots = {"change": ROOT}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    if args.variant:
        roots["variant"] = os.path.abspath(args.variant)
    order = (args.order or ("parent,change,change,parent" if args.parent else "change")).split(",")
    card = card_line()
    print(card, flush=True)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    turns = []
    for n, who in enumerate(order):
        print(f"turn {n}: {who} ({roots[who]})", flush=True)
        out = os.path.join(out_dir, f"tiled_ab_turn{n}.json")
        env = dict(os.environ, PAWS_KERNEL_BUILD_DIR=os.path.join(out_dir, f"tiled_ab_{who}"))
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", roots[who], out,
                            "--clusters", args.clusters]
                           + (["--kernel", args.kernel] if args.kernel else []), env=env)
        if r.returncode != 0:
            raise SystemExit(f"turn {n} ({who}) failed with {r.returncode}")
        with open(out) as f:
            turns.append((who, json.load(f)))
    first = turns[0][1]["cases"]
    summary = {}
    for case, entry in first.items():
        want = entry["by_cluster"]["auto"]["out"]
        for who, res in turns:
            if case not in res["cases"]:
                raise SystemExit(f"{case}: {who} did not run it")
            for c, rec in res["cases"][case]["by_cluster"].items():
                if rec["out"] != want:
                    raise SystemExit(f"{case}: {who} (cluster {c}) differs from turn 0")
        row = {k: entry[k] for k in ("radii", "L", "T", "lanes", "bound_ms", "bound_by",
                                     "sm_bound_ms")}
        for who in roots:
            by = {}
            for w, res in turns:
                if w == who:
                    for c, rec in res["cases"][case]["by_cluster"].items():
                        by.setdefault(c, []).append(rec["ms"])
            row[who] = {c: {"median_ms": statistics.median(v), "ms": v} for c, v in by.items()}
            for w, res in turns:
                if w == who:
                    for c, rec in res["cases"][case]["by_cluster"].items():
                        for k in ("us_per_step", "fixed_us", "host_us"):
                            if k in rec:
                                row[who][c].setdefault(k, []).append(rec[k])
            plan = [res["cases"][case]["by_cluster"]["auto"].get("plan") for w, res in turns
                    if w == who]
            if plan and plan[0]:
                row[who]["plan"] = plan[0]
        summary[case] = row
        line = f"{case}: bound {row['bound_ms']:.6f} ms ({row['bound_by']}), one SM" \
               f" {row['sm_bound_ms']:.4f} ms"
        for who in roots:
            line += "; " + who + " " + ", ".join(f"C={c} {v['median_ms']:.4f} ms"
                                                 for c, v in row[who].items() if c != "plan")
        if "parent" in roots:
            line += f"; parent/change {row['parent']['auto']['median_ms'] / row['change']['auto']['median_ms']:.3f}x"
        print(line, flush=True)
    record = {"card": card, "order": order, "kernel": args.kernel, "cases": summary}
    with open(os.path.join(out_dir, "dog_scan_tiled_ab.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"card": card, "cases": {c: {w: r[w]["auto"]["median_ms"] for w in roots}
                                               for c, r in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
