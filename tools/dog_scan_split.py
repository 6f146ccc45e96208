#!/usr/bin/env python3
"""Where a step of the port's dog_scan or dog_scan_tiled kernel goes, measured on the card.

    python3 tools/dog_scan_split.py [--kernel dog_scan|dog_scan_tiled] [--src FILE.cu ...]
                                    [--variants full,no_rows,...] [--clusters auto,1,6]
                                    [--shapes bench,roi185]

Builds variants of ``pawsometracker_tpu_torch/csrc/dog_scan.cu`` (and of each
``--src``, a candidate source with the same C interface) with ``nvcc`` into
``build/kernels/split/``. A variant is the source with one part of the step
taken out by a text patch. For ``--kernel dog_scan`` (the default):

- ``full``: the source as it is, checked bit for bit against the plain
  version before it is timed;
- ``no_rows``: no row pass; ``no_cols``: no column pass; ``no_passes``:
  neither (what is left is the step's fixed work: the warp maxima, the
  barriers, the exchange, the new position and the prefetch);
- ``no_prefetch``: a CTA copies none of the next patch's rows (the step
  computes on a stale buffer); ``no_exchange``: the cluster barrier of the
  step becomes a CTA barrier and each CTA reduces only its own warps' maxima
  (every CTA then follows its own chain); ``fixed``: no passes and no copy;
- ``row_offsets``: the kernel for frames that are not 16-byte aligned (each
  superset row read at its own offset), on the aligned bench frames; its
  results are right and it is checked too.

For ``--kernel dog_scan_tiled`` the same ``full``, ``no_rows``, ``no_cols``,
``no_passes``, ``no_exchange`` (each CTA reduces only its own maximum) and
``row_offsets``, and:

- ``no_first_copy``: no copy of the step's first tile (the step computes on
  the stale patch); ``first_copy_issue``: the copy issued but not waited for
  (what the copy's issue costs, without its latency); ``fixed``: no passes
  and no copies.

The variants' results are wrong and are not checked; a variant without a pass
also moves the chain (to wherever its stale maxima point), so on a crop its
copies may take the frame-edge path. Each is timed with CUDA
events behind a queued sleep of the card, so that the host's per-launch cost
does not enter, at each shape of ``--shapes``. ``dog_scan``'s: ``bench``
(1080p frames, 41x41 window, ``target_width=25``, L = 65, one chain,
unbounded) for T = 64 and T = 1, and ``roi185`` (the 185x185 crop ``track``
cuts at 1080p: the same window, bounded, a width that is not a multiple of
16) for T = 12 and T = 1. ``dog_scan_tiled``'s: ``large60`` (1080p,
``target_width=60``, 105x105 window, L = 149, unbounded) for T = 64 and
T = 1, ``roi461`` (its 461x461 crop, bounded) for T = 12 and T = 1, and the
quarter-frame autodetect snap (271x481, L = 65, T = 1) for one lane
(``snap``) and 4 (``snap4``). From T and T = 1 the per-step and the fixed
cost of a launch. Each variant runs under each cluster size of
``--clusters`` (``auto``: the wrapper's plan for one lane). Prints the card's
name and power limit, ``ptxas``'s registers per variant, one line per
variant, shape and cluster size, and writes ``build/dog_scan_split.json``
(``build/dog_scan_tiled_split.json``). With ``--sass`` it also counts the
SASS opcodes of each ``full`` build's kernels (``cuobjdump -sass``), to read
what one tap of a pass issues; with ``--clocks`` it reads the card's SM
clock, power and temperature (``nvidia-smi``) while the ``full`` build runs
the first shape's launches back to back for two seconds, since the issue
rate per second follows the clock. Launches back to back find the chunk's
frames in L2 from the launch before; with ``--cold`` each variant is also
timed with L2 emptied before each launch, as a new chunk's frames arrive.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H, W, T = 1080, 1920, 64
ROI, ROI_T = 185, 12
#: dog_scan_tiled's shapes: the large target (target_width=60, its default 105x105 window,
#: L = 149) on 1080p chunks, its 461x461 ROI crop, and the quarter-frame autodetect snap
LARGE_TW, LARGE_ROI = 60, 461
# Each variant is a list of text patches (old, new). Where a kernel's source changed, a patch
# is a list of alternatives, the first whose old text the source holds being taken.
# dog_scan: the loop bounds of the two passes, the prefetch's call and the exchange
ROW_LOOP = ("it < nblk * pw;", "it < 0;")
COL_LOOP = ("it < nrow * ly.nbh;", "it < 0;")
PREFETCH = [("load_region<kAligned>(bufs + (par ^ 1) * buf_bytes",
             "if (false) load_region<kAligned>(bufs + (par ^ 1) * buf_bytes")]
EXCHANGE = [("does not depend on C.\n    cluster_sync();",
             "does not depend on C.\n    __syncthreads();"),
            ("for (int i = lane; i < C * nwx; i += 32) {",
             "for (int i = lane; i < nwx; i += 32) {"),
            ("keep_better(dsmem_f32(dsmem_addr(&s_v[par][w], cta)),\n"
             "                  dsmem_s32(dsmem_addr(&s_k[par][w], cta)), bv, bk);",
             "keep_better(s_v[par][w], s_k[par][w], bv, bk);\n      (void)cta;")]
ROW_OFFSETS = ("return reinterpret_cast<uintptr_t>(frames) % 16 == 0 && W % 16 == 0",
               "return false && W % 16 == 0")
PATCHES = {
    "full": [],
    "no_rows": [ROW_LOOP],
    "no_cols": [COL_LOOP],
    "no_passes": [ROW_LOOP, COL_LOOP],
    "no_prefetch": PREFETCH,
    "no_exchange": EXCHANGE,
    "fixed": [ROW_LOOP, COL_LOOP, *PREFETCH],
    "row_offsets": [ROW_OFFSETS],
}
# dog_scan_tiled: the passes' loop bounds, the first tile's copy and its wait, the next tile's
# copy (slots > 1), and the exchange; where the step's redesign changed a part, the earlier
# source's text first, then this one's
T_ROW_LOOP = [("it < nbv * pw;", "it < 0;")]
T_COL_LOOP = [("it < th * nbh;", "it < 0;")]
T_FIRST_COPY = [("load_region<kAligned>(patch, shifts, frame, H, W, r0 + tr * th, ly.brows",
                 "if (false) load_region<kAligned>(patch, shifts, frame, H, W, r0 + tr * th,"
                 " ly.brows"),
                ("load_tile<kAligned>(patch, shifts, frame, H, W, r0 + tr * th, ly.brows",
                 "if (false) load_tile<kAligned>(patch, shifts, frame, H, W, r0 + tr * th,"
                 " ly.brows")]
T_FIRST_WAIT = ("    cp_async_wait_all();\n    __syncthreads();\n\n    float bv = -INFINITY;",
                "    __syncthreads();\n\n    float bv = -INFINITY;")
T_NEXT_COPY = ("load_region<kAligned>(patch, shifts, frame, H, W, r0 + nr * th",
               "if (false) load_region<kAligned>(patch, shifts, frame, H, W, r0 + nr * th")
T_EXCHANGE = [[
    # the earlier source: each warp reads every CTA's maximum after the cluster barrier
    [("    cluster_sync();\n    bv = -INFINITY;\n    bk = INT_MAX;\n    if (lane < C) {\n"
      "      bv = dsmem_f32(dsmem_addr(&s_best_v[par], lane));\n"
      "      bk = dsmem_s32(dsmem_addr(&s_best_k[par], lane));\n    }",
      "    __syncthreads();\n    bv = -INFINITY;\n    bk = INT_MAX;\n    if (lane == 0) {\n"
      "      bv = s_best_v[par];\n      bk = s_best_k[par];\n    }")],
    # this source: each warp sends its pair to every CTA by st.async; a CTA waits for its own
    [("    if (warp < nwx && lane < C)\n      st_async_b64(",
      "    if (warp < nwx && lane == 0)\n      pairs[par * kMaxCluster * kWarps + warp] ="
      " make_uint2(h, k);\n    __syncthreads();\n    if (false)\n      st_async_b64("),
     ("    if (tid == 0) mbar_expect_tx(&s_bar[par], 8u * C * nwx);\n"
      "    mbar_wait(&s_bar[par], (g >> 1) & 1);\n", ""),
     ("for (int i = lane, n = C * nwx; i < n; i += 32) {",
      "for (int i = lane, n = nwx; i < n; i += 32) {")]]]
TILED_PATCHES = {
    "full": [],
    "no_rows": T_ROW_LOOP,
    "no_cols": T_COL_LOOP,
    "no_passes": T_ROW_LOOP + T_COL_LOOP,
    "no_first_copy": [T_FIRST_COPY],
    "first_copy_issue": [T_FIRST_WAIT],
    "no_exchange": T_EXCHANGE,
    "fixed": T_ROW_LOOP + T_COL_LOOP + [T_FIRST_COPY, T_NEXT_COPY],
    "row_offsets": [ROW_OFFSETS],
}
#: the variants whose results are right, checked bit for bit
CHECKED = ("full", "row_offsets")
VARIANTS = {"dog_scan": PATCHES, "dog_scan_tiled": TILED_PATCHES}
SHAPES = {"dog_scan": "bench,roi185", "dog_scan_tiled": "large60,roi461,snap,snap4"}


def apply_patches(text: str, patches, label: str, variant: str) -> str:
    """``text`` with each patch of a variant applied. A patch given as a list
    of alternatives takes the first whose old texts all occur once in ``text``
    (an alternative is one (old, new) pair or a list of them)."""
    for patch in patches:
        alts = patch if isinstance(patch, list) else [patch]
        for alt in alts:
            pairs = alt if isinstance(alt, list) else [alt]
            if all(text.count(old) == 1 for old, _ in pairs):
                for old, new in pairs:
                    text = text.replace(old, new)
                break
        else:
            raise SystemExit(f"{label}: variant {variant} does not apply")
    return text

def build(src_text: str, name: str):
    from pawsometracker_tpu_torch.ops import _build, tracker_kernel as tk

    out = os.path.join(ROOT, "build", "kernels", "split")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, f"{name}.cu"), os.path.join(out, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src_text)
    r = subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    regs = [ln.split(":", 1)[1].strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln]
    return tk._bind(ctypes.CDLL(so)), regs


def sass_histogram(so: str) -> dict:
    """Opcode counts per kernel of a built library, from ``cuobjdump -sass``."""
    from pawsometracker_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    hist: dict = {}
    fn = None
    for ln in text.splitlines():
        m = re.search(r"Function : \S*?\d(dog_scan\w*?kernel)(ILb([01])ELb([01]))?", ln)
        if m:
            fn = m.group(1) + (f"<{'aligned' if m.group(3) == '1' else 'per-row offsets'},"
                               f" {'segments' if m.group(4) == '1' else 'one chunk'}>"
                               if m.group(2) else "")
            hist[fn] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", ln)
        if fn and m:
            op = m.group(2)
            hist[fn][op] = hist[fn].get(op, 0) + 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v in hist.items()}


def clocks_under_load(fn, seconds: float = 2.0) -> list:
    """``nvidia-smi`` readings (SM clock, its maximum, power, temperature)
    taken while ``fn`` is queued back to back for ``seconds``."""
    import threading
    import time

    import torch

    out = []

    def sample():
        time.sleep(seconds / 2)
        for _ in range(3):
            out.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
                 "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
            time.sleep(0.1)

    th = threading.Thread(target=sample)
    t_end = time.perf_counter() + seconds
    th.start()
    while time.perf_counter() < t_end:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    th.join()
    return out


def device_ms(fn, reps: int) -> float:
    """Card time per call: CUDA events around ``reps`` calls queued behind a
    sleep of the card, so the card runs them back to back."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000 * reps)  # ~0.2 ms a call at ~2 GHz: more than the host needs
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms_cold(fn, reps: int, flush) -> float:
    """Card time per call with L2 emptied before each: ``flush`` (twice the
    card's L2) is written, the card sleeps while the host queues the call,
    and CUDA events around the call time it alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=list(VARIANTS), default="dog_scan")
    ap.add_argument("--src", action="append", default=[],
                    help="a candidate source with dog_scan.cu's C interface")
    ap.add_argument("--variants", default=None)
    ap.add_argument("--sass", action="store_true", help="count the SASS opcodes of each kernel")
    ap.add_argument("--clocks", action="store_true",
                    help="read the SM clock while the kernel runs back to back")
    ap.add_argument("--clusters", default="auto",
                    help="cluster sizes to launch, comma-separated (auto: the wrapper's plan)")
    ap.add_argument("--shapes", default=None, help="comma-separated, of the kernel's shapes")
    ap.add_argument("--cold", action="store_true",
                    help="also time each launch with L2 emptied before it, as a new chunk's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dog_scan_split: no CUDA device", file=sys.stderr)
        return 2
    from pawsometracker_tpu_torch.models.dog_tracker import autodetect_spec, make_spec
    from pawsometracker_tpu_torch.ops import tracker_kernel as tk
    from pawsometracker_tpu_torch.ops.dog_kernel import guess_window_size

    tiled = args.kernel == "dog_scan_tiled"
    patches = VARIANTS[args.kernel]
    variants = (args.variants or ",".join(patches)).split(",")
    shape_names = (args.shapes or SHAPES[args.kernel]).split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    limit = tk._smem_limit(0)
    yy, xx = np.mgrid[:H, :W]

    def disc_clip(n, radius):
        frames = np.full((n, H, W), 128, np.uint8)
        path = [(H // 2 + 3 * t, W // 2 - 2 * t) for t in range(n)]
        for t, (i, j) in enumerate(path):
            frames[t][(yy - i) ** 2 + (xx - j) ** 2 <= radius ** 2] = 30
        return torch.from_numpy(frames).to(dev), path

    def crop_case(frames, path, roi, steps):
        # the roi x roi crop about the disc's first position, as the ROI pipeline cuts it; its
        # boxes the whole crop, no rebase
        r0, c0 = path[0][0] - roi // 2, path[0][1] - roi // 2
        crops = frames[:steps, r0:r0 + roi, c0:c0 + roi].contiguous()
        box = [torch.zeros((steps, 2), dtype=torch.int32, device=dev),
               torch.zeros((steps, 2), dtype=torch.int32, device=dev),
               torch.full((steps, 2), roi - 1, dtype=torch.int32, device=dev)]
        return crops, torch.tensor([roi // 2] * 2, dtype=torch.int32, device=dev), box

    # name: (spec, frames [B, T, H, W], pos0 [B, 2], (deltas, lo, hi) or None, T)
    shapes = {}
    if tiled:
        spec = make_spec((H, W), guess_window_size(LARGE_TW), LARGE_TW, True)
        frames, path = disc_clip(T, LARGE_TW // 2)
        p0 = torch.tensor([path[0]], dtype=torch.int32, device=dev)
        shapes["large60"] = (spec, frames[None], p0, None, T)
        crops, cp0, box = crop_case(frames, path, LARGE_ROI, ROI_T)
        shapes["roi461"] = (spec, crops[None], cp0[None], box, ROI_T)
        snap = autodetect_spec(make_spec((H, W), 41, 25, True))
        lanes = torch.stack([frames[k * (T // 4):k * (T // 4) + 1] for k in range(4)])
        centre = torch.tensor([[H // 2 - 1, W // 2 - 1]] * 4, dtype=torch.int32, device=dev)
        shapes["snap"] = (snap, lanes[:1].contiguous(), centre[:1], None, 1)
        shapes["snap4"] = (snap, lanes.contiguous(), centre, None, 1)
    else:
        spec = make_spec((H, W), 41, 25, True)
        frames, path = disc_clip(T, 12)
        p0 = torch.tensor([path[0]], dtype=torch.int32, device=dev)
        shapes["bench"] = (spec, frames[None], p0, None, T)
        crops, cp0, box = crop_case(frames, path, ROI, ROI_T)
        shapes["roi185"] = (spec, crops[None], cp0[None], box, ROI_T)
    del frames
    fills = torch.full((4,), 128, dtype=torch.uint8, device=dev)
    flush = torch.empty(100 << 20, dtype=torch.uint8, device=dev) if args.cold else None
    out = torch.empty((4, T, 2), dtype=torch.int32, device=dev)

    def plan_of(shape, cluster):
        sp = shapes[shape][0]
        L = sp.kernel_len
        if tiled:
            if cluster is None:
                return tk._tiled_plan(sp.radii, L, limit, False, 0)
            return tk.tile_plan(sp.radii, L, limit, False, cluster=cluster)
        if cluster is None:
            return tk._scan_plan(sp.radii, L, limit, 1, 0)
        return tk.scan_plan(sp.radii, L, cluster)

    def launch(lib, shape, steps, cluster):
        sp, fr, p0, b, _ = shapes[shape]
        taps, direction, L = tk._taps(sp.sigma, True, dev)
        B, _, h, w = fr.shape
        bp = [None] * 3 if b is None else [a.data_ptr() for a in b]
        plan = plan_of(shape, cluster)
        common = (fr.data_ptr(), fr.stride(0) if B > 1 else 0, B, steps, h, w, p0.data_ptr(),
                  fills.data_ptr(), *bp, taps.data_ptr(), L, sp.radii[0], sp.radii[1], direction,
                  out.data_ptr(), None,
                  1, 0, 0, None, None, None, None, None)  # one segment
        stream = torch.cuda.current_stream().cuda_stream
        if tiled:
            err = lib.dog_scan_tiled_launch(*common, *plan.tile, plan.cluster, stream)
        else:
            err = lib.dog_scan_launch(*common, plan.cluster, stream)
        if err != 0:
            raise RuntimeError(lib.dog_scan_error_string(err).decode())

    def plain(shape, steps):
        sp, fr, p0, b, _ = shapes[shape]
        bounds = {} if b is None else dict(zip(("deltas", "lo", "hi"), (a[:steps] for a in b)))
        return torch.stack([tk.dog_scan_plain(fr[lane, :steps], p0[lane], 128, radii=sp.radii,
                                              sigma=sp.sigma, darker_target=True, **bounds)
                            for lane in range(fr.shape[0])])

    clusters = [None if c == "auto" else int(c) for c in args.clusters.split(",")]
    sources = [("dog_scan.cu", os.path.join(ROOT, "pawsometracker_tpu_torch", "csrc",
                                            "dog_scan.cu"))]
    sources += [(os.path.basename(s), s) for s in args.src]
    record = {"card": card, "kernel": args.kernel,
              "shapes": {n: {"frame": list(v[1].shape[2:]), "lanes": v[1].shape[0],
                             "radii": list(v[0].radii), "L": v[0].kernel_len,
                             "bounded": v[3] is not None, "T": v[4],
                             "plan": plan_of(n, None)._asdict()} for n, v in shapes.items()},
              "clusters": args.clusters, "runs": []}
    for label, path_ in sources:
        text = open(path_).read()
        for variant in variants:
            patched = apply_patches(text, patches[variant], label, variant)
            name = f"{os.path.splitext(label)[0]}_{args.kernel}_{variant}"
            lib, regs = build(patched, name)
            for shape in shape_names:
                steps = shapes[shape][4]
                lanes = shapes[shape][1].shape[0]
                for cluster in clusters:
                    if variant in CHECKED:
                        n = min(steps, 8)
                        want = plain(shape, n)
                        launch(lib, shape, n, cluster)
                        torch.cuda.synchronize()
                        got = out.view(-1)[:lanes * n * 2].view(lanes, n, 2)  # [B, n, 2]
                        if not torch.equal(got, want):
                            raise SystemExit(f"{label} {shape} C={cluster}: the kernel differs"
                                             " from the plain version")
                    c = plan_of(shape, cluster).cluster
                    ms_t = device_ms(lambda: launch(lib, shape, steps, cluster),
                                     20 if steps > 1 else 200)
                    run = {"source": label, "variant": variant, "shape": shape, "cluster": c,
                           "T": steps, "ms_T": ms_t, "ptxas": regs}
                    line = f"{label} {variant} {shape} C={c}: T={steps} {ms_t:.4f} ms"
                    if steps > 1:
                        ms1 = device_ms(lambda: launch(lib, shape, 1, cluster), 200)
                        step_us = 1e3 * (ms_t - ms1) / (steps - 1)
                        run.update(ms_T1=ms1, us_per_step=step_us, fixed_us=1e3 * ms1 - step_us)
                        line += (f", T=1 {1e3 * ms1:.2f} us; per step {step_us:.2f} us, fixed"
                                 f" {run['fixed_us']:.2f} us")
                    if args.cold:
                        run["ms_T_cold"] = device_ms_cold(
                            lambda: launch(lib, shape, steps, cluster), 20 if steps > 1 else 50,
                            flush)
                        line += f"; L2 emptied before each launch {run['ms_T_cold']:.4f} ms"
                    if args.clocks and variant == "full" and shape == shape_names[0]:
                        run["clocks_under_load"] = clocks_under_load(
                            lambda: launch(lib, shape, steps, cluster))
                        print(f"{label} under load: {run['clocks_under_load']}", flush=True)
                    record["runs"].append(run)
                    print(line, flush=True)
            print(f"{label} {variant}: ptxas {regs}", flush=True)
            if args.sass and variant == "full":
                sass = sass_histogram(lib._name)
                record.setdefault("sass", {})[label] = sass
                for fn, ops in sass.items():
                    print(f"{label} SASS {fn}: {sum(ops.values())} instructions: "
                          + ", ".join(f"{op} {n}" for op, n in list(ops.items())[:16]), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_name = "dog_scan_tiled_split.json" if tiled else "dog_scan_split.json"
    with open(os.path.join(ROOT, "build", out_name), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0

if __name__ == "__main__":
    sys.exit(main())
