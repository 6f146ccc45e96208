#!/usr/bin/env python3
"""Where a step of the port's dog_scan kernel goes, measured on the card.

    python3 tools/dog_scan_split.py [--src FILE.cu ...] [--variants full,no_rows,...]
                                    [--clusters auto,1,6] [--shapes bench,roi185]

Builds variants of ``pawsometracker_tpu_torch/csrc/dog_scan.cu`` (and of each
``--src``, a candidate source with the same C interface) with ``nvcc`` into
``build/kernels/split/``. A variant is the source with one part of the step
taken out by a text patch:

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

The variants' results are wrong and are not checked. Each is timed with CUDA
events behind a queued sleep of the card, so that the host's per-launch cost
does not enter, at each shape of ``--shapes``: ``bench`` (1080p frames, 41x41
window, ``target_width=25``, L = 65, one chain, unbounded) for T = 64 and
T = 1, and ``roi185`` (the 185x185 crop ``track`` cuts at 1080p: the same
window, bounded, a width that is not a multiple of 16) for T = 12 and T = 1;
from the two the per-step and the fixed cost of a launch. Each variant runs
under each cluster size of ``--clusters`` (``auto``: the wrapper's plan for
one lane). Prints the card's name and power limit, ``ptxas``'s registers per
variant, one line per variant, shape and cluster size, and writes
``build/dog_scan_split.json``. With ``--sass`` it also counts the SASS
opcodes of each ``full`` build's kernels (``cuobjdump -sass``), to read what
one tap of a pass issues; with ``--clocks`` it reads the card's SM clock,
power and temperature (``nvidia-smi``) while the ``full`` build runs 64-step
launches back to back for two seconds, since the issue rate per second
follows the clock.
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
# the loop bounds of the two passes, the prefetch's call and the exchange, as the source has them
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
PATCHES = {
    "full": [],
    "no_rows": [ROW_LOOP],
    "no_cols": [COL_LOOP],
    "no_passes": [ROW_LOOP, COL_LOOP],
    "no_prefetch": PREFETCH,
    "no_exchange": EXCHANGE,
    "fixed": [ROW_LOOP, COL_LOOP, *PREFETCH],
    "row_offsets": [("return reinterpret_cast<uintptr_t>(frames) % 16 == 0 && W % 16 == 0",
                     "return false && W % 16 == 0")],
}


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


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=[],
                    help="a candidate source with dog_scan.cu's C interface")
    ap.add_argument("--variants", default=",".join(PATCHES))
    ap.add_argument("--sass", action="store_true", help="count the SASS opcodes of each kernel")
    ap.add_argument("--clocks", action="store_true",
                    help="read the SM clock while the kernel runs back to back")
    ap.add_argument("--clusters", default="auto",
                    help="cluster sizes to launch, comma-separated (auto: the wrapper's plan)")
    ap.add_argument("--shapes", default="bench,roi185", help="bench, roi185 or both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dog_scan_split: no CUDA device", file=sys.stderr)
        return 2
    from pawsometracker_tpu_torch.models.dog_tracker import make_spec
    from pawsometracker_tpu_torch.ops import tracker_kernel as tk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    spec = make_spec((H, W), 41, 25, True)
    taps, direction, L = tk._taps(spec.sigma, True, dev)
    ri, rj = spec.radii
    yy, xx = np.mgrid[:H, :W]
    frames = np.full((T, H, W), 128, np.uint8)
    path = [(540 + 3 * t, 960 - 2 * t) for t in range(T)]
    for t, (i, j) in enumerate(path):
        frames[t][(yy - i) ** 2 + (xx - j) ** 2 <= 144] = 30
    frames = torch.from_numpy(frames).to(dev)
    # the 185x185 crop about the disc's first position, as the ROI pipeline cuts it; its
    # boxes the whole crop, no rebase
    r0, c0 = path[0][0] - ROI // 2, path[0][1] - ROI // 2
    crops = frames[:ROI_T, r0:r0 + ROI, c0:c0 + ROI].contiguous()
    box = [torch.zeros((ROI_T, 2), dtype=torch.int32, device=dev),
           torch.zeros((ROI_T, 2), dtype=torch.int32, device=dev),
           torch.full((ROI_T, 2), ROI - 1, dtype=torch.int32, device=dev)]
    shapes = {"bench": (frames, torch.tensor(path[0], dtype=torch.int32, device=dev), None, T),
              "roi185": (crops, torch.tensor([ROI // 2] * 2, dtype=torch.int32, device=dev), box,
                         ROI_T)}
    fills = torch.full((1,), 128, dtype=torch.uint8, device=dev)
    out = torch.empty((1, T, 2), dtype=torch.int32, device=dev)

    def launch(lib, shape, steps, cluster):
        fr, p0, b, _ = shapes[shape]
        bp = [None] * 3 if b is None else [a.data_ptr() for a in b]
        err = lib.dog_scan_launch(fr.data_ptr(), 0, 1, steps, fr.shape[1], fr.shape[2],
                                  p0.data_ptr(), fills.data_ptr(), *bp, taps.data_ptr(), L, ri,
                                  rj, direction, out.data_ptr(), None,
                                  1, 0, 0, None, None, None, None, None,  # one segment
                                  cluster, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(lib.dog_scan_error_string(err).decode())

    def plain(shape, steps):
        fr, p0, b, _ = shapes[shape]
        bounds = {} if b is None else dict(zip(("deltas", "lo", "hi"), (a[:steps] for a in b)))
        return tk.dog_scan_plain(fr[:steps], p0, 128, radii=spec.radii, sigma=spec.sigma,
                                 darker_target=True, **bounds)

    limit = tk._smem_limit(0)
    clusters = [tk._scan_plan(spec.radii, L, limit, 1, 0).cluster if c == "auto" else int(c)
                for c in args.clusters.split(",")]
    sources = [("dog_scan.cu", os.path.join(ROOT, "pawsometracker_tpu_torch", "csrc",
                                            "dog_scan.cu"))]
    sources += [(os.path.basename(s), s) for s in args.src]
    record = {"card": card, "shape": {"H": H, "W": W, "T": T, "radii": [ri, rj], "L": L,
                                      "roi": [ROI, ROI], "roi_T": ROI_T},
              "clusters": clusters, "runs": []}
    for label, path_ in sources:
        text = open(path_).read()
        for variant in args.variants.split(","):
            patched = text
            for old, new in PATCHES[variant]:
                if patched.count(old) != 1:
                    raise SystemExit(f"{label}: variant {variant} does not apply ({old!r})")
                patched = patched.replace(old, new)
            name = f"{os.path.splitext(label)[0]}_{variant}"
            lib, regs = build(patched, name)
            for shape in args.shapes.split(","):
                steps = shapes[shape][3]
                for cluster in clusters:
                    if variant in ("full", "row_offsets"):
                        want = plain(shape, 8)
                        launch(lib, shape, 8, cluster)
                        torch.cuda.synchronize()
                        if not torch.equal(out[0, :8], want):
                            raise SystemExit(f"{label} {shape} C={cluster}: the kernel differs"
                                             " from the plain version")
                    ms_t = device_ms(lambda: launch(lib, shape, steps, cluster), 20)
                    ms1 = device_ms(lambda: launch(lib, shape, 1, cluster), 200)
                    step_us = 1e3 * (ms_t - ms1) / (steps - 1)
                    run = {"source": label, "variant": variant, "shape": shape,
                           "cluster": cluster, "T": steps, "ms_T": ms_t, "ms_T1": ms1,
                           "us_per_step": step_us, "fixed_us": 1e3 * ms1 - step_us,
                           "ptxas": regs}
                    if args.clocks and variant == "full":
                        run["clocks_under_load"] = clocks_under_load(
                            lambda: launch(lib, shape, steps, cluster))
                        print(f"{label} under load: {run['clocks_under_load']}", flush=True)
                    record["runs"].append(run)
                    print(f"{label} {variant} {shape} C={cluster}: T={steps} {ms_t:.4f} ms,"
                          f" T=1 {1e3 * ms1:.2f} us; per step {step_us:.2f} us, fixed"
                          f" {run['fixed_us']:.2f} us", flush=True)
            print(f"{label} {variant}: ptxas {regs}", flush=True)
            if args.sass and variant == "full":
                sass = sass_histogram(lib._name)
                record.setdefault("sass", {})[label] = sass
                for fn, ops in sass.items():
                    print(f"{label} SASS {fn}: {sum(ops.values())} instructions: "
                          + ", ".join(f"{op} {n}" for op, n in list(ops.items())[:16]), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "dog_scan_split.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
