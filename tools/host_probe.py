#!/usr/bin/env python3
"""Time the ROI path's host pieces of one checkout of the port, each alone, on the card's host.

    python3 tools/host_probe.py [--root DIR]

Imports ``pawsometracker_tpu_torch`` from ``--root`` (this checkout by
default; for example a ``git archive`` of the parent commit unpacked under
``build/``) and prints, in microseconds a call on the host's clock:

- the 24-hour timestamp grid (``np.linspace(0, 86399.999, 2073600)``) and
  ``mode_u8_host`` of a 1080p frame of ``chip_smoke.py``'s clip;
- 12 crops of 185x185 and of 461x461 with the checkout's numpy crop
  (``ops.roi_crop.crop_with_fill``, a frame at a time), into a numpy buffer and a
  pinned one, from frames in cache and from frames read once (a 480-frame
  1080p stack); and, where the checkout has it, its native chunk crop
  (``ops.roi_crop.crop_lanes_native``) on 1, 2, 3, 4 and 6 threads, one lane
  and 4 lanes;
- the pieces of a segmented launch at the batch ROI engine's shape (4 lanes
  of 12 185x185 crops, the carry in the launch), with the card asleep so that
  launches only queue: the call through ``TrackerFns``, the public wrapper,
  its checks, ``_shared_stride``, ``tracker_kernel._launch``, the engine's
  argument views, two output allocations, a device context, the current
  stream, an event, two and one staging copies, the copies back, a ``u8``
  conversion of a tensor of its type and the ctypes call alone.

Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, n):
    """Host microseconds a call of ``fn``, after one call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t0) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="the checkout whose port is timed")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("host_probe: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    from pawsometracker_tpu_torch import pipeline as pl
    from pawsometracker_tpu_torch.models.dog_tracker import make_spec, tracker_fns
    from pawsometracker_tpu_torch.ops import tracker_kernel as tk
    from pawsometracker_tpu_torch.ops.filters import mode_u8_host
    from pawsometracker_tpu_torch.ops.roi_crop import crop_with_fill

    print(cs.card_line(), f"({os.path.abspath(args.root)})", flush=True)
    frames, _ = cs.synth_clip()
    print(f"grid: 24-hour np.linspace {host_us(lambda: np.linspace(0, 86399.999, 2073600), 5):.1f}"
          f" us; mode_u8_host at 1080p {host_us(lambda: mode_u8_host(frames[0]), 10):.1f} us")

    # the crops
    stack = np.full((480, cs.H, cs.W), 128, np.uint8)
    stack[:, ::7, ::5] = 90
    for c in (185, 461):
        for name, buf in (("numpy", np.empty((12, c, c), np.uint8)),
                          ("pinned", torch.empty((12, c, c), dtype=torch.uint8,
                                                 pin_memory=True).numpy())):
            hot = host_us(lambda: [np.copyto(buf[i], frames[5, 100:100 + c, 200:200 + c])
                                   for i in range(12)], 50)
            at = [0]

            def cold(buf=buf, c=c, at=at):
                t = at[0] = (at[0] + 12) % 468
                for i in range(12):
                    crop_with_fill(stack[t + i], (300 + i, 600 + i), c, c, 128, out=buf[i])

            print(f"crop {c}x{c} x12 into {name}: numpy crop of frames read once"
                  f" {host_us(cold, 39):.1f} us, copies from frames in cache {hot:.1f} us")
    try:
        from pawsometracker_tpu_torch.ops import roi_crop
    except ImportError:
        roi_crop = None
    if roi_crop is not None:
        for c in (185, 461):
            for L in (1, 4):
                out = torch.empty((L, 12, c, c), dtype=torch.uint8, pin_memory=True).numpy()
                origins = np.array([[(300 + 50 * b + i, 600 + 80 * b + i) for i in range(12)]
                                    for b in range(L)])
                fills = np.full(L, 128, np.uint8)
                row = {}
                for name, fn in [("numpy", lambda ch, t: roi_crop.crop_lanes_plain(
                        ch, [12] * L, origins, fills, out))] + [
                        (f"native on {t}", (lambda t: lambda ch, _: roi_crop.crop_lanes_native(
                            ch, [12] * L, origins, fills, out, threads=t))(t))
                        for t in (1, 2, 3, 4, 6)]:
                    ts = []
                    for rep in range(39):
                        t0f = (rep * 12) % 468
                        t0 = time.perf_counter()
                        fn([stack[t0f:t0f + 12]] * L, None)
                        ts.append(time.perf_counter() - t0)
                    row[name] = 1e6 * float(np.median(ts[3:]))
                print(f"chunk crop {c}x{c}, {L} lane(s), median us: "
                      + ", ".join(f"{k} {v:.1f}" for k, v in row.items()), flush=True)

    # a segmented launch's pieces, the card asleep
    dev = torch.device("cuda", 0)

    def queued_us(fn, n=300):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        return us

    spec = make_spec((185, 185), (41, 41), 25, True)
    fns = tracker_fns(spec, dev, "pallas")
    L, K, S = 4, 12, 1
    n = 6 * L * K + 7 * L
    crops = torch.full((S, L, K, 185, 185), 128, dtype=torch.uint8, device=dev)
    flat = torch.zeros((S, n), dtype=torch.int32, device=dev)
    a = pl._batch_args(flat, L, K)
    a.hi[...] = 184
    fills = torch.full((L,), 128, dtype=torch.uint8, device=dev)
    carry = torch.full((L, 2), 90, dtype=torch.int32, device=dev)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True)
    named = dict(deltas=a.deltas, lo=a.lo, hi=a.hi, ks=a.ks, origin0=a.origin0,
                 origin_last=a.origin_last)
    seg = tk._Segments(S, 0, n, a.ks, a.origin0, a.origin_last, carry, carry)
    stream = torch.cuda.Stream(dev)
    pin = torch.empty((L, K, 185, 185), dtype=torch.uint8, pin_memory=True)
    pin_args = torch.empty(n, dtype=torch.int32, pin_memory=True)
    pos_h = torch.empty((L, K, 2), dtype=torch.int32, pin_memory=True)
    pos = torch.empty((S, L, K, 2), dtype=torch.int32, device=dev)

    def record(s):
        e = torch.cuda.Event()
        e.record(s)
        return e

    def copies(two):
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            crops[0].copy_(pin, non_blocking=True)
            if two:
                flat[0].copy_(pin_args, non_blocking=True)
            e = record(stream)
        torch.cuda.current_stream(dev).wait_event(e)

    def back():
        with torch.cuda.device(dev):
            s = torch.cuda.current_stream(dev)
            record(s)
            pos_h[slice(None)].copy_(pos[0], non_blocking=True)
            record(s)

    def in_context():
        with torch.cuda.device(dev):
            pass

    lib = tk._lib()
    plan = tk._scan_plan(spec.radii, spec.kernel_len, tk._smem_limit(0), L, 0)
    taps = tk._taps(spec.sigma, True, dev)[0]
    out = torch.empty((1, L, K, 2), dtype=torch.int32, device=dev)
    raw = (crops.data_ptr(), crops.stride(1), L, K, 185, 185, None, fills.data_ptr(),
           a.deltas.data_ptr(), a.lo.data_ptr(), a.hi.data_ptr(), taps.data_ptr(),
           spec.kernel_len, spec.radii[0], spec.radii[1], 1.0, out.data_ptr(), None, 1, 0, n,
           a.ks.data_ptr(), a.origin0.data_ptr(), a.origin_last.data_ptr(), carry.data_ptr(),
           carry.data_ptr(), plan.cluster, torch.cuda.current_stream(dev).cuda_stream)
    pieces = {
        "through TrackerFns": lambda: fns.scan_bounded_batch_super(
            crops, carry, fills, a.deltas, a.lo, a.hi, a.ks, a.origin0, a.origin_last,
            carry_out=carry),
        "the public wrapper": lambda: tk.dog_scan_batch_segments_cuda(
            crops, None, fills, carry=carry, carry_out=carry, **named, **kw),
        "its argument checks": lambda: tk._check_segment_args(
            crops, None, fills, a.deltas, a.lo, a.hi, a.ks, a.origin0, a.origin_last, carry,
            carry, True),
        "its CUDA checks": lambda: tk._check_cuda(dict(
            frames=crops[0], fills=fills, pos0=None, carry=carry, carry_out=carry,
            **{k: v[0] for k, v in named.items()})),
        "_shared_stride": lambda: tk._shared_stride(named, S),
        "tracker_kernel._launch": lambda: tk._launch(
            crops, crops.stride(1), L, K, None, fills, a.deltas, a.lo, a.hi, spec.radii,
            spec.sigma, True, False, "probe", seg),
        "the engine's argument views": lambda: pl._batch_args(flat, L, K),
        "two output allocations": lambda: (
            torch.empty((1, L, K, 2), dtype=torch.int32, device=dev),
            torch.empty((1, L, K, 2), dtype=torch.float32, device=dev)),
        "a device context": in_context,
        "the current stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "an event recorded": lambda: record(torch.cuda.current_stream(dev)),
        "two staging copies": lambda: copies(True),
        "one staging copy": lambda: copies(False),
        "the copies back": back,
        "u8 of a uint8 card tensor": lambda: torch.as_tensor(fills, device=dev).to(
            torch.uint8).contiguous(),
        "the ctypes call alone": lambda: lib.dog_scan_launch(*raw),
    }
    for name, fn in pieces.items():
        print(f"launch piece, {name}: {queued_us(fn):.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
