#!/usr/bin/env python3
"""Time the routes by which a 64-frame 1080p chunk of an in-memory array reaches the card.

    python3 tools/staging_probe.py [--root DIR] [--chunks 8] [--json PATH]

Imports ``pawsometracker_tpu_torch`` from ``--root`` (this checkout by
default) and times, on the card's host, one chunk ``[64, 1080, 1920]`` uint8
taken as a view of a 480-frame array in memory (1 GB, so a chunk is read
from memory, not from a cache), each chunk the next of the array:

- (a) numpy's copy into a pinned buffer (what ``_FullFrameEngine._stage``
  did), then the copy to the card;
- (b) the native copy (``ops.roi_crop.crop_lanes_native`` with every origin
  at 0 and the whole frame as the crop: ``csrc/roi_crop.cpp``, Python's lock
  released) on 1, 2, 4 and 6 threads into a pinned buffer, then the copy to
  the card;
- (c) the copy to the card straight from the pageable view;
- (d) the view's pages registered with ``cudaHostRegister``, the copy to the
  card, and the pages unregistered: once a chunk, and once a call (the whole
  array registered once, every chunk copied, then unregistered), the
  registration's own time counted;
- (e) the copy of (a), of (b) on 6 threads and of (f) on 6 threads moved to
  a second thread, so that it overlaps the previous chunk's copy to the card
  and a wait on the card as long as the bench chunk's scan (0.33 ms): ms a
  chunk in the steady state over ``--chunks`` chunks, beside the same work in
  one thread;
- (f) the staging copy (``ops.roi_crop.copy_frames_native``: ``copy_frames``
  of ``csrc/roi_crop.cpp``, byte ranges in non-temporal stores) in each form
  it takes: the chunk's frames one block (on 1, 2, 4 and 6 threads), frames
  lying apart (every other frame of the array) and rows lying apart (frames
  of a second array whose rows are 64 bytes longer than a frame's), each
  beside (b) on 6 threads on the same views.

Each route's copy to the card lands in one device buffer and is checked
equal to the chunk. Prints ms a chunk on the host's clock (the host part, and
the whole until the chunk is on the card) with the card's name and power
limit, and one JSON object last; ``--json`` writes it too. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, H, W, N = 64, 1080, 1920, 480


def card_line() -> str:
    """The card's name and power limit, by ``chip_smoke.py``'s ``card_line``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.card_line()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="the checkout whose port is timed")
    ap.add_argument("--chunks", type=int, default=8, help="chunks a timed route")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("staging_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from pawsometracker_tpu_torch.ops import roi_crop

    card = card_line()
    print(f"{card} ({os.path.abspath(args.root)}), {os.cpu_count()} host cores", flush=True)
    dev = torch.device("cuda", 0)
    stack = np.empty((N, H, W), np.uint8)
    for k in range(N):  # every page written, each frame its own
        stack[k] = k % 251
        stack[k, ::7, ::5] = 90
    wide = np.empty((3 * T, H, W + 64), np.uint8)  # rows lying apart
    for k in range(3 * T):
        wide[k] = (k * 7) % 251
    d_chunk = torch.empty((T, H, W), dtype=torch.uint8, device=dev)
    pinned = [torch.empty((T, H, W), dtype=torch.uint8, pin_memory=True) for _ in range(3)]
    zeros = np.zeros((1, T, 2), np.int64)
    fill = np.zeros(1, np.uint8)
    at = [0]
    cudart = torch.cuda.cudart()

    def next_view():
        t0 = at[0]
        at[0] = (t0 + T) % (N - T)
        return stack[t0:t0 + T]

    def next_apart():  # every other frame
        t0 = at[0]
        at[0] = (t0 + 2 * T) % (N - 2 * T)
        return stack[t0:t0 + 2 * T:2]

    def next_wide(turn=[0]):  # the three chunks of ``wide`` in turn
        turn[0] += 1
        return wide[turn[0] % 3 * T:(turn[0] % 3 + 1) * T, :, :W]

    def check(view):
        if not torch.equal(d_chunk[[0, T - 1]].cpu(), torch.from_numpy(view[[0, T - 1]].copy())):
            raise SystemExit("staging_probe: the chunk on the card differs from the view")

    def timed(host_fn, h2d_fn, verify=True, views=next_view):
        """(host ms, total ms) of one chunk by a route, medians over --chunks."""
        hosts, totals = [], []
        for _ in range(args.chunks + 1):
            view = views()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            src = host_fn(view)
            t1 = time.perf_counter()
            h2d_fn(src)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if verify:
                check(view)
            hosts.append(1e3 * (t1 - t0))
            totals.append(1e3 * (t2 - t0))
        return statistics.median(hosts[1:]), statistics.median(totals[1:])

    def h2d(src):
        d_chunk.copy_(src, non_blocking=True)

    def numpy_copy(view, buf=pinned[0]):
        buf.numpy()[...] = view
        return buf

    def native_copy(view, threads, buf=pinned[0]):
        roi_crop.crop_lanes_native([view], [T], zeros, fill, buf.numpy()[None], threads=threads)
        return buf

    forms = []

    def staging_copy(view, threads, buf=pinned[0]):
        forms.append(roi_crop.copy_frames_native(view, buf.numpy(), threads=threads))
        return buf

    out = {"card": card, "host_cores": os.cpu_count(), "chunk": [T, H, W], "routes": {}}

    def report(name, host_ms, total_ms, **extra):
        out["routes"][name] = {"host_ms": host_ms, "total_ms": total_ms, **extra}
        print(f"{name}: host {host_ms:.2f} ms, until on the card {total_ms:.2f} ms a chunk"
              + "".join(f", {k} {v:.2f}" if isinstance(v, float) else f", {k} {v}"
                        for k, v in extra.items()), flush=True)

    report("(a) numpy copy into pinned, then H2D", *timed(numpy_copy, h2d))
    for threads in (1, 2, 4, 6):
        report(f"(b) native copy on {threads} thread(s) into pinned, then H2D",
               *timed(lambda v, t=threads: native_copy(v, t), h2d))
    for threads in (1, 2, 4, 6):
        times = timed(lambda v, t=threads: staging_copy(v, t), h2d)
        report(f"(f) staging copy on {threads} thread(s) into pinned, then H2D", *times,
               form=forms[-1])
    for name, views in (("frames apart", next_apart), ("rows apart", next_wide)):
        report(f"(b) native copy on 6 threads into pinned, then H2D, {name}",
               *timed(lambda v: native_copy(v, 6), h2d, views=views))
        times = timed(lambda v: staging_copy(v, 6), h2d, views=views)
        report(f"(f) staging copy on 6 threads into pinned, then H2D, {name}", *times,
               form=forms[-1])
    report("(c) H2D from the pageable view", *timed(lambda v: torch.from_numpy(v), h2d))
    h2d_ms = timed(lambda v: pinned[1], h2d, verify=False)[1]
    report("H2D alone from pinned", 0.0, h2d_ms)

    # (d) cudaHostRegister: once a chunk, and once a call
    def register(ptr, size):
        err = int(cudart.cudaHostRegister(ptr, size, 0))
        if err:
            raise SystemExit(f"staging_probe: cudaHostRegister failed with {err}")

    def unregister(ptr):
        err = int(cudart.cudaHostUnregister(ptr))
        if err:
            raise SystemExit(f"staging_probe: cudaHostUnregister failed with {err}")

    regs, unregs, totals = [], [], []
    for _ in range(args.chunks + 1):
        view = next_view()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        register(view.ctypes.data, view.nbytes)
        t1 = time.perf_counter()
        h2d(torch.from_numpy(view))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        unregister(view.ctypes.data)
        t3 = time.perf_counter()
        check(view)
        regs.append(1e3 * (t1 - t0))
        unregs.append(1e3 * (t3 - t2))
        totals.append(1e3 * (t3 - t0))
    report("(d) registered once a chunk: register, H2D, unregister",
           statistics.median(regs[1:]) + statistics.median(unregs[1:]),
           statistics.median(totals[1:]), register_ms=statistics.median(regs[1:]),
           unregister_ms=statistics.median(unregs[1:]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    register(stack.ctypes.data, stack.nbytes)
    t1 = time.perf_counter()
    n_chunks = N // T
    for k in range(n_chunks):
        h2d(torch.from_numpy(stack[k * T:(k + 1) * T]))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    unregister(stack.ctypes.data)
    t3 = time.perf_counter()
    check(stack[(n_chunks - 1) * T:n_chunks * T])
    report(f"(d) registered once a call ({N} frames): per chunk", 1e3 * (t1 - t0 + t3 - t2)
           / n_chunks, 1e3 * (t3 - t0) / n_chunks, register_ms=1e3 * (t1 - t0),
           unregister_ms=1e3 * (t3 - t2), h2d_ms=1e3 * (t2 - t1) / n_chunks)

    # (e) the copy on a second thread, overlapping the previous chunk's H2D and a scan-long wait
    stream = torch.cuda.Stream(dev)
    sleep_cycles = 600_000  # ~0.33 ms at the H100's 1.98 GHz boost clock

    def pipeline(copy, overlap: bool) -> float:
        """ms a chunk over --chunks chunks: each copied into pinned buffer i % 3 (once the
        copy to the card of chunk i - 3 is done), copied to the card on a side stream and
        followed by a scan-long wait on the card; the copies on a second thread if
        ``overlap``."""
        views = [next_view() for _ in range(args.chunks)]
        events = [None] * len(views)
        ready = [threading.Event() for _ in views]
        issued = [threading.Event() for _ in views]

        def stage(i):
            if i >= 3:
                issued[i - 3].wait()
                events[i - 3].synchronize()
            copy(views[i], buf=pinned[i % 3])
            ready[i].set()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        th = threading.Thread(target=lambda: [stage(i) for i in range(len(views))])
        if overlap:
            th.start()
        for i in range(len(views)):
            if not overlap:
                stage(i)
            ready[i].wait()
            with torch.cuda.stream(stream):
                d_chunk.copy_(pinned[i % 3], non_blocking=True)
                events[i] = torch.cuda.Event()
                events[i].record(stream)
            issued[i].set()
            torch.cuda.current_stream(dev).wait_event(events[i])
            torch.cuda._sleep(sleep_cycles)  # the scan's time on the card
        if overlap:
            th.join()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / len(views)

    for name, copy in (("numpy copy", numpy_copy),
                       ("native copy on 6 threads", lambda v, buf: native_copy(v, 6, buf)),
                       ("staging copy on 6 threads", lambda v, buf: staging_copy(v, 6, buf))):
        serial = pipeline(copy, False)
        overlapped = pipeline(copy, True)
        report(f"(e) {name} on a second thread, overlapping H2D and the scan", overlapped,
               overlapped, serial_ms=serial)
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
