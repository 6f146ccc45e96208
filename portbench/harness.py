"""One run of one cell: set-up, the closed loop, the comparison, the result.

The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<cell>.json``); the
configuration names its entry point, a module ``entries/<entry>.py``
(``entrykit.py`` says what it provides); the per-layer metrics are readers in
``metrics/<metric>.py``. Nothing here names a cell, a configuration, an entry
point or a metric: a new one is new files and a new entry.

A run: point the program's caches at fixed directories of the checkout; make
the trial videos on the card from the seed and hand them over as host arrays;
warm up with one call of the cell's own shape; then one caller makes calls
back to back until ``seconds`` have passed, finishing the call in flight.
With ``trace=1`` a ``torch.profiler`` session (CUDA activity only) covers the
window, and the per-layer metrics are read from the calls' wall times, the
program's own per-call record (``paws_stats`` on its logger) and the device
intervals. Once the window has closed and the memory peak is read, every
answer of the window is compared with the plain reference (the entry
module's, in ``reference/``), which works each one out again from the same
host frames.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

import numpy as np

from . import frames
from . import trace as tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
CACHE = os.path.join(HERE, ".cache")
#: top-level module names a run may not hold: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "pawsometracker_tpu")
PORT = "pawsometracker_tpu_torch"


class NoCard(RuntimeError):
    """The machine has no CUDA card, or fewer than the cell asks for."""


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT):
    """``(cell, configuration, traffic)`` of the workload ``name``."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    if int(traffic["chips"]) != int(cell["chips"]) or traffic["config"] != cell["config"]:
        raise ValueError(f"traffic {cell['traffic']} is for {traffic['config']} on "
                         f"{traffic['chips']} chips, the cell is {cell['config']} on "
                         f"{cell['chips']}")
    return cell, config, traffic


def metrics_of(name: str, trace: bool, root: str = ROOT) -> list:
    """The metric entries of BENCHMARK.json that the cell ``name`` reports:
    its end-to-end metrics with ``trace=False``, its per-layer ones with
    ``trace=True``."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if name in m.get("workloads", [name])]


def cache_env() -> None:
    """The program's build and decision caches, at fixed paths in the checkout:
    the nvcc-built libraries, the engine choice's file, CUDA's own cache."""
    os.environ["PAWS_KERNEL_BUILD_DIR"] = os.path.join(CACHE, "kernels")
    os.environ["PAWSOMETRACKER_CACHE"] = os.path.join(CACHE, "paws")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")


def process_start() -> float:
    """When this process started, in ``time.time()`` seconds, from /proc
    (10 ms ticks); the import of this module where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


class StatsLog(logging.Handler):
    """Keeps the program's per-call records: ``paws_stats`` on the records of
    its logger at debug level (the stream, the timer sections in seconds and,
    on ROI, dispatches, replays, groups, crop, K and depth)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records: list = []

    def emit(self, record):
        stats = getattr(record, "paws_stats", None)
        if stats is not None:
            self.records.append(stats)

    def take(self) -> list:
        out, self.records = self.records, []
        return out


def merge_stats(records: list) -> dict | None:
    """A call's records as one (a call that runs in slices logs one a slice):
    the first's stream, the sections and counts summed, every record's spans
    in turn, the rest the last's."""
    if not records:
        return None
    out = dict(records[-1], stream=records[0]["stream"], sections={})
    for r in records:
        for k, v in r.get("sections", {}).items():
            out["sections"][k] = out["sections"].get(k, 0.0) + v
    for key in ("dispatches", "replays", "groups"):
        if key in out:
            out[key] = sum(r.get(key, 0) for r in records)
    if len(records) > 1 and any("spans" in r for r in records):
        out["spans"] = [s for r in records for s in r.get("spans", ())]
    return out


def entry(config: dict):
    """The module of the configuration's entry point, ``entries/<entry>.py``."""
    return frames.load_module("entries", config["entry"])


def compare(calls: list, ref: list) -> dict:
    """The numbers that decide ``correct``, each with its limit: positions
    (``[T, 2]``, or ``[T, targets, 2]``; one a frame and target) and
    timestamps that differ from the reference's (a missing or extra one
    counts as differing), and calls that raised or returned another number
    of videos or targets; all exact, so each limit is 0. ``compared`` counts
    the reference's positions, frames × targets."""
    pos_off = ts_off = failed = compared = 0
    for c in calls:
        want = ref[c["set"]]
        out = c.get("out")
        if out is None or len(out) != len(want) or any(
                np.shape(ij)[1:] != np.shape(ij_r)[1:] for (_, ij), (_, ij_r) in zip(out, want)):
            failed += 1
            continue
        for (ts, ij), (ts_r, ij_r) in zip(out, want):
            ij, ts = np.asarray(ij), np.asarray(ts)
            n = min(len(ij), len(ij_r))
            per_frame = int(np.prod(ij_r.shape[1:-1]))  # targets
            pos_off += int(np.count_nonzero((ij[:n] != ij_r[:n]).any(axis=-1))) \
                + abs(len(ij) - len(ij_r)) * per_frame
            m = min(len(ts), len(ts_r))
            ts_off += int(np.count_nonzero(ts[:m] != ts_r[:m])) + abs(len(ts) - len(ts_r))
            compared += len(ij_r) * per_frame
    checks = {"positions_off": {"value": pos_off, "limit": 0},
              "ts_off": {"value": ts_off, "limit": 0},
              "calls_failed": {"value": failed, "limit": 0}}
    ok = compared > 0 and all(v["value"] <= v["limit"] for v in checks.values())
    return {"correct": ok, "compared": compared, "checks": checks}


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def end_to_end(calls: list, setup_s: float) -> dict:
    """The end-to-end metrics of a window's calls: every position returned
    over the whole window, from the first call's start to the last one's end;
    the 95th percentile (linear between order statistics) of every call's
    wall time; and the set-up's seconds."""
    walls = np.array([c["wall_s"] for c in calls])
    window = calls[-1]["end_s"] - calls[0]["start_s"]
    return {"positions_per_s": sum(c["positions"] for c in calls) / window,
            "call_ms_p95": float(np.percentile(walls * 1e3, 95)),
            "setup_s": setup_s}


class Records:
    """What a per-layer metric reads: the window's calls (``start_ns``,
    ``end_ns``, ``wall_s``, ``positions``, ``videos`` as ``(frames,
    autodetect)``, where every disc of the video autodetects, the program's
    ``stats``), the device intervals (:class:`.trace.Interval`), the
    window's seconds, the cards used, and the cell's configuration and
    traffic."""

    def __init__(self, calls, intervals, window_s, cards, config, traffic):
        self.calls, self.intervals, self.window_s = calls, intervals, window_s
        self.cards, self.config, self.traffic = cards, config, traffic


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        started: float | None = None, cell=None, metric_specs=None) -> dict:
    """One run; returns the result (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` and, traced, ``breakdown``; ``checks`` last).
    ``device="cpu"`` runs the program's plain version on the host, for the
    tests: the result then names the CPU, and no device metric is read.
    ``cell``: ``(cell, configuration, traffic)`` in place of the names'
    files; ``metric_specs``: the metric entries in place of BENCHMARK.json's."""
    started = process_start() if started is None else started
    parts = {}
    t = time.time()
    cell, config, traffic = cell or load_cell(cell_name)
    specs = metric_specs if metric_specs is not None else metrics_of(cell_name, trace)
    chips = int(cell["chips"])
    cache_env()
    import torch

    on_card = device != "cpu"
    if on_card:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA card: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise NoCard(f"the cell needs {chips} cards, the machine has "
                         f"{torch.cuda.device_count()}")
        torch.cuda.init()
    import pawsometracker_tpu_torch as port

    parts["imports_s"] = time.time() - t
    t = time.time()
    sets = frames.plan(config, traffic, seed)
    clip_sets = frames.render(config, sets, seed, "cuda" if on_card else "cpu")
    cards = list(range(chips)) if on_card else []
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    parts["frames_s"] = time.time() - t

    mesh = traffic.get("mesh")
    if mesh == "auto" and not on_card:  # the CPU counterpart of the cards' mesh
        mesh = port.make_mesh(devices=["cpu"] * chips)
    ent = entry(config)
    call = ent.caller(port, config, traffic, None if on_card else "cpu", mesh)
    log = logging.getLogger(PORT)
    handler = StatsLog()
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)

    t = time.time()
    call(clip_sets[0], sets[0])  # warm-up: builds, the engine choice, the depth memo
    if on_card:
        torch.cuda.synchronize()
    handler.take()
    parts["warmup_s"] = time.time() - t

    prof = None
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        torch.cuda.synchronize()
        mark_ns = time.time_ns()
        torch.zeros(1, device="cuda").add_(1)  # the session's first device event
        torch.cuda.synchronize()

    setup_s = time.time() - started
    calls = []
    k = 0
    w0 = time.perf_counter()
    while True:
        s = k % len(clip_sets)
        c0, c0_ns = time.perf_counter(), time.time_ns()
        try:
            out = call(clip_sets[s], sets[s])
        except Exception as e:  # counted as failed; the run goes on  # noqa: BLE001
            out, err = None, f"{type(e).__name__}: {e}"
        else:
            err = None
        c1, c1_ns = time.perf_counter(), time.time_ns()
        recs = handler.take()
        calls.append({"set": s, "out": out, "error": err, "start_ns": c0_ns, "end_ns": c1_ns,
                      "wall_s": c1 - c0, "start_s": c0, "end_s": c1,
                      "positions": ent.positions(out) if out is not None else 0,
                      "videos": [(len(v.paths), all(x is None for x in v.starts))
                                 for v in sets[s]],
                      "stats": merge_stats(recs)})
        k += 1
        if c1 - w0 >= seconds:
            break
    window_s = calls[-1]["end_s"] - calls[0]["start_s"]

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips if on_card else 1,
           "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in cards)
           if on_card else 0}
    result = {"attempted": len(calls), "failed": sum(c["out"] is None for c in calls)}
    metrics = {}  # a run on the CPU reads none: its times are not the card's
    if on_card and not trace:
        values = end_to_end(calls, setup_s)
        for m in specs:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    elif on_card:
        prof.stop()
        mark, *ivs = tracing.device_intervals(prof)  # the marker came first
        offset_ns = mark.start_ns - mark_ns
        del prof
        rec = Records(calls, ivs, window_s, cards, config, traffic)
        for m in specs:
            v = frames.load_module("metrics", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = tracing.busy_s(ivs, cards)
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": tracing.top_ops(ivs),
                               "idle_gaps": tracing.idle_gaps(ivs, calls, offset_ns,
                                                              config["entry"])}
        result["trace_events"] = len(ivs)
    result["metrics"] = metrics
    result["device"] = dev

    log.removeHandler(handler)
    found = banned_modules()
    if found:
        raise ImportError(f"the run loaded {found}: the benchmark drives {PORT} alone")

    t = time.time()
    ref = ent.reference(config, clip_sets, sets)
    verdict = compare(calls, ref)
    result["correct"] = verdict["correct"]
    result["compared_positions"] = verdict["compared"]
    result["reference_s"] = time.time() - t
    result["setup_parts"] = parts
    errors = sorted({c["error"] for c in calls if c["error"]})
    if errors:
        result["errors"] = errors[:3]
    result["checks"] = verdict["checks"]
    return result
