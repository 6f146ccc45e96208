"""The metric arithmetic: busy time as a union, the tail over every call, the
rate over the whole window, the roofline's work count, the readers and the
result line."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import frames, harness, peaks, run
from portbench.trace import Interval, busy_s, idle_gaps, top_ops, union_s

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MS = 1_000_000  # ns


def iv(a, b, dev=0, name="k", kind="kernel"):
    return Interval(a * MS, b * MS, dev, name, kind)


def test_overlapping_copy_and_kernel_count_once():
    # an H2D on a side stream under a kernel: a sum by name reads 15 ms of 10
    ivs = [iv(0, 10, name="dog_scan"), iv(2, 7, name="Memcpy HtoD", kind="memcpy"), iv(20, 25)]
    assert union_s(ivs) == pytest.approx(0.015)
    assert sum(i.end_ns - i.start_ns for i in ivs) / 1e9 == pytest.approx(0.020)
    assert top_ops(ivs)[0] == ["dog_scan", pytest.approx(0.010)]


def test_busy_is_the_mean_over_cards():
    ivs = [iv(0, 10, dev=0), iv(0, 30, dev=1), iv(5, 20, dev=1)]
    assert busy_s(ivs, [0, 1]) == pytest.approx(0.020)


def calls_at(walls_ms, gap_ms=0.0, positions=480):
    calls, t = [], 100.0
    for w in walls_ms:
        calls.append({"start_s": t, "end_s": t + w / 1e3, "wall_s": w / 1e3,
                      "positions": positions})
        t += w / 1e3 + gap_ms / 1e3
    return calls


def test_p95_takes_every_call():
    e2e = harness.end_to_end(calls_at(np.arange(1, 101)), 12.0)
    assert e2e["call_ms_p95"] == pytest.approx(95.05)
    assert e2e["setup_s"] == 12.0


def test_rate_is_over_the_whole_window_stall_included():
    steady = harness.end_to_end(calls_at([50] * 10), 0)["positions_per_s"]
    assert steady == pytest.approx(4800 / 0.5)
    stalled = calls_at([50] * 10)
    for c in stalled[5:]:  # a 1 s stall between calls 5 and 6
        c["start_s"] += 1.0
        c["end_s"] += 1.0
    assert harness.end_to_end(stalled, 0)["positions_per_s"] == pytest.approx(4800 / 1.5)


def chip_smoke_cost():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.cost


@pytest.mark.parametrize("args", [
    ((20, 20), 65, 64, {}), ((20, 20), 65, 1, {}), ((20, 20), 65, 12, {"bounded": True}),
    ((135, 240), 65, 1, {}), ((135, 240), 65, 1, {"lanes": 4}), ((52, 52), 149, 64, {}),
    ((20, 20), 65, 12, {"bounded": True, "subpixel": True, "lanes": 4})])
def test_roofline_work_equals_chip_smokes_cost(args):
    radii, L, T, kw = args
    mine, theirs = peaks.cost(radii, L, T, **kw), chip_smoke_cost()(radii, L, T, **kw)
    assert mine["flops"] == theirs["flops"] and mine["bytes"] == theirs["bytes"]
    assert mine["bound_s"] * 1e3 == pytest.approx(theirs["bound_ms"], rel=1e-12)


CONFIG = json.load(open(os.path.join(ROOT, "portbench/configs/arena1080-tw25.json")))


def record(stream="roi", intervals=(), cards=(0,)):
    sec = {"setup": 0.004, "snap": 0.001, "buffers": 0.002, "crop": 0.008, "device": 0.005}
    stats = {"stream": stream, "sections": sec, "dispatches": 40, "replays": 2, "groups": 8}
    calls = [{"wall_s": 0.060, "stats": stats, "start_ns": 0, "end_ns": 60 * MS,
              "out": [(np.zeros(480), np.zeros((480, 2)))], "videos": [(480, True)]}] * 2
    return harness.Records(calls, list(intervals), 0.120, list(cards), CONFIG, {})


def reader(name):
    return frames.load_module("metrics", name).read


def test_readers_of_the_programs_sections():
    rec = record()
    assert reader("call.setup_ms")(rec) == pytest.approx(7.0)
    assert reader("roi.crop_us_per_dispatch")(rec) == pytest.approx(200.0)
    assert reader("roi.outside_us_per_dispatch")(rec) == pytest.approx(1e6 * 0.040 / 40)
    assert reader("roi.replays_per_dispatch")(rec) == pytest.approx(0.05)
    assert reader("full.wait_ms_per_chunk")(rec) is None
    full = record(stream="full")
    assert reader("full.wait_ms_per_chunk")(full) == pytest.approx(1e3 * 0.040 / 8)
    assert reader("roi.crop_us_per_dispatch")(full) is None
    assert reader("roi.replays_per_dispatch")(full) is None


def test_roofline_and_idle_from_the_device_intervals():
    assert reader("scan.roofline_pct")(record()) is None  # no kernel: nothing to read
    rec = record(intervals=[iv(0, 10), iv(5, 30, kind="memcpy"), iv(60, 66)])
    need = 2 * (peaks.cost((135, 240), 65, 1)["bound_s"]
                + peaks.cost((22, 22), 65, 479, bounded=True)["bound_s"])
    assert reader("scan.roofline_pct")(rec) == pytest.approx(100 * need / 0.016)
    assert reader("device.idle_pct")(rec) == pytest.approx(100 * (1 - 0.036 / 0.120))
    two = record(intervals=[iv(0, 12, dev=0), iv(0, 60, dev=1)], cards=(0, 1))
    assert reader("device.idle_pct")(two) == pytest.approx(100 * (1 - 0.036 / 0.120))


def test_idle_gaps_name_what_the_host_did():
    stats = {"sections": {"setup": 0.010}}
    calls = [{"start_ns": 0, "end_ns": 50 * MS, "stats": stats},
             {"start_ns": 60 * MS, "end_ns": 100 * MS, "stats": stats}]
    gaps = idle_gaps([iv(8, 20), iv(40, 70), iv(80, 100)], calls, 0, "track")
    assert gaps[0] == ["track call, pipeline", pytest.approx(0.020)]
    assert ["track call, set-up (setup, snap, buffers)", pytest.approx(0.008)] in gaps
    assert all(g[1] > 0 for g in gaps) and len(gaps) == 3


def test_result_line_keys_and_check_lines():
    result = {"checks": {"positions_off": {"value": 0, "limit": 0}}, "correct": True,
              "attempted": 3, "failed": 0, "metrics": {}, "device": {}}
    line = json.loads(run.result_line(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert run.check_lines(result) == ["check positions_off 0 limit 0"]


def test_without_a_card_run_exits_non_zero_and_prints_no_result():
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "track-roi-1080",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA card" in r.stderr


def test_benchmark_names_a_file_for_every_piece():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        t = json.load(open(os.path.join(ROOT, "portbench/traffic", f"{w['traffic']}.json")))
        assert os.path.exists(os.path.join(ROOT, "portbench/motion", f"{t['motion']}.py"))
        assert t["chips"] == w["chips"] and t["config"] == w["config"]
    for m in bench["per_layer"]:
        assert callable(reader(m["name"]))


def test_a_call_logged_in_slices_reads_as_one():
    a = {"stream": "roi", "sections": {"setup": 0.002, "crop": 0.010}, "dispatches": 10,
         "replays": 1, "groups": 10, "depth": 2}
    b = {"stream": "roi", "sections": {"setup": 0.003, "aim": 0.004}, "dispatches": 5,
         "replays": 0, "groups": 5, "depth": 3}
    m = harness.merge_stats([a, b])
    assert m["sections"] == pytest.approx({"setup": 0.005, "crop": 0.010, "aim": 0.004})
    assert (m["dispatches"], m["replays"], m["groups"], m["depth"]) == (15, 1, 15, 3)
    assert harness.merge_stats([a]) == a and harness.merge_stats([]) is None


def test_a_call_logged_in_slices_keeps_every_slices_spans():
    from pawsometracker_tpu_torch.utils.profiling import Span

    def rec(sid, a, b):  # one slice: its call span and its frame-1 mode
        return {"stream": "roi", "sections": {}, "dispatches": 1,
                "spans": [Span("call", a * MS, b * MS, sid, 0, sid, "MainThread", None),
                          Span("mode", a * MS, (a + 2) * MS, sid + 1, sid, sid, "MainThread",
                               None)]}

    one, two = rec(1, 0, 10), rec(3, 10, 30)
    m = harness.merge_stats([one, two])
    assert m["spans"] == one["spans"] + two["spans"]
    assert harness.merge_stats([one]) == one and harness.merge_stats([one])["spans"] is one["spans"]
    call = {"start_ns": 0, "end_ns": 30 * MS, "wall_s": 0.03, "videos": [(240, True)], "stats": m}
    rec_ = harness.Records([call], [], 0.03, [0], CONFIG, {})
    assert reader("setup.mode_ms_per_video")(rec_) == pytest.approx(4.0)  # both slices' modes
