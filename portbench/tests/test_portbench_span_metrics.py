"""The span readers' arithmetic on synthetic records: each reader's value on a
ROI call and a full-frame call whose spans are laid out by hand (times in
ms), and nothing from a program that records no spans."""

import pytest

from portbench import frames
from portbench.harness import Records
from portbench.trace import Interval
from pawsometracker_tpu_torch.utils.profiling import Span

MS = 1_000_000  # ns
CTL, PF = "MainThread", "paws-prefetch-0"


def span(name, a, b, sid, parent, thread=CTL, **attrs):
    return Span(name, a * MS, b * MS, sid, parent, 7, thread, attrs or None)


def roi_call():
    """A ROI call of 100 ms and 2 dispatches: pipeline 10-90 holds two
    dispatches and a drain (53 ms); a prefetch span below it on its own
    thread does not count towards its self time."""
    spans = [span("call", 0, 100, 1, 0), span("mode", 2, 5, 2, 1, lane=0),
             span("pipeline", 10, 90, 3, 1, stream="roi"),
             span("dispatch", 12, 30, 4, 3, seq=0), span("shard.copy_in", 20, 22, 5, 4, shard=0),
             span("drain", 40, 60, 6, 3, seq=0), span("shard.wait", 45, 55, 7, 6, shard=0),
             span("dispatch", 65, 80, 8, 3, seq=1), span("shard.launch", 70, 72, 9, 8, shard=0),
             span("stage.read", 15, 95, 10, 3, thread=PF)]
    return {"start_ns": 0, "end_ns": 100 * MS, "wall_s": 0.1, "videos": [(240, True)],
            "stats": {"stream": "roi", "dispatches": 2, "groups": 2, "sections": {},
                      "spans": spans}}


def full_call():
    """A full-frame call of 100 ms and 2 chunks: two staging copies (3 and
    6 ms) on the prefetch thread, two waits for the queue (4 and 6 ms)."""
    spans = [span("call", 0, 100, 1, 0), span("mode", 1, 3, 2, 1, lane=0),
             span("pipeline", 5, 95, 3, 1, stream="full"),
             span("stage.copy", 1, 4, 4, 3, thread=PF), span("stage.copy", 20, 26, 5, 3, thread=PF),
             span("prefetch.wait", 10, 14, 6, 3, lane=0),
             span("prefetch.wait", 30, 36, 7, 3, lane=0)]
    return {"start_ns": 0, "end_ns": 100 * MS, "wall_s": 0.1, "videos": [(240, True)],
            "stats": {"stream": "full", "groups": 2, "sections": {}, "spans": spans}}


def records(calls, intervals=(), cards=(0,)):
    return Records(list(calls), list(intervals), 0.1, list(cards), {}, {})


def read(name, rec):
    return frames.load_module("metrics", name).read(rec)


def test_roi_self_time_is_the_pipeline_less_its_controller_spans():
    # 80 ms less dispatches 18 + 15 and the drain 20: 27 ms over 2 dispatches
    assert read("roi.self_us_per_dispatch", records([roi_call()])) == pytest.approx(13_500)


def test_shard_spans_below_the_pipeline_over_dispatches():
    assert read("mesh.shard_us_per_dispatch", records([roi_call()])) == pytest.approx(7_000)


def test_mode_over_the_videos_set_up():
    assert read("setup.mode_ms_per_video", records([roi_call(), full_call()])) \
        == pytest.approx((3 + 2) / 2)


def test_staging_copy_a_chunk_and_queue_wait_over_groups():
    rec = records([full_call(), roi_call()])
    assert read("full.copy_ms_per_chunk", rec) == pytest.approx(4.5)
    assert read("full.queue_wait_ms_per_chunk", rec) == pytest.approx(5.0)


def test_named_idle_share_per_card_then_the_mean():
    """Card 0 runs 25-50 and 85-120 ms: 60 ms idle in the call, of which the
    controller's spans below the pipeline (2-5, 12-30, 40-60, 65-80) cover
    41; card 1 runs nothing: 56 of 100."""
    ivs = [Interval(25 * MS, 50 * MS, 0, "k", "kernel"),
           Interval(85 * MS, 120 * MS, 0, "Memcpy HtoD", "memcpy")]
    assert read("device.idle_named_pct", records([roi_call()], ivs)) \
        == pytest.approx(100 * 41 / 60)
    assert read("device.idle_named_pct", records([roi_call()], ivs, cards=(0, 1))) \
        == pytest.approx(100 * (41 / 60 + 56 / 100) / 2)


NAMES = ["full.copy_ms_per_chunk", "full.queue_wait_ms_per_chunk", "roi.self_us_per_dispatch",
         "mesh.shard_us_per_dispatch", "setup.mode_ms_per_video", "device.idle_named_pct"]


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_spans_gives_nothing(name):
    """The parent program's records (no ``spans``) and failed calls (no
    record) give every span reader nothing, and none raises."""
    calls = [roi_call(), full_call(), {"start_ns": 0, "end_ns": MS, "wall_s": 0.001,
                                       "videos": [(240, True)], "stats": None}]
    for c in calls[:2]:
        del c["stats"]["spans"]
    ivs = [Interval(0, 5 * MS, 0, "k", "kernel")]
    assert read(name, records(calls, ivs)) is None
