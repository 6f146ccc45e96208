"""The detection's span readers on planted records (times in ms): the
``detect`` and ``detect.suppress`` spans summed over the calls that record
spans; nothing where no call detects, or from a program without spans."""

import pytest

from portbench import frames
from portbench.harness import Records
from pawsometracker_tpu_torch.utils.profiling import Span

MS = 1_000_000  # ns
NAMES = ["detect.ms_per_call", "detect.suppress_ms_per_call"]


def span(name, a, b, sid, parent, **attrs):
    return Span(name, a * MS, b * MS, sid, parent, 7, "MainThread", attrs or None)


def multi_call(detect_ms, suppress_ms, spans=True):
    """A full-frame ``track_multi`` call of 100 ms that detects from 10 ms
    on: the response's launches take 1 ms, the rounds ``suppress_ms``, the
    wait for the peaks the rest of ``detect_ms``."""
    s = [span("call", 0, 100, 1, 0), span("snap", 8, 12 + detect_ms, 2, 1),
         span("detect", 10, 10 + detect_ms, 3, 2, targets=96),
         span("detect.response", 10, 11, 4, 3),
         span("detect.suppress", 11, 11 + suppress_ms, 5, 3),
         span("pipeline", 40, 95, 6, 1, stream="full")]
    stats = {"stream": "full", "sections": {}, "counts": {"multi.lanes": 96, "detect.rounds": 96}}
    if spans:
        stats["spans"] = s
    return {"start_ns": 0, "end_ns": 100 * MS, "wall_s": 0.1, "videos": [(240, True)],
            "stats": stats}


def read(name, calls):
    return frames.load_module("metrics", name).read(Records(calls, [], 0.1, [0], {}, {}))


def test_detection_over_the_calls():
    calls = [multi_call(20, 15), multi_call(26, 19)]
    assert read("detect.ms_per_call", calls) == pytest.approx(23.0)
    assert read("detect.suppress_ms_per_call", calls) == pytest.approx(17.0)


def test_a_call_that_does_not_detect_counts_as_a_call():
    """A call from given starts records spans but no detection: it is one of
    the calls the sum is spread over."""
    given = multi_call(20, 15)
    given["stats"]["spans"] = [s for s in given["stats"]["spans"] if not s.name.startswith("detect")]
    calls = [multi_call(20, 15), given]
    assert read("detect.ms_per_call", calls) == pytest.approx(10.0)
    assert read("detect.suppress_ms_per_call", calls) == pytest.approx(7.5)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    """No call that detects, a program without spans, and failed calls (no
    record) give nothing, and none raises."""
    no_detect = multi_call(20, 15)
    no_detect["stats"]["spans"] = no_detect["stats"]["spans"][:2]
    failed = {"start_ns": 0, "end_ns": MS, "wall_s": 0.001, "videos": [(240, True)],
              "stats": None}
    assert read(name, [no_detect, failed]) is None
    assert read(name, [multi_call(20, 15, spans=False), failed]) is None
    assert read(name, []) is None
