"""``detect.ms_per_call``: frame 1's multi-target detection, in ms a call.

The program's ``detect`` spans (``track_multi`` autodetecting: from the call
of ``parallel/mesh.py::global_detect_peaks``'s function until the peaks are
on the host, the whole-frame response and the N rounds of suppression
included) summed over the window's calls that record spans, over those
calls. Nothing to read where no call detects.
"""

from portbench.spans import calls_with_spans, dur_ns


def read(rec):
    calls = calls_with_spans(rec)
    total = [dur_ns(s) for _, spans, _ in calls for s in spans if s.name == "detect"]
    if not total:
        return None
    return sum(total) / len(calls) / 1e6
