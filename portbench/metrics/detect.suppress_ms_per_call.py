"""``detect.suppress_ms_per_call``: the detection's N rounds of suppression,
in ms a call.

The program's ``detect.suppress`` spans (inside ``detect``: each round's
column-major argmax, the peak and the disc about it set to minus infinity,
as the controller issues them) summed over the window's calls that record
spans, over those calls. Nothing to read where no call detects.
"""

from portbench.spans import calls_with_spans, dur_ns


def read(rec):
    calls = calls_with_spans(rec)
    total = [dur_ns(s) for _, spans, _ in calls for s in spans if s.name == "detect.suppress"]
    if not total:
        return None
    return sum(total) / len(calls) / 1e6
