"""``setup.mode_ms_per_video``: frame 1's mode, in ms a video.

The program's ``mode`` spans (``ops/filters.py::mode_u8_host`` on each
video's frame 1, in the entry point's set-up) summed over the window's
calls, over the videos those calls set up.
"""

from portbench.spans import calls_with_spans, dur_ns


def read(rec):
    calls = calls_with_spans(rec)
    videos = sum(len(c["videos"]) for c, _, _ in calls)
    if not videos:
        return None
    return sum(dur_ns(s) for _, spans, _ in calls for s in spans if s.name == "mode") \
        / 1e6 / videos
