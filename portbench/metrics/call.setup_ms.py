"""``call.setup_ms``: the entry point's set-up a call, in ms.

The program's ``setup``, ``snap`` and ``buffers`` sections (frame 1, its
mode, the spec; the snap onto the target; the ROI controller's pinned
buffers), summed over the window's calls and divided by the calls.
"""

SECTIONS = ("setup", "snap", "buffers")


def read(rec):
    calls = [c for c in rec.calls if c["stats"] is not None]
    if not calls:
        return None
    total = sum(c["stats"]["sections"].get(k, 0.0) for c in calls for k in SECTIONS)
    return 1e3 * total / len(calls)
