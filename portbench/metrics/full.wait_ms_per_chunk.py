"""``full.wait_ms_per_chunk``: the full-frame controller's wait, in ms a chunk.

Over the window's calls on the full-frame stream: the call's wall time less
every timer section the program recorded (time the controller spends waiting
on the prefetch thread's staging copy, and its own Python), over the chunk
launches (``groups``).
"""


def read(rec):
    calls = [c for c in rec.calls if c["stats"] is not None and c["stats"]["stream"] == "full"
             and c["stats"].get("groups")]
    groups = sum(c["stats"]["groups"] for c in calls)
    if not groups:
        return None
    wait = sum(c["wall_s"] - sum(c["stats"]["sections"].values()) for c in calls)
    return 1e3 * wait / groups
