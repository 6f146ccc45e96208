"""Tiny cells for the CPU tests: the benchmark's cells at a size the plain
version runs in a second (120x160 frames, a 6 px target)."""

CONFIG = dict(name="tiny", entry="track", height=120, width=160, fps=24, target_width=6,
              window_size=13, darker_target=True, engine="auto", chunk_size=8,
              target_radius_px=3.0, target_level=30, noise_sigma=2.0)
TRAFFIC = dict(motion="circle", motion_params=dict(radius_px=15, frames_per_turn=60),
               phase_jitter_deg=30, clip_sets=2, stream="auto", mesh=None, chips=1,
               videos=[dict(frames=20, background=128, start="autodetect", phase_deg=[0, 180])])
BATCH_VIDEOS = [dict(frames=20, background=128, start="autodetect", phase_deg=[0, 180]),
                dict(frames=20, background=100, start="xy", phase_deg=[90]),
                dict(frames=16, background=160, start="xy", phase_deg=[180]),
                dict(frames=20, background=128, start="xy", phase_deg=[270])]


#: three animals in one arena, each on a small spiral about its own corner,
#: more than the 29 px square a step reads at these sizes apart
MULTI_DISCS = [dict(phase_deg=[0], motion_params=dict(offset_px=[-42, -62])),
               dict(phase_deg=[120], motion_params=dict(offset_px=[-42, 62])),
               dict(phase_deg=[240], motion_params=dict(offset_px=[40, 0]))]
MULTI = dict(motion="spiral", motion_params=dict(loops=2, radius_px=5, jitter_px=1.0,
                                                  start_box_px=1),
             phase_jitter_deg=180, stream="roi", clip_sets=2)


def cell(kind: str = "track", **traffic):
    """``(cell, configuration, traffic)`` of a tiny cell: ``track``, ``batch``
    (track_batch of 4 videos), ``mesh`` (the same over a 4-entry CPU mesh), or
    ``multi`` / ``multi-auto`` (track_multi of 3 discs in one video, from their
    starts / autodetected) on ROI crops."""
    config = dict(CONFIG)
    t = dict(TRAFFIC)
    if kind in ("batch", "mesh"):
        config["entry"] = "track_batch"
        t.update(videos=BATCH_VIDEOS, clip_sets=1)
    if kind == "mesh":
        t.update(mesh="auto", chips=4)
    if kind.startswith("multi"):
        config["entry"] = "track_multi"
        start = "autodetect" if kind == "multi-auto" else "xy"
        t.update(MULTI, videos=[dict(frames=40, background=128,
                                     discs=[dict(d, start=start) for d in MULTI_DISCS])])
    t.update(traffic)
    return dict(name=f"tiny-{kind}", config="tiny", traffic="tiny", chips=t["chips"]), config, t

#: the upstream tests' spiral at the tiny cells' scale, forced onto the ROI
#: pipeline, where its jitter makes the prediction miss and replay
SPIRAL = dict(motion="spiral", motion_params=dict(loops=5, radius_px=15, jitter_px=1.0,
                                                   start_box_px=5),
              phase_jitter_deg=180, stream="roi",
              videos=[dict(frames=60, background=128, start="autodetect", phase_deg=[0])])
