"""What the entry modules share.

A configuration's ``entry`` names ``entries/<entry>.py``, which the harness
loads by that name. Each provides:

- ``caller(port, config, traffic, device, mesh)``: ``call(clips, videos) ->
  [(ts, positions), ...]``, one call of the entry point on one set of videos
  (:class:`.frames.Video`), one answer a video;
- ``reference(config, clip_sets, sets, windows=None)``: per set, per video,
  ``(ts, positions)`` as the plain reference works them out from the host
  frames (``windows`` replaces the reference's window arithmetic, as the
  control does);
- ``positions(out)``: the positions a call returned, frames × targets;
- ``work(config, videos, out, bounded)``: the scan work a call's inputs need,
  as keyword arguments of :func:`.peaks.cost`, for ``scan.roofline_pct``
  (``videos``: ``(frames, autodetect)`` a video; ``bounded``: the call ran on
  ROI crops).

Besides the keyword arguments, the display start, the count and the answers'
timestamps, which every entry shares, the reference and the work here are
those of the entry points that follow one disc a video.
"""

from __future__ import annotations

import numpy as np

from .reference import tracker


def keywords(config: dict, traffic: dict, device) -> dict:
    """The keyword arguments every entry point takes from the configuration
    and the traffic."""
    return dict(fps=float(config["fps"]), target_width=float(config["target_width"]),
                window_size=int(config["window_size"]),
                darker_target=bool(config["darker_target"]), engine=config["engine"],
                stream=traffic["stream"], chunk_size=int(config["chunk_size"]), device=device)


def xy(start):
    """A drawn ``(row, col)`` as the display ``(x, y)`` a user passes."""
    return None if start is None else (start[1], start[0])


def positions(out) -> int:
    """Positions a call returned: frames × targets, over its videos."""
    return sum(int(np.prod(np.shape(ij)[:-1])) for _, ij in out)


def answers(config: dict, pos: list) -> list:
    """``(ts, positions)`` a video, the timestamps of the reference's grid."""
    return [(tracker.timestamps(len(p), float(config["fps"])), p) for p in pos]


def one_disc_reference(config: dict, clip_sets: list, sets: list, windows=None) -> list:
    """Per set, per video: the reference's tracking of each video's one disc
    from its start, the set's videos as lanes."""
    out = []
    for clips, videos in zip(clip_sets, sets):
        pos, _ = tracker.track(clips, [v.starts[0] for v in videos],
                               target_width=float(config["target_width"]),
                               window=int(config["window_size"]),
                               darker_target=bool(config["darker_target"]), windows=windows)
        out.append(answers(config, pos))
    return out


def taps_len(config: dict) -> int:
    return tracker.taps(float(config["target_width"]), True)[2]


def one_disc_work(config: dict, videos, out, bounded: bool) -> list:
    """For each video, the snap of frame 1 (a quarter-frame window when it
    autodetects, else the configured one) and one step a later frame at the
    configured window and taps. Replays, padding and the second snap a batch
    makes where any video autodetects are work the inputs do not need."""
    H, W = int(config["height"]), int(config["width"])
    r = int(config["window_size"]) // 2
    L = taps_len(config)
    work = []
    for (_, ij), (_, auto) in zip(out, videos):
        snap = (H // 4 // 2, W // 4 // 2) if auto else (r, r)
        work.append(dict(radii=snap, L=L, T=1, lanes=1))
        work.append(dict(radii=(r, r), L=L, T=len(ij) - 1, bounded=bounded, lanes=1))
    return work
