"""The trial videos a cell's calls track, made from the seed.

A traffic mix (``traffic/<cell>.json``) lists the videos of one call (their
length, background and start rule), how many distinct sets of them the calls
rotate over, and the motion model (``motion/<name>.py``) that moves each
video's disc. A video may list ``discs``, several animals in one arena: each
with its own ``phase_deg``, start rule and ``motion_params`` overrides; a
video that lists none is one disc with the video's own. The configuration
gives the frame size, the disc and the camera noise. Everything random comes
from ``--seed``: a NumPy generator draws each disc's phase, and a
``torch.Generator`` on the device draws the sensor noise while the frames are
made there. The frames end as host ``uint8`` arrays, which is what a user
hands the tracker.
"""

from __future__ import annotations

import importlib.util
import math
import os
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under this folder, imported by its path (names
    may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class Video:
    """One trial video of a call: each disc's path, the background, and each
    disc's start as the call passes it (``None``: autodetect; else the drawn
    first centre, ``(row, col)``)."""

    paths: np.ndarray  # float64 [n, discs, 2]
    background: int
    starts: tuple  # one a disc


def discs_of(video: dict) -> list:
    """A traffic video's discs: its ``discs``, or the video itself as one."""
    return video.get("discs", [video])


def step_extent(config: dict) -> int:
    """The edge, in pixels, of the square a tracking step reads about a
    target's last position: its window, ``2 r + 1``, and the taps' apron,
    ``L - 1``. Discs this far apart lie outside each other's squares while a
    disc moves less than about ``r + L / 2`` less its radius a frame (some 40
    px at the upstream defaults), and frame 1's response at one disc's centre
    reads no pixel of another."""
    from .reference.tracker import taps

    r = int(config["window_size"]) // 2
    L = taps(float(config["target_width"]), bool(config["darker_target"]))[2]
    return 2 * r + L


def seeds(seed: int):
    """``(numpy Generator, torch seed)`` from one ``--seed`` of any size."""
    host, dev = np.random.SeedSequence(int(seed)).spawn(2)
    return np.random.default_rng(host), int(dev.generate_state(1, np.uint64)[0])


def plan(config: dict, traffic: dict, seed: int) -> list:
    """The clip sets of a run: ``traffic["clip_sets"]`` lists of
    :class:`Video`, one a video of a call, drawn from ``seed``: for each disc
    in turn its phase, then its path. A disc's ``motion_params`` update the
    traffic's; their ``offset_px`` (``[rows, cols]``, any motion model) moves
    its path off the frame centre. Raises where a path leaves the frame, or
    two discs of a video come closer than :func:`step_extent`: the tracker
    carries no identity, so no disc may lie where another's step reads."""
    rng, _ = seeds(seed)
    motion = load_module("motion", traffic["motion"])
    shape = (int(config["height"]), int(config["width"]))
    jitter = float(traffic["phase_jitter_deg"])
    r = float(config["target_radius_px"])
    sets = []
    for _ in range(int(traffic["clip_sets"])):
        videos = []
        for v in traffic["videos"]:
            paths, starts = [], []
            for d in discs_of(v):
                base = float(rng.choice(np.asarray(d["phase_deg"], np.float64)))
                phase = math.radians(base + rng.uniform(-jitter, jitter))
                params = dict(traffic["motion_params"], **d.get("motion_params", {}))
                offset = np.asarray(params.pop("offset_px", (0, 0)), np.float64)
                c = motion.centres(int(v["frames"]), shape, params, phase, rng) + offset
                if (c.min(axis=0) < r + 2).any() or (c[:, 0] > shape[0] - r - 3).any() \
                        or (c[:, 1] > shape[1] - r - 3).any():
                    raise ValueError(f"the {traffic['motion']} path leaves the frame")
                paths.append(c)
                starts.append(None if d["start"] == "autodetect"
                              else tuple(int(x) for x in np.round(c[0])))
            paths = np.stack(paths, axis=1)
            if len(starts) > 1:
                gap = np.hypot(*(paths[:, :, None] - paths[:, None]).transpose(3, 0, 1, 2))
                gap[:, np.arange(len(starts)), np.arange(len(starts))] = np.inf
                edge = step_extent(config)
                if gap.min() < edge:
                    raise ValueError(f"two discs come {gap.min():.1f} px apart, closer than "
                                     f"the {edge} px square a step reads")
            videos.append(Video(paths, int(v["background"]), tuple(starts)))
        sets.append(videos)
    return sets


def render(config: dict, sets: list, seed: int, device) -> list:
    """Host ``uint8 [n, H, W]`` arrays of each set's videos: the background,
    a disc of ``target_level`` and radius ``target_radius_px`` about each
    disc's centre (pixels on its edge mixed by the share of them it covers), and
    seeded Gaussian sensor noise of ``noise_sigma`` gray levels, rounded and
    clipped to 0-255. Made on ``device`` 32 frames at a time and copied to the
    host a video at a time."""
    import torch

    _, tseed = seeds(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(tseed)
    H, W = int(config["height"]), int(config["width"])
    r = float(config["target_radius_px"])
    level = float(config["target_level"])
    sigma = float(config["noise_sigma"])
    k = int(math.ceil(r)) + 1
    off = torch.arange(-k, k + 2, device=device)
    dy, dx = [a.reshape(-1) for a in torch.meshgrid(off, off, indexing="ij")]
    out = []
    for videos in sets:
        clips = []
        for v in videos:
            n = len(v.paths)
            clip = torch.empty((n, H, W), dtype=torch.uint8, device=device)
            c = torch.as_tensor(v.paths, dtype=torch.float64, device=device)
            for s in range(0, n, 32):
                m = len(c[s:s + 32])
                part = torch.full((m, H, W), float(v.background), device=device)
                t = torch.arange(m, device=device)[:, None]
                for cs in c[s:s + 32].unbind(1):  # one disc at a time
                    rows = cs[:, 0:1].floor().long() + dy[None]
                    cols = cs[:, 1:2].floor().long() + dx[None]
                    # the share of each pixel (a unit square about its index) the disc
                    # covers, by its centre's distance from the disc's edge
                    dist = torch.hypot(rows - cs[:, 0:1], cols - cs[:, 1:2])
                    cover = (r + 0.5 - dist).clamp(0, 1).float()
                    part[t.expand_as(rows), rows, cols] += cover * (level - float(v.background))
                part += (torch.randn(part.shape, generator=gen, device=device) * sigma).round()
                clip[s:s + m] = part.round_().clamp_(0, 255).to(torch.uint8)
            clips.append(clip.cpu().numpy())
            del clip, part
        out.append(clips)
    return out
