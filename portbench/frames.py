"""The trial videos a cell's calls track, made from the seed.

A traffic mix (``traffic/<cell>.json``) lists the videos of one call (their
length, background and start rule), how many distinct sets of them the calls
rotate over, and the motion model (``motion/<name>.py``) that moves each
video's disc. The configuration gives the frame size, the disc and the
camera noise. Everything random comes from ``--seed``: a NumPy generator
draws each video's phase, and a ``torch.Generator`` on the device draws the
sensor noise while the frames are made there. The frames end as host
``uint8`` arrays, which is what a user hands the tracker.
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
    """One trial video of a call: its disc's path, background, and the start
    the call passes (``None``: autodetect; else the drawn first centre)."""

    centres: np.ndarray  # float64 [n, 2]
    background: int
    start: tuple | None  # (row, col)


def seeds(seed: int):
    """``(numpy Generator, torch seed)`` from one ``--seed`` of any size."""
    host, dev = np.random.SeedSequence(int(seed)).spawn(2)
    return np.random.default_rng(host), int(dev.generate_state(1, np.uint64)[0])


def plan(config: dict, traffic: dict, seed: int) -> list:
    """The clip sets of a run: ``traffic["clip_sets"]`` lists of
    :class:`Video`, one a video of a call, drawn from ``seed``."""
    rng, _ = seeds(seed)
    motion = load_module("motion", traffic["motion"])
    shape = (int(config["height"]), int(config["width"]))
    jitter = float(traffic["phase_jitter_deg"])
    r = float(config["target_radius_px"])
    sets = []
    for _ in range(int(traffic["clip_sets"])):
        videos = []
        for v in traffic["videos"]:
            base = float(rng.choice(np.asarray(v["phase_deg"], np.float64)))
            phase = math.radians(base + rng.uniform(-jitter, jitter))
            c = motion.centres(int(v["frames"]), shape, traffic["motion_params"], phase, rng)
            if (c.min(axis=0) < r + 2).any() or (c[:, 0] > shape[0] - r - 3).any() \
                    or (c[:, 1] > shape[1] - r - 3).any():
                raise ValueError(f"the {traffic['motion']} path leaves the frame")
            start = None if v["start"] == "autodetect" else tuple(int(x) for x in np.round(c[0]))
            videos.append(Video(c, int(v["background"]), start))
        sets.append(videos)
    return sets


def render(config: dict, sets: list, seed: int, device) -> list:
    """Host ``uint8 [n, H, W]`` arrays of each set's videos: the background,
    a disc of ``target_level`` and radius ``target_radius_px`` about each
    centre (pixels on its edge mixed by the share of them it covers), and
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
            n = len(v.centres)
            clip = torch.empty((n, H, W), dtype=torch.uint8, device=device)
            c = torch.as_tensor(v.centres, dtype=torch.float64, device=device)
            for s in range(0, n, 32):
                cs = c[s:s + 32]
                m = len(cs)
                part = torch.full((m, H, W), float(v.background), device=device)
                rows = cs[:, 0:1].floor().long() + dy[None]
                cols = cs[:, 1:2].floor().long() + dx[None]
                # the share of each pixel (a unit square about its index) the disc covers,
                # by its centre's distance from the disc's edge
                dist = torch.hypot(rows - cs[:, 0:1], cols - cs[:, 1:2])
                cover = (r + 0.5 - dist).clamp(0, 1).float()
                t = torch.arange(m, device=device)[:, None].expand_as(rows)
                part[t, rows, cols] += cover * (level - float(v.background))
                part += (torch.randn(part.shape, generator=gen, device=device) * sigma).round()
                clip[s:s + m] = part.round_().clamp_(0, 255).to(torch.uint8)
            clips.append(clip.cpu().numpy())
            del clip, part
        out.append(clips)
    return out
