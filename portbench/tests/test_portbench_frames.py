"""The traffic generator: deterministic per seed, and every autodetected disc
starts inside the quarter-frame window the snap searches."""

import json
import os

import numpy as np
import pytest

from portbench import frames
from portbench_tiny import CONFIG, TRAFFIC

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = 2 ** 33 + 12345  # the driver's seeds pass 32 bits


def test_same_seed_same_frames_other_seed_other_frames():
    a = frames.render(CONFIG, frames.plan(CONFIG, TRAFFIC, BIG), BIG, "cpu")
    b = frames.render(CONFIG, frames.plan(CONFIG, TRAFFIC, BIG), BIG, "cpu")
    c = frames.render(CONFIG, frames.plan(CONFIG, TRAFFIC, BIG + 1), BIG + 1, "cpu")
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == np.uint8 and np.array_equal(u, v)
    assert not np.array_equal(a[0][0], c[0][0])


def test_frames_hold_the_disc_and_the_noise():
    sets = frames.plan(CONFIG, TRAFFIC, 5)
    clip = frames.render(CONFIG, sets, 5, "cpu")[0][0]
    i, j = np.round(sets[0][0].paths[0, 0]).astype(int)
    assert clip[0, i, j] < 60  # the dark disc
    far = clip[0, :20, :20].astype(int)
    assert 120 < far.mean() < 136 and far.std() > 1  # the background and its noise


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(HERE, "traffic"))))
def test_autodetected_discs_start_inside_the_snap_window(name):
    traffic = json.load(open(os.path.join(HERE, "traffic", name)))
    config = json.load(open(os.path.join(HERE, "configs", f"{traffic['config']}.json")))
    H, W = config["height"], config["width"]
    gi, gj = H // 2 - 1, W // 2 - 1  # the snap's centre guess
    ri, rj = H // 4 // 2, W // 4 // 2
    margin = config["target_radius_px"] + 1
    for seed in range(40):
        for videos in frames.plan(config, traffic, BIG + seed):
            for v, spec in zip(videos, traffic["videos"]):
                assert [s is None for s in v.starts] == \
                    [d["start"] == "autodetect" for d in frames.discs_of(spec)]
                if "discs" not in spec and v.starts[0] is None:  # one disc: the quarter-frame snap
                    i, j = v.paths[0, 0]
                    assert abs(i - gi) + margin <= ri and abs(j - gj) + margin <= rj


def test_the_spiral_is_the_upstream_tests_trajectory():
    spiral = frames.load_module("motion", "spiral")
    params = dict(loops=5, radius_px=40, jitter_px=0.0, start_box_px=0)
    c = spiral.centres(240, (1080, 1920), params, 0.0, np.random.default_rng(0))
    step = np.hypot(*np.diff(c, axis=0).T)
    assert np.array_equal(c[0], [540.0, 960.0])  # it starts at its start
    assert np.hypot(*(c[-1] - c[0])) == pytest.approx(40.0)  # and ends its radius away
    assert step.mean() == pytest.approx(2.6356, abs=1e-3)  # the tests' ~2.64 px a frame
    ang = np.unwrap(np.arctan2(c[1:, 0] - 540.0, c[1:, 1] - 960.0))
    assert ang[-1] == pytest.approx(10 * np.pi)  # five turns, from angle 0
    a = spiral.centres(240, (1080, 1920), dict(params, jitter_px=1.0, start_box_px=60), 1.0,
                       np.random.default_rng(5))
    b = spiral.centres(240, (1080, 1920), dict(params, jitter_px=1.0, start_box_px=60), 1.0,
                       np.random.default_rng(5))
    assert np.array_equal(a, b) and 0.5 < np.std(a - spiral.centres(
        240, (1080, 1920), dict(params, start_box_px=60), 1.0, np.random.default_rng(5))) < 1.5
