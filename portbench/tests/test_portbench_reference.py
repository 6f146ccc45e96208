"""The plain reference: it follows the drawn path, its float64 path with the
error bound equals its float32 emulation, and it equals the port's plain
version, whose arithmetic the CUDA kernels are held to bit for bit."""

import numpy as np
import pytest
import torch

from portbench import frames, harness
from portbench.reference import tracker as ref
from portbench_tiny import CONFIG, SPIRAL, TRAFFIC, cell


class Emulated:
    """Every window by the float32 emulation."""

    def __init__(self, g, direction, radii, L):
        self.g, self.direction = g, direction

    def argmax(self, patches):
        return ref.argmax_colmajor(ref.response_f32(patches, self.g, self.direction))


def clips_of(seed, n=40, config=CONFIG):
    traffic = dict(TRAFFIC, videos=[dict(TRAFFIC["videos"][0], frames=n)], clip_sets=1)
    sets = frames.plan(config, traffic, seed)
    return sets[0], frames.render(config, sets, seed, "cpu")[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_follows_the_drawn_path(seed):
    videos, clips = clips_of(seed)
    pos, _ = ref.track(clips, [None], target_width=6, window=13)
    assert np.abs(pos[0] - videos[0].paths[:, 0]).max() <= 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_follows_the_spiral(seed):
    sets = frames.plan(CONFIG, dict(TRAFFIC, **SPIRAL, clip_sets=1), seed)
    clips = frames.render(CONFIG, sets, seed, "cpu")[0]
    pos, _ = ref.track(clips, [None], target_width=6, window=13)
    assert np.abs(pos[0] - sets[0][0].paths[:, 0]).max() <= 1.0


@pytest.mark.parametrize("seed", [3, 4])
def test_bounded_float64_path_equals_the_float32_emulation(seed):
    _, clips = clips_of(seed, n=30)
    fast, stats = ref.track(clips, [None], target_width=6, window=13)
    slow, _ = ref.track(clips, [None], target_width=6, window=13, windows=Emulated)
    assert np.array_equal(fast[0], slow[0])


def test_ties_take_the_emulation_and_the_column_major_first():
    flat = np.full((3, 60, 80), 128, np.uint8)  # every response ties
    fast, stats = ref.track([flat], [(30, 40)], target_width=6, window=13)
    slow, _ = ref.track([flat], [(30, 40)], target_width=6, window=13, windows=Emulated)
    assert stats["emulated_windows"] == 3 and np.array_equal(fast[0], slow[0])
    assert tuple(fast[0][0]) == (30 - 6, 40 - 6)  # the window's first cell


def test_fma_equals_the_ports():
    from pawsometracker_tpu_torch.ops.filters import fma_f32

    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096).astype(np.float32).astype(np.float64)
    b = (rng.standard_normal(4096) * 1e3).astype(np.float32).astype(np.float64)
    c = rng.standard_normal(4096).astype(np.float32)
    want = fma_f32(torch.from_numpy(c), torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(ref.fma_f32(c, a, b).view(np.int32), want.view(np.int32))


def test_mode_takes_the_column_major_tie_rule():
    from pawsometracker_tpu_torch.ops.filters import mode_u8_host

    f = np.array([[5, 7], [7, 5]], np.uint8)
    g = np.array([[7, 5], [5, 9]], np.uint8)
    for x in (f, g, f.T, np.full((4, 4), 3, np.uint8)):
        assert ref.mode_u8(x) == mode_u8_host(x)


def test_timestamps_equal_the_ports_grid():
    from pawsometracker_tpu_torch.api import grid_prefix

    n = int(np.round(24 * ref.MAX_DURATION_S))
    assert np.array_equal(ref.timestamps(480, 24), grid_prefix(0.0, ref.MAX_DURATION_S, n, 480))


@pytest.mark.parametrize("kind", ["track", "batch"])
def test_reference_equals_the_ports_plain_run(kind):
    import pawsometracker_tpu_torch as port

    c, config, traffic = cell(kind)
    sets = frames.plan(config, traffic, 11)
    clips = frames.render(config, sets, 11, "cpu")
    entry = harness.entry(config)
    want = entry.reference(config, clips, sets)
    call = entry.caller(port, config, traffic, "cpu", None)
    for k in range(len(clips)):
        got = call(clips[k], sets[k])
        for (ts, ij), (ts_r, ij_r) in zip(got, want[k]):
            assert np.array_equal(ij, ij_r) and np.array_equal(ts, ts_r)


@pytest.mark.parametrize("name", ["arena1080-tw25", "batch4-arena1080-tw25"])
def test_configured_window_is_the_upstream_default(name):
    import json
    import os

    path = os.path.join(os.path.dirname(harness.__file__), "configs", f"{name}.json")
    config = json.load(open(path))
    assert config["window_size"] == ref.default_window(config["target_width"]) == 45
