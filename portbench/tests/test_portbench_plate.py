"""The 96-well plate deployment as data: its cell loads against its
configuration; the plate's discs sit at the published well centres, stay
inside their wells and apart by the square a step reads."""

import numpy as np
import pytest

from portbench import frames, harness

BIG = 2 ** 33 + 777  # a run's seed may pass 32 bits
PLATE = "multi96-plate-full-1080"


def plate():
    return harness.load_cell(PLATE)


def test_the_cell_loads_against_its_configuration():
    cell, config, traffic = plate()
    assert (cell["config"], cell["chips"], config["entry"]) == \
        ("plate96-larvae1080-tw12", 1, "track_multi")
    assert (config["target_width"], config["window_size"], config["chunk_size"]) == (12, 25, 16)
    assert frames.step_extent(config) == 57  # 2 r + L: 24 + 33
    [video] = traffic["videos"]
    assert video["frames"] == 240 and len(video["discs"]) == 96
    assert all(d["start"] == "autodetect" for d in video["discs"])
    assert [d["phase_deg"] for d in video["discs"]] == [[3.75 * i] for i in range(96)]
    assert (traffic["stream"], traffic["mesh"], traffic["clip_sets"]) == ("auto", None, 2)


def test_offsets_are_the_published_well_centres():
    """ANSI/SLAS 4-2004: 8 x 12 wells at a 9.00 mm pitch, A1's centre 14.38 mm
    from the left and 11.24 mm from the top of the 127.76 x 85.48 mm
    footprint (ANSI/SLAS 1-2004), centred in the frame at 12.635 px/mm."""
    _, config, traffic = plate()
    scale = config["assumed"]["scale_px_per_mm"]
    assert scale == 12.635
    offsets = np.array([d["motion_params"]["offset_px"] for d in traffic["videos"][0]["discs"]])
    want = np.array([[(11.24 + 9.0 * r - 85.48 / 2) * scale, (14.38 + 9.0 * c - 127.76 / 2) * scale]
                     for r in range(8) for c in range(12)])
    np.testing.assert_allclose(offsets, want, rtol=0, atol=0.01)
    # symmetric about the frame's centre, (k - 3.5) and (k - 5.5) pitches
    np.testing.assert_allclose(offsets[0], [-3.5 * 9 * scale, -5.5 * 9 * scale], atol=0.01)
    np.testing.assert_allclose(offsets[-1], [3.5 * 9 * scale, 5.5 * 9 * scale], atol=0.01)


@pytest.mark.parametrize("seed", [1, 6, BIG, 2 ** 31 + 3])
def test_plan_keeps_each_disc_in_its_well_and_apart(seed):
    """``frames.plan`` accepts the 96 discs: no two closer than the 57 px a
    step reads, and each disc, its radius included, inside its 6.9 mm well."""
    _, config, traffic = plate()
    scale = config["assumed"]["scale_px_per_mm"]
    H, W = config["height"], config["width"]
    centres = np.array([d["motion_params"]["offset_px"]
                        for d in traffic["videos"][0]["discs"]]) + [H / 2, W / 2]
    for [video] in frames.plan(config, traffic, seed):
        paths = video.paths  # [240, 96, 2]
        assert paths.shape == (240, 96, 2) and video.starts == (None,) * 96
        gap = np.hypot(*(paths[:, :, None] - paths[:, None]).transpose(3, 0, 1, 2))
        gap[:, np.arange(96), np.arange(96)] = np.inf
        assert gap.min() >= frames.step_extent(config)
        reach = np.hypot(*(paths - centres[None]).transpose(2, 0, 1)) + config["target_radius_px"]
        assert reach.max() < 6.9 / 2 * scale


def test_plan_refuses_discs_closer_than_a_step():
    """The same plate at half its pitch does not pass ``plan``."""
    _, config, traffic = plate()
    discs = [dict(d, motion_params=dict(offset_px=[x / 2 for x in d["motion_params"]["offset_px"]]))
             for d in traffic["videos"][0]["discs"]]
    half = dict(traffic, videos=[dict(traffic["videos"][0], discs=discs)])
    with pytest.raises(ValueError, match="closer than"):
        frames.plan(config, half, 1)
