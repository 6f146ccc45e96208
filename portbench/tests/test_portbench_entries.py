"""Entry points as modules: ``track_multi`` cells come out correct and its
planted faults do not; frames of videos that list no discs are the same bytes
as before discs existed; the harness names no entry point; the reference's
whole-frame peaks are the port's; discs are drawn apart, each of them."""

import hashlib
import os
import re

import numpy as np
import pytest

import pawsometracker_tpu_torch as port
from portbench import frames, harness, peaks
from portbench.reference import multi, tracker
from portbench_tiny import CONFIG, MULTI, MULTI_DISCS, cell

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(kind, seed=21):
    return harness.run("tiny", seed, 0.3, False, device="cpu", cell=cell(kind), metric_specs=[])


@pytest.mark.parametrize("kind", ["multi", "multi-auto"])
@pytest.mark.parametrize("seed", [5, 2 ** 33 + 9])
def test_tiny_multi_cells_come_out_correct(kind, seed):
    r = run(kind, seed)
    assert r["correct"] and r["failed"] == 0
    assert r["compared_positions"] == 3 * 40 * r["attempted"]  # frames x targets
    assert all(v["value"] == 0 for v in r["checks"].values())


def _planted(monkeypatch, alter):
    real = port.track_multi

    def faulty(*a, **k):
        ts, ij = real(*a, **k)
        return ts, alter(np.array(ij))

    monkeypatch.setattr(port, "track_multi", faulty)


def test_two_targets_swapped(monkeypatch):
    _planted(monkeypatch, lambda ij: ij[:, [1, 0, 2]])
    r = run("multi")
    assert not r["correct"] and r["checks"]["calls_failed"]["value"] == 0
    assert r["checks"]["positions_off"]["value"] == 2 * 40 * r["attempted"]


def test_one_target_off_by_a_pixel_in_one_frame(monkeypatch):
    def alter(ij):
        ij[17, 2, 1] += 1
        return ij

    _planted(monkeypatch, alter)
    r = run("multi-auto")
    assert not r["correct"] and r["checks"]["positions_off"]["value"] == r["attempted"]


def test_one_target_missing(monkeypatch):
    _planted(monkeypatch, lambda ij: ij[:, :2])
    r = run("multi")
    assert not r["correct"] and r["checks"]["calls_failed"]["value"] == r["attempted"]
    assert r["checks"]["positions_off"]["value"] == 0


#: SHA-256 of every clip of every set, the tiny cells' frames before videos
#: could list discs
BEFORE = {
    "batch/1": "9deb887762dd044a2c13830274c8906469987e9aa5d60eb0b00c34728160dc3c",
    "batch/2": "7ed95e6ae0b9e833abd10a1e14ebf8759cabddb249b4fd997a9f1a5bae159426",
    "batch/3": "41fc5a4a678fd19511016155876201c18110f58a529abb3ae1fc3322618f18ce",
    "mesh/1": "9deb887762dd044a2c13830274c8906469987e9aa5d60eb0b00c34728160dc3c",
    "mesh/2": "7ed95e6ae0b9e833abd10a1e14ebf8759cabddb249b4fd997a9f1a5bae159426",
    "mesh/3": "41fc5a4a678fd19511016155876201c18110f58a529abb3ae1fc3322618f18ce",
    "track/1": "f7fdbbe8cad50fa1ececa72c6f585a6d2b71bdf3282e2db540bf85569007ca98",
    "track/2": "1d5ea6710a14dbbb3d2d4164d65e3c0dae230ace077d4c866c719e1146ac0f89",
    "track/3": "30561cbd089cf9626c0a4787a84204b7e667e11242a1c2f5ee24e81d2923401c",
}


@pytest.mark.parametrize("key", sorted(BEFORE))
def test_tiny_frames_are_the_same_bytes_as_before(key):
    kind, seed = key.split("/")
    _, config, traffic = cell(kind)
    h = hashlib.sha256()
    for clips in frames.render(config, frames.plan(config, traffic, int(seed)), int(seed), "cpu"):
        for c in clips:
            h.update(c.tobytes())
    assert h.hexdigest() == BEFORE[key]


GENERAL = ["harness.py", "frames.py", "run.py", "trace.py", "spans.py", "control.py"] + [
    os.path.join("metrics", f) for f in sorted(os.listdir(os.path.join(HERE, "metrics")))]
#: an entry point named in code: as a string, or called on the port
NAMED = re.compile(r"""(["'])track(_\w+)?\1|\.track(_\w+)?\(""")


@pytest.mark.parametrize("name", GENERAL)
def test_no_general_file_names_an_entry_point(name):
    with open(os.path.join(HERE, name)) as f:
        hits = [line for line in f if NAMED.search(line)]
    assert not hits


def disc_clip(seed, n=3, H=120, W=160):
    """Frame 1 of a video of n discs at drawn places, on a drawn background."""
    rng = np.random.default_rng(seed)
    f = rng.normal(rng.integers(90, 170), 2.0, (H, W))
    ii, jj = np.mgrid[:H, :W]
    for i, j in rng.uniform([8, 8], [H - 8, W - 8], (n, 2)):
        f[np.hypot(ii - i, jj - j) <= 3] = 30
    return np.clip(np.round(f), 0, 255).astype(np.uint8)


def port_peaks(frame, n, min_distance=None):
    from pawsometracker_tpu_torch.models.dog_tracker import make_spec
    from pawsometracker_tpu_torch.parallel.mesh import global_detect_peaks

    spec = make_spec(frame.shape, (13, 13), 6.0, True)
    fill = tracker.mode_u8(frame)
    return [tuple(p) for p in global_detect_peaks(spec, n, min_distance)(frame, fill).tolist()]


def ref_peaks(frame, n, min_distance=13):
    g, direction, _ = tracker.taps(6.0, True)
    return multi.peaks(multi.frame_response(frame, tracker.mode_u8(frame), g, direction), n,
                       min_distance)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_whole_frame_peaks_are_the_ports(seed):
    frame = disc_clip(seed, n=4)
    assert ref_peaks(frame, 6) == port_peaks(frame, 6)


def test_whole_frame_ties_take_the_column_major_first_and_repeats_are_refused():
    flat = np.full((40, 50), 128, np.uint8)  # every response ties
    assert ref_peaks(flat, 2, 13) == port_peaks(flat, 2, 13)
    assert ref_peaks(flat, 2, 13)[0] == (0, 0)
    assert len(set(port_peaks(flat, 12, 30))) < 12  # the port repeats its last peak ...
    with pytest.raises(ValueError):  # ... where the reference refuses, as track_multi does
        ref_peaks(flat, 12, 30)


def test_discs_closer_than_a_step_reads_are_refused():
    assert frames.step_extent(CONFIG) == 13 + 17 - 1  # the window and the taps' apron
    assert frames.step_extent(dict(CONFIG, window_size=45, target_width=25)) == 45 + 65 - 1
    near = [dict(d, start="xy") for d in MULTI_DISCS]
    near[2] = dict(near[2], motion_params=dict(offset_px=[-42, -50]))  # ~12 px from the first
    traffic = dict(MULTI, videos=[dict(frames=10, background=128, discs=near)])
    with pytest.raises(ValueError, match="closer than"):
        frames.plan(CONFIG, traffic, 1)


def test_every_disc_is_drawn_on_its_own_path():
    _, config, traffic = cell("multi")
    sets = frames.plan(config, traffic, 3)
    clip = frames.render(config, sets, 3, "cpu")[0][0]
    video = sets[0][0]
    assert video.paths.shape == (40, 3, 2) and len(video.starts) == 3
    for t in (0, 39):
        for i, j in np.round(video.paths[t]).astype(int):
            assert clip[t, i, j] < 60  # a dark disc at each centre


def test_multi_work_counts_the_whole_frame_response():
    entry = harness.entry(dict(entry="track_multi"))
    config = dict(CONFIG, entry="track_multi")
    out = [(np.zeros(40), np.zeros((40, 3, 2)))]
    L = tracker.taps(6.0, True)[2]
    given = entry.work(config, [(40, False)], out, True)
    auto = entry.work(config, [(40, True)], out, True)
    assert auto[1:] == given and len(given) == 2
    whole = peaks.cost(**auto[0])
    assert whole["flops"] == 2 * 2 * 120 * (160 + L - 1) * L + 2 * 2 * 120 * 160 * L
    assert entry.positions(out) == 120
