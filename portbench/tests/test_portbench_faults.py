"""``correct`` comes out false when the program is broken underneath a run
(a state left unchanged, half the batch left out, the exchange between cards
left out, an answer altered where it is made) and when the control, the
reference in TF32, stands in the program's place; and true for the program."""

import logging

import pytest
import torch

from portbench import control, frames, harness
from portbench_tiny import SPIRAL, cell

import pawsometracker_tpu_torch.models.dog_tracker as dt
import pawsometracker_tpu_torch.ops.tracker_kernel as tk
from pawsometracker_tpu_torch.parallel import mesh as pmesh


@pytest.fixture
def plant(monkeypatch):
    """``plant(name, fn)``: the program's plain scan ``name`` replaced by ``fn``
    wherever the program reads it; the tracker functions built before and
    with the fault are dropped."""
    dt._tracker_fns_cached.cache_clear()

    def put(name, fn):
        monkeypatch.setattr(tk, name, fn)
        monkeypatch.setattr(dt, name, fn)

    yield put
    dt._tracker_fns_cached.cache_clear()


def run(kind, seed=21, **traffic):
    return harness.run("tiny", seed, 0.3, False, device="cpu", cell=cell(kind, **traffic),
                       metric_specs=[])


@pytest.mark.parametrize("kind", ["track", "batch", "mesh"])
def test_the_program_comes_out_correct(kind):
    r = run(kind)
    assert r["correct"] and r["compared_positions"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


def test_the_program_comes_out_correct_through_replays():
    log = logging.getLogger(harness.PORT)
    seen = harness.StatsLog()
    log.addHandler(seen)
    try:
        r = harness.run("tiny", 7, 0.3, False, device="cpu", cell=cell("track", **SPIRAL),
                        metric_specs=[])
    finally:
        log.removeHandler(seen)
    stats = seen.take()
    assert {s["stream"] for s in stats} == {"roi"} and sum(s["replays"] for s in stats) > 0
    assert r["correct"] and r["failed"] == 0


def test_a_step_that_returns_its_state_unchanged(plant):
    plain = tk.dog_scan_plain

    def frozen(frames, pos0, fill, **kw):
        out = plain(frames, pos0, fill, **kw)
        pos = pos0.to(torch.int32).expand(frames.shape[0], 2).clone()
        return (pos, out[1]) if isinstance(out, tuple) else pos

    plant("dog_scan_plain", frozen)
    r = run("track")
    assert not r["correct"] and r["checks"]["positions_off"]["value"] > 0


def test_half_the_batch_left_out(plant):
    plain = tk.dog_scan_batch_plain

    def half(frames, pos0, fills, **kw):
        out = plain(frames, pos0, fills, **kw)
        pos = out[0] if isinstance(out, tuple) else out
        B = pos.shape[0]
        if B > 1:
            pos[B // 2:] = pos[:B - B // 2]  # the second half takes the first's answers
        return out

    plant("dog_scan_batch_plain", half)
    r = run("batch")
    assert not r["correct"] and r["checks"]["positions_off"]["value"] > 0


def test_the_exchange_between_cards_left_out(monkeypatch):
    def local(self):  # every shard's lanes answered from the first shard alone
        first = self.shards[0].cpu()
        return torch.cat([first] * len(self.shards))[:self.shape[0]]

    monkeypatch.setattr(pmesh.Sharded, "cpu", local)
    r = run("mesh")
    assert not r["correct"] and r["checks"]["positions_off"]["value"] > 0


def test_an_answer_altered_where_it_is_made(plant):
    plain = tk.dog_scan_plain

    def altered(frames, pos0, fill, **kw):
        out = plain(frames, pos0, fill, **kw)
        pos = out[0] if isinstance(out, tuple) else out
        if frames.shape[0] > 2:
            pos[frames.shape[0] // 2, 1] += 1
        return out

    plant("dog_scan_plain", altered)
    r = run("track")
    assert not r["correct"] and r["checks"]["positions_off"]["value"] > 0


@pytest.mark.parametrize("seed", [1, 2])
def test_the_tf32_control_comes_out_not_correct(seed):
    c, config, traffic = cell("track", videos=[dict(frames=200, background=128,
                                                     start="autodetect", phase_deg=[0, 180])])
    sets = frames.plan(config, traffic, seed)
    clips = frames.render(config, sets, seed, "cpu")
    ref = harness.entry(config).reference(config, clips, sets)
    verdict = harness.compare(control.control_calls(config, clips, sets), ref)
    assert not verdict["correct"] and verdict["checks"]["positions_off"]["value"] > 0
    same = [{"set": k, "out": ref[k]} for k in range(len(clips))]
    assert harness.compare(same, ref)["correct"]
