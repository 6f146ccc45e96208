"""The measured engine choice on the CPU: ``pick_bounded_engine``,
``pick_bounded_engine_batch``, the engine cache and the routing of
``engine=`` (the counterparts of ``tests/test_pallas.py:284-349``,
``tests/test_sharding.py:93-105`` and ``tests/test_roi_stream.py:339-359``).

Off the card the chooser measures nothing. To drive its measurement here, the
``chooser`` fixture opens the card gate (``pipeline._measures``), names the
card, gives the shared-memory limit of an H100 and replaces the CUDA-event
timer with one that runs the function once and returns an injected time:
every candidate kernel's wrapper then runs its plain version on these CPU
tensors, so the parity pin holds by construction unless a test doctors a
candidate. The cache root is the test's ``tmp_path``."""

import functools
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pawsometracker_tpu_torch as port
from pawsometracker_tpu import pipeline as ref_pipeline
from pawsometracker_tpu.models.dog_tracker import make_spec as ref_make_spec
from pawsometracker_tpu.parallel import mesh as ref_mesh
from pawsometracker_tpu_torch import pipeline as pl
from pawsometracker_tpu_torch.models import dog_tracker
from pawsometracker_tpu_torch.models.dog_tracker import make_spec, tracker_fns
from pawsometracker_tpu_torch.ops import _build
from pawsometracker_tpu_torch.ops import tracker_kernel as tk
from pawsometracker_tpu_torch.parallel.mesh import (ShardedBatchTracker, make_mesh,
                                                    sharded_pallas_bounded)

import helpers

CPU = torch.device("cpu")
H100_SMEM = 232448
# a crop both kernels take (dog_scan fits), and one only dog_scan_tiled takes
SPEC = make_spec((33, 33), 15, 6, True)
BIG = make_spec((40, 40), (151, 301), 6, True)
# a crop both kernels take where the shape rule's is dog_scan_tiled (the window does not fit
# one CTA whole; dog_scan runs it over a cluster)
MID = make_spec((70, 140), (65, 129), 10, True)


@pytest.fixture
def fresh_fns():
    """Tracker functions built anew for the test (a doctored wrapper is read
    when they are built) and dropped after it."""
    dog_tracker._tracker_fns_cached.cache_clear()
    yield
    dog_tracker._tracker_fns_cached.cache_clear()


@pytest.fixture
def chooser(monkeypatch, tmp_path, fresh_fns):
    monkeypatch.setenv("PAWSOMETRACKER_CACHE", str(tmp_path))
    monkeypatch.setattr(pl, "_session_engine_cache", {})
    monkeypatch.setattr(pl, "_measures", lambda device: True)
    monkeypatch.setattr(pl, "_device_kind", lambda device: "Test Card")
    monkeypatch.setattr(tk, "_smem_limit", lambda index: H100_SMEM)
    state = SimpleNamespace(times={}, calls=[], root=tmp_path)

    def timed(name, fn, reps):
        state.calls.append((name, reps))
        out = fn()
        host = tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()
        return host, state.times.get(name, 1.0)

    monkeypatch.setattr(pl, "_timed", timed)
    return state


def cache_file(root):
    return os.path.join(str(root), "engine_cache_torch.json")


def test_off_the_card_measures_nothing(monkeypatch, tmp_path):
    """The counterpart of the JAX gate (``pipeline.py:384-385``): no card, no
    measurement, no file."""
    monkeypatch.setenv("PAWSOMETRACKER_CACHE", str(tmp_path))
    monkeypatch.setattr(pl, "_session_engine_cache", {})
    assert pl.pick_bounded_engine(SPEC, 4, device="cpu") == (
        "xla", {"reason": "non-cuda device"})
    assert pl.pick_bounded_engine_batch(SPEC, 4, 2, subpixel=True, device="cpu") == (
        "xla", {"reason": "non-cuda device"})
    assert pl._session_engine_cache == {}
    assert not os.path.exists(cache_file(tmp_path))


def test_key_fields(chooser, monkeypatch, tmp_path):
    """The key: the rule's version, the card, torch and CUDA, the kernel
    library's digest, the geometry, K, the batch and subpixel; not the fill.
    An edited ``.cu`` gives another digest, so another key."""
    key = pl._engine_key(SPEC, 4, 2, True, CPU)
    fields = key.split("|")
    assert fields[:5] == [pl.ENGINE_RULE, "Test Card", torch.__version__,
                          str(torch.version.cuda), _build.library_digest("dog_scan")]
    assert fields[5:] == [str(SPEC.frame_shape), str(SPEC.radii), str(round(SPEC.sigma, 6)),
                          "True", "4", "B2", "sub"]
    assert pl._engine_key(SPEC, 4, None, False, CPU).split("|")[5:] == fields[5:10]
    assert pl._engine_key(SPEC, 12, None, False, CPU) != pl._engine_key(SPEC, 4, None, False, CPU)
    # the fill is not in it: two fills, one decision
    _, a = pl.pick_bounded_engine(SPEC, 4, 128, device="cpu")
    _, b = pl.pick_bounded_engine(SPEC, 4, 90, device="cpu")
    assert a is b
    edited = tmp_path / "csrc"
    edited.mkdir()
    shutil.copy(os.path.join(_build.CSRC, "dog_scan.cu"), edited / "dog_scan.cu")
    with open(edited / "dog_scan.cu", "a") as f:
        f.write("\n// edited\n")
    monkeypatch.setattr(_build, "CSRC", str(edited))
    assert pl._engine_key(SPEC, 4, 2, True, CPU) != key


@pytest.mark.parametrize("batch", [None, 3])
def test_session_hit_and_disk_round_trip(chooser, batch):
    """A decision is measured once a process, kept in the file, and a fresh
    process (an empty session cache) reads it back without measuring."""
    pick = (functools.partial(pl.pick_bounded_engine, SPEC, 4, device="cpu") if batch is None
            else functools.partial(pl.pick_bounded_engine_batch, SPEC, 4, batch, device="cpu"))
    eng, info = pick()
    assert eng == "pallas" and info["kernel"] == "dog_scan"
    assert info["parity"] is True and info["tie_parity"] is True
    assert set(info) >= {"dog_scan_ms", "dog_scan_tiled_ms", "xla_ms", "default"}
    # the oracle once on each of the 3 probe inputs; each candidate best of 3
    # on the blob and once on each tie input
    assert sorted(chooser.calls) == sorted([("plain", 1)] * 3 + [("dog_scan", 3), ("dog_scan", 1),
                                            ("dog_scan", 1), ("dog_scan_tiled", 3),
                                            ("dog_scan_tiled", 1), ("dog_scan_tiled", 1)])
    chooser.calls.clear()
    assert pick() == (eng, info) and chooser.calls == []  # the session
    with open(cache_file(chooser.root)) as f:
        on_disk = json.load(f)
    assert list(on_disk.values()) == [info]
    pl._session_engine_cache.clear()  # as a fresh process
    assert pick() == (eng, info) and chooser.calls == []
    assert not any(n.endswith(".tmp") for n in os.listdir(chooser.root))


def test_save_keeps_decisions_saved_meanwhile(chooser, monkeypatch):
    """The file is read again just before the write: a decision another
    process saved while this one measured stays in it, beside this one's."""
    pl._save_engine_cache({"earlier key": {"engine": "pallas", "kernel": "dog_scan"}})
    timed = pl._timed

    def other_process_saves(name, fn, reps):
        if name == "dog_scan_tiled":
            pl._save_engine_cache({"meanwhile key": {"engine": "pallas",
                                                     "kernel": "dog_scan_tiled"}})
        return timed(name, fn, reps)

    monkeypatch.setattr(pl, "_timed", other_process_saves)
    _, info = pl.pick_bounded_engine(SPEC, 4, device="cpu")
    with open(cache_file(chooser.root)) as f:
        on_disk = json.load(f)
    assert set(on_disk) == {"earlier key", "meanwhile key", pl._engine_key(SPEC, 4, None, False,
                                                                            CPU)}
    assert on_disk[pl._engine_key(SPEC, 4, None, False, CPU)] == info


def test_cache_file_is_the_ports_own(chooser):
    """One cache root may hold both packages' files: the port's is
    ``engine_cache_torch.json``, never the JAX package's ``engine_cache.json``,
    and neither writes the other's."""
    assert os.path.basename(pl._engine_cache_path()) == "engine_cache_torch.json"
    assert os.path.basename(ref_pipeline._engine_cache_path()) == "engine_cache.json"
    ref_pipeline._save_engine_cache({"jax key": {"engine": "xla"}})
    pl.pick_bounded_engine(SPEC, 4, device="cpu")
    with open(os.path.join(str(chooser.root), "engine_cache.json")) as f:
        assert json.load(f) == {"jax key": {"engine": "xla"}}
    with open(cache_file(chooser.root)) as f:
        assert "jax key" not in json.load(f)


@pytest.mark.parametrize("tiled_ms,want", [(0.76, "dog_scan"), (0.74, "dog_scan_tiled"),
                                           (2.0, "dog_scan")])
@pytest.mark.parametrize("default_ms", [1.0, 40.0])
def test_margin(chooser, tiled_ms, want, default_ms):
    """The shape rule's kernel stays unless the other takes under 0.75 of its
    time (JAX ``pipeline.py:526-531``)."""
    chooser.times.update({"dog_scan": default_ms, "dog_scan_tiled": tiled_ms * default_ms,
                          "plain": 300.0})
    eng, info = pl.pick_bounded_engine(SPEC, 4, device="cpu")
    assert (eng, info["kernel"], info["default"]) == ("pallas", want, "dog_scan")
    assert info["dog_scan_ms"] == default_ms and info["xla_ms"] == 300.0


@pytest.mark.parametrize("scan_ms,want", [(0.76, "dog_scan_tiled"), (0.74, "dog_scan")])
def test_margin_where_the_shape_rule_takes_tiled(chooser, scan_ms, want):
    """Where the shape rule's kernel is dog_scan_tiled and dog_scan runs the
    window too, both are measured, dog_scan_tiled is the default, and
    dog_scan takes over only under 0.75 of its time."""
    assert tk.kernels_for(MID.radii, MID.kernel_len, H100_SMEM) == ("dog_scan_tiled",
                                                                      "dog_scan")
    chooser.times.update({"dog_scan_tiled": 1.0, "dog_scan": scan_ms, "plain": 300.0})
    eng, info = pl.pick_bounded_engine(MID, 4, device="cpu")
    assert (eng, info["kernel"], info["default"]) == ("pallas", want, "dog_scan_tiled")
    assert info["dog_scan_ms"] == scan_ms and info["dog_scan_tiled_ms"] == 1.0
    assert {n for n, _ in chooser.calls} == {"plain", "dog_scan", "dog_scan_tiled"}


def test_one_candidate_where_dog_scan_does_not_fit(chooser):
    """A window too large for dog_scan has one candidate, measured and pinned
    all the same."""
    assert tk.kernels_for(BIG.radii, BIG.kernel_len, H100_SMEM) == ("dog_scan_tiled",)
    assert tk.kernels_for(SPEC.radii, SPEC.kernel_len, H100_SMEM) == ("dog_scan",
                                                                        "dog_scan_tiled")
    eng, info = pl.pick_bounded_engine(BIG, 2, device="cpu")
    assert (eng, info["kernel"]) == ("pallas", "dog_scan_tiled")
    assert "dog_scan_ms" not in info and {n for n, _ in chooser.calls} == {"plain",
                                                                           "dog_scan_tiled"}


def test_degraded_measurement_is_not_persisted(chooser):
    """The JAX package's transient rule: every time over 500 ms is kept for
    the process and not written, so the next process measures again."""
    chooser.times.update({"dog_scan": 600.0, "dog_scan_tiled": 700.0, "plain": 900.0})
    eng, info = pl.pick_bounded_engine(SPEC, 4, device="cpu")
    assert eng == "pallas" and "transient" in info
    assert not os.path.exists(cache_file(chooser.root))
    chooser.calls.clear()
    assert pl.pick_bounded_engine(SPEC, 4, device="cpu")[1] is info and chooser.calls == []
    pl._session_engine_cache.clear()
    chooser.times["dog_scan"] = 1.0  # one time under the limit: persisted
    assert "transient" not in pl.pick_bounded_engine(SPEC, 4, device="cpu")[1]
    assert os.path.exists(cache_file(chooser.root))


def doctor(monkeypatch, kernel, when):
    """Make ``kernel``'s wrapper move every position one row down (clipped to
    the crop) on the inputs where ``when(frames)`` holds: a kernel that
    breaks ties, or everything, otherwise than the plain version."""
    real, real_b = dog_tracker.dog_scan, dog_tracker.dog_scan_batch

    def perturb(out, frames, **kw):
        if kw.get("kernel") != kernel or not when(frames):
            return out
        pos = out[0] if isinstance(out, tuple) else out
        pos = torch.clamp(pos + torch.tensor([1, 0], dtype=pos.dtype), max=frames.shape[-2] - 1)
        return (pos, out[1]) if isinstance(out, tuple) else pos

    monkeypatch.setattr(dog_tracker, "dog_scan",
                        lambda frames, *a, **kw: perturb(real(frames, *a, **kw), frames, **kw))
    monkeypatch.setattr(dog_tracker, "dog_scan_batch",
                        lambda frames, *a, **kw: perturb(real_b(frames, *a, **kw), frames, **kw))


def flat(frames):
    return bool((frames == frames.reshape(-1)[0]).all())


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("subpixel", [False, True])
def test_tie_divergence_raises(chooser, monkeypatch, batch, subpixel):
    """A candidate that flips only the flat field's result (as the doctored
    kernel of ``tests/test_pallas.py:313-349``) stops the call: where the JAX
    package pins XLA, the port raises, naming the kernel, the geometry and
    the first step that differs, and keeps no decision."""
    doctor(monkeypatch, "dog_scan_tiled", flat)
    chooser.times.update({"dog_scan": 1.0, "dog_scan_tiled": 0.1})  # it would win
    pick = (functools.partial(pl.pick_bounded_engine, SPEC, 4, subpixel=subpixel, device="cpu")
            if batch is None else
            functools.partial(pl.pick_bounded_engine_batch, SPEC, 4, batch, subpixel=subpixel,
                              device="cpu"))
    with pytest.raises(RuntimeError, match=r"dog_scan_tiled differs .*33x33 crop.*"
                                           r"'flat field': first at (step|\(lane, step\)) \(0"):
        pick()
    assert pl._session_engine_cache == {} and not os.path.exists(cache_file(chooser.root))


def test_blob_mismatch_raises(chooser, monkeypatch):
    """A candidate wrong on the blob itself raises too: no fallback to the
    plain version, for the shape rule's kernel as for the other."""
    doctor(monkeypatch, "dog_scan", lambda frames: True)
    with pytest.raises(RuntimeError, match=r"dog_scan differs .*'blob'"):
        pl.pick_bounded_engine(SPEC, 4, device="cpu")


def test_a_failing_kernel_raises(chooser, monkeypatch):
    """A kernel that fails to build or launch raises through the chooser, and
    nothing is kept."""
    def broken(*a, **kw):
        raise RuntimeError("dog_scan launch failed: too many resources requested")

    monkeypatch.setattr(dog_tracker, "dog_scan", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        pl.pick_bounded_engine(SPEC, 4, device="cpu")
    assert pl._session_engine_cache == {}


# ---- routing: engine="auto" / "pallas" / "xla" ----------------------------------------


def test_select_batched_bounded_routes(chooser):
    """``"auto"`` the chosen kernel's batched scan and its segmented form,
    ``"pallas"`` the shape rule's, ``"xla"`` the plain version's."""
    tracker = ShardedBatchTracker(SPEC, None, device="cpu")
    chooser.times.update({"dog_scan": 1.0, "dog_scan_tiled": 0.5})
    for sub in (False, True):
        name = "scan_sub_batch" if sub else "scan_bounded_batch"
        for engine, key in (("auto", dict(engine="pallas", kernel="dog_scan_tiled")),
                            ("pallas", dict(engine="pallas")), ("xla", dict(engine="xla"))):
            scan, segments = pl._select_batched_bounded(tracker, SPEC, 4, 3, 128, engine,
                                                        subpixel=sub)
            fns = tracker_fns(SPEC, "cpu", **key)
            assert scan is getattr(fns, name), (engine, sub)
            assert segments.func is fns.scan_bounded_batch_super
            assert segments.keywords == {"subpixel": sub}


def test_select_batched_bounded_off_the_card_is_plain(monkeypatch, tmp_path):
    """As JAX's off the TPU: ``"auto"`` gives the plain version."""
    monkeypatch.setenv("PAWSOMETRACKER_CACHE", str(tmp_path))
    tracker = ShardedBatchTracker(SPEC, None, device="cpu")
    scan, _ = pl._select_batched_bounded(tracker, SPEC, 4, 3, 128, "auto")
    assert scan is tracker_fns(SPEC, "cpu", "xla").scan_bounded_batch


def test_select_sharded_bounded_measures_the_shard_batch(chooser, monkeypatch):
    """Under a mesh ``"auto"`` measures at the per-shard batch, as the JAX
    package's (spied with the same arguments), and gives sharded_pallas_bounded
    with the chosen kernel; a batch the data axis does not divide measures
    nothing and gives the tracker's own scan."""
    seen, ref_seen = [], []
    pick, ref_pick = pl.pick_bounded_engine_batch, ref_pipeline.pick_bounded_engine_batch

    def spy(roi_spec, k, b, fill=128, subpixel=False, **kw):
        seen.append((k, b, subpixel))
        return pick(roi_spec, k, b, fill, subpixel, **kw)

    def ref_spy(roi_spec, k, b, fill=128, subpixel=False):
        ref_seen.append((k, b, subpixel))
        return ref_pick(roi_spec, k, b, fill, subpixel)

    monkeypatch.setattr(pl, "pick_bounded_engine_batch", spy)
    monkeypatch.setattr(ref_pipeline, "pick_bounded_engine_batch", ref_spy)
    monkeypatch.setattr(ref_pipeline, "_session_engine_cache", {})
    chooser.times.update({"dog_scan": 1.0, "dog_scan_tiled": 0.5})
    pmesh = make_mesh(devices=["cpu"] * 8, space=2)
    mesh8 = ref_mesh.make_mesh(8, space=2)
    tracker = ShardedBatchTracker(SPEC, pmesh)
    ref_tracker = ref_mesh.ShardedBatchTracker(ref_make_spec((33, 33), 15, 6, True), mesh8)
    for sub in (False, True):
        got = pl._select_sharded_bounded(tracker, SPEC, 4, 8, 128, "auto", pmesh, subpixel=sub)
        assert got is sharded_pallas_bounded(SPEC, pmesh, subpixel=sub, kernel="dog_scan_tiled")
        ref_pipeline._select_sharded_bounded(ref_tracker, ref_tracker.spec, 4, 8, 128, "auto",
                                             mesh8, subpixel=sub)
        assert (pl._select_sharded_bounded(tracker, SPEC, 4, 8, 128, "pallas", pmesh, subpixel=sub)
                is sharded_pallas_bounded(SPEC, pmesh, subpixel=sub))
    assert seen == ref_seen == [(4, 2, False), (4, 2, True)]
    assert pl._select_sharded_bounded(tracker, SPEC, 4, 3, 128, "auto", pmesh) is \
        tracker.scan_bounded
    ref_pipeline._select_sharded_bounded(ref_tracker, ref_tracker.spec, 4, 3, 128, "auto", mesh8)
    assert seen == ref_seen == [(4, 2, False), (4, 2, True)]  # no measurement
    assert pl._select_sharded_bounded(tracker, SPEC, 4, 8, 128, "xla", pmesh) is \
        tracker.scan_bounded
    with pytest.raises(ValueError, match="divisible"):
        pl._select_sharded_bounded(tracker, SPEC, 4, 3, 128, "pallas", pmesh)


def test_sharded_kernel_reaches_every_shard(chooser):
    """The kernel a mesh scan carries is every shard's: each shard's scan and
    its segmented form are that kernel's tracker functions on the shard's
    device; the plain version takes no kernel."""
    pmesh = make_mesh(devices=["cpu"] * 4)
    fn = sharded_pallas_bounded(SPEC, pmesh, subpixel=True, kernel="dog_scan_tiled")
    want = tracker_fns(SPEC, "cpu", "pallas", kernel="dog_scan_tiled")
    assert all(f is want.scan_sub_batch for f in fn.fns)
    assert all(s.func is want.scan_bounded_batch_super for s in fn.segments)
    with pytest.raises(ValueError, match="plain version"):
        sharded_pallas_bounded(SPEC, pmesh, interpret=True, kernel="dog_scan")


@pytest.mark.parametrize("entry", ["track", "track_batch", "track_multi"])
def test_entry_points_choose_on_roi(chooser, tmp_path, entry):
    """With the card gate open, each entry point's ROI path measures its
    geometry once (the single or the batched probe) and tracks with the
    chosen kernel: on the CPU every kernel runs its plain version, so the
    positions equal engine='xla'."""
    rng = np.random.default_rng(11)
    _, tra = helpers.build_trajectory(30, 24, (70, 70), rng)
    f = helpers.trajectory2video(tra, str(tmp_path), 24, 160, 160, 10, True)
    chooser.times.update({"dog_scan": 1.0, "dog_scan_tiled": 0.5})
    start = port.IJ(int(tra[0][0]), int(tra[0][1]))
    kw = dict(fps=24, target_width=10, stream="roi", device="cpu")
    run = {"track": lambda **k: port.track(f, start_location=start, **kw, **k),
           "track_batch": lambda **k: port.track_batch([f, f], start_location=[start, start],
                                                       **kw, **k),
           "track_multi": lambda **k: port.track_multi(f, start_locations=[start], **kw, **k)}
    got = run[entry]()
    keys = list(pl._session_engine_cache)
    assert len(keys) == 1 and keys[0].endswith(
        {"track": "|12", "track_batch": "|12|B2", "track_multi": "|12|B1"}[entry])
    assert pl._session_engine_cache[keys[0]]["kernel"] == "dog_scan_tiled"
    want = run[entry](engine="xla")
    pairs = zip(got, want) if entry == "track_batch" else [(got, want)]
    for a, b in pairs:
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_engine_string_reaches_the_selector(tmp_path, monkeypatch):
    """The engine string reaches _select_batched_bounded from track_batch and
    track_multi (tests/test_roi_stream.py:339-359)."""
    from pawsometracker_tpu_torch import batch as batch_mod

    rng = np.random.default_rng(63)
    _, tra = helpers.build_trajectory(20, 24, (60, 60), rng)
    f = helpers.trajectory2video(tra, str(tmp_path), 24, 140, 140, 10, True)
    seen = []
    orig = pl._select_batched_bounded

    def spy(tracker, roi_spec, k, b, fill, engine, subpixel=False):
        seen.append(engine)
        return orig(tracker, roi_spec, k, b, fill, engine, subpixel=subpixel)

    monkeypatch.setattr(pl, "_select_batched_bounded", spy)
    monkeypatch.setattr(batch_mod, "_select_batched_bounded", spy)
    port.track_batch([f], start_location=port.IJ(60, 60), fps=24, target_width=10,
                     stream="roi", engine="xla", device="cpu")
    port.track_multi(f, start_locations=[port.IJ(60, 60)], fps=24, target_width=10,
                     stream="roi", engine="pallas", device="cpu")
    assert seen == ["xla", "pallas"]


# ---- the kernel named by the caller -------------------------------------------------


def test_named_dog_scan_runs_where_the_shape_rule_takes_tiled():
    """A window dog_scan runs only over a cluster (65x129, not on one CTA
    whole): the shape rule launches dog_scan_tiled, and dog_scan by name is
    taken, not refused."""
    assert tk._pick_kernel(None, MID.radii, MID.kernel_len, H100_SMEM) == "dog_scan_tiled"
    for kernel in tk.KERNELS:
        assert tk._pick_kernel(kernel, MID.radii, MID.kernel_len, H100_SMEM) == kernel


def test_kernel_names_are_checked():
    """tracker_fns and the wrappers take None or a kernel of KERNELS; "xla"
    takes none; dog_scan refuses a window it cannot hold."""
    with pytest.raises(ValueError, match="kernel must be"):
        tracker_fns(SPEC, "cpu", kernel="dog_scan_fast")
    with pytest.raises(ValueError, match="plain version"):
        tracker_fns(SPEC, "cpu", "xla", kernel="dog_scan")
    frames = torch.zeros((2, 33, 33), dtype=torch.uint8)
    with pytest.raises(ValueError, match="kernel must be"):
        tk.dog_scan(frames, torch.tensor([16, 16], dtype=torch.int32), 0, radii=(7, 7),
                    sigma=SPEC.sigma, darker_target=True, kernel="tiled")
    assert tk._pick_kernel(None, SPEC.radii, SPEC.kernel_len, H100_SMEM) == "dog_scan"
    assert tk._pick_kernel("dog_scan_tiled", SPEC.radii, SPEC.kernel_len, H100_SMEM) == \
        "dog_scan_tiled"
    with pytest.raises(ValueError, match="dog_scan does not take a 151x301 window"):
        tk._pick_kernel("dog_scan", BIG.radii, BIG.kernel_len, H100_SMEM)


@pytest.mark.parametrize("kernel", [None, "dog_scan", "dog_scan_tiled"])
def test_named_kernel_runs_the_plain_version_on_the_cpu(kernel):
    """On CPU tensors a named kernel has nothing to choose: every wrapper
    runs the plain version."""
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 3, 40, 40)).astype(np.uint8))
    pos0 = torch.tensor([[20, 20], [10, 30]], dtype=torch.int32)
    fills = torch.tensor([128, 90], dtype=torch.uint8)
    kw = dict(radii=SPEC.radii, sigma=SPEC.sigma, darker_target=True)
    want = tk.dog_scan_batch_plain(frames, pos0, fills, **kw)
    assert torch.equal(tk.dog_scan_batch(frames, pos0, fills, kernel=kernel, **kw), want)
    assert torch.equal(tk.dog_scan(frames[0], pos0[0], 128, kernel=kernel, **kw), want[0])
    seg = tk.dog_scan_segments(frames[0][None], pos0[0], 128, kernel=kernel, **kw)
    assert torch.equal(seg[0], want[0])
    segb = tk.dog_scan_batch_segments(frames[None], pos0, fills, kernel=kernel, **kw)
    assert torch.equal(segb[0], want)


def test_probing_counts_apart():
    """Inside probing() the wrappers count in probe_launches (checked here on
    the flag; the card test counts real launches)."""
    assert not tk.is_probing()
    with tk.probing():
        assert tk.is_probing()
        with tk.probing():
            assert tk.is_probing()
        assert tk.is_probing()
    assert not tk.is_probing()
