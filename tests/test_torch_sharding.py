"""The port's device mesh on the CPU, against the JAX package's.

The JAX tests run on a virtual 8-device CPU mesh (``tests/conftest.py``); the
port's counterpart is a mesh of 8 ``cpu`` entries, taken as given as JAX takes
a device array. Both get the same seeded frames and FFV1 files: ``make_mesh``
and ``batch_sharding``, the mesh forms of ``ShardedBatchTracker``,
``sharded_pallas_bounded`` (the plain version, the counterpart of Pallas
interpret mode), the space-sharded ``global_detect_batch``,
``_select_sharded_bounded``, ``_resolve_mesh`` and ``track_batch(mesh=...)``.
Integer positions are bit-equal, ``ts`` equal, subpixel offsets within
``atol=1e-3``. The counterparts of ``tests/test_sharding.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pawsometracker_tpu as ref
import pawsometracker_tpu_torch as port
from pawsometracker_tpu.batch import _resolve_mesh as ref_resolve_mesh
from pawsometracker_tpu.batch import track_batch as ref_track_batch
from pawsometracker_tpu.models.dog_tracker import make_spec as ref_make_spec
from pawsometracker_tpu.models.dog_tracker import tracker_fns as ref_tracker_fns
from pawsometracker_tpu.parallel import mesh as ref_mesh
from pawsometracker_tpu.pipeline import _select_sharded_bounded as ref_select
from pawsometracker_tpu_torch.batch import _resolve_mesh
from pawsometracker_tpu_torch.models.dog_tracker import make_spec
from pawsometracker_tpu_torch.parallel.mesh import (
    Mesh,
    Sharded,
    ShardedBatchTracker,
    batch_sharding,
    global_detect_batch,
    make_mesh,
    sharded_pallas_bounded,
)
from pawsometracker_tpu_torch.pipeline import _select_sharded_bounded

import helpers
from test_tracker_core import draw_blob

cv2 = pytest.importorskip("cv2")

OFFSET_ATOL = 1e-3
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh8():
    """The JAX package's mesh: 8 virtual CPU devices, data 4 x space 2."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual CPU devices"
    return ref_mesh.make_mesh(8, space=2)


@pytest.fixture(scope="module")
def pmesh8():
    """The port's counterpart: 8 cpu entries, data 4 x space 2."""
    return make_mesh(devices=CPU8, space=2)


def blob_chunk(B, T, h, w, step):
    """B lanes of T frames, a blob of radius 3 moving ``step(b, t)``."""
    paths = [[step(b, t) for t in range(T)] for b in range(B)]
    frames = np.stack([np.stack([draw_blob(h, w, ij, 3) for ij in p]) for p in paths])
    return frames, np.array([p[0] for p in paths], np.int32)


def test_make_mesh_shapes(monkeypatch):
    m = make_mesh(8, space=2, devices=CPU8)
    jm = ref_mesh.make_mesh(8, space=2)
    assert m.devices.shape == jm.devices.shape == (4, 2)
    assert m.axis_names == jm.axis_names == ("data", "space")
    assert dict(m.shape) == dict(jm.shape) and list(m.shape) == list(jm.shape)
    assert m.devices.size == jm.devices.size == 8
    assert make_mesh(4, devices=CPU8).devices.shape == (4, 1)
    for maker in (lambda: make_mesh(6, space=4, devices=CPU8),
                  lambda: ref_mesh.make_mesh(6, space=4)):
        with pytest.raises(ValueError):
            maker()
    # entries are normalised: equal meshes hash alike
    assert make_mesh(devices=["cpu", torch.device("cpu")]) == make_mesh(devices=["cpu"] * 2)
    assert (hash(make_mesh(devices=["cpu"] * 2))
            == hash(make_mesh(devices=[torch.device("cpu")] * 2)))
    with pytest.raises(ValueError, match="one type"):
        Mesh([["cpu", "cuda:0"]])
    # devices=None is every card, and never the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert list(make_mesh().devices.flat) == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_batch_sharding_spec(mesh8, pmesh8):
    sh = batch_sharding(pmesh8, 4)
    assert sh.spec == ref_mesh.batch_sharding(mesh8, 4).spec == ("data", None, None, None)
    assert sh.lanes(8) == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert sh.devices == [torch.device("cpu")] * 4
    # a batch the data axis does not divide raises ValueError, as JAX's placement does
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((3, 4, 4), np.uint8), ref_mesh.batch_sharding(mesh8, 3))
    with pytest.raises(ValueError, match="divisible by 4"):
        sh.lanes(3)


@pytest.mark.parametrize("method", ["scan", "scan_bounded", "scan_sub"])
def test_sharded_scan_matches_jax(mesh8, pmesh8, method):
    """The mesh tracker's scans (one launch a data shard) equal JAX's: the
    plain scan against its single-device ``scan_batch``, the bounded and
    subpixel scans against its mesh tracker; the output stays batch-sharded."""
    h, w, B, T = 64, 64, 8, 12
    frames, pos0 = blob_chunk(B, T, h, w, lambda b, t: (16 + t, 10 + 2 * b + t))
    fills = np.full((B,), 128, np.uint8)
    rng = np.random.default_rng(5)
    lo = rng.integers(0, 8, (B, T, 2)).astype(np.int32)
    hi = np.stack([h - 1 - rng.integers(0, 8, (B, T)), w - 1 - rng.integers(0, 8, (B, T))],
                  axis=-1).astype(np.int32)
    deltas = rng.integers(-2, 3, (B, T, 2)).astype(np.int32)
    args = (frames, pos0, fills) + (() if method == "scan" else (deltas, lo, hi))
    engine = ShardedBatchTracker(make_spec((h, w), 15, 6, True), pmesh8)
    got = getattr(engine, method)(engine.shard_chunk(frames), *args[1:])
    if method == "scan":
        want = ref_tracker_fns(ref_make_spec((h, w), 15, 6, True)).scan_batch(
            *[jnp.asarray(a) for a in args])
    else:
        ref_engine = ref_mesh.ShardedBatchTracker(ref_make_spec((h, w), 15, 6, True), mesh8)
        want = getattr(ref_engine, method)(ref_engine.shard_chunk(frames),
                                           *[jnp.asarray(a) for a in args[1:]])
    pairs = list(zip(got, want)) if method == "scan_sub" else [(got, want)]
    for k, (g, wnt) in enumerate(pairs):
        assert isinstance(g, Sharded) and g.sharding.spec[0] == "data"  # stays batch-sharded
        assert len(g.shards) == 4 and g.shape == (B, T, 2)
        if k == 0:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(wnt))
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(wnt), rtol=0, atol=OFFSET_ATOL)


@pytest.mark.parametrize("subpixel", [False, True])
def test_sharded_pallas_bounded_matches_jax(mesh8, pmesh8, subpixel):
    """sharded_pallas_bounded in interpret mode, both packages: one batched
    bounded scan a data shard, bit-equal positions (offsets within 1e-3)."""
    h, w, B, T = 96, 96, 8, 6
    frames, pos0 = blob_chunk(B, T, h, w, lambda b, t: (30 + t, 20 + 3 * b + 2 * t))
    fills = np.full((B,), 128, np.uint8)
    deltas = np.zeros((B, T, 2), np.int32)
    lo = np.tile(np.array([[[2, 1]]], np.int32), (B, T, 1))
    hi = np.tile(np.array([[[h - 3, w - 2]]], np.int32), (B, T, 1))
    got = sharded_pallas_bounded(make_spec((h, w), 15, 6, True), pmesh8, interpret=True,
                                 subpixel=subpixel)(frames, pos0, fills, deltas, lo, hi)
    run = ref_mesh.sharded_pallas_bounded(ref_make_spec((h, w), 15, 6, True), mesh8,
                                          interpret=True, subpixel=subpixel)
    want = run(jax.device_put(frames, ref_mesh.batch_sharding(mesh8, 4)),
               *[jnp.asarray(a) for a in (pos0, fills, deltas, lo, hi)])
    got, want = (got, want) if subpixel else ((got,), (want,))
    assert all(g.sharding.spec[0] == "data" for g in got)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    if subpixel:
        np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=0,
                                   atol=OFFSET_ATOL)


def test_select_sharded_bounded(mesh8, pmesh8):
    """engine='pallas' under a mesh needs B % data == 0 in both packages;
    'pallas' gives sharded_pallas_bounded where the batch divides the data
    axis, and 'xla', or 'auto' off the card (the chooser measures nothing
    there, as JAX's off the TPU: tests/test_sharding.py:104-105), or a batch
    that does not divide, the tracker's own scan. tests/test_torch_engine.py
    routes 'auto' with the card gate open."""
    spec = make_spec((64, 64), 15, 6, True)
    tracker = ShardedBatchTracker(spec, pmesh8)
    ref_tracker = ref_mesh.ShardedBatchTracker(ref_make_spec((64, 64), 15, 6, True), mesh8)
    with pytest.raises(ValueError, match="divisible"):
        ref_select(ref_tracker, ref_tracker.spec, 4, 3, 128, "pallas", mesh8)
    with pytest.raises(ValueError, match="divisible"):
        _select_sharded_bounded(tracker, spec, 4, 3, 128, "pallas", pmesh8)
    assert ref_select(ref_tracker, ref_tracker.spec, 4, 8, 128, "auto", mesh8) \
        is ref_tracker.scan_bounded
    for sub in (False, True):
        assert (_select_sharded_bounded(tracker, spec, 4, 8, 128, "pallas", pmesh8, subpixel=sub)
                is sharded_pallas_bounded(spec, pmesh8, subpixel=sub))
        assert (_select_sharded_bounded(tracker, spec, 4, 8, 128, "auto", pmesh8, subpixel=sub)
                is (tracker.scan_sub if sub else tracker.scan_bounded))
    assert _select_sharded_bounded(tracker, spec, 4, 8, 128, "xla", pmesh8) is tracker.scan_bounded
    assert _select_sharded_bounded(tracker, spec, 4, 3, 128, "auto", pmesh8) is tracker.scan_bounded
    assert (_select_sharded_bounded(tracker, spec, 4, 8, 128, "xla", pmesh8, subpixel=True)
            is tracker.scan_sub)
    with pytest.raises(ValueError, match="engine='pallas'"):
        ShardedBatchTracker(spec, pmesh8, engine="pallas")


@pytest.mark.parametrize("space", [2, 3])
def test_global_detect_spatial_sharding(mesh8, space):
    """The space-sharded detector (each device its rows plus the halo) equals
    the unsharded port bit for bit, JAX's sharded and unsharded detectors, and
    the blobs; with space=3 the 64 rows split unevenly (21, 21, 22)."""
    h, w, B = 64, 96, 8
    frames = np.stack([draw_blob(h, w, (10 + 5 * b, 20 + 8 * b), 4) for b in range(B)])
    fills = np.full((B,), 128, np.uint8)
    spec = make_spec((h, w), 15, 8, True)
    unsharded = global_detect_batch(spec)(frames, fills)
    pm = make_mesh(devices=CPU8[:8 if space == 2 else 6], space=space)  # data 4 or 2
    got = global_detect_batch(spec, pm)(frames, fills)
    assert isinstance(got, Sharded) and len(got.shards) == {2: 4, 3: 2}[space]
    np.testing.assert_array_equal(np.asarray(got), unsharded.numpy())
    rspec = ref_make_spec((h, w), 15, 8, True)
    want = np.asarray(ref_mesh.global_detect_batch(rspec)(jnp.asarray(frames), jnp.asarray(fills)))
    np.testing.assert_array_equal(np.asarray(got), want)
    if space == 2:
        f0 = jax.device_put(frames, jax.sharding.NamedSharding(
            mesh8, jax.sharding.PartitionSpec("data", "space", None)))
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(ref_mesh.global_detect_batch(rspec, mesh8)(
                f0, jnp.asarray(fills))))
    for b in range(B):
        assert abs(int(np.asarray(got)[b, 0]) - (10 + 5 * b)) <= 1
        assert abs(int(np.asarray(got)[b, 1]) - (20 + 8 * b)) <= 1


@pytest.fixture(scope="module")
def ffv1_files(tmp_path_factory):
    """Four FFV1 clips of 100x100 of 40, 46, 52 and 58 frames."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(7)
    files = []
    for b in range(4):
        _, tra = helpers.build_trajectory(25, 24, (50, 50), rng)
        f = helpers.trajectory2video(tra[:40 + 6 * b], str(d), 24, 100, 100, 10, True)
        f2 = str(d / f"v{b}.avi")
        os.rename(f, f2)
        files.append(f2)
    return files


@pytest.mark.parametrize("stream,subpixel", [("full", False), ("full", True), ("roi", False),
                                             ("roi", True)])
def test_track_batch_mesh_matches_jax(ffv1_files, mesh8, pmesh8, stream, subpixel):
    """track_batch over FFV1 files on the port's 8-entry CPU mesh equals the
    JAX package's on its 8-device mesh and the port's own mesh=None run."""
    kw = dict(target_width=10, chunk_size=16, stream=stream, subpixel=subpixel)
    if stream == "roi":
        kw.update(roi_frames=4, pipeline_depth=3)
    got = port.track_batch(ffv1_files, start_location=port.IJ(50, 50), mesh=pmesh8, **kw)
    want = ref_track_batch(ffv1_files, start_location=ref.IJ(50, 50), mesh=mesh8, **kw)
    single = port.track_batch(ffv1_files, start_location=port.IJ(50, 50), device="cpu", **kw)
    assert [len(ij) for _, ij in got] == [40, 46, 52, 58]
    for (ts, ij), (ts_w, ij_w), (ts_1, ij_1) in zip(got, want, single):
        np.testing.assert_array_equal(ts, ts_w)
        np.testing.assert_array_equal(ts, ts_1)
        np.testing.assert_array_equal(ij, ij_1)
        if subpixel:
            np.testing.assert_allclose(ij, ij_w, rtol=0, atol=OFFSET_ATOL)
        else:
            np.testing.assert_array_equal(ij, ij_w)


@pytest.mark.parametrize("cards", [0, 1, 8])
def test_resolve_mesh_counts(monkeypatch, cards):
    """mesh="auto" over 0, 1 or 8 cards gives JAX's device counts (its 8
    virtual devices for 8 cards; None for fewer than 2); on the CPU, None."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    for B in (1, 3, 4, 5):
        m = _resolve_mesh("auto", B, card)
        want = ref_resolve_mesh("auto", B)
        if cards == 8:
            assert (m is None) == (want is None)
            if m is not None:
                assert m.devices.size == want.devices.size
                assert list(m.devices.flat) == [torch.device("cuda", i)
                                                 for i in range(m.devices.size)]
        else:
            assert m is None
        assert _resolve_mesh("auto", B, cpu) is None
        assert _resolve_mesh(None, B, card) is None
    pm = make_mesh(devices=["cpu"] * 2)
    assert _resolve_mesh(pm, 4, cpu) is pm


def test_mesh_device_and_divisibility(pmesh8):
    """A device outside the mesh raises ValueError; a batch the data axis does
    not divide raises ValueError, as the JAX package's does; with no card and
    no device=, mesh="auto" raises rather than run on the CPU."""
    frames = np.stack([helpers.render_frame(100, 100, (50, 50), 10, True)] * 12)
    kw = dict(target_width=10, start_location=port.IJ(50, 50))
    with pytest.raises(ValueError, match="not one of the mesh"):
        port.track_batch([frames] * 2, mesh=make_mesh(devices=["cpu"] * 2), device="cuda:0", **kw)
    same = port.track_batch([frames] * 2, mesh=make_mesh(devices=["cpu"] * 2), device="cpu", **kw)
    assert [len(ij) for _, ij in same] == [12, 12]
    with pytest.raises(ValueError):
        ref_track_batch([frames] * 3, mesh=ref_mesh.make_mesh(8, space=2),
                        target_width=10, start_location=ref.IJ(50, 50))
    with pytest.raises(ValueError, match="divisible"):
        port.track_batch([frames] * 3, mesh=pmesh8, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device="):
            port.track_batch([frames] * 2, mesh="auto", **kw)
