"""The port's spans (``utils/profiling.py::Timer``) on the CPU: none without a
profiler session, and under one a tree a call, on the profiler's own clock.

Without a session the three entry points log no ``spans`` and the same
``sections`` as before spans existed (the names the benchmark's per-layer
readers read). Under ``torch.profiler.profile`` each call's spans form one
tree under its ``call`` root: one call id, every parent resolves, every span
on the controller's thread inside its parent and every span inside the call;
the prefetch threads name themselves; a 4-device mesh launches once a shard;
the staging ring records its copy. Spans are stamped with ``time.time_ns()``,
the profiler's clock, and ``trace()`` exports them into its Chrome trace.
"""

import json
import logging
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

import pawsometracker_tpu_torch as port
from pawsometracker_tpu_torch.io import decode
from pawsometracker_tpu_torch.parallel.mesh import make_mesh
from pawsometracker_tpu_torch.utils.profiling import Timer, trace

#: each entry point's sections on each stream, as they were before spans
SECTIONS = {
    "full": {"device", "drain", "setup", "snap", "upload"},
    "roi": {"aim", "buffers", "crop", "device", "diagnose", "drain", "setup", "snap", "upload"},
}
#: track_multi's lanes crop from one stream and draw no per-lane overlay
MULTI_ROI = SECTIONS["roi"] - {"diagnose"}


def frames(T=30, H=100, W=120):
    fr = np.full((T, H, W), 128, np.uint8)
    for t in range(T):
        fr[t, 40 + t // 3:46 + t // 3, 50 + t:56 + t] = 20
    return fr


@pytest.fixture
def stats():
    """The ``paws_stats`` records the port logs while the test runs."""
    recs = []

    class Keep(logging.Handler):
        def emit(self, record):
            st = getattr(record, "paws_stats", None)
            if st is not None:
                recs.append(st)

    log = logging.getLogger("pawsometracker_tpu_torch")
    handler, level = Keep(), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    yield recs
    log.removeHandler(handler)
    log.setLevel(level)


def call(entry, stream):
    """One call of ``entry`` on ``stream`` on the CPU; track_batch over a
    4-device CPU mesh."""
    fr = frames()
    kw = dict(target_width=5, device="cpu", stream=stream)
    if entry == "track":
        return port.track(fr, start_location=port.IJ(43, 53), **kw)
    if entry == "track_batch":
        return port.track_batch([fr] * 4, start_location=[port.IJ(43, 53)] * 4,
                                mesh=make_mesh(devices=["cpu"] * 4), **kw)
    return port.track_multi(fr, start_locations=[port.IJ(43, 53), port.IJ(20, 20)], **kw)


CASES = [(e, s) for s in ("full", "roi") for e in ("track", "track_batch", "track_multi")]


@pytest.mark.parametrize("entry,stream", CASES)
def test_untraced_calls_record_no_spans(stats, entry, stream):
    call(entry, stream)
    [st] = stats
    assert "spans" not in st
    want = MULTI_ROI if (entry, stream) == ("track_multi", "roi") else SECTIONS[stream]
    assert set(st["sections"]) == want


def check_tree(spans):
    """One ``call`` root whose id every span's call id names; every parent
    resolves; a span on its parent's thread lies inside it, and every span
    inside the call. Returns the root."""
    roots = [s for s in spans if s.parent == 0]
    assert [r.name for r in roots] == ["call"]
    root = roots[0]
    assert {s.call for s in spans} == {root.call}
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
        if s.parent:
            p = by_id[s.parent]  # resolves
            if p.thread == s.thread:
                assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
    return root


@pytest.mark.parametrize("entry,stream", CASES)
def test_traced_call_spans_form_one_tree(stats, entry, stream):
    with profile(activities=[ProfilerActivity.CPU]):
        call(entry, stream)
    [st] = stats
    spans = st["spans"]
    root = check_tree(spans)
    assert root.attrs == {"entry": entry, "videos": 4 if entry == "track_batch" else 1,
                          "stream": stream}
    names = {s.name for s in spans}
    # every section is a span of its name, beside the new boundaries
    assert set(st["sections"]) <= names
    assert {"frame1", "mode", "snap.wait", "pipeline", "drain", "drain.wait", "prefetch.wait",
            "shard.launch"} <= names
    if stream == "roi":
        assert {"dispatch", "accept"} <= names
        # one a dispatch, and one more where the stream's end ended the call
        assert sum(s.name == "dispatch" for s in spans) - st["dispatches"] in (0, 1)
    assert [s.attrs["stream"] for s in spans if s.name == "pipeline"] == [stream]
    # the controller runs on the caller's thread; the prefetchers on their own
    workers = {s.thread for s in spans} - {root.thread}
    assert workers and all(t.startswith("paws-prefetch-") for t in workers)
    for s in spans:
        if s.thread != root.thread:
            assert s.name in {"stage.read", "stage.copy", "ring.wait", "prefetch.full"}
    assert sum(s.name == "mode" for s in spans) == (4 if entry == "track_batch" else 1)


def test_mesh_launches_once_a_shard(stats):
    """On a 4-device mesh each launch (the snap's, then each chunk's) is one
    ``shard.launch`` a shard, and a lane's waits for its prefetcher lie in
    the ``crop`` section that holds them."""
    with profile(activities=[ProfilerActivity.CPU]):
        call("track_batch", "roi")
    [st] = stats
    spans = st["spans"]
    launches = [s for s in spans if s.name == "shard.launch"]
    assert len(launches) == 4 * (1 + st["groups"])
    assert sorted(s.attrs["shard"] for s in launches) == sorted([0, 1, 2, 3] * (1 + st["groups"]))
    by_id = {s.id: s for s in spans}
    waits = [s for s in spans if s.name == "prefetch.wait"]
    assert {s.attrs["lane"] for s in waits} == {0, 1, 2, 3}
    assert all(by_id[s.parent].name == "crop" for s in waits)


def test_staging_ring_records_its_copy():
    """A ring given a copy function copies viewed frames in under
    ``stage.copy``, after the source's read under ``stage.read``."""
    src = decode.ArrayFrameSource(frames(), fps=24)
    ring = decode.ChunkRing(copy=lambda a, b: np.copyto(b, a))
    with profile(activities=[ProfilerActivity.CPU]):
        timer = Timer()
        chunk = ring.read(src, 8, 8, timer)
        timer.finish(stats := {})
    assert ring.holds(chunk)
    names = [s.name for s in stats["spans"]]
    assert names == ["stage.read", "stage.copy", "call"]


def test_staging_copy_span_carries_the_copiers_form():
    """The ring's ``stage.copy`` span carries the ``form`` its copier returned
    (the native copy's ``block``, ``frames`` or ``rows``); without a session
    the copy runs all the same."""
    src = decode.ArrayFrameSource(frames(), fps=24)
    forms = iter(["block", "rows", "frames"])

    def copy(a, b):
        np.copyto(b, a)
        return next(forms)

    ring = decode.ChunkRing(copy=copy)
    with profile(activities=[ProfilerActivity.CPU]):
        timer = Timer()
        first = ring.read(src, 8, 8, timer)
        second = ring.read(src, 8, 8, timer)
        timer.finish(stats := {})
    third = ring.read(src, 8, 8)
    copies = [s for s in stats["spans"] if s.name == "stage.copy"]
    assert [s.attrs for s in copies] == [{"form": "block"}, {"form": "rows"}]
    np.testing.assert_array_equal(np.concatenate([first, second, third]), frames()[:24])


def test_spans_are_on_the_profilers_clock():
    """A ``record_function`` range opened inside a span lies inside it on
    the profiler's clock, within 1 ms."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timer = Timer()
        with timer.span("outer"):
            with record_function("inner"):
                time.sleep(0.005)
        timer.finish(st := {})
    [outer] = [s for s in st["spans"] if s.name == "outer"]
    [inner] = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    start, end = inner.start_ns(), inner.start_ns() + inner.duration_ns()
    assert outer.start_ns - 1_000_000 <= start and end <= outer.end_ns + 1_000_000
    assert end - start >= 4_000_000  # the range is the sleep's


def test_no_session_no_recording():
    """Without a session a span is one shared object that does nothing, and
    sections keep their totals; under one a section is also a span."""
    timer = Timer()
    assert timer.span("a") is timer.span("b", lane=1)
    with timer.span("a"), timer.section("s"):
        pass
    assert set(timer.totals) == {"s"} and timer.spans is None
    timer.finish(st := {})
    assert st == {}
    with profile(activities=[ProfilerActivity.CPU]):
        timer = Timer()
    with timer.section("s"):
        with timer.span("a", lane=2):
            pass
    timer.finish(st := {})
    assert set(timer.totals) == {"s"}
    assert [(s.name, s.attrs) for s in st["spans"]] == [("a", {"lane": 2}), ("s", None),
                                                        ("call", {"stream": None})]


def test_trace_writes_the_spans(tmp_path):
    """``trace()`` exports the calls' spans into its Chrome trace, on the
    trace's own time base, one track a thread."""
    with trace(str(tmp_path)):
        t0 = time.time_ns()
        call("track", "full")
    doc = json.loads((tmp_path / "trace.json").read_text())
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "paws"]
    names = {e["name"] for e in mine}
    assert {"call", "pipeline", "drain", "stage.read"} <= names
    [root] = [e for e in mine if e["name"] == "call"]
    assert abs(root["ts"] * 1e3 + doc["baseTimeNanoseconds"] - t0) < 50e6
    threads = {e["args"]["name"] for e in doc["traceEvents"]
               if e.get("ph") == "M" and e.get("name") == "thread_name"
               and e.get("pid") == root["pid"]}
    assert len(threads) == 2 and any(t.startswith("paws-prefetch-") for t in threads)
    assert len({e["tid"] for e in mine}) == 2


def two_discs(T=12, H=100, W=120):
    """Two dark squares 60 px apart, each moving a pixel a frame."""
    fr = np.full((T, H, W), 128, np.uint8)
    for t in range(T):
        fr[t, 30:36, 20 + t:26 + t] = 20
        fr[t, 60:66, 80 - t:86 - t] = 20
    return fr


@pytest.mark.parametrize("stream", ["full", "roi"])
def test_multi_detection_spans_and_counts(stats, stream):
    """An autodetecting ``track_multi`` records ``detect`` (its ``targets``)
    on the controller inside ``snap``, with ``detect.response`` and
    ``detect.suppress`` nested in it, and counts its rounds
    and lanes; with ``start_locations`` it records no detection and counts
    its lanes alone."""
    kw = dict(target_width=5, device="cpu", stream=stream)
    with profile(activities=[ProfilerActivity.CPU]):
        port.track_multi(two_discs(), n_targets=2, **kw)
        port.track_multi(two_discs(), start_locations=[port.IJ(32, 22), port.IJ(62, 82)], **kw)
    auto, given = stats
    spans = auto["spans"]
    root = check_tree(spans)
    by_id = {s.id: s for s in spans}
    [detect] = [s for s in spans if s.name == "detect"]
    assert detect.attrs == {"targets": 2} and detect.thread == root.thread
    assert by_id[detect.parent].name == "snap"
    inner = sorted((s for s in spans if s.parent == detect.id), key=lambda s: s.start_ns)
    assert [s.name for s in inner] == ["detect.response", "detect.suppress"]
    assert inner[0].attrs is None and inner[1].attrs is None
    assert auto["counts"] == {"multi.lanes": 2, "detect.rounds": 2, "detect.kernel_launches": 0}
    check_tree(given["spans"])
    assert not {s.name for s in given["spans"]} & {"detect", "detect.response", "detect.suppress"}
    assert given["counts"] == {"multi.lanes": 2}


def test_untraced_multi_counts_its_lanes(stats):
    """Without a session the counts are there all the same, and no spans."""
    port.track_multi(two_discs(), n_targets=2, target_width=5, device="cpu")
    [st] = stats
    assert "spans" not in st and st["counts"] == {"multi.lanes": 2, "detect.rounds": 2,
                                                  "detect.kernel_launches": 0}


@pytest.mark.parametrize("n_targets", [1, 2, 3])
def test_cpu_detection_launches_no_kernel(stats, n_targets):
    """On the CPU the detection runs its plain rounds: ``detect.kernel_launches``
    reads 0 beside ``detect.rounds``, whatever N, and the detection kernels'
    count does not move."""
    from pawsometracker_tpu_torch.ops import detect_kernel

    frames = two_discs()
    frames[:, 85:91, 50:56] = 20  # a third disc
    before = detect_kernel.launches
    port.track_multi(frames, n_targets=n_targets, target_width=5, device="cpu")
    [st] = stats
    assert st["counts"]["detect.rounds"] == n_targets
    assert st["counts"]["detect.kernel_launches"] == 0
    assert detect_kernel.launches == before
