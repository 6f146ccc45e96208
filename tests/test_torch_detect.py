"""The whole-frame detectors' dispatchers on the CPU (``ops/detect_kernel.py``):
a CPU tensor takes the plain versions, which the card's kernels are held to
in ``tests/test_torch_cuda.py``; how far a disc reaches, which bounds the
rounds kernel's work; and the detectors' results against the benchmark's
NumPy reference."""

import numpy as np
import pytest
import torch

from pawsometracker_tpu_torch.models.dog_tracker import make_spec
from pawsometracker_tpu_torch.ops import detect_kernel as dk
from pawsometracker_tpu_torch.parallel.mesh import (_batch_frame_response, global_detect_batch,
                                                    global_detect_peaks)


def frames_of(h=60, w=90, seed=0):
    rng = np.random.default_rng(seed)
    fr = rng.integers(90, 170, size=(2, h, w)).astype(np.uint8)
    fr[0, 20:26, 30:36] = 0
    fr[1, 40:46, 70:76] = 0
    return fr


@pytest.mark.parametrize("r2", [0.0, 1.0, 2.0, 24.99, 25.0, 441.0, 16777217.0, 1e12])
def test_disc_reach_bounds_the_disc(r2):
    """The reach D of a disc is the largest distance whose square, rounded to
    float32, is within r2 (capped at the limit): every row and column of the
    disc lies within D of its centre, and none at D + 1 does."""
    limit = 5000
    d = dk.disc_reach(r2, limit)
    near = np.float32(np.arange(limit + 1, dtype=np.int64) ** 2) <= np.float32(r2)
    assert d == min(int(np.flatnonzero(near).max()), limit)


def test_cpu_dispatchers_take_the_plain_versions():
    """On the CPU ``frame_response`` is ``correlate_plain`` over ``pad_plain``
    (and no partials), ``correlate`` is ``correlate_plain``, ``suppress`` is
    ``suppress_plain``, and none of them counts a kernel launch."""
    spec = make_spec((60, 90), 21, 10, True)
    fr = torch.from_numpy(frames_of())
    L = spec.kernel_len
    before = dk.launches
    want = dk.correlate_plain(dk.pad_plain(fr, [128, 100], L), spec.sigma, True)
    resp, part = dk.frame_response(fr, [128, 100], spec.sigma, True)
    assert part is None and torch.equal(resp, want)
    assert torch.equal(dk.frame_response(fr, np.array([128, 100]), spec.sigma, True)[0], want)
    x = dk.pad_plain(fr, torch.tensor([128, 100]), L)
    assert torch.equal(dk.correlate(x, spec.sigma, True), want)
    assert torch.equal(dk.suppress(resp[0], None, 5, 49.0), dk.suppress_plain(resp[0], 5, 49.0))
    assert dk.launches == before


def test_response_parts_and_fused_response_agree():
    """The padded frames correlated whole, a row slab of them, and the mesh's
    fused response give the same bits."""
    spec = make_spec((60, 90), 21, 12, False)
    L = spec.kernel_len
    fr = torch.from_numpy(frames_of(seed=3))
    x = dk.pad_plain(fr, [128, 128], L)
    whole = dk.correlate(x, spec.sigma, False)
    assert torch.equal(_batch_frame_response(spec)(fr, [128, 128]), whole)
    assert torch.equal(dk.correlate(x[:, 10:30 + L - 1], spec.sigma, False), whole[:, 10:30])


@pytest.mark.parametrize("fills,message", [
    ([128], "one value a frame"),
    ([128, 100, 90], "one value a frame"),
    ([127.5, 128], "whole numbers"),
    ([128, 256], "whole numbers"),
    ([-1, 128], "whole numbers"),
    (np.array([128.0, np.nan]), "whole numbers"),
    (torch.tensor([128, 300]), "whole numbers"),
])
def test_fills_are_checked_alike(fills, message):
    """Fills of the wrong length, or not whole numbers in 0..255, are refused
    by the plain versions as the kernels refuse them (both read the fills
    through ``fill_values``), rather than cut to uint8 on one side only."""
    spec = make_spec((60, 90), 21, 10, True)
    fr = torch.from_numpy(frames_of())
    with pytest.raises(ValueError, match=message):
        dk.frame_response(fr, fills, spec.sigma, True)
    with pytest.raises(ValueError, match=message):
        dk.pad_plain(fr, fills, spec.kernel_len)
    with pytest.raises(ValueError, match=message):
        global_detect_batch(spec)(fr, fills)


def test_fill_values_keep_whole_numbers():
    """Whole-number fills of any type come back as the same uint8 values."""
    want = np.array([0, 128, 255], np.uint8)
    for fills in ([0, 128, 255], np.array([0.0, 128.0, 255.0]), torch.tensor([0, 128, 255]),
                  np.array([0, 128, 255], np.int64)):
        got = dk.fill_values(fills, 3)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_detectors_equal_the_benchmark_reference():
    """``global_detect_peaks`` and the unsharded ``global_detect_batch`` give
    the peaks and the response of ``portbench/reference/multi.py``."""
    from portbench.reference import multi as bench_multi
    from portbench.reference import tracker as bench_tracker

    fr = frames_of(70, 110, seed=4)
    spec = make_spec((70, 110), 21, 12, True)
    g, direction, _ = bench_tracker.taps(12, True)
    for b, fill in enumerate((128, 97)):
        want_resp = bench_multi.frame_response(fr[b], fill, g, direction)
        got_resp = _batch_frame_response(spec)(torch.from_numpy(fr[b:b + 1]), [fill])[0]
        assert np.array_equal(got_resp.numpy().view(np.uint32), want_resp.view(np.uint32))
        want = bench_multi.peaks(want_resp, 3, 21)
        got = global_detect_peaks(spec, 3)(fr[b], fill).tolist()
        assert [tuple(p) for p in got] == [tuple(p) for p in want]
    first = global_detect_batch(spec)(fr, np.array([128, 97], np.uint8)).tolist()
    assert first == [list(bench_multi.peaks(bench_multi.frame_response(fr[b], f, g, direction),
                                            1, 21)[0]) for b, f in enumerate((128, 97))]
