"""Large targets on the port's CPU path against the JAX package's ``track``.

From ``target_width`` 36 up, the default window does not fit one CTA's
shared memory whole and its scan takes ``dog_scan_tiled`` on the card (one
cluster a lane, ``ops/tracker_kernel.py::kernel_for``, ``tile_plan``). On the CPU the
same chunk scans run the plain version; here they are held to the JAX package
at ``target_width=40`` with its default window (69x69, L = 101): positions
bit-identical, timestamps equal, subpixel offsets within ``atol=1e-3``."""

import numpy as np
import pytest

import pawsometracker_tpu as ref
import pawsometracker_tpu_torch as port
from pawsometracker_tpu_torch.models.dog_tracker import make_spec
from pawsometracker_tpu_torch.ops import tracker_kernel as tk
from pawsometracker_tpu_torch.ops.dog_kernel import guess_window_size

import helpers

TW = 40
H = W = 180


def clip(n=14, seed=3):
    """``n`` frames of a dark target of width 40 on a spiral from the centre."""
    rng = np.random.default_rng(seed)
    _, tra = helpers.build_trajectory(20, 24, (90, 90), rng)
    tra = tra[:n]
    return np.stack([helpers.render_frame(H, W, ij, TW, True) for ij in tra]), np.array(tra)


def test_default_window_takes_the_tiled_kernel():
    """The default window of a target 40 wide (69x69, L = 101): the shape
    rule launches dog_scan_tiled; dog_scan also runs it (ten row blocks over
    ten CTAs), so the engine choice can time both."""
    spec = make_spec((1080, 1920), guess_window_size(TW), TW, True)
    assert spec.window_size == (69, 69) and spec.kernel_len == 101
    assert tk.kernels_for(spec.radii, spec.kernel_len, 232448) == ("dog_scan_tiled", "dog_scan")
    assert tk.kernel_for(spec.radii, spec.kernel_len, 232448) == "dog_scan_tiled"


CASES = {
    "start location": dict(start_location=(90, 90)),
    "autodetect": dict(start_location=None),
    "subpixel, 4-frame chunks": dict(start_location=(90, 90), subpixel=True, chunk_size=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_large_target_track_matches_jax(case):
    frames, truth = clip()
    kw = dict(CASES[case])

    def run(pkg, **extra):
        k = dict(kw, **extra)
        if k["start_location"] is not None:
            k["start_location"] = pkg.IJ(*k["start_location"])
        return pkg.track(frames, fps=24, target_width=TW, **k)

    got_ts, got = run(port, device="cpu")
    want_ts, want = run(ref)
    np.testing.assert_array_equal(got_ts, want_ts)
    if kw.get("subpixel"):
        np.testing.assert_array_equal(np.round(got), np.round(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    rmse = np.sqrt(np.mean(np.sum((got - truth[:len(got)]) ** 2, axis=1)))
    assert rmse < 1.0
