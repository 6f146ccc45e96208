"""A start off the frame: the port's rule, held on the CPU beside the JAX
package's two engines and the reference's rule.

A start location may lie off the frame (a user's guess, or a carried position
rebased into a crop). The port reads the patch at the start clamped into the
frame, then maps the argmax back from the start as given
(``pawsometracker_tpu_torch/csrc/dog_scan.cu``, step 1 and 5 of the note;
``ops/tracker_kernel.py::dog_scan_plain``): the JAX XLA engine's
``lax.dynamic_slice`` clamp, without the wrap that JAX's indexing applies to a
negative start. The other rules, each pinned here on the clip where they
were found (a 100x100 frame, a dark disc of radius 6 at (8, 50 + t), window
21, ``target_width=10``, 4 frames):

- JAX XLA (``tracker_fns(spec).scan``): a negative index reads the far edge
  of the frame first;
- JAX Pallas (``pallas_scan_fn``, interpret mode): maps back from the
  clamped start;
- the reference (``src/PawsomeTracker.jl:55-62``, transcribed here): centres
  the window on the start itself, fill outside the frame, then clamps.

The port's scans (one lane and batched, unbounded and bounded) equal a numpy
transcription of its rule on frames without exact ties, and equal JAX XLA
wherever no index is negative."""

import jax.numpy as jnp
import numpy as np
import pytest

from pawsometracker_tpu.models.dog_tracker import make_spec as ref_make_spec
from pawsometracker_tpu.models.dog_tracker import tracker_fns as ref_tracker_fns
from pawsometracker_tpu.ops.dog_kernel import dog_kernel_separable, get_sigma
from pawsometracker_tpu.ops.pallas_tracker import pallas_scan_fn
from pawsometracker_tpu_torch.models.dog_tracker import make_spec, tracker_fns

H = W = 100
T = 4
WINDOW = 21
TARGET_WIDTH = 10
FILL = 128
#: the starts of the decided divergence (ROADMAP queue 3), and one past the far column
STARTS = [(-1, 50), (-3, 50), (-8, 50), (50, -4), (-5, -5), (103, 50), (50, 104)]
#: starts with no negative index, where the port and JAX XLA agree
NON_NEGATIVE = [(103, 50), (50, 104), (99, 99), (0, 0), (50, 50)]

# The four rules on the disc clip, every step (the port's are tested against its
# transcription below; these rows pin each rule's values beside it)
DISC_XLA = {
    (-1, 50): [[0, 60], [8, 51], [8, 52], [8, 53]],
    (-3, 50): [[0, 60], [8, 51], [8, 52], [8, 53]],
    (-8, 50): [[0, 60], [8, 51], [8, 52], [8, 53]],
    (50, -4): [[40, 6], [30, 16], [20, 26], [28, 36]],
    (-5, -5): [[0, 5], [0, 15], [0, 25], [0, 15]],
    (103, 50): [[93, 60], [83, 70], [73, 80], [63, 90]],
}
DISC_PALLAS = {
    (-1, 50): [[8, 50], [8, 51], [8, 52], [8, 53]],
    (-3, 50): [[8, 50], [8, 51], [8, 52], [8, 53]],
    (-8, 50): [[8, 50], [8, 51], [8, 52], [8, 53]],
    (50, -4): [[40, 0], [30, 0], [20, 0], [10, 0]],
    (-5, -5): [[0, 0], [0, 0], [0, 0], [0, 0]],
    (103, 50): [[89, 40], [79, 30], [69, 20], [59, 10]],
}
DISC_PORT = {
    (-1, 50): [[7, 50], [8, 51], [8, 52], [8, 53]],
    (-3, 50): [[5, 50], [8, 51], [8, 52], [8, 53]],
    (-8, 50): [[0, 50], [8, 51], [8, 52], [8, 53]],
    (50, -4): [[40, 0], [30, 0], [20, 0], [10, 0]],
    (-5, -5): [[0, 0], [0, 0], [0, 0], [0, 0]],
    (103, 50): [[93, 40], [83, 30], [73, 20], [63, 10]],
}
#: the reference's first steps where it differs from the others
DISC_REFERENCE_FIRST = {(-1, 50): [8, 50], (-3, 50): [7, 50], (-8, 50): [2, 50],
                        (50, -4): [40, 0], (-5, -5): [0, 0]}


def disc_clip():
    """The clip of the divergence: a dark disc of radius 6 at (8, 50 + t)."""
    yy, xx = np.mgrid[:H, :W]
    frames = np.full((T, H, W), FILL, np.uint8)
    for t in range(T):
        frames[t][(yy - 8) ** 2 + (xx - 50 - t) ** 2 <= 36] = 30
    return frames


def textured_clip(seed=0, lanes=None):
    """Frames of 150 dark blobs of random depth and width at random places on
    128-gray, plus a little noise: every window holds blobs of different
    strength, so the response has one clear maximum."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    n = T if lanes is None else lanes * T
    frames = np.empty((n, H, W), np.uint8)
    for f in range(n):
        img = np.full((H, W), 128.0) + rng.normal(0, 2, (H, W))
        for i, j, depth, sig in zip(rng.uniform(-5, H + 5, 150), rng.uniform(-5, W + 5, 150),
                                    rng.uniform(30, 100, 150), rng.uniform(2, 4, 150)):
            img -= depth * np.exp(-((yy - i) ** 2 + (xx - j) ** 2) / (2 * sig ** 2))
        frames[f] = np.clip(np.round(img), 0, 255)
    return frames if lanes is None else frames.reshape(lanes, T, H, W)


def transcribe(frames, start, rule, deltas=None, lo=None, hi=None, ties=False):
    """A numpy transcription of one chain in float64. Per step: ``p`` is the
    position (plus ``deltas[t]``); the window's patch (its apron included)
    is read around ``p`` clamped into the frame (``rule="port"``) or around
    ``p`` itself (``"reference"``), cells off the frame taking the fill; the
    DoG response's first maximum in column-major order, mapped back from
    ``p``, clamped to ``lo``/``hi`` (the frame without them). Unless
    ``ties``, the response's two largest values must differ by more than
    1e-4, well above the port's float32 rounding at these values: the inputs
    have no near ties, so float64 and the port's sums pick one maximum."""
    gc, gs, direction, L = dog_kernel_separable(get_sigma(TARGET_WIDTH), True)
    gc, gs = gc.astype(np.float64), gs.astype(np.float64)
    r = np.array([WINDOW // 2] * 2)
    pad = r + L // 2
    size = 2 * r + L
    top = np.array([H - 1, W - 1])
    pos, out = np.asarray(start, np.int64), []
    for t in range(len(frames)):
        p = pos + (0 if deltas is None else deltas[t])
        c = (np.clip(p, 0, top) if rule == "port" else p) - pad
        rows, cols = c[0] + np.arange(size[0]), c[1] + np.arange(size[1])
        inside = ((rows >= 0) & (rows < H))[:, None] & ((cols >= 0) & (cols < W))[None, :]
        patch = np.where(inside, frames[t][np.clip(rows, 0, H - 1)[:, None],
                                           np.clip(cols, 0, W - 1)[None, :]], FILL)
        patch = patch.astype(np.float64)

        def corr(g):
            rows_done = sum(g[k] * patch[k:k + size[0] - L + 1] for k in range(L))
            return sum(g[k] * rows_done[:, k:k + size[1] - L + 1] for k in range(L))

        resp = direction * (corr(gc) - corr(gs))
        flat = resp.T.ravel()  # column-major
        k = int(np.argmax(flat))
        if not ties:
            second = np.partition(flat, -2)[-2]
            assert flat[k] - second > 1e-4, "a near tie: choose other test frames"
        new = p - r + np.array([k % resp.shape[0], k // resp.shape[0]])
        new = np.clip(new, top * 0 if lo is None else lo[t], top if hi is None else hi[t])
        out.append(new.tolist())
        pos = new
    return out


def port_fns():
    return tracker_fns(make_spec((H, W), WINDOW, TARGET_WIDTH, True), "cpu")


def bounds(seed):
    """Rebases of a few pixels and a clamp box a little inside the frame."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-2, 3, (T, 2)), rng.integers(0, 4, (T, 2)),
            np.array([H - 1, W - 1]) - rng.integers(0, 4, (T, 2)))


@pytest.mark.parametrize("start", STARTS)
def test_scan_follows_the_port_rule(start):
    frames = textured_clip(1)
    got = port_fns().scan(frames, np.array(start, np.int32), FILL).numpy().tolist()
    assert got == transcribe(frames, start, "port")


@pytest.mark.parametrize("start", STARTS)
def test_scan_bounded_follows_the_port_rule(start):
    frames = textured_clip(2)
    deltas, lo, hi = bounds(3)
    got = port_fns().scan_bounded(frames, np.array(start, np.int32), FILL, deltas, lo, hi)
    assert got.numpy().tolist() == transcribe(frames, start, "port", deltas, lo, hi)


@pytest.mark.parametrize("bounded", [False, True], ids=["scan_batch", "scan_bounded_batch"])
def test_batched_scans_follow_the_port_rule(bounded):
    """Every start a lane of one call, each lane on its own frames."""
    B = len(STARTS)
    frames = textured_clip(4, lanes=B)
    fills = np.full(B, FILL, np.uint8)
    starts = np.array(STARTS, np.int32)
    fns = port_fns()
    if bounded:
        box = [bounds(10 + b) for b in range(B)]
        deltas, lo, hi = (np.stack([bx[i] for bx in box]) for i in range(3))
        got = fns.scan_bounded_batch(frames, starts, fills, deltas, lo, hi)
        want = [transcribe(frames[b], STARTS[b], "port", deltas[b], lo[b], hi[b])
                for b in range(B)]
    else:
        got = fns.scan_batch(frames, starts, fills)
        want = [transcribe(frames[b], STARTS[b], "port") for b in range(B)]
    assert got.numpy().tolist() == want


@pytest.mark.parametrize("start", NON_NEGATIVE)
def test_port_equals_jax_xla_without_a_negative_index(start):
    """Past the far edge both clamp the read and map back from the start."""
    frames = textured_clip(5)
    deltas, lo, hi = bounds(6)
    ref = ref_tracker_fns(ref_make_spec((H, W), WINDOW, TARGET_WIDTH, True))
    pos0 = np.array(start, np.int32)
    want = np.asarray(ref.scan(jnp.asarray(frames), jnp.asarray(pos0), np.uint8(FILL)))
    np.testing.assert_array_equal(port_fns().scan(frames, pos0, FILL).numpy(), want)
    want_b = np.asarray(ref.scan_bounded(jnp.asarray(frames), jnp.asarray(pos0), np.uint8(FILL),
                                         jnp.asarray(deltas, jnp.int32), jnp.asarray(lo, jnp.int32),
                                         jnp.asarray(hi, jnp.int32)))
    got_b = port_fns().scan_bounded(frames, pos0, FILL, deltas, lo, hi).numpy()
    np.testing.assert_array_equal(got_b, want_b)


def test_the_four_rules_on_the_disc_clip():
    """Each engine's values on the clip of the divergence, side by side: JAX
    XLA reads the far edge for a negative index, JAX Pallas maps back from the
    clamped start, the port from the start as given (its transcription
    agrees where the response has no exact tie), and the reference centres
    its window on the start."""
    frames = disc_clip()
    rspec = ref_make_spec((H, W), WINDOW, TARGET_WIDTH, True)
    xla = ref_tracker_fns(rspec).scan
    pallas = pallas_scan_fn(rspec, interpret=True)
    fns = port_fns()
    for start in DISC_XLA:
        pos0 = np.array(start, np.int32)
        args = (jnp.asarray(frames), jnp.asarray(pos0), np.uint8(FILL))
        assert np.asarray(xla(*args)).tolist() == DISC_XLA[start], start
        assert np.asarray(pallas(*args)).tolist() == DISC_PALLAS[start], start
        assert fns.scan(frames, pos0, FILL).numpy().tolist() == DISC_PORT[start], start
    for start, first in DISC_REFERENCE_FIRST.items():
        assert transcribe(frames, start, "reference", ties=True)[0] == first, start
    # where the read lies on the disc, the port's transcription gives the port's values
    for start in [(-1, 50), (-3, 50), (-8, 50)]:
        assert transcribe(frames, start, "port", ties=True) == DISC_PORT[start], start
