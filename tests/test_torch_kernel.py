"""The tracker scan's plain PyTorch version against the JAX package's Pallas
kernel (interpret mode) and XLA scan, in the unbatched and the batched
configurations, and the wrappers' dispatch and checks. The CUDA kernel itself
is tested on the card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pawsometracker_tpu.models.dog_tracker import make_spec as ref_make_spec
from pawsometracker_tpu.models.dog_tracker import tracker_fns as ref_tracker_fns
from pawsometracker_tpu.ops.pallas_tracker import pallas_scan_fn
from pawsometracker_tpu_torch.models.dog_tracker import make_spec, tracker_fns
from pawsometracker_tpu_torch.ops import tracker_kernel as tk
from pawsometracker_tpu_torch.ops.roi_crop import crop_with_fill as _crop_with_fill

from test_pallas import draw_blob_aniso
from test_tracker_core import draw_blob


def plain(spec, frames, pos0, fill, deltas=None, lo=None, hi=None, subpixel=False):
    b = {}
    if deltas is not None:
        b = {k: torch.from_numpy(np.asarray(v, np.int32))
             for k, v in (("deltas", deltas), ("lo", lo), ("hi", hi))}
    out = tk.dog_scan(torch.from_numpy(frames), torch.tensor(pos0, dtype=torch.int32), fill,
                      radii=spec.radii, sigma=spec.sigma, darker_target=spec.darker_target,
                      subpixel=subpixel, **b)
    return tuple(o.numpy() for o in out) if subpixel else out.numpy()


def jax_args(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("start", [(30, 20), (1, 1), (95, 95), (50, 3)])
def test_plain_scan_matches_pallas_and_xla(start):
    h, w, T = 100, 100, 12
    path = [(min(start[0] + t, h - 3), min(start[1] + t, w - 3)) for t in range(T)]
    frames = np.stack([draw_blob_aniso(h, w, ij, 4, 3) for ij in path])
    rspec = ref_make_spec((h, w), 21, 8, True)
    args = jax_args(frames, np.array(start, np.int32))
    want_x = np.asarray(ref_tracker_fns(rspec).scan(*args, np.uint8(128)))
    want_p = np.asarray(pallas_scan_fn(rspec, interpret=True)(*args, np.uint8(128)))
    got = plain(make_spec((h, w), 21, 8, True), frames, start, 128)
    np.testing.assert_array_equal(got, want_x)
    np.testing.assert_array_equal(got, want_p)
    assert got.dtype == np.int32 and got.shape == (T, 2)


def test_plain_scan_lighter_target():
    h, w, T = 64, 64, 6
    path = [(30, 20 + 2 * t) for t in range(T)]
    frames = np.stack([draw_blob(h, w, ij, 4, dark=False) for ij in path])
    rspec = ref_make_spec((h, w), 17, 8, False)
    args = jax_args(frames, np.array(path[0], np.int32))
    want = np.asarray(pallas_scan_fn(rspec, interpret=True)(*args, np.uint8(128)))
    np.testing.assert_array_equal(plain(make_spec((h, w), 17, 8, False), frames, path[0], 128),
                                  want)


def test_plain_bounded_matches_pallas_and_xla():
    ch, cw, T = 97, 97, 8
    path = [(48 + t, 48 + t) for t in range(T)]
    crops = np.stack([draw_blob(ch, cw, ij, 4) for ij in path])
    deltas = np.zeros((T, 2), np.int32)
    lo = np.tile(np.array([[5, 0]], np.int32), (T, 1))
    hi = np.tile(np.array([[90, 80]], np.int32), (T, 1))
    rspec = ref_make_spec((ch, cw), 21, 8, True)
    a = jax_args(crops, np.array(path[0], np.int32))
    b = jax_args(deltas, lo, hi)
    want_x = np.asarray(ref_tracker_fns(rspec).scan_bounded(a[0], a[1], np.uint8(128), *b))
    want_p = np.asarray(pallas_scan_fn(rspec, bounded=True, interpret=True)(
        a[0], a[1], np.uint8(128), *b))
    got = plain(make_spec((ch, cw), 21, 8, True), crops, path[0], 128, deltas, lo, hi)
    np.testing.assert_array_equal(got, want_x)
    np.testing.assert_array_equal(got, want_p)


def test_plain_per_frame_deltas_match_pallas():
    """Per-frame crop origins: the carried position rebased by deltas. The
    plain scan equals Pallas and XLA, and the full-frame scan of the same
    content shifted by the origins."""
    H, W, T = 240, 260, 6
    path = [(60 + 6 * t, 70 + 9 * t) for t in range(T)]
    frames = np.stack([draw_blob(H, W, ij, 5) for ij in path])
    ch = cw = 97
    origins = np.array([[i - 48, j - 48] for i, j in path], np.int64)
    crops = np.stack([_crop_with_fill(frames[t], origins[t], ch, cw, 128) for t in range(T)])
    deltas = np.zeros((T, 2), np.int32)
    deltas[1:] = origins[:-1] - origins[1:]
    lo = np.maximum(-origins, 0).astype(np.int32)
    hi = np.minimum([ch - 1, cw - 1], np.array([H - 1, W - 1]) - origins).astype(np.int32)
    pos0 = (np.array(path[0]) - origins[0]).astype(np.int32)
    rspec = ref_make_spec((ch, cw), 21, 10, True)
    want = np.asarray(pallas_scan_fn(rspec, bounded=True, interpret=True)(
        *jax_args(crops, pos0), np.uint8(128), *jax_args(deltas, lo, hi)))
    got = plain(make_spec((ch, cw), 21, 10, True), crops, pos0, 128, deltas, lo, hi)
    np.testing.assert_array_equal(got, want)
    full = plain(make_spec((H, W), 21, 10, True), frames, path[0], 128)
    np.testing.assert_array_equal(got + origins, full)


def test_plain_subpixel_matches_pallas_and_xla(rng):
    """Bounded + subpixel: positions exact, offsets within 1e-3 (the engines
    sum the response in different orders)."""
    ch, cw, T = 64, 64, 6
    path = [(30 + t, 28 + 2 * t) for t in range(T)]
    frames = np.stack([draw_blob(ch, cw, ij, 3) for ij in path]).astype(np.uint8)
    frames = np.clip(frames.astype(np.int32) + rng.integers(-3, 4, frames.shape), 0,
                     255).astype(np.uint8)
    pos0 = np.array([30, 28], np.int32)
    deltas = np.zeros((T, 2), np.int32)
    lo = np.zeros((T, 2), np.int32)
    hi = np.tile(np.array([[ch - 1, cw - 1]], np.int32), (T, 1))
    rspec = ref_make_spec((ch, cw), 15, 6, True)
    a, b = jax_args(frames, pos0), jax_args(deltas, lo, hi)
    xp, xo = ref_tracker_fns(rspec).scan_sub(a[0], a[1], np.uint8(128), *b)
    pp, po = pallas_scan_fn(rspec, bounded=True, subpixel=True, interpret=True)(
        a[0], a[1], np.uint8(128), *b)
    gp, go = plain(make_spec((ch, cw), 15, 6, True), frames, pos0, 128, deltas, lo, hi,
                   subpixel=True)
    assert np.abs(go).max() > 0  # offsets are non-trivial
    for wp, wo in ((xp, xo), (pp, po)):
        np.testing.assert_array_equal(gp, np.asarray(wp))
        np.testing.assert_allclose(go, np.asarray(wo), rtol=0, atol=1e-3)
    assert go.dtype == np.float32 and np.abs(go).max() <= 0.5


TIE_SHAPES = [(41, 15, 6, True), (49, 21, 10, True), (41, 21, 10, False), (97, 21, 8, True),
              (141, 41, 25, True)]


def _tie_scan_args(ch, K=4):
    deltas = np.zeros((K, 2), np.int32)
    lo = np.zeros((K, 2), np.int32)
    hi = np.tile(np.array([[ch - 1, ch - 1]], np.int32), (K, 1))
    return np.array([ch // 2, ch // 2], np.int32), deltas, lo, hi


@pytest.mark.parametrize("ch,win,tw,dark", TIE_SHAPES)
def test_mirror_blob_ties_match_pallas_and_xla(ch, win, tw, dark):
    """The engine gate's mirror-symmetric centred blob (pawsometracker_tpu/
    pipeline.py:445-448): its mirror positions tie to the last ulp, and the
    plain scan must take the same maximum as Pallas and XLA."""
    K, fill = 4, 128
    rspec = ref_make_spec((ch, ch), win, tw, dark)
    yy, xx = np.mgrid[:ch, :ch]
    blob = np.exp(-((yy - ch // 2) ** 2 + (xx - ch // 2) ** 2) / (2.0 * max(rspec.sigma, 1.0) ** 2))
    fr = np.clip(fill + (-1.0 if dark else 1.0) * 110.0 * blob, 0, 255).astype(np.uint8)
    crops = np.ascontiguousarray(np.broadcast_to(fr, (K, ch, ch)))
    pos, deltas, lo, hi = _tie_scan_args(ch, K)
    a, b = jax_args(crops, pos), jax_args(deltas, lo, hi)
    want_x = np.asarray(ref_tracker_fns(rspec).scan_bounded(a[0], a[1], np.uint8(fill), *b))
    want_p = np.asarray(pallas_scan_fn(rspec, bounded=True, interpret=True)(
        a[0], a[1], np.uint8(fill), *b))
    got = plain(make_spec((ch, ch), win, tw, dark), crops, pos, fill, deltas, lo, hi)
    np.testing.assert_array_equal(got, want_x)
    np.testing.assert_array_equal(got, want_p)


@pytest.mark.parametrize("ch,win,tw,dark", TIE_SHAPES)
def test_flat_field_ties_break_column_major(ch, win, tw, dark):
    """The engine gate's flat field (the fill everywhere): every cell of the
    window ties, and the first cell in column-major order wins, so each step
    moves by -radii until the clamp. The plain scan computes every response
    with the same FMA sequence, so the tie is exact and the rule decides.
    (XLA's jitted dot is not position-invariant here and can pick another
    cell: a decided divergence, ROADMAP.md "Exact ties".)"""
    K, fill = 4, 128
    spec = make_spec((ch, ch), win, tw, dark)
    crops = np.full((K, ch, ch), fill, np.uint8)
    pos, deltas, lo, hi = _tie_scan_args(ch, K)
    want = np.maximum(pos[None] - (np.arange(1, K + 1)[:, None] * np.array(spec.radii)), 0)
    np.testing.assert_array_equal(plain(spec, crops, pos, fill, deltas, lo, hi), want)
    np.testing.assert_array_equal(plain(spec, crops, pos, fill), want)


def test_noise_frames_match_pallas_and_xla(rng):
    """Random u8 frames (no exact ties): positions equal both JAX engines."""
    ch, T = 61, 8
    rspec = ref_make_spec((ch, ch), 21, 8, True)
    frames = rng.integers(0, 256, size=(T, ch, ch)).astype(np.uint8)
    pos0 = np.array([30, 30], np.int32)
    a = jax_args(frames, pos0)
    want_x = np.asarray(ref_tracker_fns(rspec).scan(a[0], a[1], np.uint8(128)))
    want_p = np.asarray(pallas_scan_fn(rspec, interpret=True)(a[0], a[1], np.uint8(128)))
    got = plain(make_spec((ch, ch), 21, 8, True), frames, pos0, 128)
    np.testing.assert_array_equal(got, want_x)
    np.testing.assert_array_equal(got, want_p)


def test_out_of_crop_start_is_defined():
    ch, cw, T = 97, 97, 4
    crops = np.stack([draw_blob(ch, cw, (48, 48), 4) for _ in range(T)])
    spec = make_spec((ch, cw), 21, 8, True)
    deltas = np.zeros((T, 2), np.int32)
    lo = np.zeros((T, 2), np.int32)
    hi = np.tile(np.array([[ch - 1, cw - 1]], np.int32), (T, 1))
    for start in [(-50, -120), (300, 48), (48, 500), (-1, cw + 1)]:
        got = plain(spec, crops, start, 128, deltas, lo, hi)
        assert (got >= 0).all() and (got[:, 0] < ch).all() and (got[:, 1] < cw).all(), start
        got_u = plain(spec, crops, start, 128)
        assert (got_u >= 0).all() and (got_u[:, 0] < ch).all() and (got_u[:, 1] < cw).all()


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    spec = make_spec((40, 40), 9, 6, True)
    frames = np.stack([draw_blob(40, 40, (20, 20 + t), 3) for t in range(5)])
    before = tk.launches
    got = plain(spec, frames, (20, 20), 128)
    assert tk.launches == before
    want = tk.dog_scan_plain(torch.from_numpy(frames), torch.tensor([20, 20], dtype=torch.int32),
                             128, radii=spec.radii, sigma=spec.sigma, darker_target=True)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got[:, 1], np.arange(20, 25))


def test_wrapper_rejects_bad_arguments():
    spec = make_spec((40, 40), 9, 6, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True)
    frames = torch.zeros((3, 40, 40), dtype=torch.uint8)
    p0 = torch.tensor([5, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        tk.dog_scan(frames.float(), p0, 0, **kw)
    with pytest.raises(ValueError, match="uint8"):
        tk.dog_scan(frames[0], p0, 0, **kw)
    with pytest.raises(ValueError, match="pos0"):
        tk.dog_scan(frames, p0[:1], 0, **kw)
    z = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        tk.dog_scan(frames, p0, 0, deltas=z, **kw)
    with pytest.raises(ValueError, match="shape"):
        tk.dog_scan(frames, p0, 0, deltas=z[:2], lo=z, hi=z, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tk.dog_scan_cuda(frames, p0, 0, **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tk.dog_scan(frames.to("meta"), p0.to("meta"), 0, **kw)


def owners(plan, radii):
    """Which CTA owns each output cell of the window, and in which slot, by
    the kernel's indexing (csrc/dog_scan.cu, dog_scan_tiled_kernel): CTA r
    takes tiles r, r + C, ... of the row-major tile grid. -1 where no CTA
    does; a cell owned twice raises."""
    wh, ww = 2 * radii[0] + 1, 2 * radii[1] + 1
    (th, tw), (ntr, ntc), C = plan.tile, plan.tiles, plan.cluster
    rank = np.full((wh, ww), -1)
    slot = np.full((wh, ww), -1)
    for r in range(C):
        for s in range(plan.slots):
            tile = r + s * C
            if tile >= ntr * ntc:
                break
            tr, tc = divmod(tile, ntc)
            cells = (slice(tr * th, min((tr + 1) * th, wh)), slice(tc * tw, min((tc + 1) * tw, ww)))
            assert (rank[cells] == -1).all(), "a cell owned twice"
            rank[cells], slot[cells] = r, s
    return rank, slot


PLAN_WINDOWS = [((135, 240), 65), ((34, 34), 97), ((34, 34), 101), ((52, 52), 149),
                ((86, 86), 245), ((20, 20), 65), ((7, 7), 17), ((5, 300), 129), ((0, 0), 65),
                ((3, 3), 9)]


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("radii,L", PLAN_WINDOWS)
def test_tile_shape_fits_shared_memory(radii, L, subpixel):
    """tile_plan: the tile, its apron, the row sums and (with subpixel) the
    response slots fit the limit; tiles are whole register blocks of rows and
    columns; C is at most 16 and at most the tile count; every output cell of
    the window is owned by exactly one CTA, and no CTA has more tiles than its
    slots or none at all."""
    limit = 232448
    plan = tk.tile_plan(radii, L, limit, subpixel)
    th, tw = plan.tile
    assert th % tk.SCAN_R == 0 and tw % tk.SCAN_R == 0
    assert plan.smem == tk._tiled_smem_bytes(L, th, tw, plan.slots if subpixel else 0) <= limit
    nt = plan.tiles[0] * plan.tiles[1]
    assert 1 <= plan.cluster <= min(tk.MAX_CLUSTER, nt)
    assert plan.slots == -(-nt // plan.cluster) and (plan.slots - 1) * plan.cluster < nt
    rank, slot = owners(plan, radii)
    assert (rank >= 0).all() and (slot < plan.slots).all()
    assert set(np.unique(rank)) == set(range(plan.cluster))
    assert plan.work >= 1.0


@pytest.mark.parametrize("cluster", [1, 3, 8, 16])
def test_tile_plan_forced_cluster_owns_every_cell_once(cluster):
    """A cluster size forced for timing or tests, even above the tile count
    (some CTAs then own no tile), still covers the window once; the
    subpixel neighbour lookup finds each cell at its owner and slot."""
    radii, L = (17, 40), 65
    plan = tk.tile_plan(radii, L, 232448, True, cluster=cluster)
    assert plan.cluster == cluster
    rank, slot = owners(plan, radii)
    assert (rank >= 0).all()
    (th, tw), ntc = plan.tile, plan.tiles[1]
    for a in range(0, rank.shape[0], 5):
        for b in range(0, rank.shape[1], 7):
            tile = (a // th) * ntc + b // tw  # the kernel's lookup of a neighbour's owner
            assert (tile % cluster, tile // cluster) == (rank[a, b], slot[a, b])


def test_tile_plan_follows_the_cards_cluster_limit():
    """A card that schedules only smaller clusters gets a plan within it, with
    the tiles spread evenly (no CTA idle)."""
    radii, L = (135, 240), 65  # quarter-frame snap at 1080p: 39 tiles of 7x483
    assert tk.tile_plan(radii, L, 232448).cluster == 13  # 3 tiles each
    plan = tk.tile_plan(radii, L, 232448, max_cluster=8)
    assert (plan.cluster, plan.slots) == (8, 5)
    plan = tk.tile_plan(radii, L, 232448, max_cluster=4)
    assert (plan.cluster, plan.slots) == (4, 10)


def test_tile_plan_keeps_the_apron_small():
    """Tiles span the window's width while it fits, so the row pass
    recomputes no apron columns; a window too wide for one tile is cut into
    the fewest column tiles."""
    assert tk.tile_plan((52, 52), 149, 232448).work == 1.0
    assert tk.tile_plan((135, 240), 65, 232448).work < 1.02
    wide = tk.tile_plan((20, 4000), 65, 232448)
    assert wide.tiles[1] > 1 and wide.work < 1.05


@pytest.mark.parametrize("field", ["flat (ties)", "noise", "plateaus"])
@pytest.mark.parametrize("cluster", [None, 2, 5, 16])
def test_cluster_argmax_equals_column_major_first_maximum(field, cluster, rng):
    """The kernel's reduction, mirrored: each CTA keeps the first maximum in
    column-major order of the cells it owns, then the C pairs are reduced
    with the same rule. It equals the first maximum over the whole window,
    exact ties across CTAs included, whatever the cluster size."""
    radii = (10, 16)
    wh, ww = 2 * radii[0] + 1, 2 * radii[1] + 1
    if field == "flat (ties)":
        resp = np.zeros((wh, ww), np.float32)
    elif field == "noise":
        resp = rng.standard_normal((wh, ww)).astype(np.float32)
    else:
        resp = rng.integers(0, 3, (wh, ww)).astype(np.float32)
    plan = tk.tile_plan(radii, 65, 232448, cluster=cluster)
    rank, _ = owners(plan, radii)

    def keep_better(pairs):
        return max(pairs, key=lambda vk: (vk[0], -vk[1]))

    per_cta = []
    for r in range(plan.cluster):
        cells = [(resp[a, b], b * wh + a) for a, b in zip(*np.nonzero(rank == r))]
        per_cta.append(keep_better(cells) if cells else (-np.inf, 2**31 - 1))
    k = keep_better(per_cta)[1]
    want = tk.argmax_colmajor(torch.from_numpy(resp)).numpy()
    assert (k % wh, k // wh) == tuple(want)


@pytest.mark.parametrize("radii,L", PLAN_WINDOWS)
def test_pass_items_cover_the_tile_once_within_the_layout(radii, L):
    """The kernel's pass indexing, mirrored: the row pass's items (7 rows of
    one patch column) write every row sum of the tile once and read no patch
    row past the layout's; the column pass's items (7 columns of one tile row)
    write every output of the tile once and read no row sum past the row's
    pitch."""
    plan = tk.tile_plan(radii, L, 232448)
    (th, tw), pw = plan.tile, plan.tile[1] + L - 1
    brows = th + L
    pitch2 = (tw + L) | 1
    written = np.zeros((th, pw), int)
    nbv = th // tk.SCAN_R
    items = [(blk * 7, 7, x) for blk in range(nbv) for x in range(pw)]
    for a0, R, x in items:
        written[a0:a0 + R, x] += 1
        assert a0 + L + R - 1 <= brows - 1  # the last look-ahead load
    assert (written == 1).all()
    R = tk.SCAN_R
    ng = -(-tw // R)
    out = np.zeros((th, tw), int)
    for it in range(th * ng):
        a, b0 = divmod(it, ng)
        b0 *= R
        assert b0 + L + R - 1 <= pitch2 - 1
        out[a, b0:b0 + R] += 1
    assert (out == 1).all()


def order_key(v):
    """The kernel's order_key: float32 bits made monotone as uint32."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000).astype(np.uint64)


@pytest.mark.parametrize("field", ["noise", "ties", "zeros and -inf", "negative"])
def test_exchange_key_orders_as_keep_better(field, rng):
    """The exchange's (key, index) pairs, the larger key then the smaller
    index winning, pick the pair keep_better picks (larger value, then the
    smaller column-major index) on any finite responses with -inf for empty
    slots, and key_value gives the value back bit for bit."""
    n = 300
    if field == "noise":
        v = rng.standard_normal(n).astype(np.float32)
    elif field == "ties":
        v = rng.integers(-2, 3, n).astype(np.float32)
    elif field == "zeros and -inf":
        v = np.where(rng.random(n) < 0.5, np.float32(0), np.float32(-np.inf)).astype(np.float32)
    else:
        v = -rng.random(n).astype(np.float32) * 1e3
    k = rng.permutation(n).astype(np.uint64)
    keys = order_key(v)
    best = max(range(n), key=lambda i: (keys[i], -int(k[i])))
    want = max(range(n), key=lambda i: (float(v[i]), -int(k[i])))
    assert best == want
    back = np.where(keys & 0x80000000, keys & 0x7FFFFFFF, ~keys & 0xFFFFFFFF).astype(np.uint32)
    assert np.array_equal(back, v.view(np.uint32))


def test_tile_shape_rejects_oversized_kernel():
    with pytest.raises(ValueError, match="shared memory"):
        tk.tile_plan((20, 20), 601, 232448)


def test_smem_formula_matches_kernel_source():
    """Both kernels' shared-memory formulas, as the source has them and as the
    wrapper mirrors them."""
    import os

    src = open(os.path.join(os.path.dirname(tk.__file__), "..", "csrc", "dog_scan.cu")).read()
    # dog_scan_tiled_kernel: tiled_layout, the warps that exchange, and a CTA's threads
    for line in ("s.brows = th + L;",
                 "s.pitch = 16 * ((tw + L + 29) / 16);",
                 "s.pitch2 = (tw + L) | 1;",
                 "s.off_rows = (long long)s.brows * s.pitch;",
                 "s.off_taps = s.off_rows + 8LL * th * s.pitch2;",
                 "s.off_pairs = s.off_taps + 8LL * L;",
                 "s.off_resp = s.off_pairs + 16LL * kMaxCluster * kWarps;",
                 "s.off_shift = s.off_resp + 8LL * resp_slots * th * tw;",
                 "s.bytes = s.off_shift + 4LL * s.brows;",
                 f"constexpr int kMaxCluster = {tk.MAX_CLUSTER};",
                 "const int nwx = min(nthreads >> 5, (th * nbh + 31) / 32);",
                 "const int items = max(tile_h / kR * (tile_w + L - 1), tile_h * (tile_w / kR));",
                 "cluster_config(&cfg, &attr, cluster, B, min(kThreads, 32 * ((items + 31) / 32)),"
                 " smem, stream);"):
        assert line in src, line
    assert tk.TILED_PAIRS_BYTES == 2 * 8 * tk.MAX_CLUSTER * (tk.MAX_THREADS // 32) == 5120
    # the quarter-frame snap's tile, 7x483 with L = 65, 3 response slots: a 72x576 u8 patch,
    # 7x549 float2 row sums, 65 tap pairs, the exchange's pairs, 2x3x7x483 f32 responses, 72
    # row offsets
    assert tk._tiled_smem_bytes(65, 7, 483, 3) == (72 * 576 + 8 * 7 * 549 + 8 * 65 + 5120
                                                   + 8 * 3 * 7 * 483 + 4 * 72)
    # dog_scan_kernel: scan_layout, a CTA of `slots` row blocks
    assert f"constexpr int kR = {tk.SCAN_R};" in src
    assert f"constexpr int kThreads = {tk.MAX_THREADS};" in src
    for line in ("s.slots = (s.nbv + cluster - 1) / cluster;",
                 "s.brows = 2 * ri + s.slots * kR + L;",
                 "const int items = max(max(s.slots * pw, s.slots * kR * s.nbh), "
                 "s.brows * (s.pitch / 16) / 4);",
                 "s.threads = min(kThreads, 32 * ((items + 31) / 32));",
                 "s.pitch = 16 * ((4 * rj + L + 30) / 16);",
                 "s.pitch2 = (s.nbh * kR + L) | 1;",
                 "s.off_rows = 2LL * s.brows * s.pitch;",
                 "s.off_taps = s.off_rows + 8LL * s.slots * kR * s.pitch2;",
                 "s.off_resp = s.off_taps + 8LL * L;",
                 "s.off_shift = s.off_resp + 8LL * s.slots * kR * ww;",
                 "s.bytes = s.off_shift + 8LL * s.brows;"):
        assert line in src, line
    # bench shape, C = 6, one row block a CTA: two 112x160 u8 supersets, 7x107 float2 row
    # sums, 65 tap pairs, 2x7x41 f32 responses, 2x112 row offsets; 105 row-pass items, and
    # 1120 chunks to copy a step, so 9 warps (280 threads, four chunks each)
    assert tk.scan_plan((20, 20), 65) == (6, 1, 288, 2 * 112 * 160 + 8 * 7 * 107 + 8 * 65
                                          + 8 * 7 * 41 + 8 * 112)
    # C = 1, the whole window on one CTA: 147-row supersets, 42 rows of sums, 630 items
    assert tk.scan_plan((20, 20), 65, 1) == (1, 6, 640, 2 * 147 * 160 + 8 * 42 * 107 + 8 * 65
                                             + 8 * 42 * 41 + 8 * 147)


@pytest.mark.parametrize("radii,L,want", [
    ((20, 20), 65, "dog_scan"),          # bench window, target_width=25
    ((10, 10), 17, "dog_scan"),          # window 21, target_width=5
    ((20, 20), 129, "dog_scan"),         # target_width=40
    ((52, 52), 149, "dog_scan_tiled"),   # default window of target_width=60: both run
    ((135, 240), 65, "dog_scan_tiled"),  # quarter-frame autodetect snap at 1080p
    ((0, 0), 65, "dog_scan"),
])
def test_kernel_for_picks_by_shape(radii, L, want):
    """The bench window takes dog_scan, the quarter-frame snap the tiled one:
    a shape dispatch between two kernels, each fitting; dog_scan where the
    whole window fits one CTA, though it runs wherever its fewest-blocks plan
    (the window's row blocks over at most 16 CTAs) fits."""
    limit = 232448
    assert tk.kernel_for(radii, L, limit) == want
    runs = tk.scan_plan(radii, L).smem <= limit
    assert runs == bool(tk.scan_plans(radii, L, limit))
    if runs:
        assert tk.scan_plans(radii, L, limit)[0] == tk.scan_plan(radii, L)
    if want == "dog_scan":
        assert tk.scan_plan(radii, L, 1).smem <= limit
        assert tk.kernels_for(radii, L, limit) == tk.KERNELS
    else:
        assert tk.scan_plan(radii, L, 1).smem > limit
        assert tk.kernels_for(radii, L, limit) == (("dog_scan_tiled", "dog_scan") if runs
                                                   else ("dog_scan_tiled",))
        assert tk.tile_plan(radii, L, limit, subpixel=True).smem <= limit


def scan_owners(plan, radii):
    """Which CTA owns each output row of the window, by the kernel's indexing
    (csrc/dog_scan.cu, dog_scan_kernel): CTA r takes the rows [a_lo, a_lo +
    nrow) of row blocks r * slots .. (r + 1) * slots - 1; -1 where none does."""
    wh = 2 * radii[0] + 1
    band = plan.slots * tk.SCAN_R
    rank = np.full(wh, -1)
    for r in range(plan.cluster):
        a_lo = min(r * band, wh)
        nrow = min(band, wh - a_lo)
        assert (rank[a_lo:a_lo + nrow] == -1).all(), "a row owned twice"
        rank[a_lo:a_lo + nrow] = r
    return rank


@pytest.mark.parametrize("radii,L", PLAN_WINDOWS)
def test_scan_plans_fit_and_own_every_row_once(radii, L):
    """scan_plans: one plan a count of row blocks a CTA, fewest first, each
    with the fewest CTAs (at most 16) that give it, each fitting the limit;
    every output row of the window is owned by exactly one CTA, no CTA owns
    more than its slots, and a CTA's threads cover its row-pass items or 640."""
    limit = 232448
    plans = tk.scan_plans(radii, L, limit)
    nbv = -(-(2 * radii[0] + 1) // tk.SCAN_R)
    assert [p.slots for p in plans] == sorted({p.slots for p in plans})
    for plan in plans:
        assert plan.smem == tk._scan_smem_bytes(L, *radii, plan.slots) <= limit
        assert 1 <= plan.cluster <= min(tk.MAX_CLUSTER, nbv)
        assert plan.slots == -(-nbv // plan.cluster) and plan == tk.scan_plan(radii, L,
                                                                             plan.cluster)
        assert (plan.slots - 1) * plan.cluster < nbv  # no fewer CTAs give these slots
        assert (scan_owners(plan, radii) >= 0).all()
        items = plan.slots * (2 * radii[1] + L)
        assert plan.threads % 32 == 0 and min(items, 640) <= plan.threads <= 640
    if plans:
        assert plans[-1].cluster == 1 or plans[-1].smem == max(p.smem for p in plans)


@pytest.mark.parametrize("cluster", [1, 2, 5, 6, 16])
def test_scan_plan_forced_cluster_owns_every_row_once(cluster):
    """A cluster size forced for timing or tests, even above the block count
    (the CTAs past the window own no row and only join the barriers), still
    covers the window's rows once; the subpixel lookup finds each row at its
    owner (row // (slots * 7))."""
    radii, L = (20, 20), 65
    plan = tk.scan_plan(radii, L, cluster)
    assert plan.cluster == cluster and plan.slots == -(-6 // cluster)
    rank = scan_owners(plan, radii)
    assert (rank >= 0).all()
    assert (rank == np.arange(41) // (plan.slots * tk.SCAN_R)).all()


def test_scan_plan_on_the_card_weighs_lanes_against_blocks(monkeypatch):
    """The card's plan: the fewest blocks a CTA while the lanes' clusters run
    in one wave; past that the plan whose waves times blocks is least (the
    card's occupancy query stubbed); a forced size the card cannot schedule,
    or no schedulable plan, raises."""
    active = {6: 20, 3: 44, 2: 66, 1: 132}
    monkeypatch.setattr(tk, "_scan_active_clusters", lambda radii, L, c, dev: active[c])
    tk._scan_plan_cached.cache_clear()
    try:
        assert tk._scan_plan((20, 20), 65, 232448, 1, 0).cluster == 6
        assert tk._scan_plan((20, 20), 65, 232448, 20, 0).cluster == 6
        assert tk._scan_plan((20, 20), 65, 232448, 40, 0).cluster == 6  # 2 waves x 1 = 1 x 2
        assert tk._scan_plan((20, 20), 65, 232448, 60, 0).cluster == 6  # 3 x 1 = 1 x 3
        assert tk._scan_plan((20, 20), 65, 232448, 66, 0).cluster == 2  # 4 x 1 against 1 x 3
        monkeypatch.setattr(tk, "scan_cluster", 3)
        assert tk._scan_plan((20, 20), 65, 232448, 66, 0) == tk.scan_plan((20, 20), 65, 3)
        active[3] = 0
        with pytest.raises(RuntimeError, match="cannot run a cluster of 3"):
            tk._scan_plan((20, 20), 65, 232448, 1, 0)
        monkeypatch.setattr(tk, "scan_cluster", None)
        for c in active:
            active[c] = 0
        tk._scan_plan_cached.cache_clear()
        with pytest.raises(RuntimeError, match="dog_scan: the card cannot run"):
            tk._scan_plan((20, 20), 65, 232448, 1, 0)
    finally:
        tk._scan_plan_cached.cache_clear()


def test_bench_shapes_dispatch():
    """At 1080p the spec's window and the autodetect window go to the two
    kernels (make_spec / autodetect_spec as the main paths build them)."""
    from pawsometracker_tpu_torch.models.dog_tracker import autodetect_spec

    spec = make_spec((1080, 1920), 41, 25, True)
    assert tk.kernel_for(spec.radii, spec.kernel_len, 232448) == "dog_scan"
    aspec = autodetect_spec(spec)
    assert tk.kernel_for(aspec.radii, aspec.kernel_len, 232448) == "dog_scan_tiled"


@pytest.mark.parametrize("target_width,want", [(25, "dog_scan"), (35, "dog_scan"),
                                               (36, "dog_scan_tiled"), (38, "dog_scan_tiled"),
                                               (39, "dog_scan_tiled"), (40, "dog_scan_tiled"),
                                               (60, "dog_scan_tiled"), (63, "dog_scan_tiled"),
                                               (64, "dog_scan_tiled"), (100, "dog_scan_tiled")])
def test_default_window_switches_kernel_between_target_width_38_and_39(target_width, want):
    """At the default window (guess_window_size) the chunk scans leave
    dog_scan for dog_scan_tiled between target_width 35 and 36, where the
    whole window stops fitting one CTA: 61x61 (L = 89) takes 205240 bytes on
    one CTA, 65x65 (L = 89) 234976, of the 232448 a block may use. dog_scan
    still runs up to 63 (109x109, L = 153: sixteen row blocks, one a CTA of
    the largest cluster, 230136 bytes a CTA), so there the chooser can time
    both; from 64 (113x113, L = 157: two blocks a CTA, 273600 bytes) only
    dog_scan_tiled runs. Between 38 and 39 (both 69x69, L from 93 to 97),
    where PR 10's one-CTA kernel stopped fitting, dog_scan_tiled stays."""
    from pawsometracker_tpu_torch.ops.dog_kernel import guess_window_size

    spec = make_spec((1080, 1920), guess_window_size(target_width), target_width, True)
    assert tk.kernel_for(spec.radii, spec.kernel_len, 232448) == want
    assert tk.kernels_for(spec.radii, spec.kernel_len, 232448) == {
        "dog_scan": tk.KERNELS, "dog_scan_tiled": ("dog_scan_tiled", "dog_scan")}[want] \
        if target_width < 64 else ("dog_scan_tiled",)
    one, plan = (tk.scan_plan(spec.radii, spec.kernel_len, c) for c in (1, None))
    if target_width in (35, 36, 38, 39, 63, 64):
        assert (spec.window_size[0], spec.kernel_len, one.smem, plan.cluster, plan.slots,
                plan.smem) == {
            35: (61, 89, 205240, 9, 1, 83832), 36: (65, 89, 234976, 10, 1, 91336),
            38: (69, 93, 250784, 10, 1, 101096), 39: (69, 97, 255136, 10, 1, 103432),
            63: (109, 153, 625776, 16, 1, 230136), 64: (113, 157, 686040, 9, 2, 273600)}[
            target_width]


# ---- the batched configurations (grid over lanes) ---------------------------


def plain_batch(spec, frames, pos0, fills, deltas=None, lo=None, hi=None, subpixel=False):
    b = {}
    if deltas is not None:
        b = {k: torch.from_numpy(np.asarray(v, np.int32))
             for k, v in (("deltas", deltas), ("lo", lo), ("hi", hi))}
    out = tk.dog_scan_batch(torch.from_numpy(frames), torch.from_numpy(np.asarray(pos0, np.int32)),
                            torch.from_numpy(np.asarray(fills, np.uint8)), radii=spec.radii,
                            sigma=spec.sigma, darker_target=spec.darker_target,
                            subpixel=subpixel, **b)
    return tuple(o.numpy() for o in out) if subpixel else out.numpy()


@pytest.mark.parametrize("fills_kind", ["shared fill", "per-video fills"])
def test_batched_plain_matches_pallas_and_xla(fills_kind):
    """The cases of tests/test_pallas.py:58-90: grid (B, T), one fill or
    per-video fills."""
    if fills_kind == "shared fill":
        h, w, T, B = 80, 90, 8, 3
        paths = [[(20 + b * 5 + t, 30 + t) for t in range(T)] for b in range(B)]
        frames = np.stack([np.stack([draw_blob(h, w, ij, 3) for ij in p]) for p in paths])
        fills = np.full((B,), 128, np.uint8)
    else:
        h, w, T, B = 64, 64, 5, 2
        frames = np.stack([
            np.stack([draw_blob(h, w, (20 + t, 20 + t), 3, bg=100) for t in range(T)]),
            np.stack([draw_blob(h, w, (30 + t, 30 + t), 3, bg=200) for t in range(T)]),
        ])
        paths = [[(20, 20)], [(30, 30)]]
        fills = np.array([100, 200], np.uint8)
    rspec = ref_make_spec((h, w), 15, 6, True)
    pos0 = np.array([p[0] for p in paths], np.int32)
    want_x = np.asarray(ref_tracker_fns(rspec).scan_batch(*jax_args(frames, pos0, fills)))
    want_p = np.asarray(pallas_scan_fn(rspec, batched=True, interpret=True)(*jax_args(frames, pos0,
                                                                               fills)))
    got = plain_batch(make_spec((h, w), 15, 6, True), frames, pos0, fills)
    np.testing.assert_array_equal(got, want_x)
    np.testing.assert_array_equal(got, want_p)
    assert got.dtype == np.int32 and got.shape == (B, T, 2)


def test_batched_bounded_plain_matches_pallas_and_xla():
    """tests/test_pallas.py:129-159: per-lane clamp boxes and fills."""
    ch, cw, T, B = 81, 89, 6, 3
    paths = [[(30 + 4 * b + t, 40 + t) for t in range(T)] for b in range(B)]
    crops = np.stack([np.stack([draw_blob(ch, cw, ij, 4, bg=90 + 40 * b) for ij in p])
                      for b, p in enumerate(paths)])
    rspec = ref_make_spec((ch, cw), 19, 8, True)
    pos0 = np.array([p[0] for p in paths], np.int32)
    fills = np.array([90, 130, 170], np.uint8)
    deltas = np.zeros((B, T, 2), np.int32)
    lo = np.tile(np.array([[0, 0], [2, 1], [0, 3]], np.int32)[:, None], (1, T, 1))
    hi = np.tile(np.array([[80, 88], [70, 85], [78, 80]], np.int32)[:, None], (1, T, 1))
    args = jax_args(crops, pos0, fills, deltas, lo, hi)
    base = ref_tracker_fns(rspec).scan_bounded
    want_x = np.asarray(jax.vmap(getattr(base, "__wrapped__", base))(*args))
    want_p = np.asarray(pallas_scan_fn(rspec, batched=True, bounded=True, interpret=True)(*args))
    got = plain_batch(make_spec((ch, cw), 19, 8, True), crops, pos0, fills, deltas, lo, hi)
    np.testing.assert_array_equal(got, want_x)
    np.testing.assert_array_equal(got, want_p)
    got_f = tracker_fns(make_spec((ch, cw), 19, 8, True), "cpu").scan_bounded_batch(
        crops, pos0, fills, deltas, lo, hi)
    np.testing.assert_array_equal(got_f.numpy(), want_x)


def test_batched_subpixel_plain_matches_pallas_and_xla(rng):
    """tests/test_pallas.py:162-206 (batched): positions exact, offsets within
    1e-3 (the engines sum the response in different orders)."""
    ch, cw, T, B = 64, 64, 6, 2
    path = [(30 + t, 28 + 2 * t) for t in range(T)]
    frames = np.stack([draw_blob(ch, cw, ij, 3) for ij in path]).astype(np.uint8)
    frames = np.clip(frames.astype(np.int32) + rng.integers(-3, 4, frames.shape), 0,
                     255).astype(np.uint8)
    fb = np.stack([frames, frames[:, ::-1].copy()])
    pos0 = np.tile(np.array([[30, 28]], np.int32), (B, 1))
    deltas = np.zeros((B, T, 2), np.int32)
    lo = np.zeros((B, T, 2), np.int32)
    hi = np.tile(np.array([[[ch - 1, cw - 1]]], np.int32), (B, T, 1))
    fills = np.full((B,), 128, np.uint8)
    rspec = ref_make_spec((ch, cw), 15, 6, True)
    args = jax_args(fb, pos0, fills, deltas, lo, hi)
    base = ref_tracker_fns(rspec).scan_sub
    xp, xo = jax.jit(jax.vmap(getattr(base, "__wrapped__", base)))(*args)
    pp, po = pallas_scan_fn(rspec, batched=True, bounded=True, subpixel=True, interpret=True)(*args)
    spec = make_spec((ch, cw), 15, 6, True)
    gp, go = plain_batch(spec, fb, pos0, fills, deltas, lo, hi, subpixel=True)
    assert np.abs(go).max() > 0
    for wp, wo in ((xp, xo), (pp, po)):
        np.testing.assert_array_equal(gp, np.asarray(wp))
        np.testing.assert_allclose(go, np.asarray(wo), rtol=0, atol=1e-3)
    fp, fo = tracker_fns(spec, "cpu").scan_sub_batch(fb, pos0, fills, deltas, lo, hi)
    np.testing.assert_array_equal(fp.numpy(), gp)
    np.testing.assert_array_equal(fo.numpy(), go)


def test_batched_wrapper_checks_and_dispatch():
    spec = make_spec((40, 40), 9, 6, True)
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True)
    frames = torch.from_numpy(np.stack([np.stack([draw_blob(40, 40, (20, 20 + t), 3)
                                                  for t in range(5)])] * 2))
    p0 = torch.tensor([[20, 20], [20, 21]], dtype=torch.int32)
    fl = torch.tensor([128, 128], dtype=torch.uint8)
    before = tk.launches
    got = tk.dog_scan_batch(frames, p0, fl, **kw)
    assert tk.launches == before  # the CPU tensor took the plain version
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(),
                                      tk.dog_scan(frames[b], p0[b], 128, **kw).numpy())
    shared = tk.dog_scan_batch(frames[0], p0, fl, **kw)  # lanes read one stream
    np.testing.assert_array_equal(shared[0].numpy(), got[0].numpy())
    with pytest.raises(ValueError, match="uint8"):
        tk.dog_scan_batch(frames.float(), p0, fl, **kw)
    with pytest.raises(ValueError, match="pos0"):
        tk.dog_scan_batch(frames, p0[0], fl, **kw)
    with pytest.raises(ValueError, match="lanes"):
        tk.dog_scan_batch(frames, p0[:1], fl[:1], **kw)
    with pytest.raises(ValueError, match="fills"):
        tk.dog_scan_batch(frames, p0, fl[:1], **kw)
    z = torch.zeros((2, 5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        tk.dog_scan_batch(frames, p0, fl, deltas=z, **kw)
    with pytest.raises(ValueError, match="shape"):
        tk.dog_scan_batch(frames, p0, fl, deltas=z[:, :4], lo=z, hi=z, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tk.dog_scan_batch_cuda(frames, p0, fl, **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tk.dog_scan_batch(frames.to("meta"), p0.to("meta"), fl.to("meta"), **kw)


def test_source_names_the_batched_configurations():
    import os

    src = open(os.path.join(os.path.dirname(tk.__file__), "..", "csrc", "dog_scan.cu")).read()
    assert "blockIdx.x" in src and "lane_stride" in src
    assert tk._config_name(True, True, batched=True) == "batched bounded+subpixel"
    assert tk._config_name(False, False) == "unbounded"
