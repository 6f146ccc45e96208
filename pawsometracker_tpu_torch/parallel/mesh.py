"""Batch tracking on one card or over a mesh of devices, and the whole-frame DoG detectors.

The counterpart of the JAX package's ``pawsometracker_tpu/parallel/mesh.py``.
A :class:`Mesh` is a ``(data, space)`` array of devices, as a
``jax.sharding.Mesh`` is, taken as given: a device may appear more than once
(its shards then share the device and its streams). ``data`` splits a batch of
videos, one contiguous range of lanes a row of the mesh; ``space`` splits the
rows of a frame in the whole-frame detector.

:class:`ShardedBatchTracker` gives the batched tracker functions of one spec:
on one device, B videos per launch of the CUDA kernel (one cluster per video); or,
with a mesh, one launch of the same batched function per data shard, on the
first device of its row and in that device's context. The JAX package's
tracker replicates over ``space``; the results are the same on every device of
a row, so the port runs each shard once. A launch returns at once, so shards on
different cards run together. :class:`Sharded` holds the per-shard tensors of
a batch, the counterpart of a batch-sharded ``jax.Array``, and
:func:`sharded_pallas_bounded` is the batched bounded scan over a mesh, one
``dog_scan_batch`` launch a shard. :func:`global_detect_batch` and
:func:`global_detect_peaks` find targets in whole frames, through the DoG
response that the JAX package computes outside its Pallas kernel.
"""

from __future__ import annotations

import contextlib
import functools
from collections import OrderedDict

import numpy as np
import torch

from ..models.dog_tracker import TrackerSpec, autodetect_spec, resolve_device, tracker_fns
from ..ops import detect_kernel
from ..utils.profiling import OFF

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "BatchSharding",
    "Sharded",
    "ShardedFn",
    "ShardedBatchTracker",
    "sharded_pallas_bounded",
    "global_detect_batch",
    "global_detect_peaks",
]


class Mesh:
    """A ``(data, space)`` array of devices, as ``jax.sharding.Mesh``:
    ``devices`` is the object array of :class:`torch.device` s (each
    normalised as :func:`~..models.dog_tracker.resolve_device` does, so
    ``"cuda"`` and ``"cuda:0"`` are one device), ``axis_names`` the axes and
    ``shape`` their sizes in order. All devices are of one type."""

    axis_names = ("data", "space")

    def __init__(self, devices):
        arr = np.array(devices, dtype=object)
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"a mesh is a non-empty (data, space) array of devices, got shape "
                             f"{arr.shape}")
        for idx, d in np.ndenumerate(arr):
            arr[idx] = resolve_device(d)
        if len({d.type for d in arr.flat}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{sorted(set(map(str, arr.flat)))}")
        self.devices = arr

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def data_devices(self) -> list:
        """The device each data shard runs on: the first of its row."""
        return list(self.devices[:, 0])

    def _key(self):
        return self.devices.shape, tuple(self.devices.flat)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, *, space: int = 1, devices=None) -> Mesh:
    """A ``(data, space)`` mesh over the first ``n_devices`` of ``devices``.

    ``space`` divides ``n_devices``; the data axis gets the rest. With
    ``space=1`` (default) this is a pure data-parallel mesh. ``devices=None``
    means every CUDA card and raises when there is none (pass ``devices=``,
    e.g. ``["cpu"] * 8``, for another mesh); entries may repeat."""
    if n_devices is not None and n_devices % space != 0:
        raise ValueError(f"space={space} must divide n_devices={n_devices}")
    if devices is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("no CUDA device is available; pass devices= (e.g. "
                               "devices=['cpu'] * 8) to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % space != 0:
        raise ValueError(f"space={space} must divide n_devices={n_devices}")
    if not 0 < n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices} of {len(devices)} devices")
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devices[:n_devices]
    return Mesh(arr.reshape(n_devices // space, space))


def _check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a Mesh (see make_mesh) or None, got {type(mesh).__name__}")
    return mesh


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """``device`` if it is one of the mesh's (``None``: the first data
    shard's device); a device outside the mesh raises ``ValueError``."""
    if device is None:
        return mesh.devices[0, 0]
    dev = resolve_device(device)
    if dev not in set(mesh.devices.flat):
        raise ValueError(f"device {dev} is not one of the mesh's devices: {mesh}")
    return dev


def on_device(dev: torch.device):
    """The context in which work for ``dev`` is issued: ``dev``'s, on a card."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class BatchSharding:
    """Where a batch lies on a mesh: the leading (lane) axis split over
    ``data``, the rest replicated. ``spec`` is ``("data", None, ...)``, equal
    to JAX's ``PartitionSpec("data", None, ...)``; :meth:`lanes` gives the
    lane range each data row owns, and ``devices`` the device it runs on."""

    def __init__(self, mesh: Mesh, ndim: int):
        self.mesh = mesh
        self.spec = ("data",) + (None,) * (ndim - 1)
        self.devices = mesh.data_devices()

    def lanes(self, batch: int) -> list[slice]:
        """The lanes of each data shard of a batch of ``batch`` lanes; a batch
        the data axis does not divide raises ``ValueError``, as JAX does."""
        n = len(self.devices)
        if batch % n:
            raise ValueError(f"a batch sharded over the mesh's data axis ({n}) needs its "
                             f"dimension 0 divisible by {n}, but it is {batch}")
        k = batch // n
        return [slice(i * k, (i + 1) * k) for i in range(n)]


def batch_sharding(mesh: Mesh, ndim: int) -> BatchSharding:
    """Shard the leading (batch) axis on ``data``; replicate the rest."""
    return BatchSharding(_check_mesh(mesh), ndim)


class Sharded:
    """A batch split over a mesh's data axis: ``shards[i]`` holds the lanes
    ``sharding.lanes(B)[i]`` on ``sharding.devices[i]``. :meth:`cpu`
    gathers it into one host tensor (waiting for each shard's device), as do
    :meth:`numpy` and ``np.asarray``."""

    __slots__ = ("shards", "sharding")

    def __init__(self, shards, sharding: BatchSharding):
        self.shards = list(shards)
        self.sharding = sharding

    @property
    def shape(self) -> tuple:
        return (sum(s.shape[0] for s in self.shards),) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self):
        return self.shards[0].dtype

    def cpu(self) -> torch.Tensor:
        return torch.cat([s.cpu() for s in self.shards])

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self):
        return f"Sharded(shape={self.shape}, dtype={self.dtype}, spec={self.sharding.spec})"


def shard_lanes(x, sharding: BatchSharding, batch: int) -> list:
    """``x`` (a :class:`Sharded`, a tensor or an array of ``batch`` lanes) as
    one tensor a data shard, on that shard's device; a :class:`Sharded`
    keeps its shards."""
    if isinstance(x, Sharded):
        if x.shape[0] != batch or len(x.shards) != len(sharding.devices):
            raise ValueError(f"a Sharded of shape {x.shape} in {len(x.shards)} shards, where "
                             f"{batch} lanes in {len(sharding.devices)} were expected")
        return [s.to(d) for s, d in zip(x.shards, sharding.devices)]
    t = x if torch.is_tensor(x) else torch.as_tensor(np.ascontiguousarray(x))
    return [t[sl].to(d) for sl, d in zip(sharding.lanes(batch), sharding.devices)]


class ShardedFn:
    """One batched function over a mesh: ``fns[i]``, a single-device function
    of the lanes of data shard i, runs on ``devices[i]`` in that device's
    context. A call splits every argument by lane range (a :class:`Sharded`
    keeps its shards), launches the shards in turn and returns a
    :class:`Sharded` (a tuple of them where the function returns a tuple).

    A bounded scan over the mesh also carries its segmented form:
    ``segments[i]`` is shard i's ``scan_bounded_batch_super`` (see
    :class:`~..models.dog_tracker.TrackerFns`), which the lane engines launch
    at S = 1 a shard at a time. ``timer`` (a call's :class:`~..utils.profiling.Timer`;
    None: no spans) records each shard's turn of a call as ``shard.launch``."""

    def __init__(self, fns, mesh: Mesh, segments=None, timer=None):
        self.fns = list(fns)
        self.mesh = mesh
        self.devices = mesh.data_devices()
        self.segments = None if segments is None else list(segments)
        self.timer = OFF if timer is None else timer

    def __call__(self, *args):
        batch = args[0].shape[0]
        parts = [shard_lanes(a, BatchSharding(self.mesh, 1), batch) for a in args]
        outs = []
        for i, (fn, dev) in enumerate(zip(self.fns, self.devices)):
            with self.timer.span("shard.launch", shard=i), on_device(dev):
                outs.append(fn(*(p[i] for p in parts)))

        def wrap(shards):
            return Sharded(shards, BatchSharding(self.mesh, shards[0].dim()))

        if isinstance(outs[0], tuple):
            return tuple(wrap([o[k] for o in outs]) for k in range(len(outs[0])))
        return wrap(outs)

    def map(self, make) -> "ShardedFn":
        """A new ShardedFn of ``make(fn, device)`` for each shard's function."""
        return ShardedFn([make(f, d) for f, d in zip(self.fns, self.devices)], self.mesh,
                         timer=self.timer)


def _batch_frame_response(spec: TrackerSpec):
    """``fn(frames_u8 [B,H,W], fills [B]) -> float32 [B,H,W]``: the whole
    frame's DoG response, each frame padded by half the taps with its fill.
    Both whole-frame detectors build on :mod:`..ops.detect_kernel`'s response,
    so they can never disagree.

    The correlation is direct taps, each a float32 multiply and a separate
    add, rows first: no matrix product, so no TF32 and no library summation
    order. On the card it is one launch of ``csrc/detect.cu``'s response
    kernel, on the CPU the same arithmetic in plain PyTorch, and the two round
    every operation alike (``tests/test_torch_cuda.py`` holds them bit-equal).
    Each output element reads only its own rows of the padded frame, so a
    frame correlated in row slabs (the space-sharded detector) is bit-equal to
    the whole frame. The JAX package uses banded matmuls at HIGHEST precision;
    the two agree on the peaks of distinct blobs, not on exact ties."""

    def response(frames: torch.Tensor, fills) -> torch.Tensor:
        return detect_kernel.frame_response(frames, fills, spec.sigma, spec.darker_target)[0]

    return response


def _argmax_frames(resp: torch.Tensor, H: int) -> torch.Tensor:
    """Per frame of ``resp [B, H, W]``, the first maximum in column-major
    order (the tracker's tie-break) as int32 ``(row, col)``."""
    k = torch.argmax(resp.transpose(1, 2).reshape(resp.shape[0], -1), dim=1)
    return torch.stack([k % H, k // H], dim=1).to(torch.int32)


@functools.lru_cache(maxsize=128)
def global_detect_batch(spec: TrackerSpec, mesh: Mesh | None = None):
    """Whole-frame target detection, batched and (optionally) spatially
    sharded: the DoG response over the ENTIRE frame and its first maximum in
    column-major order per frame (the tracker's tie-break). Framework
    extension beyond the reference's quarter-frame auto-detect (reference:
    src/PawsomeTracker.jl:99-107).

    Returns ``fn(frames_u8 [B, H, W], fills_u8 [B]) -> int32 [B, 2]``. With
    no mesh it runs on the frames' device (numpy frames run on the CPU). With
    a mesh the batch splits over ``data`` and each data shard's rows over
    ``space``: device ``(i, s)`` correlates its rows from a slab of the padded
    frame that carries the ``L - 1`` halo rows beside them (the halo exchange
    XLA inserts in the JAX package), and the response rows go to
    ``devices[i, 0]`` for the argmax; it returns a :class:`Sharded`. The
    response is computed per output element either way, so the sharded result
    is bit-equal to the unsharded one."""
    H = spec.frame_shape[0]
    sigma, darker, L = spec.sigma, spec.darker_target, spec.kernel_len
    response = _batch_frame_response(spec)

    if mesh is None:
        def detect(frames, fills):
            return _argmax_frames(response(torch.as_tensor(frames), fills), H)

        return detect

    mesh = _check_mesh(mesh)
    space = mesh.shape["space"]
    rows = [(H * s // space, H * (s + 1) // space) for s in range(space)]

    def detect_sharded(frames, fills):
        batch = frames.shape[0]
        sharding = BatchSharding(mesh, 3)
        f_parts = shard_lanes(frames, sharding, batch)
        fill_parts = shard_lanes(fills, sharding, batch)
        out = []
        for i, (f, fl) in enumerate(zip(f_parts, fill_parts)):
            home = mesh.devices[i, 0]
            with on_device(home):
                x = detect_kernel.pad_plain(f, fl, L)
            parts = []
            for s, (r0, r1) in enumerate(rows):
                dev = mesh.devices[i, s]
                with on_device(dev):
                    parts.append(detect_kernel.correlate(x[:, r0:r1 + L - 1].to(dev), sigma,
                                                         darker))
            with on_device(home):
                out.append(_argmax_frames(torch.cat([p.to(home) for p in parts], dim=1), H))
        return Sharded(out, BatchSharding(mesh, 2))

    return detect_sharded


@functools.lru_cache(maxsize=128)
def global_detect_peaks(spec: TrackerSpec, n_targets: int, min_distance: int | None = None):
    """Top-``n_targets`` DoG-response peaks in ONE frame, with non-maximum
    suppression: multi-target auto-detection.

    Peaks are returned strongest-first; each peak suppresses a disk of radius
    ``min_distance`` (default: the search-window extent, so two targets are
    never the same blob). Ties break column-major like the tracker. If
    suppression exhausts the frame before N peaks are found, the remaining
    entries REPEAT the last valid peak; callers (``track_multi``) reject
    duplicate peaks with a clear error instead of seeding bogus trackers.

    Returns ``fn(frame_u8 [H, W], fill_u8, timer=OFF) -> int32 [n_targets,
    2]``, run on the frame's device: on the card two launches of
    ``csrc/detect.cu`` (the response, then all N rounds), whatever N and the
    taps; on the CPU the plain rounds (:mod:`..ops.detect_kernel`). Under a
    recording ``timer`` the response's launch is the span ``detect.response``
    and the rounds' ``detect.suppress``. The rounds read nothing back to the
    host, so the caller's copy of the peaks is the one wait for the device."""
    N = int(n_targets)
    if min_distance is None:
        min_distance = max(2 * spec.radii[0] + 1, 2 * spec.radii[1] + 1)
    r2 = float(min_distance) ** 2

    def detect(frame_u8, fill_u8, timer=OFF):
        frame = torch.as_tensor(frame_u8)
        with timer.span("detect.response"):
            resp, part = detect_kernel.frame_response(frame[None], [int(fill_u8)], spec.sigma,
                                                      spec.darker_target)
        with timer.span("detect.suppress"):
            return detect_kernel.suppress(resp[0], None if part is None else part[0], N, r2)

    return detect


def _mesh_fns(spec: TrackerSpec, mesh: Mesh, engine: str, kernel: str | None = None) -> list:
    """Each data shard's tracker functions on its device, every one with
    ``kernel`` (see :func:`~..models.dog_tracker.tracker_fns`)."""
    return [tracker_fns(spec, d, engine, kernel=kernel) for d in mesh.data_devices()]


def sharded_pallas_bounded(spec: TrackerSpec, mesh: Mesh, *, interpret: bool = False,
                           subpixel: bool = False, kernel: str | None = None) -> ShardedFn:
    """The batched bounded scan under a device mesh: each data shard runs
    one ``dog_scan_batch`` launch on its lanes, on its device (the JAX
    package's ``shard_map`` of the fused kernel over ``data``), of ``kernel``
    on every shard (one of ``ops.tracker_kernel.KERNELS``, as the ROI path's
    measured choice gives it; None: the shape rule's).

    The batch must divide the mesh's ``data`` extent. Signature of the
    batched bounded scan: ``fn(frames [B,T,ch,cw], pos0 [B,2], fills [B],
    deltas [B,T,2], lo [B,T,2], hi [B,T,2]) -> positions int32 [B,T,2]``
    (and offsets float32 ``[B,T,2]`` with ``subpixel``), each a
    :class:`Sharded`. ``interpret=True`` runs the plain PyTorch version, the
    port's counterpart of Pallas interpret mode: an explicit request, never a
    fallback, and it takes no ``kernel``. One ShardedFn for each set of
    arguments, however they are spelt."""
    return _sharded_pallas_bounded(spec, _check_mesh(mesh), bool(interpret), bool(subpixel),
                                   kernel)


@functools.lru_cache(maxsize=128)
def _sharded_pallas_bounded(spec, mesh, interpret, subpixel, kernel) -> ShardedFn:
    fns = _mesh_fns(spec, mesh, "xla" if interpret else "pallas", kernel)
    return _bounded_fn(fns, mesh, subpixel)


def _bounded_fn(fns, mesh: Mesh, subpixel: bool) -> ShardedFn:
    """The batched bounded scan of each shard's ``fns`` over ``mesh``, with its
    segmented form."""
    name = "scan_sub_batch" if subpixel else "scan_bounded_batch"
    return ShardedFn([getattr(f, name) for f in fns], mesh,
                     [functools.partial(f.scan_bounded_batch_super, subpixel=subpixel)
                      for f in fns])


class ShardedBatchTracker:
    """Batch-of-videos tracking engine: the batched forms of
    :class:`~..models.dog_tracker.TrackerFns` for ``spec`` (and for its
    quarter-frame autodetect spec), each one launch of the CUDA kernel for
    all B videos on one device or, with a ``mesh``, one launch per data
    shard (:class:`ShardedFn`, taking and returning :class:`Sharded`).

    ``snap``/``snap_detect``: ``(frames [B,H,W], guesses [B,2], fills [B]) ->
    [B,2]``; ``scan``: ``(frames [B,T,H,W], pos0 [B,2], fills) -> [B,T,2]``;
    ``scan_bounded``/``scan_sub`` take ``deltas, lo, hi [B,T,2]`` too;
    ``snap_sub``/``snap_detect_sub`` also return offsets. With a mesh,
    ``scan_bounded`` and ``scan_sub`` carry their segmented form
    (:meth:`ShardedFn.segmented`). ``engine`` is as in
    :func:`~..models.dog_tracker.tracker_fns`, except that ``"pallas"`` with a
    mesh raises, as in the JAX package. ``device``: without a mesh, as in
    ``tracker_fns``; with one, ``None`` or one of its devices (``.device``,
    where single-device work goes). ``timer``: the call's, for the per-shard
    spans of the snaps over a mesh."""

    def __init__(self, spec: TrackerSpec, mesh=None, engine: str = "auto", *, device=None,
                 timer=None):
        self.spec = spec
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            fns = tracker_fns(spec, self.device, engine)
            det = tracker_fns(autodetect_spec(spec), self.device, engine)
            self.snap = fns.snap_batch
            self.snap_detect = det.snap_batch
            self.scan = fns.scan_batch
            self.scan_bounded = fns.scan_bounded_batch
            self.scan_sub = fns.scan_sub_batch
            self.snap_sub = fns.snap_sub_batch
            self.snap_detect_sub = det.snap_sub_batch
            return
        _check_mesh(mesh)
        if engine == "pallas":
            # the kernel under a mesh is a DIFFERENT code path
            # (sharded_pallas_bounded, selected in the ROI pipeline); the JAX
            # package refuses the flag here, and so does the port
            raise ValueError(
                "engine='pallas' is not supported with a mesh on "
                "ShardedBatchTracker; the sharded kernel engine is selected "
                "in the ROI pipeline (engine='auto')"
            )
        self.device = mesh_device(mesh, device)
        fns = _mesh_fns(spec, mesh, engine)
        det = _mesh_fns(autodetect_spec(spec), mesh, engine)

        def sharded(name, src):
            return ShardedFn([getattr(f, name) for f in src], mesh, timer=timer)

        self.snap = sharded("snap_batch", fns)
        self.snap_detect = sharded("snap_batch", det)
        self.scan = sharded("scan_batch", fns)
        self.scan_bounded = _bounded_fn(fns, mesh, False)
        self.scan_sub = _bounded_fn(fns, mesh, True)
        self.snap_sub = sharded("snap_sub_batch", fns)
        self.snap_detect_sub = sharded("snap_sub_batch", det)

    def shard_chunk(self, chunk):
        """Place a host array (a ``[B, T, H, W]`` chunk, or any per-video
        array) on the tracker's device, or batch-sharded over its mesh."""
        chunk = np.ascontiguousarray(chunk)
        if self.mesh is None:
            return torch.as_tensor(chunk).to(self.device)
        sharding = batch_sharding(self.mesh, chunk.ndim)
        return Sharded(shard_lanes(chunk, sharding, chunk.shape[0]), sharding)
