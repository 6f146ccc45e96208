"""Checkpoint / resume for long recordings.

The reference has no checkpointing; its closest analog is segmented-video
chaining, where the state handed across a boundary is a single position
(reference: src/PawsomeTracker.jl:203-206). This module generalizes that to
arbitrary time slices of ONE file: tracking proceeds in fixed-duration slices,
after each slice the accumulated results and the resume point are persisted,
and an interrupted run picks up exactly where it stopped.

Slice boundaries are aligned to whole frames (slice duration is rounded to a
multiple of ``1/fps``), so the union of slice samplings equals a single run's
sampling and the resumed trajectory is identical to an uninterrupted one
(each slice's first step is a snap from the previous slice's final position —
the same operation as a regular per-frame step). Timestamps are regenerated
from the single-run ``linspace(start, stop, n)`` grid rather than concatenated
per slice, so they too match an uninterrupted run exactly.

The checkpoint is the JAX package's format (an ``.npz`` with ``ts``, ``ij``,
``next_time`` and ``done``), so a run checkpointed by either package resumes
in the other.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .api import DEFAULT_MAX_DURATION_SECONDS, IJ, grid_prefix, track
from .models.dog_tracker import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["track_resumable", "load_checkpoint"]


def load_checkpoint(path: str):
    """Load a checkpoint; returns None when absent or unreadable.

    A corrupt/truncated file (e.g. power loss mid-write on a filesystem that
    reordered the rename before the data blocks) must not permanently brick
    resume — the damaged file is set aside and tracking restarts from the
    beginning."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return {
                "ts": z["ts"],
                "ij": z["ij"],
                "next_time": float(z["next_time"]),
                "done": bool(z["done"]),
            }
    except Exception as e:
        quarantined = path + ".corrupt"
        try:
            os.replace(path, quarantined)
        except OSError:
            quarantined = "<could not move aside>"
        logger.warning(
            "checkpoint %s is unreadable (%s); moved to %s — restarting from scratch",
            path, e, quarantined,
        )
        return None


def _slice_worker(args):
    """Run one slice's track() — module-level so multiprocessing 'spawn' can
    import it. Used by ``isolate_slices=True`` (see track_resumable). The
    child initialises CUDA and loads the kernel library itself; ``device``
    travels in ``kw``. Returns host numpy, never a card tensor."""
    file, t0, t1, fps, loc, kw = args
    _, ij = track(file, start=t0, stop=t1, fps=fps, start_location=loc, **kw)
    return np.asarray(ij)


def _save(path: str, ts, ij, next_time: float, done: bool):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # atomic: write-fsync-rename
        np.savez(f, ts=ts, ij=ij, next_time=next_time, done=done)
        f.flush()
        os.fsync(f.fileno())  # data durable BEFORE the rename lands
    os.replace(tmp, path)


def track_resumable(
    file,
    *,
    checkpoint_path: str,
    start: float = 0.0,
    stop: float | None = None,
    fps: float = 24,
    checkpoint_every: float = 60.0,
    start_location=None,
    isolate_slices: bool = False,
    _max_slices: int | None = None,
    **track_kwargs,
):
    """Track ``file`` in checkpointed slices; resume from ``checkpoint_path``
    if it exists. Returns ``(ts, positions)`` for the WHOLE tracked range.

    ``track_kwargs`` go to each slice's :func:`.api.track`, ``device``
    included: the card by default (raises when there is none), ``"cpu"`` for
    the plain version on the host.

    ``isolate_slices=True`` runs each slice's track() in a fresh spawned
    subprocess (never forked: a child forked after CUDA started cannot use
    it). Results are identical (the cross-slice state is the same single
    position either way); the point is bounded host memory over a
    multi-hour recording. Each slice subprocess re-pays the import of torch,
    CUDA's start and the kernel library's load (seconds), so pair it with a
    LARGE ``checkpoint_every`` (e.g. 600 s). Requires a path input
    (in-memory frame arrays would be pickled wholesale).

    ``_max_slices`` limits the number of slices processed in this call (used
    by tests to simulate interruption); the checkpoint then holds the partial
    result.
    """
    stop = DEFAULT_MAX_DURATION_SECONDS if stop is None else float(stop)
    if isolate_slices and not isinstance(file, (str, os.PathLike)):
        raise ValueError(
            "isolate_slices=True needs a path input (an in-memory frame array "
            "would be pickled wholesale into every slice subprocess)"
        )
    if track_kwargs.get("device") is None and not torch.cuda.is_available():
        resolve_device(None)  # raises: no card, and the CPU was not asked for
    # align slice duration to whole frames so slice sampling == one-run sampling
    frames_per_slice = max(1, int(round(checkpoint_every * fps)))
    slice_dur = frames_per_slice / fps

    # the single-run timestamp grid: linspace(start, stop, n_total) — slice
    # results are re-labeled on this grid so ts match an uninterrupted run
    n_total = max(1, int(np.round(fps * (stop - start))))

    def _grid_ts(n: int) -> np.ndarray:
        return grid_prefix(float(start), stop, n_total, n)

    state = load_checkpoint(checkpoint_path)
    if state is not None and state["done"]:
        return state["ts"], state["ij"]
    if state is not None:
        all_ij = [state["ij"]]
        t0 = state["next_time"]
        # np.round, not truncation: with subpixel=True the stored positions are
        # floats and the resume seed must match _track_many's chaining rounding
        loc = IJ(int(np.round(state["ij"][-1][0])), int(np.round(state["ij"][-1][1])))
    else:
        all_ij = []
        t0 = float(start)
        loc = start_location

    slices = 0
    done = False
    dirty = False  # new results since the last persisted checkpoint
    while t0 < stop - 0.5 / fps:
        if _max_slices is not None and slices >= _max_slices:
            break
        t1 = min(t0 + slice_dur, stop)
        expected = int(np.round(fps * (t1 - t0)))
        try:
            if isolate_slices:
                import multiprocessing

                ctx = multiprocessing.get_context("spawn")
                with ctx.Pool(1) as pool:  # apply() re-raises child exceptions
                    ij_i = pool.apply(
                        _slice_worker, ((file, t0, t1, fps, loc, track_kwargs),)
                    )
            else:
                _, ij_i = track(
                    file, start=t0, stop=t1, fps=fps, start_location=loc, **track_kwargs
                )
        except EOFError:  # stream ended exactly at a slice boundary
            done = True
            dirty = True
            break
        all_ij.append(ij_i)
        loc = IJ(int(np.round(ij_i[-1][0])), int(np.round(ij_i[-1][1])))
        t0 = t1
        slices += 1
        if len(ij_i) < expected:  # stream ended inside the slice
            done = True
        ij_acc = np.concatenate(all_ij)
        _save(checkpoint_path, _grid_ts(len(ij_acc)), ij_acc, t0, done)
        dirty = False
        if done:
            break
    else:
        done = True
        dirty = True

    if not all_ij:
        raise EOFError(f"no frames tracked from {file}")
    ij_all = np.concatenate(all_ij)
    ts_all = _grid_ts(len(ij_all))
    if dirty:
        _save(checkpoint_path, ts_all, ij_all, t0, done)
    return ts_all, ij_all
