"""Command-line interface: ``python -m pawsometracker_tpu_torch [files...]``.

The JAX package's CLI (``python -m pawsometracker_tpu``) on the port: the same
flags, defaults, outputs and exit codes, plus ``--device``. It tracks on the
CUDA card unless ``--device cpu`` asks for the plain PyTorch version on the
host; without a card and without ``--device`` it fails. Output is CSV
(``t,row,col``) on stdout or ``--out results.npz``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _window_size(s: str):
    """``"21"`` -> 21; ``"61x9"`` -> (61, 9) in the reference's (w, h)
    convention (reference: src/PawsomeTracker.jl:70-72)."""
    if "x" in s.lower():
        w, h = s.lower().split("x", 1)
        return (int(w), int(h))
    return int(s)


def build_parser() -> argparse.ArgumentParser:
    """The CLI argument parser (exposed for --help docs generation)."""
    p = argparse.ArgumentParser(
        prog="pawsometracker_tpu_torch",
        description="Track a single blob-like target through video file(s) with a DoG matched filter.",
    )
    p.add_argument("files", nargs="+",
                   help="video file, or consecutive segments of one recording; "
                        ".npy/.npz files load as in-memory [T, H, W](, 3) uint8 "
                        "frame stacks (see --input-fps)")
    p.add_argument("--start", type=float, default=None, help="start time (s)")
    p.add_argument("--stop", type=float, default=None, help="stop time (s)")
    p.add_argument("--fps", type=float, default=24, help="tracking sample rate")
    p.add_argument("--target-width", type=float, default=25, help="target diameter (px, FWHM)")
    p.add_argument("--window-size", type=_window_size, default=None, metavar="L|WxH",
                   help="search window: edge length for a square window, or WxH "
                        "(reference (w, h) convention, e.g. 61x9)")
    p.add_argument("--lighter-target", action="store_true", help="target is lighter than background")
    p.add_argument("--start-ij", type=int, nargs=2, metavar=("ROW", "COL"), default=None,
                   action="append", help="raw 0-based start index (repeat for "
                   "multiple targets in ONE video — multi-target mode)")
    p.add_argument("--start-xy", type=int, nargs=2, metavar=("X", "Y"), default=None,
                   action="append", help="display-pixel start coordinates "
                   "(repeatable like --start-ij)")
    p.add_argument("--batch", action="store_true",
                   help="treat files as INDEPENDENT videos tracked concurrently "
                        "on the device (track_batch) instead of consecutive "
                        "segments of one recording")
    p.add_argument("--mesh", default="none", choices=["none", "auto"],
                   help="with --batch: 'auto' shards the batch across all "
                        "local cards (a device mesh); 'none' runs "
                        "single-device")
    p.add_argument("--n-targets", type=int, default=None,
                   help="auto-detect and track N targets in one video (track_multi)")
    p.add_argument("--diagnostic-file", default=None, help="write a 640x360 overlay video here")
    p.add_argument("--sar", type=float, default=None, help="override sample aspect ratio")
    p.add_argument("--backend", default="auto", choices=["auto", "native", "opencv"])
    p.add_argument("--engine", default="auto", choices=["auto", "pallas", "xla"])
    p.add_argument("--stream", default="auto", choices=["auto", "roi", "full"])
    p.add_argument("--pipeline-depth", type=lambda s: s if s == "auto" else int(s),
                   default="auto",
                   help="chunks the host runs ahead of the device (0 = synchronous; "
                        "'auto' adapts from the measured drain latency)")
    p.add_argument("--speculate", default="predict", choices=["predict", "contain"],
                   help="ROI crop aiming strategy")
    p.add_argument("--roi-frames", type=int, default=None, help="frames per ROI mini-chunk")
    p.add_argument("--subpixel", action="store_true",
                   help="parabolic peak refinement (float positions)")
    p.add_argument("--decode-workers", type=int, default=None,
                   help="cooperating native decoders per video (bit-identical; "
                        "default: the PAWSIO_DECODE_WORKERS env var)")
    p.add_argument("--fast-decode", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="skip the h264 in-loop deblocking filter in the native "
                        "decoder (~10-30%% faster on decode-bound hosts; pixels "
                        "not bit-exact vs a spec decode, tracks stay inside the "
                        "<1 px oracle). --no-fast-decode forces a spec decode "
                        "over the PAWSIO_FAST_DECODE env var; default: the env "
                        "var rules")
    p.add_argument("--input-fps", type=float, default=None,
                   help="native rate of .npy/.npz frame-stack inputs (default: "
                        "already at --fps)")
    p.add_argument("--checkpoint", default=None, help="checkpoint path for resumable tracking")
    p.add_argument("--progress", action="store_true",
                   help="print tracking progress to stderr")
    p.add_argument("--out", default=None, help="write results to this .npz instead of CSV stdout")
    p.add_argument("--format", default="csv", choices=["csv", "json"], help="stdout format")
    p.add_argument("--device", default=None,
                   help="where to track: the CUDA card by default (fails without "
                        "one); 'cpu' runs the plain PyTorch version on the host")
    return p


def _load_input(path: str):
    """A CLI input: a video path, or a ``.npy``/``.npz`` frame stack loaded as
    an in-memory uint8 array (``.npz``: the ``frames`` key, else its sole
    array)."""
    low = path.lower()
    if not (low.endswith(".npy") or low.endswith(".npz")):
        return path
    import numpy as np

    if low.endswith(".npy"):
        # memory-mapped: frames materialize one at a time in the source, so
        # huge stacks track with bounded memory
        return np.load(path, mmap_mode="r")
    data = np.load(path)
    keys = list(data.files)
    if "frames" in keys:
        return data["frames"]
    if len(keys) != 1:
        raise ValueError(
            f"{path}: .npz frame input needs a 'frames' array or exactly one "
            f"array, found {keys}"
        )
    return data[keys[0]]


def main(argv=None) -> int:
    """CLI entry point; returns a process exit code."""
    args = build_parser().parse_args(argv)
    from . import IJ, track, track_resumable

    if args.start_ij and args.start_xy:
        print("error: give at most one of --start-ij / --start-xy", file=sys.stderr)
        return 2
    locs = [IJ(*p) for p in (args.start_ij or [])] or [tuple(p) for p in (args.start_xy or [])]
    loc = locs[0] if len(locs) == 1 else None
    multi = args.n_targets is not None or len(locs) > 1
    if multi and (args.batch or args.checkpoint):
        print("error: multi-target mode is incompatible with --batch/--checkpoint",
              file=sys.stderr)
        return 2
    if args.batch and args.checkpoint:
        print("error: --batch is incompatible with --checkpoint", file=sys.stderr)
        return 2

    kwargs = dict(
        start=args.start,
        stop=args.stop,
        fps=args.fps,
        target_width=args.target_width,
        window_size=args.window_size,
        darker_target=not args.lighter_target,
        start_location=loc,
        diagnostic_file=args.diagnostic_file,
        sar=args.sar,
        backend=args.backend,
        engine=args.engine,
        stream=args.stream,
        pipeline_depth=args.pipeline_depth,
        speculate=args.speculate,
        roi_frames=args.roi_frames,
        subpixel=args.subpixel,
        decode_workers=args.decode_workers,
        fast_decode=args.fast_decode,
        input_fps=args.input_fps,
        device=args.device,
    )
    if args.mesh == "auto" and not args.batch:
        print("error: --mesh auto requires --batch (the mesh shards the "
              "video-batch axis)", file=sys.stderr)
        return 2
    try:
        inputs = [_load_input(f) for f in args.files]
    except (IOError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.progress:
        def _progress(done, total):
            print(f"\r{done}/{total} frames", end="", file=sys.stderr, flush=True)

        kwargs["progress"] = _progress
    cast = float if args.subpixel else int
    try:
        if args.checkpoint:
            if len(args.files) != 1:
                print("error: --checkpoint supports a single file", file=sys.stderr)
                return 2
            if args.diagnostic_file:
                print("error: --diagnostic-file is not supported with "
                      "--checkpoint (slices reopen the encoder mid-video)",
                      file=sys.stderr)
                return 2
            cp_kwargs = dict(kwargs)  # forward EVERY tracking flag
            cp_kwargs.pop("diagnostic_file")  # not supported by slices
            cp_kwargs["start"] = args.start or 0.0
            ts, ij = track_resumable(
                inputs[0], checkpoint_path=args.checkpoint, **cp_kwargs
            )
        elif args.batch:
            from .batch import track_batch

            b_kwargs = {k: v for k, v in kwargs.items()
                        if k not in ("speculate", "diagnostic_file")}
            if args.diagnostic_file:
                print("error: --batch needs per-file overlays; use the library's "
                      "diagnostic_files", file=sys.stderr)
                return 2
            if args.speculate != "predict":
                print("error: --speculate contain is not supported with --batch "
                      "(the batch pipeline always runs predict mode)",
                      file=sys.stderr)
                return 2
            if args.mesh == "auto":
                b_kwargs["mesh"] = "auto"
            results = track_batch(inputs, **b_kwargs)
            return _emit_batch(args, results)
        elif multi:
            from .multi import track_multi

            m_kwargs = {k: v for k, v in kwargs.items()
                        if k not in ("speculate", "start_location")}
            if args.speculate != "predict":
                print("error: --speculate contain is not supported in multi-target "
                      "mode (the multi pipeline always runs predict mode)",
                      file=sys.stderr)
                return 2
            m_kwargs["start"] = args.start or 0.0
            if m_kwargs["stop"] is None:
                m_kwargs.pop("stop")
            if len(args.files) != 1:
                print("error: multi-target mode supports a single file", file=sys.stderr)
                return 2
            ts, ij = track_multi(
                inputs[0],
                start_locations=locs if locs else None,
                n_targets=args.n_targets,
                **m_kwargs,
            )
            return _emit_multi(args, ts, ij)
        else:
            target = inputs if len(inputs) > 1 else inputs[0]
            ts, ij = track(target, **kwargs)
    except (IOError, EOFError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.progress:
        print(file=sys.stderr)  # newline after the \r progress line

    if args.out:
        import numpy as np

        np.savez(args.out, ts=ts, ij=ij)
        print(f"wrote {len(ij)} positions to {args.out}", file=sys.stderr)
    elif args.format == "json":
        print(json.dumps({"ts": [float(t) for t in ts], "ij": [[cast(a), cast(b)] for a, b in ij]}))
    else:
        print("t,row,col")
        for t, (i, j) in zip(ts, ij):
            print(f"{t:.6f},{i},{j}")
    return 0


def _emit_batch(args, results) -> int:
    """Emit track_batch results: CSV gains a leading file column; JSON is a
    per-file list; --out saves ts_<k>/ij_<k> arrays."""
    cast = float if args.subpixel else int
    if args.out:
        import numpy as np

        np.savez(args.out, **{f"ts_{k}": ts for k, (ts, _) in enumerate(results)},
                 **{f"ij_{k}": ij for k, (_, ij) in enumerate(results)})
        print(f"wrote {len(results)} videos to {args.out}", file=sys.stderr)
    elif args.format == "json":
        print(json.dumps([
            {"file": f, "ts": [float(t) for t in ts],
             "ij": [[cast(a), cast(b)] for a, b in ij]}
            for f, (ts, ij) in zip(args.files, results)
        ]))
    else:
        print("file,t,row,col")
        for f, (ts, ij) in zip(args.files, results):
            for t, (i, j) in zip(ts, ij):
                print(f"{f},{t:.6f},{i},{j}")
    return 0


def _emit_multi(args, ts, ij) -> int:
    """Emit track_multi results (``ij [T, N, 2]``): long-format CSV
    ``t,target,row,col``; JSON carries the [T, N, 2] list; --out saves ts/ij."""
    cast = float if args.subpixel else int
    if args.out:
        import numpy as np

        np.savez(args.out, ts=ts, ij=ij)
        print(f"wrote {len(ij)} frames x {ij.shape[1]} targets to {args.out}",
              file=sys.stderr)
    elif args.format == "json":
        print(json.dumps({
            "ts": [float(t) for t in ts],
            "ij": [[[cast(a), cast(b)] for a, b in row] for row in ij],
        }))
    else:
        print("t,target,row,col")
        for t, row in zip(ts, ij):
            for n, (i, j) in enumerate(row):
                print(f"{t:.6f},{n},{i},{j}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
