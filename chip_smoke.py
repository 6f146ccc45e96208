#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels (``dog_scan`` and ``dog_scan_tiled``, one
source; ``detect_response`` and ``detect_rounds``, another) and its native crop
(``roi_crop.cpp``), all at once, from ``pawsometracker_tpu_torch/csrc`` and
runs three phases on the card, with the engine choice between the first two;
any failure exits non-zero:

1. Each kernel against its plain PyTorch version on the same card tensors, at
   the bench shape (1080p frames, ``target_width=25``, 41x41 window, T=64).
   One chain: unbounded; bounded with random deltas/lo/hi from a fixed seed;
   bounded with subpixel offsets; a clamp box far from the position with
   deltas up to the window radius; the quarter-frame autodetect snap (the
   tiled kernel); the subpixel snap; a frame 1918 wide (not a multiple of 16,
   T=16, subpixel); and two exact-tie geometries, a flat field and a
   mirror-symmetric blob. B = 4 lanes with fills 128/100/160/128 in one
   launch: unbounded; bounded and bounded+subpixel (T=16); a lane starting
   off the frame (T=16); four targets reading one frame stream (lane stride
   0); the quarter-frame snap and the subpixel snap; and one lane equal to
   the unbatched call. ``dog_scan_tiled`` in chains at the default windows
   of ``target_width`` 40, 60 (T=12) and 100 (T=4): one chain unbounded,
   bounded and bounded+subpixel, 4 lanes with their own frames, 4 targets on
   shared frames, a lane starting off the frame, and (at 60) a flat field,
   whose ties span tiles of different CTAs, and 8 lanes on one stream from
   each edge and corner of the frame (T=6, ± subpixel). The ROI pipeline's
   chunk scans:
   bounded and bounded+subpixel at T=12 on the crops it cuts at 1080p, 185x185
   (``dog_scan``) and 461x461 at ``target_width=60`` (``dog_scan_tiled``),
   with the per-frame boxes and rebases it builds; and the batch and multi ROI
   engines' batched bounded chunk scans (T=12) at both crop sizes: B = 4
   videos' crops with lane 2 pure fill (a video past its end), bounded and
   bounded+subpixel, and the crops of 4 targets cut from one frame stream;
   and the 461x461 chunk from 8 starts on each edge and corner of the crop
   (± subpixel).
   The mesh: ``sharded_pallas_bounded`` (one batched bounded launch a data
   shard) on those batch ROI chunks at both crop sizes, against its plain
   version (``interpret=True``), with one launch a shard, on each mesh of the
   machine: ``make_mesh()`` (every card), 2 and 4 shards on cuda:0, and 2
   cards where there are two or more; and the space-sharded whole-frame
   detector (2 data x 2 space on cuda:0, and 1 x 2 over two cards) against
   the unsharded one at 1080p, B = 4, and the unsharded one (the response
   kernel on the uint8 frames) against the plain response and argmax on the
   same card tensors. The whole-frame detection kernels (``csrc/detect.cu``)
   at the plate cell's shape, on a frame of 96 discs at 1080p: the response
   kernel bit-equal to its plain version on the same card tensors at L = 33
   (``target_width`` 12, the plate's), 65 and 149; the rounds kernel's 96
   peaks (``min_distance`` 25) equal to the plain rounds' on the same
   response; and the whole detection on the card equal to the CPU's. Segments
   (S chunk scans a lane in one launch of either kernel, chained as the JAX
   package's super-programs chain them; no pipeline launches S > 1), S = 2
   and 4, each one launch against its plain version: one chain at both ROI
   crop sizes by the ks rule (a short chunk), 4 lanes with the carry in the launch (a lane with no real frame and a
   short one in chunk 1; positions and carry), and 1080p 64-frame chunks from
   the last step; and 3 segments of 12 1080p frames at ``target_width=60``'s
   window from the last step (± subpixel), each segment's first patch read
   where the one before left the chain.
   Every case runs on each kernel that takes its window (the shape rule's
   first; ``dog_scan`` runs windows up to ``target_width`` 63 at the default
   window, so the large target's and the 461x461 crop's too, though the shape
   rule gives it only those that fit one CTA whole, up to 35), and
   ``dog_scan`` also under each forced cluster size (``SCAN_CLUSTERS`` where
   it fits, and the largest the card schedules), each against the one plain
   run of the case. Integer positions must be equal, offsets within
   ``atol=1e-3``.
E. The engine choice (``engine="auto"`` on the ROI paths), with the engine
   cache in a fresh directory: ``pick_bounded_engine`` and
   ``pick_bounded_engine_batch`` for every geometry whose bounded scans the
   main paths launch (the 185x185 and 461x461 crops, one chain and 4 lanes,
   with and without subpixel; 1 and 2 lanes, the mesh paths' shards and the
   CLI's ``--batch``) and for the 1080p ROI crops of ``target_width`` 30, 35
   and 38 (windows 53, 61 and 69), each decision printed:
   every candidate kernel must give the plain version's positions on the
   probe's blob and both tie frames, and the probe's launches and plain runs
   stay out of the counts. A second call must hit the session cache and a
   fresh process must read every decision from the file without measuring.
   Then both kernels timed at every shape where both fit (the 185x185 chunk
   scans, one chain and 4 lanes, one segment and 2; the sweep's crops, one
   chain and 4 lanes), each with its bound from ``cost()`` and the pick.
2. The main paths, each driven with the launch counts set to 0 just before
   it and read just after (the ROI paths with ``engine="auto"``, the
   default: every bounded launch must be the kernel the engine choice chose
   for the crop, and the positions must equal the same call under
   ``engine="pallas"``, the shape rule's kernel):
   - ``track()`` on a synthetic 1080p, 480-frame clip (a dark disc of radius
     12 on 128-gray moving on a circle), with the start location given,
     auto-detected, and with ``subpixel=True``: 1 + ceil(479/64) = 9
     launches each;
   - ``track_batch`` on four 1080p clips of 160, 160, 120 and 160 frames, each
     a disc on its own background on the circle at phase b*pi/2: start
     locations given, lane 2 auto-detected, and ``subpixel=True``;
   - ``track_multi`` on one 1080p clip of 160 frames with four discs: start
     locations given, ``n_targets=4``, and ``subpixel=True``; the
     autodetecting call (``n_targets=4``, here and on ROI) must launch the
     detection kernels twice (``detect_kernel.launches``, set to 0 before the
     path) and report the two as ``detect.kernel_launches``, every other call
     none;
   - ``track()`` of a large target: ``target_width=60`` with its default
     window (105x105, L = 149), a disc of radius 30 on the same circle, 480
     frames, the same three ways; every launch at the window must be the
     shape rule's kernel (``dog_scan``), the autodetect snap
     ``dog_scan_tiled``, and the ``device="cpu"`` cross-check runs the first
     33 frames.
   These four stream full frames (``stream="full"``), each chunk staged by
   its prefetcher into a pinned ring by one native copy (the clips are
   arrays served as views): the copies must number the chunks. Then each entry point
   through ``stream="auto"``, which takes the speculative ROI pipeline at
   1080p (as the JAX package does when the crops are under half the frame):
   ``track()`` on the bench clip ("track ROI") and the large target ("track
   large target ROI"), ``track_batch`` on its four clips ("track_batch ROI",
   one lane a video) and ``track_multi`` on its clip ("track_multi ROI", one
   lane a target), the same three ways each. Each ROI call must report
   ``stream="roi"``, launch its snaps (two where a batch lane autodetects)
   plus the pipeline's dispatches, every chunk a bounded launch (probe and
   replays included), cut its crops with the native crop, and equal the same
   call on ``stream="full"``.
   Each call must launch the kernel as often as its chunking says and never
   run the plain version, land within RMSE < 1 px of the drawn truth per
   video or target, equal the port's single-video ``track()`` of each video
   or target on the card, and equal the port's own ``device="cpu"`` run
   (the first call of each batch and multi path; for ``track()`` every
   call, on the first 129 frames of the clip, 33 for the large target).
   Then ``track_resumable`` of the bench clip ("track_resumable ROI",
   ``stream="auto"``, 120-frame slices, so 4): interrupted after 2 slices
   and resumed, uninterrupted, and with ``subpixel=True``; each must equal
   "track ROI"'s uninterrupted ``track()`` (offsets within ``atol=1e-3``,
   ``ts`` exactly), leave a done checkpoint, and launch per slice its snap
   plus one bounded launch a dispatch. Then the same call from frame 37 (an
   on-grid start past 0): every slice served as views from its first frame,
   equal to the same call forced down the resampler's walk from frame 0
   (``ArrayFrameSource.views_allowed``, a test hook), both timed. And the CLI ("CLI"): the first 96
   frames of the bench clip and of two ``track_batch`` clips as ``.npy``
   files, ``python -m pawsometracker_tpu_torch --format json`` with no
   ``--device`` (so on the card) in fresh processes, single-file, ``--batch``
   on the two files and ``--checkpoint``, each equal to the in-process
   ``track``, ``track_batch`` and ``track_resumable``; one more fresh process
   runs the single-file command through the CLI's ``main`` with its parts
   timed and its launches counted (the path's counts), and must find the
   kernel library in the build cache.
   Then the mesh ("track_batch mesh=<mesh>", "track_batch ROI mesh=<mesh>"):
   ``track_batch`` over each mesh of phase 1, on full frames and on ROI, the
   same three ways as track_batch, each equal to its ``mesh=None`` run above
   and launching once a data shard for each of that run's launches (the
   snap(s), then each chunk or dispatch), with no plain run.
3. Timing with CUDA events: each kernel per launch at T=64 (one chain:
   unbounded, bounded, bounded+subpixel, the snap; lanes: B = 1, 4 and 16,
   and four targets on shared frames; bounded and bounded+subpixel lanes at
   T=16) and at T=1 (the fixed cost of a launch); the tiled kernel's snap for
   B = 4; the T=64 chunk scans at the default windows of ``target_width``
   40, 60 and 100 (B = 1 and 4, unbounded and bounded+subpixel) on each
   kernel that takes them; ``dog_scan`` under each forced cluster size at
   the bench chunk and the 185x185 crop's chunk scans; the plain
   version on the same inputs, each bound and the share of the whole card's,
   one SM's and the cluster's SMs' bound the kernel reaches, and
   ``dog_scan``'s time in PR 10 (``PR10_MS``) and ``dog_scan_tiled``'s in
   PR 11 (``PR11_MS``) in the log beside its row; one
   cuDNN ``conv2d`` with the 2-D DoG kernel plus ``argmax`` as the snap's
   library yardstick; end-to-end frames/s of the four paths; and a
   ``torch.profiler`` busy share of one ``track()``, one ``track_batch`` and
   one large-target ``track()``; and for the ROI paths the chunk scans at
   their crops (T=12), the wrapper's host microseconds a launch (launches
   queued behind a sleep of the card), and per e2e run the pipeline's timer
   sections (crop, upload, device, drain), the depth it settled at and its
   replays, and a ``torch.profiler`` busy share; the same for the batch and
   multi ROI paths beside their ``stream="full"`` figures; a cuDNN
   ``conv2d`` + ``argmax`` yardstick for the snaps at the bench window;
   ``track_resumable`` ROI frames/s over the 4-slice call beside "track ROI",
   with its per-slice set-up and snap; the detection kernels a launch at the
   plate cell's shape (1080p, L = 33, N = 96; the rounds also at N = 1, 24
   and 400) beside their plain versions and their bounds, and one whole
   detection (frame on the card to peaks on the host) by the host clock,
   kernels against the plain torch ops; a full-frame chunk's staging copy
   into pinned memory, native (the kept route) and numpy's (the route before
   it), beside its host-to-device copy and its kernel; and the CLI's wall time a process,
   split into process start, imports, CUDA initialisation, the kernel
   library's load (a build-cache hit or not) and tracking; and the mesh:
   ``sharded_pallas_bounded`` a call on each mesh (card time by CUDA events
   where every shard is on cuda:0, wall time a call, the host's time) beside
   the unsharded launch, and e2e frames/s of each mesh path beside
   ``mesh=None`` in the same call, with a profile of each mesh's ROI call;
   and each segmented launch of phase 1 at S = 1, 2 and 4 beside S times its
   S = 1 launch (the plain version at S = 2, the wrapper's host time a
   launch); and the ROI path's host work by cell
   (track ROI, the large target's, track_batch ROI, track_multi ROI): the
   set-up a call and outside the sections, crop, device and upload a chunk
   from the e2e runs, the chunk's crops alone natively (equal to numpy on
   every chunk) and in numpy, and a chunk launch's host microseconds through
   the scan the engines stage once over a device slot and through the public
   wrapper (equal outputs); with ``--parent DIR``, the same cells against
   that checkout in turns (``tools/host_path_ab.py``).

Prints the card's name and power limit, the build time and ``ptxas``'s
registers, the kernels' configurations with their launch counts, one JSON
line of per-kernel numbers, and, last, ``{"ok": true, "device": {...}}``. The
full record goes to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 1080, 1920
FPS = 24
N_FRAMES = 480
TARGET_WIDTH = 25
WINDOW = 41
CHUNK = 64
DISC_R = 12
SEED = 0
OFFSET_ATOL = 1e-3
#: the large-target path: track() at target_width=60 with its default window
#: (105x105, L = 149, dog_scan_tiled on every launch), a disc of radius 30
LARGE_TW = 60
LARGE_DISC_R = 30
#: frames of the large-target clip that the device="cpu" cross-check runs
#: (the plain version takes ~0.3 s a step on the host at this window)
CPU_CHECK_FRAMES = 33
#: dog_scan_tiled's phase-1 chains: the default windows of these target
#: widths at 1080p, and the steps of each (the plain version costs more a step
#: as the window and L grow)
TILED_STEPS = {40: 12, 60: 12, 100: 4}
#: the track_batch clips: one background (= fill) and length per video
BATCH_FILLS = (128, 100, 160, 128)
BATCH_LENS = (160, 160, 120, 160)
MULTI_FRAMES = 160
MULTI_CHUNK = 16  # track_multi's default chunk_size
#: steps of the batched bounded phase-1 cases (the plain version takes ~30 ms a step)
BOUNDED_T = 16
#: ROI chunk length of stream="auto" in predict mode (the pipeline's default K)
ROI_K = 12
#: track_resumable's slices: 5 s at 24 fps, 120 frames, so 4 over the clip
CHECKPOINT_EVERY = 5.0
#: the on-grid frame past 0 that phase 2's track_resumable check starts from
RESUME_K0 = 37
#: frames of each clip that the CLI phase writes as .npy and tracks
CLI_FRAMES = 96
#: the target widths of the engine choice's sweep at 1080p ROI: default windows 53, 61 and 69,
#: where both kernels run (dog_scan runs windows up to target_width 63; the shape rule's
#: first is dog_scan at 30 and 35, dog_scan_tiled at 38)
SWEEP_TW = (30, 35, 38)
#: dog_scan's cluster sizes phase 1 forces at every window where they fit, beside the card's
#: own pick and the largest the card schedules: the whole window on one CTA, two CTAs, and
#: one 7-row block a CTA at the bench window (41 = 6 * 7 - 1)
SCAN_CLUSTERS = (1, 2, 6)
#: dog_scan's ms a launch in PR 10's last chip_smoke.py run (H100 80GB HBM3, 700 W), before
#: its redesign as a cluster, by phase-3 timing name: printed in the log beside this run's
#: (never in the kernels line, which holds only what this run measured)
PR10_MS = {
    "unbounded": 0.5104, "bounded": 0.5125, "bounded+subpixel": 0.5211,
    "batched unbounded B=1": 0.5103, "batched unbounded B=4": 0.5105,
    "batched unbounded B=16": 0.5115, "batched shared frames (4 targets)": 0.5105,
    "batched bounded B=4 (T=16)": 0.1305, "batched bounded+subpixel B=4 (T=16)": 0.1326,
    "unbounded T=1": 0.0104, "bounded+subpixel T=1": 0.0108, "batched unbounded B=4 T=1": 0.0104,
    "ROI 185x185 T=12 bounded": 0.1061, "ROI 185x185 T=12 bounded+subpixel": 0.1080,
    "ROI batch 185x185 B=4 T=12 bounded (lane 2 fill)": 0.1130,
    "ROI batch 185x185 B=4 T=12 bounded+subpixel (lane 2 fill)": 0.1130,
    "ROI multi 185x185 4 targets of one stream T=12 bounded": 0.1063,
    "segments ROI 185x185 one chain T=12 S=1": 0.1110,
    "segments ROI 185x185 one chain T=12 S=2": 0.2194,
    "segments ROI 185x185 one chain T=12 S=4": 0.4357,
    "segments ROI 185x185 B=4 carry T=12 S=1": 0.1112,
    "segments ROI 185x185 B=4 carry T=12 S=2": 0.2255,
    "segments ROI 185x185 B=4 carry T=12 S=4": 0.4424,
    "segments full 1080p T=64 S=1": 0.5103, "segments full 1080p T=64 S=2": 1.0588,
    "segments full 1080p T=64 S=4": 2.1149,
    "ROI tw=30 233x233 T=12 bounded": 0.1942, "ROI tw=35 269x269 T=12 bounded": 0.2720,
    "ROI tw=38 297x297 T=12 bounded": 0.3285,
    "ROI batch tw=30 233x233 B=4 T=12 bounded": 0.1944,
    "ROI batch tw=35 269x269 B=4 T=12 bounded": 0.2720,
    "ROI batch tw=38 297x297 B=4 T=12 bounded": 0.3286,
}
#: dog_scan_tiled's ms a launch in PR 11's last chip_smoke.py run (H100 80GB HBM3, 700 W), before
#: its step was redesigned, by phase-3 and engine-choice timing name: printed in the log beside
#: this run's (never in the kernels line, which holds only what this run measured)
PR11_MS = {
    "snap quarter-frame": 0.0344, "batched snap quarter-frame B=4": 0.0348,
    "tw=40 T=64 unbounded B=1 [dog_scan_tiled]": 0.5244,
    "tw=40 T=64 bounded+subpixel B=1 [dog_scan_tiled]": 0.5492,
    "tw=40 T=64 unbounded B=4 [dog_scan_tiled]": 0.5244,
    "tw=40 T=64 bounded+subpixel B=4 [dog_scan_tiled]": 0.5497,
    "tw=60 T=64 unbounded B=1 [dog_scan_tiled]": 0.7333,
    "tw=60 T=64 bounded+subpixel B=1 [dog_scan_tiled]": 0.7618,
    "tw=60 T=64 unbounded B=4 [dog_scan_tiled]": 0.7334,
    "tw=60 T=64 bounded+subpixel B=4 [dog_scan_tiled]": 0.7611,
    "tw=100 T=64 unbounded B=1 [dog_scan_tiled]": 2.8792,
    "tw=100 T=64 bounded+subpixel B=1 [dog_scan_tiled]": 2.9044,
    "tw=100 T=64 unbounded B=4 [dog_scan_tiled]": 2.8913,
    "tw=100 T=64 bounded+subpixel B=4 [dog_scan_tiled]": 2.9161,
    "ROI 461x461 T=12 bounded": 0.1535, "ROI 461x461 T=12 bounded+subpixel": 0.1552,
    "ROI batch 461x461 B=4 T=12 bounded (lane 2 fill)": 0.1679,
    "ROI batch 461x461 B=4 T=12 bounded+subpixel (lane 2 fill)": 0.1680,
    "ROI multi 461x461 4 targets of one stream T=12 bounded": 0.1535,
    "segments ROI 461x461 one chain T=12 S=1": 0.1560,
    "segments ROI 461x461 one chain T=12 S=2": 0.3078,
    "segments ROI 461x461 one chain T=12 S=4": 0.6110,
    "segments ROI 461x461 B=4 carry T=12 S=1": 0.1560,
    "segments ROI 461x461 B=4 carry T=12 S=2": 0.3201,
    "segments ROI 461x461 B=4 carry T=12 S=4": 0.6253,
    "ROI 185x185 T=12 bounded": 0.0727, "ROI 185x185 T=12 bounded+subpixel": 0.0764,
    "ROI batch 185x185 B=4 T=12 bounded (lane 2 fill)": 0.0767,
    "ROI batch 185x185 B=4 T=12 bounded+subpixel (lane 2 fill)": 0.0769,
    "segments ROI 185x185 one chain T=12 S=2": 0.1496,
    "segments ROI 185x185 B=4 carry T=12 S=2": 0.1529,
    "ROI tw=30 233x233 T=12 bounded": 0.0922, "ROI batch tw=30 233x233 B=4 T=12 bounded": 0.0924,
    "ROI tw=35 269x269 T=12 bounded": 0.1014, "ROI batch tw=35 269x269 B=4 T=12 bounded": 0.1014,
    "ROI tw=38 297x297 T=12 bounded": 0.1041, "ROI batch tw=38 297x297 B=4 T=12 bounded": 0.1042,
}
#: steps of phase 1's dog_scan_tiled cases from starts on each edge and corner of the frame
EDGE_STEPS = 6


def pr11(name) -> str:
    """dog_scan_tiled's PR 11 time of a timing name, for the log."""
    return f"PR 11 {PR11_MS[name]:.4f} ms" if name in PR11_MS else "PR 11 not measured"


#: H100 SXM published peaks: f32 outside the tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
N_SMS = 132
#: the plate cell's detection: target_width 12 (L = 33) at 1080p, 96 peaks, min_distance 25
#: (its window's edge), on a frame of 96 discs at a 96-well plate's pitch (12.635 px/mm)
PLATE_TW = 12
PLATE_WINDOW = 25
PLATE_N = 96
PLATE_PITCH = 9.0 * 12.635


def log(*a):
    print(*a, flush=True)


def circle_path(n, phase=0.0):
    """Integer centres on a circle of radius 200 px about the frame centre,
    one revolution per N_FRAMES frames, starting at angle ``phase``."""
    ang = 2 * np.pi * np.arange(n) / N_FRAMES + phase
    return np.stack([np.round(540 + 200 * np.sin(ang)), np.round(960 + 200 * np.cos(ang))],
                    axis=1).astype(np.int64)


def draw_discs(frames, paths, radius=DISC_R):
    """Dark discs (gray 30) at each path's centre per frame."""
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disc = yy**2 + xx**2 <= radius**2
    for path in paths:
        for k, (i, j) in enumerate(path[:len(frames)]):
            frames[k, i - radius:i + radius + 1, j - radius:j + radius + 1][disc] = 30
    return frames


def synth_clip():
    """track()'s clip: one disc starting inside the autodetect window."""
    truth = circle_path(N_FRAMES)
    return draw_discs(np.full((N_FRAMES, H, W), 128, np.uint8), [truth]), truth


def synth_large():
    """The large-target clip: track()'s circle with a disc of radius 30."""
    truth = circle_path(N_FRAMES)
    return draw_discs(np.full((N_FRAMES, H, W), 128, np.uint8), [truth], LARGE_DISC_R), truth


def device_clips(n, lanes, radius, dev):
    """``lanes`` clips of n 1080p frames made on the card (so the host does
    not copy them): a disc of ``radius`` on 128-gray on the circle at phase
    b*pi/2 in lane b; and the paths."""
    import torch

    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    frames = torch.full((lanes, n, H, W), 128, dtype=torch.uint8, device=dev)
    paths = [circle_path(n, b * np.pi / 2) for b in range(lanes)]
    for b, path in enumerate(paths):
        for t, (i, j) in enumerate(path):
            frames[b, t][(yy - int(i)) ** 2 + (xx - int(j)) ** 2 <= radius ** 2] = 30
    return frames, paths


def synth_batch():
    """track_batch's clips: video b has its own background and length, and
    its disc on the circle at phase b*pi/2."""
    clips, truths = [], []
    for b, (bg, n) in enumerate(zip(BATCH_FILLS, BATCH_LENS)):
        truth = circle_path(n, b * np.pi / 2)
        clips.append(draw_discs(np.full((n, H, W), bg, np.uint8), [truth]))
        truths.append(truth)
    return clips, truths


def synth_multi():
    """track_multi's clip: four discs on the circle, a quarter turn apart."""
    truths = [circle_path(MULTI_FRAMES, b * np.pi / 2) for b in range(4)]
    return draw_discs(np.full((MULTI_FRAMES, H, W), 128, np.uint8), truths), truths


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def mesh_list(make_mesh, lanes) -> dict:
    """The meshes the mesh part drives, by label: every card (``make_mesh()``,
    or the most cards whose count divides ``lanes``), 2 and 4 data shards on
    cuda:0, and 2 cards where the machine has them."""
    import torch

    n = torch.cuda.device_count()
    k = n
    while lanes % k:
        k -= 1
    meshes = {("make_mesh()" if k == n else f"make_mesh({k})"): make_mesh(k)}
    meshes["cuda:0 x2"] = make_mesh(devices=["cuda:0"] * 2)
    meshes["cuda:0 x4"] = make_mesh(devices=["cuda:0"] * 4)
    if n >= 2 and k != 2:
        meshes["2 cards"] = make_mesh(2)
    return meshes


def space_meshes(make_mesh) -> dict:
    """The meshes of the space-sharded detector: 2 data x 2 space on cuda:0,
    and 1 x 2 over two cards where the machine has them."""
    import torch

    meshes = {"cuda:0 x4, space 2": make_mesh(devices=["cuda:0"] * 4, space=2)}
    if torch.cuda.device_count() >= 2:
        meshes["2 cards, space 2"] = make_mesh(2, space=2)
    return meshes


def cost(radii, L, T, subpixel=False, bounded=False, lanes=1):
    """FLOPs of the direct taps and bytes the scan must move (each patch read
    once, each output written once) for ``lanes`` chains of T steps, and the
    least time at the card's peaks. The subpixel offsets read the response's
    neighbours, which the taps have already computed, so they add no FLOPs
    here. Also the least time of one chain on one SM (1/132 of the f32 peak),
    which is what bounds a chain: its steps run in order on one CTA."""
    wh, ww = 2 * radii[0] + 1, 2 * radii[1] + 1
    ph, pw = wh + L - 1, ww + L - 1
    flops = T * (2 * 2 * wh * pw * L + 2 * 2 * wh * ww * L)
    nbytes = T * ph * pw + T * 8 + (T * 8 if subpixel else 0) + (T * 24 if bounded else 0) + 9
    t_ops, t_bytes = lanes * flops / PEAK_F32_FLOPS, lanes * nbytes / PEAK_BYTES_PER_S
    return {"flops": lanes * flops, "bytes": lanes * nbytes + 8 * L,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "sm_bound_ms": 1e3 * flops / (PEAK_F32_FLOPS / N_SMS)}


def plate_frame(seed: int = 1) -> np.ndarray:
    """96 dark discs of radius 6 on 128-gray with noise, one a well of a 96-well plate
    centred in the 1080p frame, each a little off its well's centre."""
    rng = np.random.default_rng(seed)
    fr = 128 + np.round(rng.normal(0, 2, (H, W)))
    yy, xx = np.mgrid[0:H, 0:W]
    for r in range(8):
        for c in range(12):
            ci = H / 2 + (r - 3.5) * PLATE_PITCH + rng.uniform(-20, 20)
            cj = W / 2 + (c - 5.5) * PLATE_PITCH + rng.uniform(-20, 20)
            fr[(yy - ci) ** 2 + (xx - cj) ** 2 <= 36] = 30
    return np.clip(fr, 0, 255).astype(np.uint8)


def detect_response_cost(h, w, L):
    """FLOPs and bytes of one ``detect_response`` launch on a uint8 frame: two passes of L
    taps (a multiply and an add each) for the centre and the surround, the vertical one over
    the padded frame's W + L - 1 columns; the frame read once, the response and each 32-row
    tile's column maxima (value, row) written once; and the least time at the card's peaks."""
    flops = 2 * 2 * (h * (w + L - 1) + h * w) * L
    nbytes = h * w + 4 * h * w + 8 * -(-h // 32) * w + 8 * L
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def detect_rounds_cost(h, w, n, r2, D):
    """Bytes that one ``detect_rounds`` launch of ``n`` rounds moves, a round's disc wholly
    inside the frame: the partials read once (each 32-row tile's column maxima); then each
    round reads the 2D+1 columns of the tiles its disc's rows touch (at most
    ceil((2D+1)/32) + 1), writes -inf over the disc's cells and those tiles' partials of
    its columns, reads the columns' P partials back, and writes its peak. The least time at
    the card's bandwidth; the kernel is one CTA walking n dependent rounds, so latency, not
    bytes, bounds it."""
    P = -(-h // 32)
    nb, nt = min(w, 2 * D + 1), min(P, -(-(2 * D + 1) // 32) + 1)
    d = np.arange(-D, D + 1, dtype=np.int64)
    disc = int((np.float32(d[:, None] ** 2 + d[None, :] ** 2) <= np.float32(r2)).sum())
    per_round = 4 * nt * 32 * nb + 4 * disc + 8 * nt * nb + 8 * P * nb + 8
    nbytes = 8 * P * w + n * per_round
    return {"flops": 0, "bytes": nbytes, "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "bound_by": "bytes (latency: one CTA, n dependent rounds)"}


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Card time per call of ``fn``: CUDA events around ``reps`` calls queued
    behind a sleep of the card (~0.2 ms a call), so that the card runs them
    back to back and the host's cost per launch does not enter."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000 * reps)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def rmse(ij, truth) -> float:
    d = np.asarray(ij, np.float64) - np.asarray(truth[:len(ij)], np.float64)
    return float(np.sqrt(np.mean(np.sum(d ** 2, axis=-1))))


def same(a, b, subpixel) -> bool:
    if a.shape != b.shape:
        return False
    if subpixel:
        return bool(np.allclose(a, b, rtol=0, atol=OFFSET_ATOL))
    return bool(np.array_equal(a, b))


def profile_busy(fn):
    """Wall time of one call and the card's busy time in it, by event name
    (device-side events only: host ops repeat their time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev[e.key] = float(e.self_device_time_total)
    busy = sum(dev.values())
    return {"wall_us": wall_us, "device_us_by_name": dev,
            "device_busy_share": (busy / wall_us) if dev else None}


class StatsLog(logging.Handler):
    """Keeps the stats of the last ``track()``: the port logs them at debug
    level as ``paws_stats`` (the stream, and on ROI the crop, K, dispatches,
    replays, the depth it ended at and the timer sections)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.last = None
        self.all: list = []  # every call's, until cleared

    def emit(self, record):
        stats = getattr(record, "paws_stats", None)
        if stats is not None:
            self.last = stats
            self.all.append(stats)


def count_plain_runs(*modules) -> dict:
    """Wrap the plain versions in ``modules`` (the chunk scans, the segmented
    scans, and the batched chain's tensor ops) so that each run adds one to
    the returned count ``"n"``: the main paths must never take them on the
    card. A run inside the engine chooser's probe, where the plain version is
    the oracle, adds one to ``"probe"`` instead."""
    from pawsometracker_tpu_torch.ops import tracker_kernel as tk

    runs = {"n": 0, "probe": 0}

    def counted(fn):
        def wrapper(*a, **k):
            runs["probe" if tk.is_probing() else "n"] += 1
            return fn(*a, **k)
        return wrapper

    for mod in modules:
        for name in ("dog_scan_plain", "dog_scan_batch_plain", "dog_scan_segments_plain",
                     "dog_scan_batch_segments_plain", "chain_batch"):
            if hasattr(mod, name):
                setattr(mod, name, counted(getattr(mod, name)))
    return runs


def cli_probe(args) -> int:
    """The CLI in this fresh process, as ``python -m pawsometracker_tpu_torch``
    runs it, with its parts timed: ``args`` is the parent's ``time.time()``
    at the spawn, then the CLI's arguments. The CLI prints its output on
    stdout; the last line of stderr is one JSON object with the seconds of
    the process start, the imports, CUDA's initialisation, the kernel
    library's load (and whether the build cache had it) and the CLI's
    ``main``, and the launches, plain runs and pipeline stats of that run."""
    start_s = time.time() - float(args[0])
    t0 = time.perf_counter()
    import torch

    from pawsometracker_tpu_torch.__main__ import main
    from pawsometracker_tpu_torch.models import dog_tracker
    from pawsometracker_tpu_torch.ops import _build, tracker_kernel as tk
    t1 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tk._lib()
    t3 = time.perf_counter()
    plain_runs = count_plain_runs(tk, dog_tracker)
    stats_log = StatsLog()
    port_logger = logging.getLogger("pawsometracker_tpu_torch")
    port_logger.addHandler(stats_log)
    port_logger.setLevel(logging.DEBUG)
    tk.reset_launches()
    rc = main(args[1:])
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    print(json.dumps({"process_start_s": start_s, "imports_s": t1 - t0, "cuda_init_s": t2 - t1,
                      "library_load_s": t3 - t2, "cache_hit": "dog_scan" not in _build.build_log,
                      "main_s": t4 - t3, "launches": tk.launches,
                      "by_config": dict(tk.launches_by_config),
                      "by_kernel": dict(tk.launches_by_kernel), "plain_runs": plain_runs["n"],
                      "stats": stats_log.all}, default=str), file=sys.stderr)
    return rc


def engine_probe(args) -> int:
    """In this fresh process, as a user's next run would: the engine chooser's
    decisions for the geometries in ``args[0]`` (JSON: a list of ``[crop,
    window, target_width, batch or null, subpixel]``), read from the engine
    cache under ``$PAWSOMETRACKER_CACHE``. Prints one JSON object: the
    decisions, the kernel launches and the probe's launches and plain runs
    (all 0 when nothing was measured)."""
    from pawsometracker_tpu_torch import pipeline
    from pawsometracker_tpu_torch.models import dog_tracker
    from pawsometracker_tpu_torch.models.dog_tracker import make_spec
    from pawsometracker_tpu_torch.ops import tracker_kernel as tk

    plain_runs = count_plain_runs(tk, dog_tracker)
    tk.reset_launches()
    infos = []
    for crop, window, tw, batch, sub in json.loads(args[0]):
        rspec = make_spec((crop, crop), window, tw, True)
        if batch is None:
            infos.append(pipeline.pick_bounded_engine(rspec, ROI_K, subpixel=sub)[1])
        else:
            infos.append(pipeline.pick_bounded_engine_batch(rspec, ROI_K, batch, subpixel=sub)[1])
    print(json.dumps({"infos": infos, "launches": tk.launches,
                      "probe_launches": dict(tk.probe_launches), "plain_runs": plain_runs}))
    return 0


def roi_chunk(frames, truth, spec, fill, dev, roi_geometry, crop_with_fill):
    """One T=ROI_K chunk as the ROI pipeline builds it at chain start: frame
    t+1 cropped (mode fill outside the frame) around the truth of frame t at
    the predict-mode geometry, with the per-frame rebase ``deltas`` and clamp
    box ``lo``/``hi`` in crop coordinates, and the start in frame 1's crop.
    Returns ``(crops, pos0, bounds)`` on the card."""
    import torch

    ch, cw, margin = roi_geometry(spec, ROI_K, 7, "predict")
    o = np.asarray(truth[:ROI_K], np.int64) - margin
    crops = np.stack([crop_with_fill(frames[1 + i], o[i], ch, cw, fill) for i in range(ROI_K)])
    deltas = np.zeros_like(o)
    deltas[1:] = o[:-1] - o[1:]
    bounds = {"deltas": deltas, "lo": np.maximum(-o, 0),
              "hi": np.minimum([ch - 1, cw - 1], [H - 1, W - 1] - o)}
    bounds = {k: torch.tensor(v, dtype=torch.int32, device=dev) for k, v in bounds.items()}
    pos0 = torch.tensor(np.asarray(truth[0]) - o[0], dtype=torch.int32, device=dev)
    return torch.from_numpy(crops).to(dev), pos0, bounds


def roi_lanes(lane_frames, truths, fills, spec, dev, roi_geometry, crop_with_fill):
    """One T=ROI_K chunk of L lanes as the batch and multi ROI engines build
    it at chain start: lane b's frames t+1 cropped around its truth of frame
    t, the per-frame rebase with ``deltas[:, 0] = 0`` (the chain rebases the
    carry instead), the lane's box, and its start in its frame-1 crop. A lane
    whose frames are None holds pure fill, as a lane past its video's end
    does. Returns ``(crops [L,K,ch,cw], pos0 [L,2], fills [L], bounds)`` on
    the card."""
    import torch

    ch, cw, margin = roi_geometry(spec, ROI_K, 7, "predict")
    crops, pos0, bounds = [], [], {"deltas": [], "lo": [], "hi": []}
    for frames, truth, fill in zip(lane_frames, truths, fills):
        o = np.asarray(truth[:ROI_K], np.int64) - margin
        if frames is None:
            crops.append(np.full((ROI_K, ch, cw), fill, np.uint8))
        else:
            crops.append(np.stack([crop_with_fill(frames[1 + i], o[i], ch, cw, fill)
                                   for i in range(ROI_K)]))
        deltas = np.zeros_like(o)
        deltas[1:] = o[:-1] - o[1:]
        bounds["deltas"].append(deltas)
        bounds["lo"].append(np.maximum(-o, 0))
        bounds["hi"].append(np.minimum([ch - 1, cw - 1], [H - 1, W - 1] - o))
        pos0.append(np.asarray(truth[0]) - o[0])
    bounds = {k: torch.tensor(np.stack(v), dtype=torch.int32, device=dev)
              for k, v in bounds.items()}
    return (torch.from_numpy(np.stack(crops)).to(dev),
            torch.tensor(np.stack(pos0), dtype=torch.int32, device=dev),
            torch.tensor(fills, dtype=torch.uint8, device=dev), bounds)


def roi_segments(lane_frames, truths, fills, spec, dev, roi_geometry, crop_with_fill, ks):
    """S chunks of ROI_K crops a lane as the ROI engines build them, for one
    segmented launch: lane b's frames cropped around its truth one frame
    back, chunk s holding ``ks[s, b]`` real frames (the rest repeat its last
    crop at its last origin; a lane with none holds fill, as a video past its
    end does), the next chunk going on from the frame after. Returns on the
    card ``crops [S,L,K,ch,cw]``, the per-frame boxes, the single engine's
    rebases (``deltas[s][0]`` from the last real row of chunk s-1, for L = 1)
    and the batched engine's (``deltas[:, :, 0] = 0``, with ``origin0``,
    ``origin_last`` and the absolute ``carry``), the start in the first
    crop, ``ks`` and ``fills``."""
    import torch

    S, L = ks.shape
    ch, cw, margin = roi_geometry(spec, ROI_K, 7, "predict")
    crops = np.empty((S, L, ROI_K, ch, cw), np.uint8)
    o = np.zeros((S, L, ROI_K, 2), np.int64)
    for b, (frames, truth, fill) in enumerate(zip(lane_frames, truths, fills)):
        f = 0  # frames of the lane tracked before chunk s
        for s in range(S):
            k = int(ks[s, b])
            last = np.asarray(truth[f], np.int64) - margin
            for t in range(ROI_K):
                if t < k:
                    last = np.asarray(truth[f + t], np.int64) - margin
                    crops[s, b, t] = crop_with_fill(frames[f + t + 1], last, ch, cw, fill)
                elif t == 0:
                    crops[s, b, t] = fill
                else:
                    crops[s, b, t] = crops[s, b, t - 1]
                o[s, b, t] = last
            f += k
    lo = np.maximum(-o, 0)
    hi = np.minimum([ch - 1, cw - 1], [H - 1, W - 1] - o)
    batch_d = np.zeros_like(o)
    batch_d[:, :, 1:] = o[:, :, :-1] - o[:, :, 1:]
    single_d = batch_d.copy()
    pre = np.stack([np.asarray(t[0], np.int64) - margin for t in truths])
    for s in range(S):
        prev = pre if s == 0 else o[s - 1, np.arange(L), np.maximum(ks[s - 1] - 1, 0)]
        single_d[s, :, 0] = prev - o[s, :, 0]
    origin_last = o[np.arange(S)[:, None], np.arange(L)[None, :], np.maximum(ks - 1, 0)]

    # the per-segment arguments as the engines stage them: views of one
    # [S, n] int32 buffer, one segment a row, so the launch reads them as they lie
    per_segment = {"single_deltas": single_d, "deltas": batch_d, "lo": lo, "hi": hi,
                   "origin0": o[:, :, 0], "origin_last": origin_last, "ks": ks}
    flat = np.concatenate([np.asarray(v).reshape(S, -1) for v in per_segment.values()], axis=1)
    flat = torch.tensor(flat, dtype=torch.int32, device=dev)
    out, at = {}, 0
    for k, v in per_segment.items():
        n = int(np.prod(np.shape(v)[1:]))
        out[k] = flat[:, at:at + n].view(np.shape(v))
        at += n
    starts = np.stack([np.asarray(t[0]) for t in truths])
    return dict(out, crops=torch.from_numpy(crops).to(dev),
                carry=torch.tensor(starts, dtype=torch.int32, device=dev),
                pos0=torch.tensor(starts - pre, dtype=torch.int32, device=dev),
                fills=torch.tensor(fills, dtype=torch.uint8, device=dev))


def host_us_per_launch(fn, n=200) -> float:
    """Host microseconds a call of ``fn`` (a kernel wrapper) takes to return,
    with the card asleep so the launches only queue."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return us


def crop_timing(roi_crop, lane_frames, lane_truths, fills, crop, margin):
    """The ROI path's chunk crops at ``crop`` x ``crop``, K = ROI_K, one lane a
    clip of ``lane_frames`` (cropped around its truth, one frame back, as the
    pipeline aims), on successive chunks of the clips, so that their frames
    come from memory as a call's do: the native crop (csrc/roi_crop.cpp) must
    equal the numpy one byte for byte on every chunk. Returns the median
    microseconds a chunk of each into pinned buffers, and the threads the
    native call took."""
    import torch

    L, n = len(lane_frames), min(len(f) for f in lane_frames) - 1
    out_np = torch.empty((L, ROI_K, crop, crop), dtype=torch.uint8, pin_memory=True).numpy()
    out_nat = torch.empty((L, ROI_K, crop, crop), dtype=torch.uint8, pin_memory=True).numpy()
    fills = np.asarray(fills, np.uint8)
    times = {"numpy": [], "native": []}
    for t0 in range(0, n - ROI_K + 1, ROI_K):
        chunks = [f[1 + t0:1 + t0 + ROI_K] for f in lane_frames]
        origins = np.stack([np.asarray(tr[t0:t0 + ROI_K], np.int64) - margin
                            for tr in lane_truths])
        for name, fn, out in (("numpy", roi_crop.crop_lanes_plain, out_np),
                              ("native", roi_crop.crop_lanes_native, out_nat)):
            t = time.perf_counter()
            fn(chunks, [ROI_K] * L, origins, fills, out)
            times[name].append(time.perf_counter() - t)
        if not np.array_equal(out_np, out_nat):
            raise SystemExit(f"phase 3: the native crop differs from numpy at {crop}x{crop},"
                             f" {L} lane(s), frames {1 + t0}..{t0 + ROI_K}")
    threads = roi_crop.crop_threads(L * ROI_K * crop * crop)
    return {k: 1e6 * statistics.median(v[1:]) for k, v in times.items()}, threads


def log_profile(name, prof):
    dev, wall_us = prof["device_us_by_name"], prof["wall_us"]
    if not dev:
        log(f"phase 3 profile of one {name}: the profiler recorded no device time (not measured)")
        return
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:4]
    log(f"phase 3 profile of one {name}: wall {wall_us / 1e3:.1f} ms, device time"
        f" {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}% of wall): "
        + ", ".join(f"{k[:40]} {v / 1e3:.2f} ms" for k, v in top))


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Run the port on one card and check it end to end.")
    ap.add_argument("--parent", help="another checkout (e.g. the parent commit's, unpacked with"
                                     " git archive under build/): phase 3 then times the ROI"
                                     " host path against it in turns (tools/host_path_ab.py)")
    parent = ap.parse_args(argv).parent

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from pawsometracker_tpu_torch import (IJ, global_detect_peaks, load_checkpoint,
                                              make_mesh, track, track_batch, track_multi,
                                              track_resumable)
        from pawsometracker_tpu_torch.parallel.mesh import (_argmax_frames, global_detect_batch,
                                                            sharded_pallas_bounded)
        from pawsometracker_tpu_torch.models import dog_tracker
        from pawsometracker_tpu_torch.models.dog_tracker import autodetect_spec, make_spec
        from pawsometracker_tpu_torch.ops import _build, roi_crop, tracker_kernel as tk
        from pawsometracker_tpu_torch.ops import detect_kernel as dk
        from pawsometracker_tpu_torch.ops.dog_kernel import dog_kernel_2d, guess_window_size
        from pawsometracker_tpu_torch.ops.filters import mode_u8_host
        from pawsometracker_tpu_torch import pipeline as pl
        from pawsometracker_tpu_torch.io.decode import ArrayFrameSource
        from pawsometracker_tpu_torch.ops.roi_crop import crop_with_fill as _crop_with_fill
        from pawsometracker_tpu_torch.pipeline import roi_geometry
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    wall_start = time.perf_counter()
    phase_wall: dict = {}  # seconds of each part of this run, in order

    def phase_done(label):
        phase_wall[label] = time.perf_counter() - wall_start - sum(phase_wall.values())
    record: dict = {"card": card_line(), "device": torch.cuda.get_device_name(0)}
    log(record["card"])  # as nvidia-smi gives it: name, power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    stats_log = StatsLog()
    port_logger = logging.getLogger("pawsometracker_tpu_torch")
    port_logger.addHandler(stats_log)
    port_logger.setLevel(logging.DEBUG)

    # the plain versions count their runs here, so phase 2 can show the main
    # paths never took them on the card
    plain_runs = count_plain_runs(tk, dog_tracker)

    # the three sources build at once, one nvcc each: the scan kernels, the detection
    # kernels and the native crop
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for built in [pool.submit(tk._lib), pool.submit(dk._lib), pool.submit(roi_crop._lib)]:
            built.result()
    record["build_s"] = time.perf_counter() - t0
    log(f"build: dog_scan.cu, detect.cu and roi_crop.cpp at once in {record['build_s']:.2f} s")
    for line in _build.build_log.get("detect", "").splitlines():
        entry = re.search(r"Compiling entry function .*\d((?:response|rounds)_kernel)", line)
        if entry:
            log(f"  ptxas: {entry.group(1)}")
        elif "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    for line in _build.build_log.get("dog_scan", "").splitlines():
        entry = re.search(r"Compiling entry function .*\d(dog_scan(?:_tiled)?_kernel)"
                          r"(ILb([01])ELb([01]))?", line)
        if entry:
            log(f"  ptxas: {entry.group(1)}"
                + (f"<{'aligned' if entry.group(3) == '1' else 'per-row offsets'},"
                   f" {'segments' if entry.group(4) == '1' else 'one chunk'}>"
                   if entry.group(2) else ""))
        elif "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    frames_np, truth = synth_clip()
    clips, truths = synth_batch()
    multi_np, multi_truths = synth_multi()
    large_np, large_truth = synth_large()
    log(f"synthetic clips drawn in {time.perf_counter() - t0:.1f} s")
    spec = make_spec((H, W), WINDOW, TARGET_WIDTH, True)
    aspec = autodetect_spec(spec)
    L = spec.kernel_len
    fill = mode_u8_host(frames_np[0])
    kw = dict(radii=spec.radii, sigma=spec.sigma, darker_target=True)
    kwa = dict(radii=aspec.radii, sigma=aspec.sigma, darker_target=True)
    B = len(clips)

    phase_done("set-up and build")
    # ---- phase 1: the kernel against its plain version, on the card -------
    rng = np.random.default_rng(SEED)
    chunk = torch.from_numpy(frames_np[1:1 + CHUNK]).to(dev)
    tr = truth[1:1 + CHUNK]
    pos0 = torch.tensor(truth[0], dtype=torch.int32, device=dev)
    deltas = rng.integers(-3, 4, size=(CHUNK, 2))
    lo = np.maximum(tr - rng.integers(0, 16, size=(CHUNK, 2)), 0)
    hi = np.minimum(tr + rng.integers(0, 16, size=(CHUNK, 2)), [H - 1, W - 1])
    bnd = {k: torch.tensor(v, dtype=torch.int32, device=dev)
           for k, v in (("deltas", deltas), ("lo", lo), ("hi", hi))}
    frame0 = torch.from_numpy(frames_np[0]).to(dev)[None]
    centre = torch.tensor([H // 2 - 1, W // 2 - 1], dtype=torch.int32, device=dev)
    # exact-tie geometries (the JAX package's engine gate): a flat field, where
    # every window cell ties, and a mirror-symmetric blob
    flat = torch.full((CHUNK, H, W), fill, dtype=torch.uint8, device=dev)
    yy, xx = np.mgrid[:H, :W]
    blob = np.exp(-((yy - H // 2) ** 2 + (xx - W // 2) ** 2) / (2.0 * spec.sigma ** 2))
    mirror = torch.from_numpy(np.clip(fill - 110.0 * blob, 0, 255).astype(np.uint8)).to(dev)
    mirror = mirror[None].expand(CHUNK, H, W).contiguous()
    mid = torch.tensor([H // 2 + 3, W // 2 - 2], dtype=torch.int32, device=dev)
    # a width that is not a multiple of 16: each superset row at its own offset
    narrow = chunk[:BOUNDED_T, :, :W - 2].contiguous()

    # lanes: frames 1..64 of each batch clip, per-lane fills, per-lane boxes
    lanes = torch.from_numpy(np.stack([c[1:1 + CHUNK] for c in clips])).to(dev)
    lane_pos0 = torch.tensor(np.stack([t[0] for t in truths]), dtype=torch.int32, device=dev)
    lane_fills = torch.tensor(BATCH_FILLS, dtype=torch.uint8, device=dev)
    ltr = np.stack([t[1:1 + BOUNDED_T] for t in truths])
    lbnd = {"deltas": rng.integers(-3, 4, size=(B, BOUNDED_T, 2)),
            "lo": np.maximum(ltr - rng.integers(0, 16, size=(B, BOUNDED_T, 2)), 0),
            "hi": np.minimum(ltr + rng.integers(0, 16, size=(B, BOUNDED_T, 2)), [H - 1, W - 1])}
    lbnd = {k: torch.tensor(v, dtype=torch.int32, device=dev) for k, v in lbnd.items()}
    # a clamp box far from the carried position, deltas up to the window radius
    ri, rj = spec.radii
    far_lo = np.stack([rng.integers(800, 1000, CHUNK), rng.integers(100, 300, CHUNK)], 1)
    far = {"deltas": np.stack([rng.integers(-ri, ri + 1, CHUNK),
                               rng.integers(-rj, rj + 1, CHUNK)], 1),
           "lo": far_lo, "hi": far_lo + rng.integers(0, 40, (CHUNK, 2))}
    far = {k: torch.tensor(v, dtype=torch.int32, device=dev) for k, v in far.items()}
    lanes_t = lanes[:, :BOUNDED_T].contiguous()
    lanes0 = torch.from_numpy(np.stack([c[0] for c in clips])).to(dev)[:, None].contiguous()
    centres = centre[None].expand(B, 2).contiguous()
    shared = torch.from_numpy(multi_np[1:1 + CHUNK]).to(dev)
    shared_pos0 = torch.tensor(np.stack([t[0] for t in multi_truths]), dtype=torch.int32,
                               device=dev)
    shared_fills = torch.full((B,), 128, dtype=torch.uint8, device=dev)
    off_pos0 = lane_pos0.clone()
    off_pos0[1] = torch.tensor([-50, W + 60], dtype=torch.int32, device=dev)  # off the frame

    # name: (frames, pos0, fill(s), spec kwargs, bounds, subpixel, batched)
    cases = {
        "unbounded": (chunk, pos0, fill, kw, {}, False, False),
        "flat field (ties)": (flat, centre, fill, kw, {}, False, False),
        "mirror blob (ties)": (mirror, mid, fill, kw, {}, False, False),
        "bounded": (chunk, pos0, fill, kw, bnd, False, False),
        "bounded+subpixel": (chunk, pos0, fill, kw, bnd, True, False),
        "far box, large deltas": (chunk, pos0, fill, kw, far, False, False),
        "snap quarter-frame": (frame0, centre, fill, kwa, {}, False, False),
        "snap+subpixel": (frame0, pos0, fill, kw, {}, True, False),
        "width 1918 +subpixel": (narrow, pos0, fill, kw, {}, True, False),
        "batched unbounded": (lanes, lane_pos0, lane_fills, kw, {}, False, True),
        "batched bounded": (lanes_t, lane_pos0, lane_fills, kw, lbnd, False, True),
        "batched bounded+subpixel": (lanes_t, lane_pos0, lane_fills, kw, lbnd, True, True),
        "batched lane off the frame": (lanes_t, off_pos0, lane_fills, kw, {}, False, True),
        "batched shared frames (4 targets)": (shared, shared_pos0, shared_fills, kw, {}, False,
                                              True),
        "batched snap quarter-frame": (lanes0, centres, lane_fills, kwa, {}, False, True),
        "batched snap+subpixel": (lanes0, lane_pos0, lane_fills, kw, {}, True, True),
    }
    # dog_scan_tiled in chains (T > 1) at the default windows of large targets:
    # one chain unbounded, bounded and bounded+subpixel; 4 lanes with their own
    # frames and fills, one of them starting off the frame; 4 targets on shared
    # frames; and a flat field, where the ties span tiles of different CTAs
    for tw, steps in TILED_STEPS.items():
        tspec = make_spec((H, W), guess_window_size(tw), tw, True)
        tkw = dict(radii=tspec.radii, sigma=tspec.sigma, darker_target=True)
        tpaths = [circle_path(steps + 1, b * np.pi / 2) for b in range(B)]
        own = np.stack([draw_discs(np.full((steps + 1, H, W), bg, np.uint8), [tp], tw // 2)
                        for tp, bg in zip(tpaths, BATCH_FILLS)])
        own = torch.from_numpy(np.ascontiguousarray(own[:, 1:])).to(dev)
        tshared = draw_discs(np.full((steps + 1, H, W), 128, np.uint8), tpaths, tw // 2)
        tshared = torch.from_numpy(np.ascontiguousarray(tshared[1:])).to(dev)
        tstarts = torch.tensor(np.stack([tp[0] for tp in tpaths]), dtype=torch.int32, device=dev)
        toff = tstarts.clone()
        toff[1] = torch.tensor([-50, W + 60], dtype=torch.int32, device=dev)
        ttr = tpaths[0][1:]
        tbnd = {"deltas": rng.integers(-3, 4, size=(steps, 2)),
                "lo": np.maximum(ttr - rng.integers(0, 16, size=(steps, 2)), 0),
                "hi": np.minimum(ttr + rng.integers(0, 16, size=(steps, 2)), [H - 1, W - 1])}
        tbnd = {k: torch.tensor(v, dtype=torch.int32, device=dev) for k, v in tbnd.items()}
        cases.update({
            f"tw={tw} unbounded": (own[0], tstarts[0], 128, tkw, {}, False, False),
            f"tw={tw} bounded": (own[0], tstarts[0], 128, tkw, tbnd, False, False),
            f"tw={tw} bounded+subpixel": (own[0], tstarts[0], 128, tkw, tbnd, True, False),
            f"tw={tw} batched own frames": (own, tstarts, lane_fills, tkw, {}, False, True),
            f"tw={tw} batched shared frames (4 targets)": (tshared, tstarts, shared_fills,
                                                                 tkw, {}, False, True),
            f"tw={tw} batched lane off the frame": (own, toff, lane_fills, tkw, {}, False,
                                                          True),
        })
        if tw == LARGE_TW:
            tflat = torch.full((steps, H, W), fill, dtype=torch.uint8, device=dev)
            cases[f"tw={tw} flat field (ties across CTAs)"] = (tflat, centre, fill, tkw, {},
                                                                     False, False)
            cases[f"tw={tw} flat field (ties across CTAs) +subpixel"] = (
                tflat, centre, fill, tkw, {}, True, False)
            # 8 lanes on one stream from each edge and corner of the frame, a disc drawn whole
            # next to each: every step's first tiles run off the frame
            edge_starts = [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1), (0, W // 2),
                           (H - 1, W // 2), (H // 2, 0), (H // 2, W - 1)]
            r = tw // 2
            tedge = draw_discs(np.full((EDGE_STEPS + 1, H, W), 128, np.uint8),
                               [[(min(max(i, r), H - 1 - r), min(max(j, r), W - 1 - r))]
                                * (EDGE_STEPS + 1) for i, j in edge_starts], r)
            tedge = torch.from_numpy(np.ascontiguousarray(tedge[1:])).to(dev)
            estarts = torch.tensor(edge_starts, dtype=torch.int32, device=dev)
            efills = torch.full((len(edge_starts),), 128, dtype=torch.uint8, device=dev)
            for sub in (False, True):
                cases[f"tw={tw} batched starts on each edge and corner"
                      + (" +subpixel" if sub else "")] = (tedge, estarts, efills, tkw, {}, sub,
                                                          True)

    # the ROI pipeline's chunk scans at the crops it cuts at 1080p: the bench
    # shape (185x185, dog_scan) and the large target (461x461, dog_scan_tiled)
    lspec = make_spec((H, W), guess_window_size(LARGE_TW), LARGE_TW, True)
    lkw = dict(radii=lspec.radii, sigma=lspec.sigma, darker_target=True)
    roi_cases = []
    for label, fr_np, tru, sp, skw in (("185x185", frames_np, truth, spec, kw),
                                       ("461x461", large_np, large_truth, lspec, lkw)):
        crops, rpos0, rbnd = roi_chunk(fr_np, tru, sp, fill, dev, roi_geometry, _crop_with_fill)
        for sub in (False, True):
            name = f"ROI {label} T={ROI_K} {'bounded+subpixel' if sub else 'bounded'}"
            cases[name] = (crops, rpos0, fill, skw, rbnd, sub, False)
            roi_cases.append(name)
    # the 461x461 crop's chunk from starts on each edge and corner of the crop (8 lanes on
    # it, its boxes): the first tiles run off the crop
    crops461, _, _, _, rbnd461, _, _ = cases[f"ROI 461x461 T={ROI_K} bounded"]
    e = crops461.shape[-1] - 1
    cstarts = torch.tensor([(0, 0), (0, e), (e, 0), (e, e), (0, e // 2), (e, e // 2), (e // 2, 0),
                            (e // 2, e)], dtype=torch.int32, device=dev)
    cbnd = {k: v[None].expand(len(cstarts), -1, -1).contiguous() for k, v in rbnd461.items()}
    for sub in (False, True):
        cases[f"ROI 461x461 B=8 starts on each edge and corner T={ROI_K}"
              f" {'bounded+subpixel' if sub else 'bounded'}"] = (
            crops461, cstarts, torch.full((len(cstarts),), fill, dtype=torch.uint8, device=dev),
            lkw, cbnd, sub, True)
    # the batch and multi ROI engines' chunk scans (batched bounded, each lane
    # reading its own crops) at both crop sizes: in the batch, lane 2 is pure
    # fill, as a video past its end is; the 4 targets' crops are cut from one
    # frame stream
    tiled_truths = [circle_path(ROI_K + 1, b * np.pi / 2) for b in range(B)]
    tiled_multi = draw_discs(np.full((ROI_K + 1, H, W), 128, np.uint8), tiled_truths,
                             LARGE_DISC_R)
    for label, sp, skw, lane_frames, lane_truths, fills_b, stream, stream_truths in (
            ("185x185", spec, kw, clips, truths, BATCH_FILLS, multi_np, multi_truths),
            ("461x461", lspec, lkw, [tiled_multi] * B, tiled_truths, (128,) * B,
             tiled_multi, tiled_truths)):
        lane_frames = [None if b == 2 else f for b, f in enumerate(lane_frames)]
        bcrops, bpos0, bfills, bbnd = roi_lanes(lane_frames, lane_truths, fills_b, sp, dev,
                                                roi_geometry, _crop_with_fill)
        for sub in (False, True):
            name = (f"ROI batch {label} B={B} T={ROI_K}"
                    f" {'bounded+subpixel' if sub else 'bounded'} (lane 2 fill)")
            cases[name] = (bcrops, bpos0, bfills, skw, bbnd, sub, True)
            roi_cases.append(name)
        mcrops, mpos0, mfills, mbnd = roi_lanes([stream] * B, stream_truths, (128,) * B, sp, dev,
                                                roi_geometry, _crop_with_fill)
        name = f"ROI multi {label} {B} targets of one stream T={ROI_K} bounded"
        cases[name] = (mcrops, mpos0, mfills, skw, mbnd, False, True)
        roi_cases.append(name)
    del tiled_multi

    def run_kernel(name, kernel=None):
        fr, p0, fl, k, b, sub, batched = cases[name]
        if batched:
            return tk.dog_scan_batch_cuda(fr, p0, fl, subpixel=sub, kernel=kernel, **k, **b)
        return tk.dog_scan_cuda(fr, p0, fl, subpixel=sub, kernel=kernel, **k, **b)

    smem_limit = tk._smem_limit(0)

    def taps_of(k):
        return tk._taps(k["sigma"], True, dev)[2]

    def kernel_of(name):
        k = cases[name][3]
        return tk.kernel_for(k["radii"], taps_of(k), smem_limit)

    def scan_clusters(k):
        """dog_scan's forced cluster sizes at a window: those of SCAN_CLUSTERS
        that fit, and the largest the card schedules (up to 16)"""
        fits = [c for c in range(1, tk.MAX_CLUSTER + 1)
                if tk.scan_plan(k["radii"], taps_of(k), c).smem <= smem_limit
                and tk._scan_active_clusters(tuple(k["radii"]), taps_of(k), c, 0) > 0]
        return sorted({c for c in SCAN_CLUSTERS if c in fits} | set(fits[-1:]))

    def checked_runs(k):
        """(kernel, forced cluster) of each run phase 1 holds to the plain
        version: the shape rule's kernel first, every other kernel that takes
        the window, and dog_scan under each forced cluster size"""
        first = tk.kernel_for(k["radii"], taps_of(k), smem_limit)
        runs = [(first, None)] + [(kn, None) for kn in tk.kernels_for(k["radii"], taps_of(k),
                                                                      smem_limit) if kn != first]
        if "dog_scan" in tk.kernels_for(k["radii"], taps_of(k), smem_limit):
            runs += [("dog_scan", c) for c in scan_clusters(k)]
        return runs

    def run_label(name, kernel, cluster, first):
        if (kernel, cluster) == first:
            return name
        return f"{name} [{kernel}" + (f", C={cluster}" if cluster else "") + "]"

    def run_plain(name):
        fr, p0, fl, k, b, sub, batched = cases[name]
        if batched:
            return tk.dog_scan_batch_plain(fr, p0, fl, subpixel=sub, **k, **b)
        return tk.dog_scan_plain(fr, p0, fl, subpixel=sub, **k, **b)

    phase1 = {}
    for name, (fr, p0, fl, k, b, sub, batched) in cases.items():
        t_case = time.perf_counter()
        want = run_plain(name)
        runs = checked_runs(k)
        for kname, c in runs:
            tk.scan_cluster = c
            try:
                got = run_kernel(name, kname)
                torch.cuda.synchronize()
            finally:
                tk.scan_cluster = None
            gp, wp = (got[0], want[0]) if sub else (got, want)
            pos_equal = bool(torch.equal(gp, wp))
            err = float((gp - wp).abs().max())
            if sub:
                err = max(err, float((got[1] - want[1]).abs().max()))
            ok = pos_equal and err <= (OFFSET_ATOL if sub else 0)
            steps = int(fr.shape[-3])
            label = run_label(name, kname, c, runs[0])
            phase1[label] = {"kernel": kname, "cluster": c, "T": steps,
                             "lanes": int(p0.shape[0]) if batched else 1,
                             "positions_equal": pos_equal, "max_abs_err": err, "ok": ok}
            log(f"phase 1 {label} ({kname}" + (f", C={c} forced" if c else "") + f"): T={steps}"
                f" lanes={phase1[label]['lanes']} positions equal={pos_equal}"
                f" max_abs_err={err:.3g} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"phase 1 {label}: kernel and plain version disagree")
        log(f"phase 1 {name}: {len(runs)} kernel runs against one plain run,"
            f" {time.perf_counter() - t_case:.2f} s")
    one = tk.dog_scan_batch_cuda(chunk[None], pos0[None], lane_fills[:1], **kw)
    one_ok = bool(torch.equal(one[0], tk.dog_scan_cuda(chunk, pos0, int(BATCH_FILLS[0]), **kw)))
    phase1["batched B=1 equals unbatched"] = {"kernel": "dog_scan", "T": CHUNK, "lanes": 1,
                                              "positions_equal": one_ok,
                                              "max_abs_err": 0.0 if one_ok else None,
                                              "ok": one_ok}
    log(f"phase 1 batched B=1 equals unbatched: T={CHUNK} -> {'ok' if one_ok else 'FAIL'}")
    if not one_ok:
        raise SystemExit("phase 1: a one-lane batched launch differs from the unbatched one")
    # the mesh: sharded_pallas_bounded (one batched bounded launch a data shard)
    # against its plain version (interpret=True) on the batch ROI engine's
    # chunk scans at both crop sizes, and the space-sharded whole-frame
    # detector against the unsharded one, on each mesh of this card (or cards)
    meshes = mesh_list(make_mesh, B)
    log(f"phase 1 meshes ({torch.cuda.device_count()} card(s) on this machine): "
        + ", ".join(f"{k} {dict(m.shape)}" for k, m in meshes.items()))
    sharded_cases = {}
    for label, sp in (("185x185", spec), ("461x461", lspec)):
        ch, cw, _ = roi_geometry(sp, ROI_K, 7, "predict")
        rspec = make_spec((ch, cw), sp.window_size, sp.target_width, True)
        for sub in (False, True):
            case = (f"ROI batch {label} B={B} T={ROI_K}"
                    f" {'bounded+subpixel' if sub else 'bounded'} (lane 2 fill)")
            for mlabel, mesh in meshes.items():
                sharded_cases[f"sharded_pallas_bounded {mlabel}: {case}"] = (rspec, mesh, sub, case)
    for name, (rspec, mesh, sub, case) in sharded_cases.items():
        fr, p0, fl, _, b, _, _ = cases[case]
        before = tk.launches
        bnds = (b["deltas"], b["lo"], b["hi"])
        got = sharded_pallas_bounded(rspec, mesh, subpixel=sub)(fr, p0, fl, *bnds)
        n_launch = tk.launches - before
        want = sharded_pallas_bounded(rspec, mesh, interpret=True, subpixel=sub)(fr, p0, fl,
                                                                                 *bnds)
        torch.cuda.synchronize()
        got, want = (got, want) if sub else ((got,), (want,))
        gp, wp = torch.from_numpy(np.asarray(got[0])), torch.from_numpy(np.asarray(want[0]))
        pos_equal = bool(torch.equal(gp, wp))
        err = float((gp - wp).abs().max())
        if sub:
            err = max(err, float(np.abs(np.asarray(got[1]) - np.asarray(want[1])).max()))
        shards = mesh.shape["data"]
        ok = pos_equal and err <= (OFFSET_ATOL if sub else 0) and n_launch == shards
        phase1[name] = {"kernel": kernel_of(case), "T": ROI_K, "lanes": B, "shards": shards,
                        "launches": n_launch, "positions_equal": pos_equal, "max_abs_err": err,
                        "ok": ok}
        log(f"phase 1 {name} ({kernel_of(case)}): {shards} shard(s), launches={n_launch}"
            f" (want {shards}), positions equal={pos_equal} max_abs_err={err:.3g}"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 1 {name}: the sharded scan and its plain version disagree")
    detect_frames = lanes0[:, 0].contiguous()
    unsharded = global_detect_batch(spec)(detect_frames, lane_fills).cpu().numpy()
    # the unsharded detector launches the response kernel on the uint8 frames: it must
    # give the plain response's argmax on the same card tensors (the sharded detectors
    # below are held to it)
    plain_first = _argmax_frames(dk.correlate_plain(dk.pad_plain(detect_frames, lane_fills, L),
                                                    spec.sigma, True), H).cpu().numpy()
    ok = bool(np.array_equal(unsharded, plain_first))
    phase1["global_detect_batch unsharded"] = {"kernel": "detect_response", "lanes": B,
                                               "positions_equal": ok,
                                               "max_abs_err": float(np.abs(
                                                   unsharded - plain_first).max()), "ok": ok}
    log(f"phase 1 global_detect_batch unsharded (detect_response): 1080p, B={B}, L={L}, equals"
        f" the plain response's argmax={ok} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 1 global_detect_batch: the kernel's response differs from plain")
    for label, mesh in space_meshes(make_mesh).items():
        got = np.asarray(global_detect_batch(spec, mesh)(detect_frames, lane_fills))
        ok = bool(np.array_equal(got, unsharded))
        phase1[f"global_detect_batch {label}"] = {"kernel": None, "lanes": B,
                                                  "positions_equal": ok, "max_abs_err": None,
                                                  "ok": ok}
        log(f"phase 1 space-sharded global_detect_batch {label} {dict(mesh.shape)}: 1080p,"
            f" B={B}, equals the unsharded detector={ok} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 1 global_detect_batch {label}: differs from unsharded")
    # the detection kernels at the plate cell's shape: the response (from the uint8 frame,
    # the pad fused in) at L = 33, 65 and 149 and the rounds' 96 peaks, each against its
    # plain version on the same card tensors; then the whole detection against the CPU's
    plate_np = plate_frame()
    plate_dev = torch.from_numpy(plate_np).to(dev)
    plate_fill = int(mode_u8_host(plate_np))
    pspec = make_spec((H, W), PLATE_WINDOW, PLATE_TW, True)
    plate_r2 = float(max(2 * pspec.radii[0] + 1, 2 * pspec.radii[1] + 1)) ** 2
    for tw in (PLATE_TW, TARGET_WIDTH, LARGE_TW):
        tspec = make_spec((H, W), PLATE_WINDOW, tw, True)
        tL = tspec.kernel_len
        got, _ = dk.frame_response(plate_dev[None], [plate_fill], tspec.sigma, True)
        want = dk.correlate_plain(dk.pad_plain(plate_dev[None], [plate_fill], tL), tspec.sigma,
                                  True)
        ok = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        phase1[f"detect_response 1080p L={tL}"] = {"kernel": "detect_response", "L": tL,
                                                   "positions_equal": ok, "max_abs_err": err,
                                                   "ok": ok}
        log(f"phase 1 detect_response 1080p L={tL} (target_width {tw}): bit-equal to plain="
            f"{ok} max_abs_err={err:.3g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 1 detect_response L={tL}: differs from its plain version")
    plate_resp, plate_part = dk.frame_response(plate_dev[None], [plate_fill], pspec.sigma, True)
    want = dk.suppress_plain(plate_resp[0], PLATE_N, plate_r2)
    before = dk.launches
    got = dk.suppress(plate_resp[0].clone(), plate_part[0].clone(), PLATE_N, plate_r2)
    n_launch = dk.launches - before
    cpu_peaks = global_detect_peaks(pspec, PLATE_N)(plate_np, plate_fill)
    card_peaks = global_detect_peaks(pspec, PLATE_N)(plate_dev, plate_fill).cpu()
    ok = (bool(torch.equal(got, want)) and n_launch == 1 and torch.equal(card_peaks, cpu_peaks)
          and len({tuple(p) for p in cpu_peaks.tolist()}) == PLATE_N)
    err = float((got - want).abs().max())
    phase1[f"detect_rounds 1080p N={PLATE_N}"] = {"kernel": "detect_rounds", "launches": n_launch,
                                                  "positions_equal": ok, "max_abs_err": err,
                                                  "ok": ok}
    log(f"phase 1 detect_rounds 1080p L={pspec.kernel_len} N={PLATE_N} r2={plate_r2:g}: one"
        f" launch ({n_launch}), peaks equal the plain rounds'={bool(torch.equal(got, want))},"
        f" the card's detection equals the CPU's={bool(torch.equal(card_peaks, cpu_peaks))},"
        f" {len({tuple(p) for p in cpu_peaks.tolist()})} distinct -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 1 detect_rounds: differs from the plain rounds or the CPU")
    # segments: S chunk scans a lane in one launch (the kernel layer's form) against
    # their plain versions, at the ROI crops (one chain by the ks rule with a
    # short chunk; 4 lanes by the carry, lane 2 with no real frame and lane 3 a
    # short one in chunk 1) and at the 1080p full-frame chunk (each segment
    # from the last step), S = 2 and 4
    seg_ks = {"one chain": np.array([[ROI_K], [5], [ROI_K], [ROI_K]]),
              "4 lanes": np.array([[ROI_K] * 4, [ROI_K, ROI_K, 0, 5], [ROI_K] * 4,
                                   [ROI_K] * 4])}
    seg_data = {
        "185x185": (kw, roi_segments([frames_np], [truth], [fill], spec, dev, roi_geometry,
                                     _crop_with_fill, seg_ks["one chain"]),
                    roi_segments(clips, truths, BATCH_FILLS, spec, dev, roi_geometry,
                                 _crop_with_fill, seg_ks["4 lanes"])),
        "461x461": (lkw, roi_segments([large_np], [large_truth], [fill], lspec, dev,
                                            roi_geometry, _crop_with_fill, seg_ks["one chain"]),
                          roi_segments([large_np] * B, [circle_path(N_FRAMES)] * B, (128,) * B,
                                       lspec, dev, roi_geometry, _crop_with_fill,
                                       seg_ks["4 lanes"])),
    }
    full_segments = torch.from_numpy(frames_np[1:1 + 4 * CHUNK]).to(dev).view(4, CHUNK, H, W)
    seg_cases = {}  # name: (kind, data, spec kwargs, S, subpixel)
    for label, (skw, one_d, lanes_d) in seg_data.items():
        for S, sub in ((2, False), (4, False), (4, True)):
            tail = f"S={S}" + (" +subpixel" if sub else "")
            seg_cases[f"segments ROI {label} one chain T={ROI_K} {tail}"] = ("one", one_d, skw, S,
                                                                          sub)
            seg_cases[f"segments ROI {label} B={B} carry T={ROI_K} {tail}"] = ("carry", lanes_d,
                                                                            skw, S, sub)
    for S in (2, 4):
        seg_cases[f"segments full 1080p T={CHUNK} S={S}"] = ("full", (full_segments, pos0), kw,
                                                            S, False)
    # the large target's window on full frames, 3 segments of TILED_STEPS[60], each from the
    # step before's position: a segment's first patch follows the chain across the boundary
    lsteps = TILED_STEPS[LARGE_TW]
    large_segments = torch.from_numpy(large_np[1:1 + 3 * lsteps]).to(dev).view(3, lsteps, H, W)
    large_p0 = torch.tensor(large_truth[0], dtype=torch.int32, device=dev)
    for sub in (False, True):
        seg_cases[f"segments full 1080p tw={LARGE_TW} T={lsteps} S=3"
                  + (" +subpixel" if sub else "")] = ("full", (large_segments, large_p0), lkw,
                                                      3, sub)

    def run_segments(name, plain=False, carry_out=None, kernel=None):
        kind, d, skw, S, sub = seg_cases[name]
        one = (tk.dog_scan_segments_plain if plain
               else functools.partial(tk.dog_scan_segments_cuda, kernel=kernel))
        batch = (tk.dog_scan_batch_segments_plain if plain
                 else functools.partial(tk.dog_scan_batch_segments_cuda, kernel=kernel))
        if kind == "full":
            return one(d[0][:S], d[1], fill, subpixel=sub, **skw)
        if kind == "one":
            return one(d["crops"][:S, 0], d["pos0"][0], fill, deltas=d["single_deltas"][:S, 0],
                       lo=d["lo"][:S, 0], hi=d["hi"][:S, 0], ks=d["ks"][:S, 0], subpixel=sub,
                       **skw)
        return batch(d["crops"][:S], None, d["fills"], deltas=d["deltas"][:S], lo=d["lo"][:S],
                     hi=d["hi"][:S], ks=d["ks"][:S], origin0=d["origin0"][:S],
                     origin_last=d["origin_last"][:S], carry=d["carry"], carry_out=carry_out,
                     subpixel=sub, **skw)

    def seg_kernel(name):
        k = seg_cases[name][2]
        return tk.kernel_for(k["radii"], taps_of(k), smem_limit)

    for name, (kind, _, skw_s, S, sub) in seg_cases.items():
        want = run_segments(name, plain=True)
        if kind == "carry":
            want, want_c = want
        runs = checked_runs(skw_s)
        for kname, c in runs:
            tk.scan_cluster = c
            try:
                before = tk.launches
                got = run_segments(name, kernel=kname)
                n_launch = tk.launches - before
                torch.cuda.synchronize()
            finally:
                tk.scan_cluster = None
            carry_equal = True
            if kind == "carry":
                got, got_c = got
                carry_equal = bool(torch.equal(got_c, want_c))
            gp, wp = (got[0], want[0]) if sub else (got, want)
            pos_equal = bool(torch.equal(gp, wp)) and carry_equal
            err = float((gp - wp).abs().max())
            if sub:
                err = max(err, float((got[1] - want[1]).abs().max()))
            ok = pos_equal and err <= (OFFSET_ATOL if sub else 0) and n_launch == 1
            lanes_n = B if kind == "carry" else 1
            label = run_label(name, kname, c, runs[0])
            phase1[label] = {"kernel": kname, "cluster": c, "T": int(gp.shape[-2]),
                             "segments": S, "lanes": lanes_n, "launches": n_launch,
                             "positions_equal": pos_equal, "max_abs_err": err, "ok": ok}
            log(f"phase 1 {label} ({kname}" + (f", C={c} forced" if c else "") + f"): {S}"
                f" segments of T={gp.shape[-2]}, lanes={lanes_n}, one launch={n_launch == 1},"
                " positions" + (" and carry" if kind == "carry" else "") + f" equal={pos_equal}"
                f" max_abs_err={err:.3g} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"phase 1 {label}: the segmented kernel and its plain version"
                                 " disagree")
    for name in [n for n in cases if n.startswith("tw=")]:
        del cases[name]
    del flat, mirror, narrow, own, tshared, tflat, tedge, large_segments
    record["phase1"] = phase1

    phase_done("phase 1")
    # ---- engine choice: the measured kernel of each bounded ROI geometry ------
    # in a cache root of its own, which the CLI's fresh processes of phase 2
    # inherit
    os.environ["PAWSOMETRACKER_CACHE"] = tempfile.mkdtemp(prefix="chip_smoke_engine_",
                                                          dir=os.path.join(ROOT, "build"))
    pl._session_engine_cache.clear()

    def roi_spec_of(sp):
        ch, cw, _ = roi_geometry(sp, ROI_K, 7, "predict")
        return make_spec((ch, cw), sp.window_size, sp.target_width, True)

    def lanes_label(batch):
        return "L=1" if batch is None else f"B={batch}"

    # every geometry whose bounded scans the main paths launch: both crops, one
    # chain and 4 lanes, each with and without subpixel; the shards of the mesh
    # paths (1 and 2 lanes of track_batch ROI; the CLI's --batch of 2 files);
    # and the sweep's windows (target_width 30, 35, 38)
    geoms = {}  # label: (crop spec, lanes or None, subpixel)
    for label, sp in (("185x185", spec), ("461x461", lspec)):
        for batch in (None, B):
            for sub in (False, True):
                geoms[f"{label} {lanes_label(batch)}" + (" +subpixel" if sub else "")] = (
                    roi_spec_of(sp), batch, sub)
    for batch in (1, 2):
        for sub in (False, True):
            geoms[f"185x185 B={batch} (a mesh shard)" + (" +subpixel" if sub else "")] = (
                roi_spec_of(spec), batch, sub)
    sweep = {tw: make_spec((H, W), guess_window_size(tw), tw, True) for tw in SWEEP_TW}
    for tw, tspec in sweep.items():
        rs = roi_spec_of(tspec)
        geoms[f"tw={tw} {rs.frame_shape[0]}x{rs.frame_shape[1]} L=1"] = (rs, None, False)

    def pick(rspec, batch, sub):
        if batch is None:
            return pl.pick_bounded_engine(rspec, ROI_K, fill, subpixel=sub)
        return pl.pick_bounded_engine_batch(rspec, ROI_K, batch, fill, subpixel=sub)

    tk.reset_launches()
    plain_runs["n"] = plain_runs["probe"] = 0
    engine_choice = {}
    for label, (rspec, batch, sub) in geoms.items():
        t0 = time.perf_counter()
        try:
            eng, info = pick(rspec, batch, sub)
        except RuntimeError as e:  # a kernel differs from the plain version, or failed
            raise SystemExit(f"engine choice {label}: {e}")
        wall = time.perf_counter() - t0
        ok = (eng == "pallas" and info.get("parity") is True and info.get("tie_parity") is True
              and info.get("kernel") in tk.KERNELS)
        engine_choice[label] = dict(info, wall_s=wall, ok=ok)
        log(f"engine choice {label} (crop {rspec.frame_shape[0]}x{rspec.frame_shape[1]}, window"
            f" {rspec.window_size[0]}x{rspec.window_size[1]}, L = {rspec.kernel_len}, K = {ROI_K}):"
            f" {json.dumps(info)}, {wall:.2f} s -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"engine choice {label}: {info}")
    probe = {"launches": dict(tk.probe_launches), "plain_runs": plain_runs["probe"]}
    ok = tk.launches == 0 and plain_runs["n"] == 0
    log(f"engine choice: the probes launched {probe['launches']} (apart from the launch counts:"
        f" {tk.launches}) and ran the plain version {probe['plain_runs']} times (counted apart:"
        f" {plain_runs['n']}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("engine choice: the probe's runs entered the counts")
    # a second call hits the session cache; a fresh process reads the file
    before = sum(tk.probe_launches.values())
    hits = all(pick(*g)[1] is pl._session_engine_cache[pl._engine_key(
        g[0], ROI_K, g[1], g[2], dev)] for g in geoms.values())
    hits = hits and sum(tk.probe_launches.values()) == before and plain_runs["probe"] == \
        probe["plain_runs"]
    wanted = [[g[0].frame_shape[0], g[0].window_size[0], g[0].target_width, g[1], g[2]]
              for g in geoms.values()]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                        "sys.exit(chip_smoke.engine_probe(sys.argv[1:]))", json.dumps(wanted)],
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                       text=True, timeout=300)
    fresh_wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise SystemExit(f"engine choice: the fresh process failed:\n{r.stderr[-4000:]}")
    fresh = json.loads(r.stdout.strip().splitlines()[-1])
    read_back = (fresh["infos"] == [json.loads(json.dumps(pick(*g)[1])) for g in geoms.values()]
                 and fresh["launches"] == 0 and not fresh["probe_launches"]
                 and fresh["plain_runs"] == {"n": 0, "probe": 0})
    log(f"engine choice: a second call hits the session cache={hits}; a fresh process read all"
        f" {len(geoms)} decisions from {pl._engine_cache_path()} without measuring={read_back}"
        f" (launches {fresh['launches']}, probe launches {fresh['probe_launches']}, plain runs"
        f" {fresh['plain_runs']}, {fresh_wall:.2f} s) -> {'ok' if hits and read_back else 'FAIL'}")
    if not (hits and read_back):
        raise SystemExit("engine choice: a decision was measured again")
    chosen = {label: info["kernel"] for label, info in engine_choice.items()}

    # both kernels timed at every main-path shape where both fit (the 185x185
    # chunk scans, one chain and 4 lanes, one segment and 2) and at the
    # target_width sweep's crops; each row's bound from cost(), and the pick
    sweep_cases = {}
    for tw, tspec in sweep.items():
        rs = roi_spec_of(tspec)
        skw_t = dict(radii=tspec.radii, sigma=tspec.sigma, darker_target=True)
        crops, rpos0, rbnd = roi_chunk(frames_np, truth, tspec, fill, dev, roi_geometry,
                                       _crop_with_fill)
        sweep_cases[tw] = (rs, skw_t, (crops, rpos0, fill, rbnd),
                           roi_lanes(clips, truths, BATCH_FILLS, tspec, dev, roi_geometry,
                                     _crop_with_fill))
    rows = {}  # label: (launch(kernel), radii, sigma, steps, subpixel, lanes, plain, pick)
    for crop in ("185x185", "461x461"):
        for sub in (False, True):
            tail = "bounded+subpixel" if sub else "bounded"
            name = f"ROI {crop} T={ROI_K} {tail}"
            fr, p0, fl, k, b, _, _ = cases[name]
            rows[name] = (functools.partial(
                lambda kern, fr, p0, fl, k, b, sub: tk.dog_scan_cuda(
                    fr, p0, fl, subpixel=sub, kernel=kern, **k, **b), fr=fr, p0=p0, fl=fl, k=k,
                b=b, sub=sub), k, ROI_K, sub, 1, None,
                f"{crop} L=1" + (" +subpixel" if sub else ""))
            name = f"ROI batch {crop} B={B} T={ROI_K} {tail} (lane 2 fill)"
            fr, p0, fl, k, b, _, _ = cases[name]
            rows[name] = (functools.partial(
                lambda kern, fr, p0, fl, k, b, sub: tk.dog_scan_batch_cuda(
                    fr, p0, fl, subpixel=sub, kernel=kern, **k, **b), fr=fr, p0=p0, fl=fl, k=k,
                b=b, sub=sub), k, ROI_K, sub, B, None,
                f"{crop} B={B}" + (" +subpixel" if sub else ""))
    for name, lanes_n, glabel in ((f"segments ROI 185x185 one chain T={ROI_K} S=2", 1,
                                   "185x185 L=1"),
                                  (f"segments ROI 185x185 B={B} carry T={ROI_K} S=2", B,
                                   f"185x185 B={B}")):
        rows[name] = (functools.partial(lambda kern, name: run_segments(name, kernel=kern),
                                        name=name), seg_cases[name][2], 2 * ROI_K, False,
                      lanes_n, None, glabel)
    for tw, (rs, skw_t, (crops, rpos0, fl, rbnd), (bc, bp, bf, bb)) in sweep_cases.items():
        crop = f"{rs.frame_shape[0]}x{rs.frame_shape[1]}"
        rows[f"ROI tw={tw} {crop} T={ROI_K} bounded"] = (
            functools.partial(lambda kern, c, p, f, b, k: tk.dog_scan_cuda(
                c, p, f, kernel=kern, **k, **b), c=crops, p=rpos0, f=fl, b=rbnd, k=skw_t),
            skw_t, ROI_K, False, 1,
            functools.partial(lambda c, p, f, b, k: tk.dog_scan_plain(c, p, f, **k, **b),
                              c=crops, p=rpos0, f=fl, b=rbnd, k=skw_t),
            f"tw={tw} {crop} L=1")
        rows[f"ROI batch tw={tw} {crop} B={B} T={ROI_K} bounded"] = (
            functools.partial(lambda kern, c, p, f, b, k: tk.dog_scan_batch_cuda(
                c, p, f, kernel=kern, **k, **b), c=bc, p=bp, f=bf, b=bb, k=skw_t),
            skw_t, ROI_K, False, B, None, None)
    engine_timing = {}
    for name, (launch, skw_r, steps, sub, lanes_n, plain_fn, glabel) in rows.items():
        case_L = tk._taps(skw_r["sigma"], True, dev)[2]
        c = cost(skw_r["radii"], case_L, steps, sub, True, lanes=lanes_n)
        plain_ms = cuda_time_ms(plain_fn, reps=1, warmup=0) if plain_fn is not None else None
        picked = chosen.get(glabel) if glabel else None
        engine_timing[name] = {"pick": picked, "plain_ms": plain_ms, "T": steps,
                               "lanes": lanes_n, "L": case_L, **c}
        for kname in tk.kernels_for(skw_r["radii"], case_L, smem_limit):
            ms = cuda_time_ms(functools.partial(launch, kname), reps=20)
            row = {"ms": ms, "us_per_step": 1e3 * ms / steps, "card_bound_share": c["bound_ms"] / ms,
                   "sm_bound_share": c["sm_bound_ms"] / ms}
            where = ""
            if kname == "dog_scan":
                plan = tk._scan_plan(skw_r["radii"], case_L, smem_limit, lanes_n, 0)
                row.update(cluster=plan.cluster, slots=plan.slots,
                           cluster_bound_share=c["sm_bound_ms"] / plan.cluster / ms)
                where = (f", its cluster of {plan.cluster} SMs"
                         f" {c['sm_bound_ms'] / plan.cluster:.4f} ms"
                         f" ({100 * row['cluster_bound_share']:.1f}%); PR 10 "
                         + (f"{PR10_MS[name]:.4f} ms" if name in PR10_MS else "not measured"))
            if kname == "dog_scan_tiled":
                plan = tk._tiled_plan(skw_r["radii"], case_L, smem_limit, sub, 0)
                row.update(cluster=plan.cluster, tile=list(plan.tile),
                           cluster_bound_share=c["sm_bound_ms"] / plan.cluster / ms)
                where = (f", its cluster of {plan.cluster} SMs {c['sm_bound_ms'] / plan.cluster:.4f}"
                         f" ms ({100 * row['cluster_bound_share']:.1f}%); {pr11(name)}")
            engine_timing[name][kname] = row
            log(f"engine choice timing {name} ({kname}): {ms:.4f} ms a launch"
                f" ({row['us_per_step']:.2f} us/step), bound {c['bound_ms']:.6f} ms ({c['bound_by']},"
                f" {100 * row['card_bound_share']:.2f}%), one SM {c['sm_bound_ms']:.4f} ms"
                f" ({100 * row['sm_bound_share']:.1f}%){where}; plain "
                + (f"{plain_ms:.3f} ms" if plain_ms is not None else "not measured")
                + f"; the chooser's pick: {picked or 'not measured'}")
    record["engine_choice"] = {"decisions": engine_choice, "probe": probe,
                               "session_hits": hits, "fresh_process_read_back": read_back,
                               "timing": engine_timing}
    del sweep_cases

    phase_done("engine choice")
    # ---- phase 2: the main paths --------------------------------------------
    base = dict(fps=FPS, target_width=TARGET_WIDTH, window_size=WINDOW, stream="full")
    large = dict(fps=FPS, target_width=LARGE_TW, stream="full")  # the default window
    # stream="auto": at 1080p the crop is under half the frame, so ROI
    roi = dict(fps=FPS, target_width=TARGET_WIDTH, window_size=WINDOW)
    large_roi = dict(fps=FPS, target_width=LARGE_TW)
    start0 = IJ(int(truth[0][0]), int(truth[0][1]))
    batch_locs = [IJ(int(t[0][0]), int(t[0][1])) for t in truths]
    multi_locs = [IJ(int(t[0][0]), int(t[0][1])) for t in multi_truths]
    paths = {
        "track": {
            "start_location": dict(start_location=start0),
            "autodetect": dict(start_location=None),
            "subpixel": dict(start_location=start0, subpixel=True),
        },
        "track_batch": {
            "start_location": dict(start_location=batch_locs),
            "lane 2 autodetect": dict(start_location=batch_locs[:2] + [None] + batch_locs[3:]),
            "subpixel": dict(start_location=batch_locs, subpixel=True),
        },
        "track_multi": {
            "start_locations": dict(start_locations=multi_locs),
            "n_targets=4": dict(n_targets=4),
            "subpixel": dict(start_locations=multi_locs, subpixel=True),
        },
        "track large target": {
            "start_location": dict(start_location=start0),
            "autodetect": dict(start_location=None),
            "subpixel": dict(start_location=start0, subpixel=True),
        },
    }
    # each ROI path and the full-frame path it is held equal to
    roi_paths = {"track ROI": "track", "track large target ROI": "track large target",
                 "track_batch ROI": "track_batch", "track_multi ROI": "track_multi"}
    for path, full_path in roi_paths.items():
        paths[path] = paths[full_path]
    entry = {
        "track": lambda **k: track(frames_np, **base, **k),
        "track_batch": lambda **k: track_batch(clips, **base, **k),
        "track_multi": lambda **k: track_multi(multi_np, **base, **k),
        "track large target": lambda **k: track(large_np, **large, **k),
        "track ROI": lambda **k: track(frames_np, **roi, **k),
        "track large target ROI": lambda **k: track(large_np, **large_roi, **k),
        "track_batch ROI": lambda **k: track_batch(clips, **roi, **k),
        "track_multi ROI": lambda **k: track_multi(multi_np, **roi, **k),
    }
    n_batch_scans = math.ceil((max(BATCH_LENS) - 1) / CHUNK)
    want_launches = {
        "track": {n: 1 + math.ceil((N_FRAMES - 1) / CHUNK) for n in paths["track"]},
        "track_batch": {"start_location": 1 + n_batch_scans, "lane 2 autodetect": 2 + n_batch_scans,
                        "subpixel": 1 + n_batch_scans},
        "track_multi": {n: 1 + math.ceil((MULTI_FRAMES - 1) / MULTI_CHUNK)
                        for n in paths["track_multi"]},
        "track large target": {n: 1 + math.ceil((N_FRAMES - 1) / CHUNK)
                               for n in paths["track large target"]},
    }
    def bounded_by_kernel():
        # "<kernel>: [batched ]bounded[+subpixel][, segmented]", by kernel
        counts = {}
        for c, n in tk.launches_by_config.items():
            kname, cfg = c.split(": ")
            if cfg.removeprefix("batched ").startswith("bounded"):
                counts[kname] = counts.get(kname, 0) + n
        return counts

    def bounded_launches():
        return sum(bounded_by_kernel().values())

    large_kernel = tk.kernel_for(lspec.radii, lspec.kernel_len, smem_limit)
    # the engine choice's geometry of each ROI path's bounded launches
    roi_geoms = {"track ROI": "185x185 L=1", "track large target ROI": "461x461 L=1",
                 "track_batch ROI": f"185x185 B={B}", "track_multi ROI": f"185x185 B={B}"}

    # the full-frame paths' chunks, each staged into a pinned ring by one native copy on its
    # prefetcher's thread (the clips are arrays served as views); the ROI paths stage none
    want_copies = {"track": math.ceil((N_FRAMES - 1) / CHUNK),
                   "track large target": math.ceil((N_FRAMES - 1) / CHUNK),
                   "track_batch": sum(math.ceil((n - 1) / CHUNK) for n in BATCH_LENS),
                   "track_multi": math.ceil((MULTI_FRAMES - 1) / MULTI_CHUNK)}
    results, main_counts, roi_stats, staged, detections = {}, {}, {}, {}, {}
    for path, runs in paths.items():
        tk.reset_launches()  # counts to 0 just before the path, read just after
        dk.reset_launches()
        plain_runs["n"] = plain_runs["probe"] = 0
        for name, extra in runs.items():
            before, plain_before = tk.launches, plain_runs["n"]
            detect_before = dk.launches
            tiled_before = tk.launches_by_kernel["dog_scan_tiled"]
            bounded_before = bounded_by_kernel()
            crops_before, copies_before = roi_crop.native_calls, roi_crop.copy_calls
            stats_log.last = None
            t0 = time.perf_counter()
            out = entry[path](**extra)
            torch.cuda.synchronize()
            staged[path, name] = roi_crop.copy_calls - copies_before
            # the detection kernels' launches, as counted and as the call reports them
            detections[path, name] = (dk.launches - detect_before, (stats_log.last or {}).get(
                "counts", {}).get("detect.kernel_launches"))
            results[path, name] = (out, tk.launches - before, plain_runs["n"] - plain_before,
                                   time.perf_counter() - t0,
                                   tk.launches_by_kernel["dog_scan_tiled"] - tiled_before)
            if path in roi_paths:
                by_kernel = {k: n - bounded_before.get(k, 0)
                             for k, n in bounded_by_kernel().items()
                             if n > bounded_before.get(k, 0)}
                roi_stats[path, name] = dict(stats_log.last or {},
                                             bounded_launches=sum(by_kernel.values()),
                                             bounded_by_kernel=by_kernel,
                                             native_crops=roi_crop.native_calls - crops_before)
        main_counts[path] = {"total": tk.launches, "by_config": dict(tk.launches_by_config),
                             "by_kernel": dict(tk.launches_by_kernel),
                             "detect_launches": dict(dk.launches_by_kernel),
                             "plain_runs": plain_runs["n"], "probe_runs": plain_runs["probe"],
                             "probe_launches": dict(tk.probe_launches)}
    record["main_path_launches"] = main_counts

    phase2 = {}
    detected = global_detect_peaks(spec, 4)(torch.from_numpy(multi_np[0]).to(dev), 128)
    detected = [IJ(int(i), int(j)) for i, j in detected.cpu().numpy()]
    for path, runs in paths.items():
        kind = roi_paths.get(path, path)  # the entry point and clip of the path
        for name, extra in runs.items():
            t_checks = time.perf_counter()
            out, n_launch, n_plain, wall, n_tiled = results[path, name]
            sub = bool(extra.get("subpixel"))
            if kind == "track":
                videos = [(out, truth, frames_np, extra)]
            elif kind == "track large target":
                videos = [(out, large_truth, large_np, extra)]
            elif kind == "track_batch":
                videos = [(out[b], truths[b], clips[b],
                           dict(extra, start_location=extra["start_location"][b]))
                          for b in range(B)]
            else:
                starts = detected if "n_targets" in extra else multi_locs
                order = [int(np.argmin([abs(s.i - t[0][0]) + abs(s.j - t[0][1])
                                        for t in multi_truths])) for s in starts]
                ts_m, pos_m = out
                videos = [((ts_m, pos_m[:, n]), multi_truths[order[n]], multi_np,
                           dict(start_location=starts[n], subpixel=sub))
                          for n in range(len(starts))]
            errs, equal_single = [], True
            for (ts, ij), tru, frames, single_kw in videos:
                errs.append(rmse(ij, tru))
                if kind in ("track_batch", "track_multi"):  # each alone through track()
                    ts_1, ij_1 = track(frames, **base, **single_kw)
                    equal_single &= same(ij, ij_1, sub) and np.array_equal(ts, ts_1)
            equal_cpu, roi_ok, roi_note = None, True, ""
            if kind == "track large target":
                # the plain version at this window is slow on the host: the first
                # CPU_CHECK_FRAMES frames, against the same prefix of the card's run
                ts_c, ij_c = track(large_np[:CPU_CHECK_FRAMES],
                                   **(large if path == "track large target" else large_roi),
                                   **extra, device="cpu")
                equal_cpu = (same(out[1][:CPU_CHECK_FRAMES], ij_c, sub)
                             and np.array_equal(out[0][:CPU_CHECK_FRAMES], ts_c))
            elif kind == "track" or name in ("start_location", "start_locations"):
                cpu = entry[path](**extra, device="cpu")
                pairs = [(out, cpu)] if kind != "track_batch" else list(zip(out, cpu))
                equal_cpu = all(same(a[1], c[1], sub) and np.array_equal(a[0], c[0])
                                for a, c in pairs)
            if path in roi_paths:
                # ROI: the snap (two where a lane of the batch autodetects), then
                # one bounded launch per dispatched chunk (probe and replays
                # included); the same call on stream="full"
                st = roi_stats[path, name]
                want_n = (2 if "autodetect" in name and kind == "track_batch" else 1) \
                    + st.get("groups", -1)
                full = results[kind, name][0]
                pairs = [(out, full)] if kind != "track_batch" else list(zip(out, full))
                equal_full = all(same(a[1], f[1], sub) and np.array_equal(a[0], f[0])
                                 for a, f in pairs)
                # engine="auto": every bounded launch the kernel the engine choice
                # chose for the crop, and the positions of the shape rule's kernel
                want_kernel = chosen[roi_geoms[path] + (" +subpixel" if sub else "")]
                by_shape = entry[path](**extra, engine="pallas")
                pairs = [(out, by_shape)] if kind != "track_batch" else list(zip(out, by_shape))
                equal_pallas = all(same(a[1], f[1], sub) and np.array_equal(a[0], f[0])
                                   for a, f in pairs)
                st["equals_engine_pallas"] = equal_pallas
                # one launch a dispatch; the chunks' crops cut natively
                # (csrc/roi_crop.cpp)
                roi_ok = (st.get("stream") == "roi" and equal_full and equal_pallas
                          and st["bounded_launches"] == st.get("groups") == st.get("dispatches")
                          and list(st["bounded_by_kernel"]) == [want_kernel]
                          and st["native_crops"] > 0)
                roi_note = (f", stream={st.get('stream')} crop={st.get('crop')} K={st.get('K')}"
                            f" dispatches={st.get('dispatches')} (bounded launches"
                            f" {st['bounded_by_kernel']}, the chosen kernel {want_kernel})"
                            f" replays={st.get('replays')} depth={st.get('depth')}, native crop"
                            f" calls={st['native_crops']}, equals"
                            f" stream='full'={equal_full}, equals engine='pallas'={equal_pallas}")
            else:
                want_n = want_launches[path][name]
            n_copies = staged[path, name]
            # track_multi's autodetect: the response and all its rounds, two launches of
            # csrc/detect.cu, reported as detect.kernel_launches; every other call none
            n_detect, reported = detections[path, name]
            want_detect = 2 if "n_targets" in extra else 0
            detect_ok = n_detect == want_detect and reported == (2 if want_detect else None)
            ok = (n_launch == want_n and n_plain == 0 and max(errs) < 1.0 and equal_single
                  and equal_cpu is not False and roi_ok and detect_ok
                  and n_copies == want_copies.get(path, 0))
            if kind in ("track", "track large target"):
                ok = ok and len(out[1]) == N_FRAMES
            elif kind == "track_batch":
                ok = ok and [len(o[1]) for o in out] == list(BATCH_LENS)
            else:
                ok = ok and out[1].shape[:2] == (MULTI_FRAMES, B)
            if kind == "track large target":
                # every launch at the tracking window takes the shape rule's kernel
                # (dog_scan_tiled: the 105x105 window does not fit one CTA whole), the
                # autodetect snap dog_scan_tiled; on ROI the bounded launches the chosen
                # kernel (above)
                auto = int(name == "autodetect")
                bounded = roi_stats[path, name] if path in roi_paths else {}
                at_window = n_launch - auto - bounded.get("bounded_launches", 0)
                want_tiled = (auto + bounded.get("bounded_by_kernel", {}).get("dog_scan_tiled", 0)
                              + (at_window if large_kernel == "dog_scan_tiled" else 0))
                ok = ok and n_tiled == want_tiled
            phase2[f"{path} {name}"] = {"launches": n_launch, "want_launches": want_n,
                                        "detect_launches": n_detect,
                                        "reported_detect_launches": reported,
                                        "tiled_launches": n_tiled, "staged_copies": n_copies,
                                        "plain_runs": n_plain, "rmse_px": errs,
                                        "equals_single_track": equal_single,
                                        "equals_cpu_run": equal_cpu, "wall_s": wall, "ok": ok,
                                        **({"roi": roi_stats[path, name]}
                                           if path in roi_paths else {})}
            log(f"phase 2 {path}({name}): launches={n_launch} (want {want_n}, dog_scan_tiled"
                f" {n_tiled}), detection kernel launches={n_detect} (want {want_detect},"
                f" reported {reported}), plain runs={n_plain}, native staging copies={n_copies} (want"
                f" {want_copies.get(path, 0)}),"
                f" rmse max={max(errs):.4f} px over {len(errs)}, equals single track()="
                f"{equal_single}, equals device='cpu' run={equal_cpu}, {wall:.3f} s{roi_note}"
                f" (checks {time.perf_counter() - t_checks:.1f} s) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"phase 2 {path} {name} failed")
    record["phase2"] = phase2

    phase_done("phase 2, earlier paths")
    # the mesh: track_batch over each mesh, on full frames and on ROI, the same
    # three ways as track_batch; each equal to its mesh=None run above, with
    # one launch a data shard for each launch of that run, and no plain run
    mesh_paths = {}
    for label, mesh in meshes.items():
        for full_path, kw_stream in (("track_batch", base), ("track_batch ROI", roi)):
            path = f"{full_path} mesh={label}"
            mesh_paths[path] = full_path
            entry[path] = (lambda m, k0: lambda **k: track_batch(clips, mesh=m, **k0, **k))(
                mesh, kw_stream)
            shards = mesh.shape["data"]
            tk.reset_launches()  # counts to 0 just before the path, read just after
            plain_runs["n"] = 0
            for name, extra in paths["track_batch"].items():
                before, plain_before = tk.launches, plain_runs["n"]
                bounded_before = bounded_launches()
                stats_log.last = None
                t0 = time.perf_counter()
                out = entry[path](**extra)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n_launch, n_plain = tk.launches - before, plain_runs["n"] - plain_before
                st = stats_log.last or {}
                sub = bool(extra.get("subpixel"))
                want_out = results[full_path, name][0]
                equal = all(same(a[1], w[1], sub) and np.array_equal(a[0], w[0])
                            for a, w in zip(out, want_out))
                snaps = 2 if "autodetect" in name else 1
                if full_path == "track_batch ROI":
                    want_n = shards * (snaps + st.get("dispatches", -1))
                    counted = bounded_launches() - bounded_before == shards * st.get("dispatches")
                else:
                    want_n = shards * want_launches["track_batch"][name]
                    counted = True
                ok = (equal and n_launch == want_n and n_plain == 0 and counted
                      and st.get("shards") == shards
                      and [len(o[1]) for o in out] == list(BATCH_LENS))
                phase2[f"{path} {name}"] = {"launches": n_launch, "want_launches": want_n,
                                            "shards": shards, "plain_runs": n_plain,
                                            "equals_mesh_none": equal, "wall_s": wall,
                                            "stats": st, "ok": ok}
                log(f"phase 2 {path}({name}): {shards} shard(s), launches={n_launch} (want"
                    f" {want_n}), plain runs={n_plain}, stream={st.get('stream')},"
                    f" dispatches={st.get('dispatches')}, equals mesh=None={equal},"
                    f" {wall:.3f} s -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"phase 2 {path} {name} failed")
            main_counts[path] = {"total": tk.launches, "by_config": dict(tk.launches_by_config),
                                 "by_kernel": dict(tk.launches_by_kernel),
                                 "plain_runs": plain_runs["n"]}
    phase_done("phase 2, mesh")
    # track_resumable of the bench clip on ROI, in 4 slices of 120 frames:
    # each run equals track ROI's uninterrupted track() and launches, per
    # slice, its snap and one bounded launch a dispatch
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    resumable_kw = dict(roi, checkpoint_every=CHECKPOINT_EVERY)

    def run_resumable(cp, **k):
        if os.path.exists(cp):
            os.remove(cp)
        if k.pop("interrupt", False):
            track_resumable(frames_np, checkpoint_path=cp, start_location=start0, _max_slices=2,
                            **resumable_kw, **k)
            if load_checkpoint(cp)["done"]:
                raise SystemExit("phase 2 track_resumable: done after 2 of 4 slices")
            return track_resumable(frames_np, checkpoint_path=cp, **resumable_kw, **k)
        return track_resumable(frames_np, checkpoint_path=cp, start_location=start0,
                               **resumable_kw, **k)

    path = "track_resumable ROI"
    n_slices = math.ceil(N_FRAMES / (CHECKPOINT_EVERY * FPS))
    tk.reset_launches()  # counts to 0 just before the path, read just after
    plain_runs["n"] = 0
    for name, extra, want_name in (("interrupted and resumed", {"interrupt": True},
                                    "start_location"),
                                   ("uninterrupted", {}, "start_location"),
                                   ("subpixel", {"subpixel": True}, "subpixel")):
        cp = os.path.join(work.name, f"resumable {name}.npz")
        before, plain_before, bounded_before = tk.launches, plain_runs["n"], bounded_launches()
        stats_log.all.clear()
        t0 = time.perf_counter()
        ts_r, ij_r = run_resumable(cp, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch, n_plain = tk.launches - before, plain_runs["n"] - plain_before
        slices = list(stats_log.all)
        dispatches = sum(st.get("dispatches", 0) for st in slices)
        want_n = len(slices) + dispatches  # a snap each slice, a launch a dispatch
        sub = bool(extra.get("subpixel"))
        ts_t, ij_t = results["track ROI", want_name][0]
        equal = same(ij_r, ij_t, sub) and np.array_equal(ts_r, ts_t)
        done = bool(load_checkpoint(cp)["done"])
        ok = (equal and done and len(slices) == n_slices and n_launch == want_n and n_plain == 0
              and bounded_launches() - bounded_before == dispatches
              and all(st.get("stream") == "roi" for st in slices) and len(ij_r) == N_FRAMES)
        phase2[f"{path} {name}"] = {"launches": n_launch, "want_launches": want_n,
                                    "slices": len(slices), "dispatches": dispatches,
                                    "plain_runs": n_plain, "equals_track": equal,
                                    "checkpoint_done": done, "wall_s": wall, "ok": ok}
        log(f"phase 2 {path}({name}): {len(slices)} slices (want {n_slices}), launches={n_launch}"
            f" (want {want_n}: a snap a slice + {dispatches} dispatches, all bounded), plain"
            f" runs={n_plain}, equals track ROI's track()={equal}, checkpoint done={done},"
            f" {wall:.3f} s -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 2 {path} {name} failed")
    main_counts[path] = {"total": tk.launches, "by_config": dict(tk.launches_by_config),
                         "by_kernel": dict(tk.launches_by_kernel), "plain_runs": plain_runs["n"]}
    # track_resumable ROI from an on-grid start past 0 (frame RESUME_K0): each slice served as
    # views from its first frame on, against the same call forced down the resampler's walk
    # from frame 0 (ArrayFrameSource.views_allowed, a test hook); equal positions and ts
    served, runs_past0 = [], {}
    init = ArrayFrameSource.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        served.append(self.serves_views)

    ArrayFrameSource.__init__ = spy
    try:
        for way in ("views", "walk"):
            ArrayFrameSource.views_allowed = way == "views"
            served.clear()
            cp = os.path.join(work.name, f"resumable past 0 {way}.npz")
            t0 = time.perf_counter()
            runs_past0[way] = track_resumable(frames_np, checkpoint_path=cp,
                                              start=RESUME_K0 / FPS, start_location=IJ(
                                                  *map(int, truth[RESUME_K0])), **resumable_kw)
            torch.cuda.synchronize()
            runs_past0[way] += (time.perf_counter() - t0, list(served))
    finally:
        ArrayFrameSource.__init__ = init
        ArrayFrameSource.views_allowed = True
    (ts_v, ij_v, wall_v, served_v), (ts_w, ij_w, wall_w, served_w) = (runs_past0["views"],
                                                                       runs_past0["walk"])
    equal = np.array_equal(ij_v, ij_w) and np.array_equal(ts_v, ts_w)
    ok = (equal and len(ij_v) == N_FRAMES - RESUME_K0 and served_v and all(served_v)
          and not any(served_w))
    phase2[f"{path} from frame {RESUME_K0}"] = {
        "equals_walk": equal, "slices": len(served_v), "served_views": served_v,
        "walk_served_views": served_w, "wall_s": {"views": wall_v, "walk": wall_w}, "ok": ok}
    log(f"phase 2 {path}(from frame {RESUME_K0}, start={RESUME_K0 / FPS}): {len(served_v)} slices"
        f" served as views {served_v}, equal to the same call down the resampler's walk"
        f" ({len(served_w)} slices, views {served_w})={equal}, {len(ij_v)} frames; views"
        f" {wall_v:.3f} s, walk {wall_w:.3f} s -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"phase 2 {path} from frame {RESUME_K0} failed")

    # the CLI in fresh processes with no --device, so on the card: each loads
    # the kernel library that this process built from the build cache
    cli_files = {"single": os.path.join(work.name, "bench.npy"),
                 "batch 0": os.path.join(work.name, "batch0.npy"),
                 "batch 2": os.path.join(work.name, "batch2.npy")}
    cli_frames = {"single": frames_np[:CLI_FRAMES], "batch 0": clips[0][:CLI_FRAMES],
                  "batch 2": clips[2][:CLI_FRAMES]}  # both start in the autodetect window
    for k, f in cli_files.items():
        np.save(f, cli_frames[k])
    cli_kw = dict(fps=FPS, target_width=TARGET_WIDTH, window_size=WINDOW)
    common = ["--fps", str(FPS), "--target-width", str(TARGET_WIDTH), "--window-size",
              str(WINDOW), "--format", "json"]
    at = ["--start-ij", str(start0.i), str(start0.j)]

    def as_json(ts, ij):
        return {"ts": [float(t) for t in ts], "ij": [[int(a), int(b)] for a, b in ij]}

    batch_files = [cli_files["batch 0"], cli_files["batch 2"]]
    cli_modes = {  # name: (arguments, the in-process result as the CLI prints it)
        "single-file": ([cli_files["single"], *at, *common],
                        as_json(*track(cli_frames["single"], start_location=start0, **cli_kw))),
        "batch": ([*batch_files, "--batch", *common],
                  [dict(file=f, **as_json(*r)) for f, r in zip(batch_files, track_batch(
                      [cli_frames["batch 0"], cli_frames["batch 2"]], **cli_kw))]),
        "checkpoint": ([cli_files["single"], *at, *common, "--checkpoint",
                        os.path.join(work.name, "cli.npz")],
                       as_json(*track_resumable(cli_frames["single"], start_location=start0,
                                                checkpoint_path=os.path.join(work.name,
                                                                             "in-process.npz"),
                                                **cli_kw))),
    }
    env = dict(os.environ, PYTHONPATH=ROOT)
    cli_record = {}
    for name, (argv, want) in cli_modes.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "pawsometracker_tpu_torch", *argv], cwd=ROOT,
                           env=env, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        equal = r.returncode == 0 and json.loads(r.stdout) == want
        cli_record[name] = {"rc": r.returncode, "wall_s": wall, "equals_in_process": equal}
        log(f"phase 2 CLI({name}): python -m pawsometracker_tpu_torch exit {r.returncode},"
            f" equals the in-process result={equal}, {wall:.2f} s a process"
            f" -> {'ok' if equal else 'FAIL'}")
        if not equal:
            raise SystemExit(f"phase 2 CLI {name} failed:\n{r.stderr[-4000:]}")
    # the single-file command once more, through the CLI's main in a fresh
    # process with its parts timed and its launches counted (the path's counts)
    argv = cli_modes["single-file"][0]
    probe_code = "import sys, chip_smoke; sys.exit(chip_smoke.cli_probe(sys.argv[1:]))"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", probe_code, repr(time.time()), *argv], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise SystemExit(f"phase 2 CLI probe failed:\n{r.stderr[-4000:]}")
    probe = json.loads(r.stderr.strip().splitlines()[-1])
    dispatches = sum(st.get("dispatches", 0) for st in probe["stats"])
    want_n = len(probe["stats"]) + dispatches
    ok = (json.loads(r.stdout) == cli_modes["single-file"][1] and probe["cache_hit"]
          and probe["launches"] == want_n and probe["plain_runs"] == 0
          and [st.get("stream") for st in probe["stats"]] == ["roi"])
    probe.update(wall_s=wall, ok=ok)
    cli_record["probe"] = probe
    phase2["CLI"] = cli_record
    main_counts["CLI"] = {"total": probe["launches"], "by_config": probe["by_config"],
                          "by_kernel": probe["by_kernel"], "plain_runs": probe["plain_runs"]}
    log(f"phase 2 CLI(single-file, timed, in a fresh process): launches={probe['launches']}"
        f" (want {want_n}: the snap + {dispatches} dispatches), plain runs={probe['plain_runs']},"
        f" kernel library from the build cache={probe['cache_hit']}, output equals the"
        f" in-process track()={json.loads(r.stdout) == cli_modes['single-file'][1]}"
        f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 2 CLI probe failed")

    phase_done("phase 2, track_resumable and CLI")
    # ---- phase 3: timing ------------------------------------------------------
    cases["batched unbounded B=1"] = (lanes[:1], lane_pos0[:1], lane_fills[:1], kw, {}, False,
                                      True)
    cases["batched unbounded B=16"] = (lanes.repeat(4, 1, 1, 1), lane_pos0.repeat(4, 1),
                                       lane_fills.repeat(4), kw, {}, False, True)
    bnd1 = {k: v[:1] for k, v in bnd.items()}
    cases["unbounded T=1"] = (chunk[:1], pos0, fill, kw, {}, False, False)
    cases["bounded+subpixel T=1"] = (chunk[:1], pos0, fill, kw, bnd1, True, False)
    cases["batched unbounded B=4 T=1"] = (lanes[:, :1].contiguous(), lane_pos0, lane_fills, kw,
                                          {}, False, True)
    # dog_scan_tiled's chunk scans at the default windows of large targets, 64
    # frames made on the card, one lane and 4 lanes, unbounded and
    # bounded+subpixel (frame-sized boxes, as track(subpixel=True) gives)
    large_cases = []
    for tw in TILED_STEPS:
        tspec = make_spec((H, W), guess_window_size(tw), tw, True)
        tkw = dict(radii=tspec.radii, sigma=tspec.sigma, darker_target=True)
        tframes, tpaths = device_clips(CHUNK + 1, B, tw // 2, dev)
        tframes = tframes[:, 1:].contiguous()
        tstarts = torch.tensor(np.stack([tp[0] for tp in tpaths]), dtype=torch.int32, device=dev)
        box = {"deltas": torch.zeros((B, CHUNK, 2), dtype=torch.int32, device=dev),
               "lo": torch.zeros((B, CHUNK, 2), dtype=torch.int32, device=dev),
               "hi": torch.tensor([H - 1, W - 1], dtype=torch.int32,
                                  device=dev).expand(B, CHUNK, 2).contiguous()}
        for n_lanes in (1, B):
            for sub in (False, True):
                name = (f"tw={tw} T=64 {'bounded+subpixel' if sub else 'unbounded'}"
                        f" B={n_lanes}")
                if n_lanes == 1:  # one chain, as track() launches it
                    cases[name] = (tframes[0], tstarts[0], 128, tkw,
                                   {k: v[0] for k, v in box.items()} if sub else {}, sub, False)
                else:
                    cases[name] = (tframes, tstarts, lane_fills, tkw, box if sub else {}, sub,
                                   True)
                large_cases.append(name)
    timed = {  # name: (case, whether the plain version is timed too[, the kernel])
        "unbounded": ("unbounded", True),
        "bounded": ("bounded", True),
        "bounded+subpixel": ("bounded+subpixel", True),
        "snap quarter-frame": ("snap quarter-frame", True),
        "batched unbounded B=1": ("batched unbounded B=1", True),
        "batched unbounded B=4": ("batched unbounded", True),
        "batched unbounded B=16": ("batched unbounded B=16", False),
        "batched bounded B=4 (T=16)": ("batched bounded", True),
        "batched bounded+subpixel B=4 (T=16)": ("batched bounded+subpixel", True),
        "batched shared frames (4 targets)": ("batched shared frames (4 targets)", False),
        "unbounded T=1": ("unbounded T=1", True),
        "bounded+subpixel T=1": ("bounded+subpixel T=1", True),
        "batched unbounded B=4 T=1": ("batched unbounded B=4 T=1", True),
        "batched snap quarter-frame B=4": ("batched snap quarter-frame", True),
        # the large targets' chunk scans on each kernel that takes their window;
        # the plain version at the large-target path's shape only (~60 ms a step)
        **{f"{n} [{kn}]": (n, kn == large_kernel and n == f"tw={LARGE_TW} T=64 unbounded B=1",
                           kn)
           for n in large_cases for kn in tk.kernels_for(cases[n][3]["radii"],
                                                         taps_of(cases[n][3]), smem_limit)},
        # the ROI pipeline's chunk scans at its crops, as phase 1 checked them
        **{n: (n, True) for n in roi_cases},
    }
    timing = {}
    for name, (case, with_plain, *kname) in timed.items():
        fr, p0, fl, k, b, sub, batched = cases[case]
        kname = kname[0] if kname else kernel_of(case)
        n_lanes = int(p0.shape[0]) if batched else 1
        steps = int(fr.shape[-3])
        ms = cuda_time_ms(lambda: run_kernel(case, kname), reps=20 if steps > 1 else 200)
        plain_ms = (cuda_time_ms(lambda: run_plain(case), reps=1, warmup=int(case not in large_cases))
                    if with_plain else None)
        case_L = tk._taps(k["sigma"], True, dev)[2]
        c = cost(k["radii"], case_L, steps, sub, bool(b), lanes=n_lanes)
        timing[name] = {"kernel": kname, "config": tk._config_name(bool(b), sub, batched),
                        "T": steps, "lanes": n_lanes, "L": case_L, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": None,
                        **c, "us_per_step": 1e3 * ms / steps, "sm_bound_share": c["sm_bound_ms"] / ms,
                        "card_bound_share": c["bound_ms"] / ms}
        where = ""
        if kname == "dog_scan":  # a chain runs on its cluster's C SMs
            plan = tk._scan_plan(k["radii"], case_L, smem_limit, n_lanes, 0)
            timing[name].update(cluster=plan.cluster, slots=plan.slots, threads=plan.threads,
                                cluster_bound_ms=c["sm_bound_ms"] / plan.cluster,
                                cluster_bound_share=c["sm_bound_ms"] / plan.cluster / ms)
            where = (f"; its cluster of {plan.cluster} SMs {c['sm_bound_ms'] / plan.cluster:.4f}"
                     f" ms ({100 * c['sm_bound_ms'] / plan.cluster / ms:.1f}% of it reached,"
                     f" {plan.slots} row block(s) and {plan.threads} threads a CTA); PR 10 "
                     + (f"{PR10_MS[name]:.4f} ms" if name in PR10_MS else "not measured"))
        if kname == "dog_scan_tiled":  # a chain runs on its cluster's C SMs
            plan = tk._tiled_plan(k["radii"], case_L, smem_limit, sub, 0)
            timing[name].update(cluster=plan.cluster, tile=list(plan.tile), work=plan.work,
                                cluster_bound_ms=c["sm_bound_ms"] / plan.cluster,
                                cluster_bound_share=c["sm_bound_ms"] / plan.cluster / ms)
            where = (f"; its cluster of {plan.cluster} SMs {c['sm_bound_ms'] / plan.cluster:.4f}"
                     f" ms ({100 * c['sm_bound_ms'] / plan.cluster / ms:.1f}% of it reached,"
                     f" tiles {plan.tile[0]}x{plan.tile[1]}, work {plan.work:.3f}x the direct taps);"
                     f" {pr11(name)}")
        log(f"phase 3 {name} ({kname}): T={steps} lanes={n_lanes} kernel {ms:.4f}"
            f" ms/launch ({1e3 * ms / steps:.2f} us/step), plain "
            + (f"{plain_ms:.3f} ms" if plain_ms is not None else "not measured")
            + f", bound {c['bound_ms']:.6f} ms ({c['bound_by']}, {100 * c['bound_ms'] / ms:.2f}%"
            f" of it reached), one chain on one SM {c['sm_bound_ms']:.4f} ms"
            f" ({100 * c['sm_bound_ms'] / ms:.1f}%){where}")
    # dog_scan under each forced cluster size at the bench chunk and the
    # 185x185 crop's chunk scans, beside the card's own pick (timed above)
    cluster_sweep = {}
    for case in ("unbounded", f"ROI 185x185 T={ROI_K} bounded",
                 f"ROI batch 185x185 B={B} T={ROI_K} bounded (lane 2 fill)"):
        row = {}
        for cl in scan_clusters(cases[case][3]):
            tk.scan_cluster = cl
            try:
                row[cl] = cuda_time_ms(lambda: run_kernel(case, "dog_scan"), reps=20)
            finally:
                tk.scan_cluster = None
        cluster_sweep[case] = row
        log(f"phase 3 dog_scan {case} under forced cluster sizes: "
            + ", ".join(f"C={cl} {v:.4f} ms" for cl, v in row.items())
            + f"; the card's pick C={timing[case]['cluster']} {timing[case]['ms']:.4f} ms")
    record["dog_scan_cluster_sweep"] = cluster_sweep
    # what one ROI launch costs the host: the wrapper's checks, the taps and
    # plan lookups, the output allocation and the ctypes call
    wrapper_us = {n: host_us_per_launch(lambda n=n: run_kernel(n)) for n in roi_cases}
    record["wrapper_host_us_per_launch"] = wrapper_us
    for n, us in wrapper_us.items():
        log(f"phase 3 wrapper host time, {n}: {us:.1f} us a launch (card asleep, launches queued)")
    # sharded_pallas_bounded a call: one launch a data shard, in turn on the
    # host; shards on cuda:0 queue on its one stream, so their times add. Card
    # time by CUDA events where every shard is on cuda:0 (else not measured);
    # wall time a call with every card synchronised; the wrapper's host time
    sharded_timing = {}
    for name, (rspec, mesh, sub, case) in sharded_cases.items():
        fr, p0, fl, _, b, _, _ = cases[case]
        fn = sharded_pallas_bounded(rspec, mesh, subpixel=sub)
        one_card = all(d == dev for d in mesh.data_devices())
        bnds = (b["deltas"], b["lo"], b["hi"])
        ms = cuda_time_ms(lambda: fn(fr, p0, fl, *bnds), reps=20) if one_card else None
        n_calls = 50
        for d in set(mesh.data_devices()):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn(fr, p0, fl, *bnds)
        for d in set(mesh.data_devices()):
            torch.cuda.synchronize(d)
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_calls
        host_us = host_us_per_launch(lambda: fn(fr, p0, fl, *bnds), n=50)
        shards = mesh.shape["data"]
        sharded_timing[name] = {"kernel": kernel_of(case), "case": case, "shards": shards,
                                "ms": ms, "wall_ms": wall_ms, "host_us_per_call": host_us,
                                "unsharded_ms": timing[case]["ms"],
                                "bound_ms": timing[case]["bound_ms"],
                                "bound_by": timing[case]["bound_by"]}
        log(f"phase 3 {name}: {shards} shard(s), card "
            + (f"{ms:.4f} ms a call" if ms is not None else "time not measured (two cards)")
            + f", wall {wall_ms:.4f} ms a call (every card synchronised), host"
            f" {host_us:.1f} us a call; one unsharded B={B} launch {timing[case]['ms']:.4f} ms,"
            f" bound {timing[case]['bound_ms']:.6f} ms ({timing[case]['bound_by']})")
    record["sharded_pallas_bounded"] = sharded_timing
    # segmented launches: card ms at S = 1, 2 and 4 beside S
    # times the S = 1 launch, at the ROI crops (one chain by the ks rule; 4
    # lanes with the carry in the launch) and at the 1080p 64-frame chunk; the
    # plain version at S = 2; the wrapper's host time a launch
    seg_timed = {}
    for seg_base in [n.rsplit(" S=", 1)[0] for n in seg_cases if n.endswith(" S=2")]:
        kind, d, skw, _, _ = seg_cases[f"{seg_base} S=2"]
        for S in (1, 2, 4):
            seg_cases[f"{seg_base} S={S}"] = (kind, d, skw, S, False)
            seg_timed[f"{seg_base} S={S}"] = seg_base
    seg_timing = {}
    for name, seg_base in seg_timed.items():
        kind, d, skw, S, sub = seg_cases[name]
        steps = CHUNK if kind == "full" else ROI_K
        n_lanes = B if kind == "carry" else 1
        ms = cuda_time_ms(lambda: run_segments(name), reps=20)
        plain_ms = cuda_time_ms(lambda: run_segments(name, plain=True), reps=1, warmup=0) \
            if S == 2 else None
        host_us = host_us_per_launch(lambda: run_segments(name), n=100)
        case_L = tk._taps(skw["sigma"], True, dev)[2]
        c = cost(skw["radii"], case_L, S * steps, sub, kind != "full", lanes=n_lanes)
        one = seg_timing.get(f"{seg_base} S=1", {}).get("ms", ms)
        seg_timing[name] = timing[name] = {
            "kernel": seg_kernel(name),
            "config": tk._config_name(kind != "full", sub, kind == "carry", segmented=True),
            "T": steps, "segments": S, "lanes": n_lanes, "L": case_L, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, **c,
            "us_per_step": 1e3 * ms / (S * steps), "sm_bound_share": c["sm_bound_ms"] / ms,
            "card_bound_share": c["bound_ms"] / ms, "ms_per_segment": ms / S,
            "s_times_one_ms": S * one, "ratio_to_s_times_one": ms / (S * one),
            "host_us_per_launch": host_us}
        log(f"phase 3 {name} ({seg_kernel(name)}): {S} segments of T={steps}, lanes={n_lanes}:"
            f" kernel {ms:.4f} ms/launch ({ms / S:.4f} ms a segment; S x the S=1 launch"
            f" {S * one:.4f} ms, ratio {ms / (S * one):.4f}), plain "
            + (f"{plain_ms:.3f} ms" if plain_ms is not None else "not measured")
            + f", bound {c['bound_ms']:.6f} ms ({c['bound_by']}), host {host_us:.1f} us a launch"
            + (f"; PR 10 {PR10_MS[name]:.4f} ms" if seg_kernel(name) == "dog_scan"
               and name in PR10_MS else "")
            + (f"; {pr11(name)}" if seg_kernel(name) == "dog_scan_tiled" else ""))
    record["segmented"] = seg_timing
    for name in ("batched unbounded B=16", "unbounded T=1", "bounded+subpixel T=1",
                 "batched unbounded B=4 T=1", *large_cases):
        del cases[name]
    del tframes, box
    # the library yardstick of a snap's response: one cuDNN conv2d of the
    # window's patch (one per lane) with the 2-D DoG kernel (TF32 off), then
    # argmax. Two calls, and not bit-equal to the kernel (cuDNN sums in its
    # own order)
    def library_snap(sp, frames, centres):
        k2d, kl = dog_kernel_2d(sp.sigma, True)
        pi_, pj_ = sp.radii[0] + kl // 2, sp.radii[1] + kl // 2
        patches = torch.stack([f[i - pi_:i + pi_ + 1, j - pj_:j + pj_ + 1]
                               for f, (i, j) in zip(frames, centres)]).float()[:, None]
        weight = torch.from_numpy(k2d).to(dev)[None, None]

        def run():
            return torch.nn.functional.conv2d(patches, weight).flatten(1).argmax(1)

        ms = cuda_time_ms(run, reps=20)
        k, (i, j) = int(run()[0]), centres[0]
        ww = 2 * sp.radii[1] + 1
        return ms, [i - sp.radii[0] + k // ww, j - sp.radii[1] + k % ww]

    ci, cj = int(centre[0]), int(centre[1])
    library_ms, lib_ij = library_snap(aspec, frame0, [(ci, cj)])
    kernel_ij = tk.dog_scan_cuda(frame0, centre, fill, **kwa)[0].cpu().numpy()
    record["snap_library"] = {"ms": library_ms, "call": "torch.nn.functional.conv2d + argmax",
                              "argmax_ij": lib_ij, "kernel_ij": kernel_ij.tolist()}
    log(f"phase 3 snap library yardstick (cuDNN conv2d with the 2-D DoG kernel, TF32 off, +"
        f" argmax; two calls, not bit-equal): {library_ms:.4f} ms, its maximum at {lib_ij}"
        f" (the kernel's: {kernel_ij.tolist()})")
    lane_centres = [tuple(int(v) for v in p) for p in lane_pos0.cpu().numpy()]
    yardsticks = {
        "snap quarter-frame": library_ms,
        "batched snap quarter-frame B=4": library_snap(aspec, lanes0[:, 0], [(ci, cj)] * B)[0],
        "unbounded T=1": library_snap(spec, chunk[:1], [tuple(int(v) for v in truth[0])])[0],
        "batched unbounded B=4 T=1": library_snap(spec, lanes[:, 0], lane_centres)[0],
    }
    yardsticks["bounded+subpixel T=1"] = yardsticks["unbounded T=1"]
    for name, ms in yardsticks.items():
        timing[name]["library_ms"] = ms
        log(f"phase 3 library yardstick of {name} (conv2d + argmax, one call for"
            f" {timing[name]['lanes']} lane(s)): {ms:.4f} ms against the kernel's"
            f" {timing[name]['ms']:.4f} ms")
    record["timing"] = timing

    e2e = {}
    for path, frames_per_call, extra in (
            ("track", N_FRAMES, paths["track"]["start_location"]),
            ("track_batch", sum(BATCH_LENS), paths["track_batch"]["start_location"]),
            ("track_multi", MULTI_FRAMES, paths["track_multi"]["start_locations"]),
            ("track large target", N_FRAMES, paths["track large target"]["start_location"]),
            ("track ROI", N_FRAMES, paths["track ROI"]["start_location"]),
            ("track large target ROI", N_FRAMES, paths["track ROI"]["start_location"]),
            ("track_batch ROI", sum(BATCH_LENS), paths["track_batch"]["start_location"]),
            ("track_multi ROI", MULTI_FRAMES, paths["track_multi"]["start_locations"]),
            *((p, sum(BATCH_LENS), paths["track_batch"]["start_location"])
              for p in mesh_paths)):
        walls, runs_stats = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            stats_log.last = None
            t0 = time.perf_counter()
            entry[path](**extra)
            walls.append(time.perf_counter() - t0)
            runs_stats.append(stats_log.last)
        e2e[path] = {"frames_per_s": frames_per_call / statistics.median(walls),
                     "runs_s": walls, "frames": frames_per_call}
        note = ""
        med = sorted(range(3), key=walls.__getitem__)[1]
        st = runs_stats[med]
        if st is not None:
            # the call's own accounting of its median run: the timer sections
            # and the wall outside them
            sec = dict(st["sections"])
            sec["outside the sections"] = walls[med] - sum(sec.values())
            e2e[path]["stats"] = st
            e2e[path]["ms_per_call"] = {k: 1e3 * v for k, v in sec.items()}
            note = "; median run, ms a call: " + ", ".join(f"{k} {1e3 * v:.2f}"
                                                           for k, v in sec.items())
            if "dispatches" in st:
                n_disp = st["dispatches"]
                per = {k: 1e6 * v / n_disp for k, v in sec.items()
                       if k not in ("setup", "snap", "buffers")}  # once a call
                e2e[path]["host_us_per_dispatch"] = per
                note += (f"; {n_disp} dispatches, {st['replays']} replays, depth {st['depth']}"
                         f" at the end, crop {st['crop']}, K={st['K']}; us a dispatch: "
                         + ", ".join(f"{k} {v:.1f}" for k, v in per.items()))
        kind = mesh_paths.get(path, path)
        kind = roi_paths.get(kind, kind)
        log(f"phase 3 e2e {path}: {e2e[path]['frames_per_s']:.1f} frames/s (median of"
            f" {len(walls)}, {frames_per_call} frames of {W}x{H}"
            + (", summed over 4 videos)" if kind == "track_batch" else
               ", clip frames with 4 targets)" if kind == "track_multi" else ")") + note)
    # the ROI path's host work a chunk and a call, by cell: the crops (native
    # against numpy), the launch (the scan the engines stage once over a device
    # slot, against the public wrapper the engines called before: its checks,
    # conversions and repacking), and from the e2e runs above the set-up a
    # call and the time outside the sections a chunk
    host_path = {}
    geoms = {"track ROI": (spec, f"ROI 185x185 T={ROI_K} bounded"),
             "track large target ROI": (lspec, f"ROI 461x461 T={ROI_K} bounded"),
             "track_batch ROI": (spec, f"ROI batch 185x185 B={B} T={ROI_K} bounded (lane 2 fill)"),
             "track_multi ROI": (spec, f"ROI multi 185x185 {B} targets of one stream T={ROI_K}"
                                       " bounded")}
    crop_inputs = {"track ROI": ([frames_np], [truth], [fill]),
                   "track large target ROI": ([large_np], [large_truth], [fill]),
                   "track_batch ROI": (clips, truths, BATCH_FILLS),
                   "track_multi ROI": ([multi_np] * B, multi_truths, [128] * B)}
    for cell, (cspec, case) in geoms.items():
        crops, p0, fl, _, bnd, _, batched = cases[case]
        ch, cw, margin = roi_geometry(cspec, ROI_K, 7, "predict")
        crop_us, crop_threads = crop_timing(roi_crop, *crop_inputs[cell], ch, margin)
        rspec = make_spec((ch, cw), cspec.window_size, cspec.target_width, True)
        fns = dog_tracker.tracker_fns(rspec, dev, "pallas")
        if batched:
            eng = pl._BatchedEngine(fns.scan_bounded_batch, (ch, cw), (H, W), fl.cpu().numpy(),
                                    False, None, dev,
                                    segments=functools.partial(fns.scan_bounded_batch_super,
                                                               subpixel=False))
        else:
            eng = pl._SingleEngine(fns.scan_bounded, (ch, cw), (H, W), fl, False, None, dev,
                                   segments=fns.scan_bounded_super)
        group = eng._new_group(ROI_K)
        group.frames[0][0].copy_(crops if batched else crops[None])
        if batched:  # the carry starts each lane at its position, as the chain does
            a = pl._batch_args(group.args[0], B, ROI_K)
            for k in ("deltas", "lo", "hi"):
                a._asdict()[k][0].copy_(bnd[k])
            a.ks.fill_(ROI_K)
            a.origin0.zero_()
            a.origin_last.zero_()
            carries = [p0.clone() for _ in range(2)]
            staged = functools.partial(group.staged[0].run, 1, carry=carries[0],
                                       carry_out=carries[0])
            public = functools.partial(fns.scan_bounded_batch_super, group.frames[0][:1],
                                       carries[1], eng.fills[0], a.deltas[:1], a.lo[:1],
                                       a.hi[:1], a.ks[:1], a.origin0[:1], a.origin_last[:1],
                                       carry_out=carries[1])
            got, want = staged().clone(), public()[0]
        else:
            a = pl._single_args(group.args[0], ROI_K)
            for k in ("deltas", "lo", "hi"):
                a._asdict()[k][0].copy_(bnd[k])
            a.ks.fill_(ROI_K)
            staged = functools.partial(group.staged[0].run, 1, pos0=p0)
            public = functools.partial(fns.scan_bounded, group.frames[0][0, 0], p0, fill,
                                       a.deltas[0], a.lo[0], a.hi[0])
            got, want = staged()[0].clone(), public()
        if not torch.equal(got, want):
            raise SystemExit(f"phase 3 {cell}: the staged launch differs from the public wrapper")
        launch_us = {"staged": host_us_per_launch(staged),
                     "public wrapper": host_us_per_launch(public)}
        run = e2e[cell]
        per = run.get("host_us_per_dispatch", {})
        host_path[cell] = {"crop_us_per_chunk": crop_us, "crop_threads": crop_threads,
                           "launch_host_us": launch_us,
                           "setup_ms_per_call": run.get("ms_per_call", {}).get("setup"),
                           "us_per_chunk": per, "frames_per_s": run["frames_per_s"]}
        log(f"phase 3 host path {cell} ({ch}x{cw}, {eng.lanes[0]} lane(s),"
            f" {group.staged[0].kernel}): set-up"
            f" {host_path[cell]['setup_ms_per_call'] or float('nan'):.2f} ms a call; us a chunk:"
            f" outside {per.get('outside the sections', float('nan')):.1f}, crop"
            f" {per.get('crop', float('nan')):.1f}, device {per.get('device', float('nan')):.1f},"
            f" upload {per.get('upload', float('nan')):.1f}; the chunk's crops alone: native"
            f" {crop_us['native']:.1f} us on {crop_threads} thread(s), numpy"
            f" {crop_us['numpy']:.1f} us (equal); a launch's host time: staged"
            f" {launch_us['staged']:.1f} us, the public wrapper {launch_us['public wrapper']:.1f}"
            f" us; {run['frames_per_s']:.1f} frames/s")
        eng.close()
    record["host_path"] = host_path
    if parent is not None:  # before/after against another checkout, in turns
        r = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "host_path_ab.py"),
                            "--parent", parent], capture_output=True, text=True, timeout=900)
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines:
            raise SystemExit(f"phase 3: tools/host_path_ab.py failed ({r.returncode}):"
                             f" {r.stderr[-2000:]}")
        for line in lines[:-1]:
            log(f"phase 3 host path A/B: {line}")
        record["host_path_ab"] = json.loads(lines[-1])
        log(f"phase 3 host path before/after (parent, change, change, parent): {lines[-1]}")
    # track_resumable on ROI over its 4 slices, beside track ROI in this call:
    # the gap is each slice's set-up (its frame 1 and that frame's mode) and snap
    walls, runs_slices = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        stats_log.all.clear()
        t0 = time.perf_counter()
        run_resumable(os.path.join(work.name, "timed.npz"))
        walls.append(time.perf_counter() - t0)
        runs_slices.append(list(stats_log.all))
    med = sorted(range(3), key=walls.__getitem__)[1]
    per_slice = {sec: [1e3 * st["sections"].get(sec, 0.0) for st in runs_slices[med]]
                 for sec in ("setup", "snap")}
    e2e["track_resumable ROI"] = {"frames_per_s": N_FRAMES / statistics.median(walls),
                                  "runs_s": walls, "frames": N_FRAMES,
                                  "slices": len(runs_slices[med]), "ms_per_slice": per_slice}
    log(f"phase 3 e2e track_resumable ROI: {e2e['track_resumable ROI']['frames_per_s']:.1f}"
        f" frames/s (median of {len(walls)}, {N_FRAMES} frames of {W}x{H} in"
        f" {len(runs_slices[med])} slices), against track ROI's"
        f" {e2e['track ROI']['frames_per_s']:.1f} in this call; median run, ms a slice: setup "
        + ", ".join(f"{v:.2f}" for v in per_slice["setup"]) + "; snap "
        + ", ".join(f"{v:.2f}" for v in per_slice["snap"]))
    record["e2e_fps"] = e2e
    # the CLI's wall time a process: the three modes, and the parts of the
    # timed single-file process
    pr = cli_record["probe"]
    parts = {"process start": pr["process_start_s"], "imports": pr["imports_s"],
             "CUDA initialisation": pr["cuda_init_s"], "kernel library load": pr["library_load_s"],
             "CLI main (load the .npy, track, print)": pr["main_s"]}
    parts["the rest (interpreter exit)"] = pr["wall_s"] - sum(parts.values())
    record["cli"] = cli_record
    log("phase 3 CLI wall a process: "
        + ", ".join(f"{n} {cli_record[n]['wall_s']:.2f} s" for n in cli_modes)
        + f"; the timed single-file process {pr['wall_s']:.2f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f" (the library {'from the build cache' if pr['cache_hit'] else 'built'})")
    # where one full-frame chunk's time goes: the staging copy of a view into a pinned
    # buffer, by the kept route (the native copy, on the prefetch thread in the pipeline) and
    # by numpy's (the route before it), the host-to-device copy, the kernel (above); each
    # copy of the next chunk of the clip, in turns, so that its frames come from memory
    pinned = torch.empty((CHUNK, H, W), dtype=torch.uint8, pin_memory=True)
    copies = {"native": lambda src: roi_crop.copy_frames_native(src, pinned.numpy()),
              "numpy": lambda src: np.copyto(pinned.numpy(), src)}
    copy_ms = {k: [] for k in copies}
    for i in range(6):
        for name, fn in copies.items():
            src = frames_np[1 + CHUNK * (i % 6):1 + CHUNK * (i % 6 + 1)]
            t0 = time.perf_counter()
            fn(src)
            copy_ms[name].append(1e3 * (time.perf_counter() - t0))
    host_ms = {k: statistics.median(v) for k, v in copy_ms.items()}
    h2d_ms = cuda_time_ms(lambda: chunk.copy_(pinned, non_blocking=True), reps=5)
    record["staging_per_chunk_ms"] = {"native_copy": host_ms["native"],
                                      "numpy_copy": host_ms["numpy"], "h2d": h2d_ms,
                                      "kernel": timing["unbounded"]["ms"], "frames": CHUNK,
                                      "copy_threads": roi_crop.crop_threads(CHUNK * H * W)}
    log(f"phase 3 per {CHUNK}-frame chunk: the staging copy into pinned memory, native"
        f" {host_ms['native']:.2f} ms on {roi_crop.crop_threads(CHUNK * H * W)} threads (the"
        f" kept route, on the prefetch thread), numpy {host_ms['numpy']:.2f} ms (the route"
        f" before it), medians of 6 in turns; host-to-device {h2d_ms:.2f} ms, kernel"
        f" {timing['unbounded']['ms']:.2f} ms")
    record["profile"] = {}
    for path, extra in (("track", paths["track"]["start_location"]),
                        ("track_batch", paths["track_batch"]["start_location"]),
                        ("track_multi", paths["track_multi"]["start_locations"]),
                        ("track large target", paths["track large target"]["start_location"]),
                        ("track ROI", paths["track ROI"]["start_location"]),
                        ("track large target ROI", paths["track ROI"]["start_location"]),
                        ("track_batch ROI", paths["track_batch"]["start_location"]),
                        ("track_multi ROI", paths["track_multi"]["start_locations"]),
                        *((p, paths["track_batch"]["start_location"]) for p in mesh_paths
                          if p.startswith("track_batch ROI"))):
        record["profile"][path] = profile_busy(lambda: entry[path](**extra))
        log_profile(f"{path}()", record["profile"][path])

    # the detection kernels a launch at the plate cell's shape (1080p, L = 33, N = 96) beside
    # their plain versions on the same card tensors (whose card time holds the gaps while the
    # host issues their launches), each with its bound; and one whole detection, frame on the
    # card to peaks on the host, by the host clock, kernels against the plain torch ops
    pL = pspec.kernel_len
    D = dk.disc_reach(plate_r2, max(H, W))
    detect_timing = {}

    def response_launch():
        return dk.frame_response(plate_dev[None], [plate_fill], pspec.sigma, True)

    def response_plain():
        return dk.correlate_plain(dk.pad_plain(plate_dev[None], [plate_fill], pL), pspec.sigma,
                                  True)

    detect_timing["detect_response"] = dict(
        case=f"1080p L={pL}", ms=cuda_time_ms(response_launch, reps=50),
        plain_ms=cuda_time_ms(response_plain, reps=1, warmup=0),
        **detect_response_cost(H, W, pL))
    reps = 20
    for n in (PLATE_N, 1, 24, 400):
        # each launch on its own copy of the response and partials: the rounds overwrite both
        copies = iter([(plate_resp[0].clone(), plate_part[0].clone()) for _ in range(reps + 2)])
        ms = cuda_time_ms(lambda: dk.suppress(*next(copies), n, plate_r2), reps=reps)
        del copies
        name = "detect_rounds" if n == PLATE_N else f"detect_rounds N={n}"
        detect_timing[name] = dict(case=f"1080p N={n} r2={plate_r2:g} D={D}", ms=ms,
                                   **detect_rounds_cost(H, W, n, plate_r2, D))
    detect_timing["detect_rounds"]["plain_ms"] = cuda_time_ms(
        lambda: dk.suppress_plain(plate_resp[0].clone(), PLATE_N, plate_r2), reps=1, warmup=0)
    for name, t in detect_timing.items():
        log(f"phase 3 {name} {t['case']}: {t['ms']:.4f} ms a launch"
            + (f", plain {t['plain_ms']:.3f} ms" if "plain_ms" in t else "")
            + f", bound {t['bound_ms']:.6f} ms ({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.2f}%"
            f" of it reached)")
    detect = global_detect_peaks(pspec, PLATE_N)

    def plain_detection():
        return dk.suppress_plain(response_plain()[0], PLATE_N, plate_r2).cpu()

    host_ms = {}
    for label, fn, n_runs in (("kernels", lambda: detect(plate_dev, plate_fill).cpu(), 20),
                              ("plain", plain_detection, 3)):
        runs = []
        for _ in range(n_runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs.append(1e3 * (time.perf_counter() - t0))
        host_ms[label] = runs
    record["detect_timing"] = detect_timing
    record["detection_host_ms"] = host_ms
    log(f"phase 3 one {PLATE_N}-peak detection at 1080p, frame on the card to peaks on the host:"
        f" kernels median {statistics.median(host_ms['kernels']):.3f} ms, plain torch ops median"
        f" {statistics.median(host_ms['plain']):.2f} ms")

    # ---- the record -------------------------------------------------------------
    by_config: dict = {}
    for counts in main_counts.values():
        for cfg, n in counts["by_config"].items():
            by_config[cfg] = by_config.get(cfg, 0) + n
    total = sum(c["total"] for c in main_counts.values())
    log(f"kernels: configurations and main-path launches: {json.dumps(by_config)}"
        f" (total {total}); phase 1 checked {', '.join(phase1)}")
    # each kernel with its headline case: the bench shape's 64-step chunk scan,
    # and the quarter-frame snap (the one shape of dog_scan_tiled on every
    # autodetected path; it also takes every launch of the large-target path,
    # timed in its configs)
    headline = {"dog_scan": "unbounded", "dog_scan_tiled": "snap quarter-frame"}
    library = {"dog_scan": None, "dog_scan_tiled": library_ms}
    kernels = []
    for kname, case in headline.items():
        main = timing[case]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "pawsometracker_tpu_torch/csrc/dog_scan.cu",
            "replaces": "pawsometracker_tpu/ops/pallas_tracker.py:342",
            "launches": sum(c["by_kernel"].get(kname, 0) for c in main_counts.values()),
            "max_abs_err": max(v["max_abs_err"] for v in phase1.values()
                               if v["kernel"] == kname),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": library[kname],
            "launches_by_config": {c: n for c, n in by_config.items()
                                   if c.startswith(kname + ":")},
            "launches_by_path": {p: c["by_kernel"].get(kname, 0) for p, c in main_counts.items()},
            # the mesh paths count one launch a data shard; sharded_pallas_bounded,
            # the launch wrapper over the mesh, with its shards' times
            "sharded_pallas_bounded": {n: t for n, t in sharded_timing.items()
                                       if t["kernel"] == kname},
            # the segmented launches at S = 1, 2, 4
            "segmented": {n: t for n, t in seg_timing.items() if t["kernel"] == kname},
            # the kernel's timed cases, each with its configuration's launches
            # on the main paths
            "configs": [{"case": n, "launches": by_config.get(f"{kname}: {t['config']}", 0),
                         **{k: v for k, v in t.items() if k not in ("flops", "bytes", "kernel")}}
                        for n, t in timing.items() if t["kernel"] == kname],
        })
    for kname in ("detect_response", "detect_rounds"):
        t = detect_timing[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "pawsometracker_tpu_torch/csrc/detect.cu",
            "replaces": "pawsometracker_tpu/parallel/mesh.py (XLA, no Pallas kernel)",
            "launches": sum(c.get("detect_launches", {}).get(kname, 0)
                            for c in main_counts.values()),
            "max_abs_err": max(v["max_abs_err"] for v in phase1.values()
                               if v["kernel"] == kname),
            "case": t["case"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "launches_by_path": {p: c.get("detect_launches", {}).get(kname, 0)
                                 for p, c in main_counts.items()},
            "configs": [dict(tc, name=n) for n, tc in detect_timing.items()
                        if n.startswith(kname + " ")],
        })
    line = {"kernels": kernels}
    record["kernels"] = kernels
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    for path, counts in main_counts.items():
        if counts["total"] <= 0:
            raise SystemExit(f"the {path} path launched no kernel")
    for k in kernels:
        if k["launches"] <= 0:
            raise SystemExit(f"the main paths never launched {k['name']}")
    phase_done("phase 3")
    record["phase_wall_s"] = phase_wall
    log(f"chip_smoke wall: {time.perf_counter() - wall_start:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in phase_wall.items()) + ")")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
