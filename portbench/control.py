"""The control of the benchmark's comparison: the reference in TF32.

The tracker's configuration states float32 sums of direct taps with no TF32
(``arithmetic`` in each configuration file). The nearest precision below it,
and the step a faster version would be tempted by, is TF32: the same two
separable passes as matrix products on the tensor cores, whose inputs keep
10 bits of mantissa. :class:`TF32Windows` computes each window's response so
(banded matrix products, inputs rounded to TF32, float32 sums) and takes its
column-major first maximum; put in the program's place, it must come out not
correct. Run on the card at a cell's own size:

    python3 portbench/control.py --workload track-roi-1080 --seeds 1,2,3

prints, for each seed, the verdict of the benchmark's own comparison
(``harness.compare``) on the control's answers, with the numbers it compared
beside their limits. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import frames, harness  # noqa: E402
from portbench.reference import tracker as reference  # noqa: E402


def round_tf32(x):
    """float32 tensor rounded to TF32 (10 mantissa bits), to nearest even."""
    import torch

    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class TF32Windows:
    """Drop-in for the reference's windows: the argmax of the TF32 response."""

    def __init__(self, g, direction, radii, L, device="cpu"):
        import torch

        ph, pw = 2 * radii[0] + L, 2 * radii[1] + L
        self.device = torch.device(device)
        self.direction = float(direction)
        band_r = torch.from_numpy(reference._bands(g, ph).astype(np.float32))
        band_c = torch.from_numpy(reference._bands(g, pw).astype(np.float32))
        self.band_r = round_tf32(band_r).to(self.device)
        self.band_ct = round_tf32(band_c).transpose(1, 2).contiguous().to(self.device)

    def argmax(self, patches: np.ndarray) -> np.ndarray:
        import torch

        p = torch.from_numpy(patches).to(self.device).float()[:, None]
        rows = round_tf32(self.band_r[None] @ p)
        sums = rows @ self.band_ct[None]
        resp = self.direction * (sums[:, 0] - sums[:, 1])
        return reference.argmax_colmajor(resp.cpu().numpy())


def control_calls(config: dict, clip_sets: list, sets: list, device="cpu") -> list:
    """One call a clip set, in the form the harness records its calls, with
    the control's answers: the entry module's reference with
    :class:`TF32Windows` in place of its float32 sums, and the timestamps of
    the reference's grid."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True

    def windows(g, direction, radii, L):
        return TF32Windows(g, direction, radii, L, device)

    answers = harness.entry(config).reference(config, clip_sets, sets, windows=windows)
    return [{"set": k, "out": out} for k, out in enumerate(answers)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    _, config, traffic = harness.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        sets = frames.plan(config, traffic, seed)
        clips = frames.render(config, sets, seed, "cuda")
        ref = harness.entry(config).reference(config, clips, sets)
        t1 = time.perf_counter()
        verdict = harness.compare(control_calls(config, clips, sets, "cuda"), ref)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "tf32",
                          "correct": verdict["correct"], "compared": verdict["compared"],
                          "reference_s": round(t1 - t0, 3),
                          "control_s": round(time.perf_counter() - t1, 3),
                          "checks": verdict["checks"]}), flush=True)
        del clips
    return 0


if __name__ == "__main__":
    sys.exit(main())
