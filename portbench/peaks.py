"""The card's peaks and the least time of the tracker's scan work.

A frozen copy of the repository's ``chip_smoke.py::cost`` arithmetic, so that
no change to the program or its scripts changes the yardstick.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s in float32 outside the tensor cores, which is what the
direct-tap scan runs on, and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def cost(radii, L: int, T: int, subpixel: bool = False, bounded: bool = False,
         lanes: int = 1) -> dict:
    """FLOPs of the direct taps and bytes the scan must move (each patch read
    once, each output written once) for ``lanes`` chains of T steps of a
    window of ``radii`` with L taps, and the least time at the card's peaks
    (``bound_s``). The subpixel offsets read the response's neighbours, which
    the taps have already computed, so they add no FLOPs."""
    wh, ww = 2 * radii[0] + 1, 2 * radii[1] + 1
    ph, pw = wh + L - 1, ww + L - 1
    flops = T * (2 * 2 * wh * pw * L + 2 * 2 * wh * ww * L)
    nbytes = T * ph * pw + T * 8 + (T * 8 if subpixel else 0) + (T * 24 if bounded else 0) + 9
    t_ops, t_bytes = lanes * flops / PEAK_F32_FLOPS, lanes * nbytes / PEAK_BYTES_PER_S
    return {"flops": lanes * flops, "bytes": lanes * nbytes + 8 * L,
            "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
