"""Batch tracking on one card or over a device mesh, and the whole-frame detectors."""

from .mesh import (
    Mesh,
    Sharded,
    ShardedBatchTracker,
    batch_sharding,
    global_detect_batch,
    global_detect_peaks,
    make_mesh,
    sharded_pallas_bounded,
)
