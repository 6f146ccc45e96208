"""Batch tracking on one card, and the whole-frame detectors."""

from .mesh import ShardedBatchTracker, global_detect_batch, global_detect_peaks
