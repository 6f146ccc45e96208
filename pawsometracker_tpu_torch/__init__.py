"""PawsomeTracker in PyTorch and CUDA: the DoG video tracker on an NVIDIA card.

A port of ``pawsometracker_tpu`` (JAX, TPU) that follows one blob-like
target through a video with a Difference-of-Gaussians matched filter
evaluated in a search window around the previous position. Host decode feeds
chunks of uint8 frames to a hand-written CUDA kernel that carries the whole
per-frame recurrence of a chunk in one launch (``csrc/dog_scan.cu``), one
CTA per chain: ``track`` runs one chain, ``track_batch`` one per video and
``track_multi`` one per target of one video, and ``track_batch(mesh=...)``
spreads the videos over several cards (``make_mesh``); ``track_resumable`` tracks
a long recording in checkpointed slices, and ``python -m
pawsometracker_tpu_torch`` is the command line. The same step in plain
PyTorch runs on the CPU (``device="cpu"``).

This package imports neither JAX nor the JAX package, and importing it has no
side effects: the kernel is built at first use.
"""

from .api import DEFAULT_MAX_DURATION_SECONDS, IJ, track
from .batch import track_batch
from .checkpoint import load_checkpoint, track_resumable
from .diagnose import Diagnose, Dont, diagnose
from .models.dog_tracker import (
    TrackerSpec,
    autodetect_spec,
    make_spec,
    spec_from_reference,
    tracker_fns,
)
from .multi import track_multi
from .ops.dog_kernel import (
    dog_kernel_2d,
    dog_kernel_separable,
    fix_window_size,
    get_sigma,
    guess_window_size,
)
from .parallel import (
    ShardedBatchTracker,
    batch_sharding,
    global_detect_batch,
    global_detect_peaks,
    make_mesh,
)

__version__ = "0.1.0"

__all__ = [
    "track",
    "track_batch",
    "track_multi",
    "track_resumable",
    "load_checkpoint",
    "IJ",
    "DEFAULT_MAX_DURATION_SECONDS",
    "TrackerSpec",
    "tracker_fns",
    "make_spec",
    "autodetect_spec",
    "spec_from_reference",
    "get_sigma",
    "guess_window_size",
    "fix_window_size",
    "dog_kernel_2d",
    "dog_kernel_separable",
    "Diagnose",
    "Dont",
    "diagnose",
    "ShardedBatchTracker",
    "make_mesh",
    "batch_sharding",
    "global_detect_batch",
    "global_detect_peaks",
    "__version__",
]
