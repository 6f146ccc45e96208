"""The benchmark of the PyTorch/CUDA tracker: one cell, one seed, one run.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the checkout's root. The cells, configurations, traffic mixes, motion
models and per-layer metrics are data and small modules under this folder,
found by the names in the root ``BENCHMARK.json``.
"""
