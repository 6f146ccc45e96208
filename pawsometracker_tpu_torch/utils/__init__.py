"""Utilities: profiling hooks and timers."""

from .profiling import Timer, trace
