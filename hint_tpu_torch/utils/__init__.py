"""Profiling and timing (port of ``hint_tpu/utils/__init__.py``).

``profile_trace`` records with ``torch.profiler`` where ``hint_tpu`` uses
``jax.profiler``. ``hint_tpu``'s ``respect_env_platforms`` and
``enable_compilation_cache`` configure XLA and have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Record the host's and, where a card is present, the card's activity
    while the block runs, and write a Chrome trace (``chrome://tracing``,
    Perfetto) into ``log_dir``. Yields the profiler, whose
    ``key_averages()`` the caller may read after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Running per-step wall-clock stats for the train loop."""

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.n += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.n, 1)
