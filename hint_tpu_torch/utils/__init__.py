"""Profiling (port of ``hint_tpu/utils/__init__.py``).

``profile_trace`` records with ``torch.profiler`` where ``hint_tpu`` uses
``jax.profiler``; the program's spans and counters (``instrument``) show in
what it records. ``hint_tpu``'s ``respect_env_platforms`` and
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

