"""Spans and counters at the port's layer boundaries.

``span(name)`` marks a stretch of the host's work for ``torch.profiler``.
While a profiler records, it is a profiler range, on the profiler's clock:
the same timeline as the device's kernels and copies, so each idle stretch
of the device can be put down to what the host was doing. Otherwise it is
one shared no-op context, and a call costs a check of the profiler's state
(~0.3 us on a CPU core, against ~15 us for an unprofiled
``record_function``). Spans nest on a thread; the autograd engine's device
thread inherits the profiler from the thread that called ``backward``.

The range is a function-scope range (``_RecordFunctionFast``), not the
user-scope one of ``torch.profiler.record_function``: the profiler mirrors
a user-scope range on the device as an annotation over the kernels launched
under it, which a reader of the device's operations would count as device
work. A program span shows on the host's side alone.

The spans (PERF.md, Layers, names each beside what reads it):

* ``train.epoch``, with ``train.shuffle`` and ``train.read_losses`` in it;
  ``train.step``, with ``train.rows``, ``train.forward``, ``train.backward``
  and ``train.optimizer`` in it (``train/trainer.py``);
* ``serve.sample`` and ``serve.log_prob`` (one request), with
  ``serve.prepare``, ``serve.lock``, ``serve.h2d``, ``serve.compute`` and
  ``serve.d2h`` in them (``serve.py``);
* ``hac.pack`` (a parameter version packed for the kernels) and
  ``hac.build`` (the kernel library loaded or compiled) (``ops/hac_fused.py``).

``count(name, n)`` adds to one registry of named counts (``COUNTS``), always
on and without a lock, as module globals are; ``snapshot()`` copies it, and
a reader takes the difference of two copies (``since``). The counters:
``hac.launches``, ``hac.launches.wgmma``, ``hac.launches.tiled``, ``hac.launches.under_grad``,
``hac.bwd_launches``, ``hac.bwd_weight_launches``,
``hac.reshuffle_levelwise``, ``hac.packs``, ``hac.builds``, ``hac.build_s``
(seconds), ``train.steps``, ``train.rows``, ``serve.requests.sample``,
``serve.requests.log_prob``, ``serve.rows`` (rows asked), ``serve.rows_computed``
(bucket rows over every page) and ``serve.pages``.
"""

from __future__ import annotations

import contextlib

import torch

#: every count since the process started, by name
COUNTS: dict = {}

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records; else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def count(name: str, n=1) -> None:
    COUNTS[name] = COUNTS.get(name, 0) + n


def get(name: str):
    """The count of ``name`` (0 before its first)."""
    return COUNTS.get(name, 0)


def snapshot() -> dict:
    return dict(COUNTS)


def since(before: dict) -> dict:
    """Every count's growth since ``before`` (a ``snapshot()``)."""
    return {k: v - before.get(k, 0) for k, v in COUNTS.items()}
