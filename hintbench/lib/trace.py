"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, reduced to what the per-layer readers and the breakdown
need.

* device operations: every kernel, copy and fill the card ran, by name and
  duration;
* ``busy_s``: the union of their intervals inside the window, the seconds
  in which an operation ran on the device; ``window_s``: the length of the
  window's own span (``WINDOW``), in the profiler's clock;
* idle gaps: the stretches of the window in which nothing ran on the
  device, each named by what the host was doing when it began: the
  innermost host operation or span open at that moment.
"""

from __future__ import annotations

import contextlib
import heapq
from collections import defaultdict

import numpy as np

WINDOW = "hintbench.window"
TOP = 10


def _kineto_events(prof):
    """(name, is_device, start_us, end_us, thread) of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(e.device_type())
        start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else float(e.start_us())
        dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else float(e.duration_us())
        out.append((e.name(), dev, start, start + dur, 0 if dev else e.start_thread_id()))
    return out


def _union(intervals: np.ndarray, lo: float, hi: float):
    """Sorted disjoint intervals covering ``intervals`` (n, 2) clipped to
    [lo, hi]."""
    iv = np.clip(intervals, lo, hi)
    iv = iv[iv[:, 1] > iv[:, 0]]
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, dtype=np.float64).reshape(-1, 2)


def short(name: str) -> str:
    """A kernel's or host operation's name without its return type, the
    anonymous namespace and its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(", 1)
    return (name[:cut] if cut > 0 else name)[:160]


def _name_gaps(gaps: np.ndarray, host: list) -> list:
    """The innermost host event open at each gap's start (the open event
    that started last), by a sweep over both in time order."""
    order = sorted(range(len(host)), key=lambda i: host[i][1])
    names, heap, j = [], [], 0
    for g0 in gaps[:, 0]:
        while j < len(order) and host[order[j]][1] <= g0:
            i = order[j]
            heapq.heappush(heap, (-host[i][1], host[i][2], i))
            j += 1
        while heap and heap[0][1] <= g0:
            heapq.heappop(heap)
        names.append(short(host[heap[0][2]][0]) if heap else "host: no operation open")
    return names


def summarize(prof) -> dict:
    events = _kineto_events(prof)
    spans = [(s, e) for n, d, s, e, _ in events if n == WINDOW and not d]
    if not spans:
        raise RuntimeError("the trace holds no window span")
    lo, hi = spans[0]
    # the device side of the window's own span is an annotation, not an operation
    dev = [(n, s, e) for n, d, s, e, _ in events if d and n != WINDOW and e > lo and s < hi]
    busy = _union(np.asarray([(s, e) for _, s, e in dev], np.float64).reshape(-1, 2), lo, hi)
    busy_us = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
    by_name = defaultdict(float)
    for n, s, e in dev:
        by_name[short(n)] += (min(e, hi) - max(s, lo)) / 1e6
    # idle gaps inside the window, named by the innermost open host event
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    host = [(n, s, e) for n, d, s, e, _ in events if not d and n != WINDOW and e > lo and s < hi]
    idle = defaultdict(float)
    for (g0, g1), name in zip(gaps, _name_gaps(gaps, host)):
        idle[name] += (g1 - g0) / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (hi - lo) / 1e6,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
        "idle": sorted(idle.items(), key=lambda kv: -kv[1]),
    }


def breakdown(summary: dict) -> dict:
    return {"device_ops": [[n, s] for n, s in summary["device_ops"][:TOP]],
            "idle_gaps": [[n, s] for n, s in summary["idle"][:TOP]]}


@contextlib.contextmanager
def traced(enabled: bool, out: dict):
    """Profile the body when ``enabled`` and put its summary in ``out``;
    the body wraps its window in ``window_span()``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    out.update(summarize(prof))


def window_span():
    from torch.profiler import record_function

    return record_function(WINDOW)
