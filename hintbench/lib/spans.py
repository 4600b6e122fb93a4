"""The program's spans in the profile of a traced window: for each span
name, what the host spent under it, what it launched on the device and the
device's idle time under it.

The program (``hint_tpu_torch.utils.instrument``) opens its spans as
host-side profiler ranges named ``train.*``, ``serve.*`` and ``hac.*``; they
nest on a thread. For each name, over the window:

* ``n``: the spans that started in it;
* ``host_s``: their seconds on the host, children included;
* ``blocked_s``: of those, the host's seconds in calls that wait on the
  device (``BLOCKING``, and a copy's runtime call where the copy runs to
  the host or the call is the synchronous ``cudaMemcpy``);
* ``ops``, ``ops_s``: the device operations launched under them and their
  device seconds, children included. An operation is put down, by its
  correlation id, to the runtime call that launched it, and that call to
  the innermost program span open on its thread at the call's start;
* ``idle_s``: the window's idle seconds in which the span was the innermost
  program span open, each idle stretch divided among those spans by
  intersection (so the names' ``idle_s`` add up to no more than the
  window's idle time).

A thread with no program span open (the autograd engine's device thread,
which runs a backward) takes the innermost span open on any thread: the
one that started last, such as ``train.backward`` on the thread that
called it. A span opened on such a thread is a child of that span.

The device-side annotation the profiler makes of a user-scope range (the
window's own) is no operation: it counts in nothing here.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict
from typing import NamedTuple

import numpy as np

from hintbench.lib.trace import WINDOW, _union

PROGRAM = re.compile(r"^(train|serve|hac)\.")
#: host calls that wait on the device, by name as the profiler gives it
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                      "Command Buffer Full", "Command_Buffer_Full"})
FIELDS = ("n", "host_s", "blocked_s", "ops", "ops_s", "idle_s")


class Event(NamedTuple):
    name: str
    device: bool
    start: float  # us, the profiler's clock
    end: float
    thread: int  # 0 on the device
    corr: int  # the runtime call's and its operation's correlation id
    annotation: bool  # a user-scope range, or its device-side mirror


def events(prof) -> list:
    """Every event of a ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(e.device_type())
        out.append(Event(e.name(), dev, e.start_ns() / 1e3, e.end_ns() / 1e3, 0 if dev else e.start_thread_id(),
                         e.correlation_id(), e.is_user_annotation()))
    return out


def of_profile(prof) -> dict:
    """``attribute`` over the window of a traced run (``trace.window_span``)."""
    evs = events(prof)
    lo, hi = next((e.start, e.end) for e in evs if e.name == WINDOW and not e.device)
    return attribute(evs, lo, hi)


def _runtime(name: str) -> bool:
    return name.startswith("cu")


def _waits(call: Event, op_name: str) -> bool:
    """Whether a runtime call blocks the host until the device has worked
    through it."""
    if call.name in BLOCKING:
        return True
    if not call.name.startswith("cudaMemcpy"):
        return False
    return call.name == "cudaMemcpy" or "DtoH" in op_name


def attribute(evs: list, lo: float, hi: float) -> dict:
    """``{span name: {field: value}}`` over the window [lo, hi] (us)."""
    spans = sorted((e for e in evs if not e.device and PROGRAM.match(e.name) and e.end > lo and e.start < hi),
                   key=lambda e: (e.start, -e.end))
    ops = [e for e in evs if e.device and not e.annotation and e.end > lo and e.start < hi]
    busy = _union(np.asarray([(e.start, e.end) for e in ops], np.float64).reshape(-1, 2), lo, hi)
    calls = {e.corr: e for e in evs if not e.device and e.corr and _runtime(e.name)}
    # the points at which the innermost open span is asked for: each operation's
    # launching call, and each call that waits
    op_name = {op.corr: op.name for op in ops}
    queries = []  # (time, thread, kind: 0 launch, 1 wait, seconds)
    for op in ops:
        call = calls.get(op.corr)
        if call is not None:
            queries.append((call.start, call.thread, 0, (min(op.end, hi) - max(op.start, lo)) / 1e6))
    for e in evs:
        if not e.device and e.end > lo and e.start < hi and _waits(e, op_name.get(e.corr, "")):
            queries.append((e.start, e.thread, 1, (min(e.end, hi) - max(e.start, lo)) / 1e6))
    queries.sort(key=lambda q: q[0])

    # one sweep: span starts (outer first) before the queries at the same time
    parent = [-1] * len(spans)
    own = [[0, 0.0, 0.0] for _ in spans]  # ops, ops_s, blocked_s put down to the span itself
    stacks = defaultdict(list)  # thread -> open spans, innermost last

    def innermost(t: float, thread: int) -> int:
        for st in stacks.values():
            while st and spans[st[-1]].end <= t:
                st.pop()
        mine = stacks.get(thread)
        if mine:
            return mine[-1]
        tops = [st[-1] for st in stacks.values() if st]
        return max(tops, key=lambda i: (spans[i].start, i)) if tops else -1

    qi = 0
    for i, sp in enumerate(spans):
        while qi < len(queries) and queries[qi][0] < sp.start:
            _put(queries[qi], innermost(queries[qi][0], queries[qi][1]), own)
            qi += 1
        parent[i] = innermost(sp.start, sp.thread)
        stacks[sp.thread].append(i)
    for q in queries[qi:]:
        _put(q, innermost(q[0], q[1]), own)

    # children into their parents (a child starts after its parent: reverse order)
    total = [list(o) for o in own]
    for i in range(len(spans) - 1, -1, -1):
        if parent[i] >= 0:
            for k in range(3):
                total[parent[i]][k] += total[i][k]
    idle = _idle(spans, lo, hi, busy)
    out = defaultdict(lambda: dict.fromkeys(FIELDS, 0))
    for i, sp in enumerate(spans):
        row = out[sp.name]
        row["n"] += lo <= sp.start < hi
        row["host_s"] += (min(sp.end, hi) - max(sp.start, lo)) / 1e6
        row["ops"] += total[i][0]
        row["ops_s"] += total[i][1]
        row["blocked_s"] += total[i][2]
        row["idle_s"] += idle[i]
    return dict(out)


def _put(query, span: int, own: list) -> None:
    if span < 0:
        return
    if query[2] == 0:
        own[span][0] += 1
        own[span][1] += query[3]
    else:
        own[span][2] += query[3]


def _idle(spans: list, lo: float, hi: float, busy) -> list:
    """Each span's share of the window's idle time: the stretches between
    the ``busy`` intervals in which it was the innermost open span (the open
    span that started last, on any thread)."""
    edges = [lo] + [float(v) for v in busy.reshape(-1)] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    points = sorted([(max(sp.start, lo), 0, i) for i, sp in enumerate(spans)]
                    + [(min(sp.end, hi), 1, i) for i, sp in enumerate(spans)])
    share = [0.0] * len(spans)
    heap, closed, g, t0 = [], set(), 0, lo
    for t, kind, i in points + [(hi, 2, -1)]:
        while heap and heap[0][2] in closed:
            heapq.heappop(heap)
        if heap and t > t0:  # [t0, t) belongs to the innermost open span
            top = heap[0][2]
            while g < len(gaps) and gaps[g][1] <= t0:
                g += 1
            k = g
            while k < len(gaps) and gaps[k][0] < t:
                share[top] += (min(gaps[k][1], t) - max(gaps[k][0], t0)) / 1e6
                k += 1
        t0 = max(t0, t)
        if kind == 0:
            heapq.heappush(heap, (-spans[i].start, -i, i))
        elif kind == 1:
            closed.add(i)
    return share
