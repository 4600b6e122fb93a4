#!/usr/bin/env python3
"""One traced run of a cell, as ``run.py --trace 1`` makes it, with the
program's spans and counters read beside the accepted per-layer metrics.

    python3 hintbench/spanned.py --workload rcinn4-posterior --seed 7 --seconds 20

The accepted summary of a traced window (``lib/trace.py``) holds the
device's operations and idle gaps. This adds, over the same window, the
program's spans (``lib/spans.py``) and the growth of its counters
(``hint_tpu_torch.utils.instrument``), reads with them the metrics of
``SPAN_METRICS`` for the cell, and reads the cell's end-to-end metrics too,
which here hold the profiler's cost. It prints the check's table and
``run.py``'s line with those metrics added and ``spans`` and ``counters``
after them. ``BENCHMARK.json`` does not list these metrics yet: its harness
does not hand spans and counters to its readers (PERF.md, Open questions).
"""

import contextlib
import json
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import hintbench.run as RUN  # noqa: E402 - after the path; it sets the build caches

#: the per-layer entries of these metrics, as BENCHMARK.json would take them
SPAN_METRICS = [
    {"name": "train_host_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "Trainer: host dispatch", "moves": "train_rows_per_s", "workloads": ["rcinn4-train"]},
    {"name": "train_launches_per_step", "unit": "launches", "better": "lower", "source": "program_span",
     "layer": "Trainer: host dispatch", "moves": "train_rows_per_s", "workloads": ["rcinn4-train"]},
    {"name": "train_opt_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "Optimizer (ClampedAdam)", "moves": "train_rows_per_s", "workloads": ["rcinn4-train"]},
    {"name": "train_repack_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "HAC re-pack", "moves": "train_rows_per_s", "workloads": ["rcinn4-train"]},
    {"name": "serve_idle_copy_pct", "unit": "%", "better": "lower", "source": "program_span",
     "layer": "Service: host copies", "moves": "serve_rows_per_s", "workloads": ["rcinn4-posterior"]},
    {"name": "serve_idle_service_pct", "unit": "%", "better": "lower", "source": "program_span",
     "layer": "Service: host work", "moves": "serve_rows_per_s", "workloads": ["rcinn4-posterior"]},
    {"name": "serve_pad_pct", "unit": "%", "better": "lower", "source": "program_counter",
     "layer": "Service: buckets", "moves": "serve_rows_per_s", "workloads": ["rcinn4-posterior"]},
    {"name": "serve_launches_per_request", "unit": "launches", "better": "lower", "source": "program_span",
     "layer": "Service: host dispatch", "moves": "serve_p95_ms", "workloads": ["rcinn4-posterior"]},
]


def run(cell, seed: int, seconds: float, device) -> dict:
    """``run.run_cell`` traced, with the span metrics of the cell and its
    end-to-end metrics read, and ``spans`` and ``counters`` added."""
    from hintbench.lib import spans as SP
    from hintbench.lib import trace as TR
    from hint_tpu_torch.utils import instrument

    summarize, window_span, reader = TR.summarize, TR.window_span, cell.reader
    found = {"spans": {}, "counters": {}}

    def with_spans(prof):
        found["spans"] = SP.of_profile(prof)
        return {**summarize(prof), "spans": found["spans"]}

    @contextlib.contextmanager
    def counted_window():
        before = instrument.snapshot()
        with window_span():
            yield
        found["counters"] = instrument.since(before)

    cell.reader = lambda name: types.SimpleNamespace(
        read=lambda ctx: reader(name).read({**ctx, "counters": found["counters"]}))
    cell.per_layer = cell.per_layer + [m for m in SPAN_METRICS if cell.name in m["workloads"]] + cell.end_to_end
    TR.summarize, TR.window_span = with_spans, counted_window
    try:
        out = RUN.run_cell(cell, seed, seconds, True, device, strict=device.type == "cuda")
    finally:
        TR.summarize, TR.window_span = summarize, window_span
    return {**out, **found}


def main(argv=None) -> int:
    args = RUN.parse(argv)
    import torch

    from hintbench.lib import check
    from hintbench.lib.spec import Cell

    if not torch.cuda.is_available():
        print("needs a CUDA card: no result", file=sys.stderr)
        return 2
    out = run(Cell(args.workload), args.seed, args.seconds, torch.device("cuda", 0))
    check.print_table(out["check"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
