#!/usr/bin/env python3
"""The benchmark of ``hint_tpu_torch`` on NVIDIA H100s: one run of one cell.

    python3 hintbench/run.py --workload rcinn4-train --seed 7 --seconds 10 --trace 0

Run from the root of a checkout. The cell, its configuration, traffic mix,
limits and the reader of each metric are found by the names in
``BENCHMARK.json``.
It sets up (the weights and data from ``--seed`` on the card, the first
steps or the warm-up requests), measures for ``--seconds``, then checks the
window's own outputs against the plain reference (``hintbench/reference``)
and prints one JSON line: the end-to-end metrics (``--trace 0``) or the
per-layer ones, read from a ``torch.profiler`` trace of the window
(``--trace 1``). Every number compared is printed beside its limit as the
last lines of standard error and under ``check``, the line's last key.

It exits with a code other than 0 and prints no result where there is no
CUDA card, where the cell asks for more cards than there are, or where a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".hintbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "hint_tpu")


def loaded_forbidden() -> list:
    """Modules whose top-level name, compared whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation of the sorted
    values."""
    v = sorted(values)
    k = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, strict: bool = True) -> dict:
    """One run of ``cell`` (a ``spec.Cell``) on ``device``; returns the
    result line's fields. ``strict``: the program's registry has to agree
    with the configuration file."""
    import torch

    from hintbench.lib import check
    from hintbench.lib import trace as TR
    from hintbench.lib.peaks import H100
    from hintbench.lib.serve_cell import ServeCell
    from hintbench.lib.train_cell import TrainCell

    kind = cell.traffic["kind"]
    impl = {"train": TrainCell, "serve": ServeCell}[kind](cell.config, cell.traffic, cell.config_module, seed,
                                                          device, strict)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    impl.setup()
    setup_s = time.perf_counter() - T_START
    summary = {}
    with TR.traced(trace, summary):
        with TR.window_span():
            res = impl.window(seconds)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    impl.release()
    if kind == "train":
        numbers = check.train_numbers(impl.first, impl.reference("float32"))
        attempted, failed = res["steps"], res["failed"]
    else:
        numbers = impl.numbers("float32")
        attempted, failed = res["attempted"], res["failed"]
    correct, table = check.verdict(numbers, cell.limits)
    correct = correct and failed == 0
    ctx = {"kind": kind, "run": res, "setup_s": setup_s, "trace": summary, "work": impl.work, "peaks": H100,
           "cfg": cell.config, "percentile": percentile}
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = cell.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                      "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = TR.breakdown(summary)
    if kind == "serve" and res["errors"]:
        print("request errors: " + "; ".join(res["errors"]), file=sys.stderr)
    out["check"] = table
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from hintbench.lib import check
    from hintbench.lib.spec import Cell

    cell = Cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s), found {n}: no result", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}: no result", file=sys.stderr)
        return 3
    check.print_table(out["check"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
