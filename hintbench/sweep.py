#!/usr/bin/env python3
"""The output check over many seeds, on the card, at each cell's own size.

    python3 hintbench/sweep.py --workload rcinn4-train --seeds 1782124435 1 2 3 --out sweep.jsonl

For each seed it sets the cell up as a run does (training: the first steps
of the very state a window takes; serving: a short window of the cell's
own load, ``--window`` seconds) and writes one JSON line of readings:

* ``port``: the program against the plain f32 reference, the numbers a run
  compares;
* ``port_f64``, ``ref_f64``: the program and the plain f32 reference,
  each against the same reference in float64;
* ``control``: the reference in TF32 (the precision below the configs'
  f32) against the f32 reference: what the control reads;
* ``half`` (training): the reference with half of each batch left out,
  the mean taken over the rest: the fault's readings;
* ``worst``: the leaf or endpoint behind each number of ``port``.

A state left unchanged reads 1 in ``change_gap`` by its definition and
needs no run. The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def train_readings(cell, seed: int, device) -> dict:
    from hintbench.lib import check
    from hintbench.lib.train_cell import TrainCell

    tc = TrainCell(cell.config, cell.traffic, cell.config_module, seed, device)
    tc.setup()
    tc.release()
    ref, ref64 = tc.reference("float32"), tc.reference("float64")
    out = {
        "port": check.train_numbers(tc.first, ref),
        "port_f64": check.train_numbers(tc.first, ref64),
        "ref_f64": check.train_numbers(ref, ref64),
        "control": check.train_numbers(tc.reference("tf32"), ref),
        "half": check.train_numbers(tc.reference("float32", half=True), ref),
    }
    keep = check.kept_leaves(ref["grad"])
    out["worst"] = {k: check.worst_leaf(tc.first[k], ref[k], keep) for k in ("grad", "change")}
    out["losses"] = {"port": tc.first["losses"], "ref": ref["losses"], "f64": ref64["losses"]}
    out["left_out"] = sorted(set(ref["grad"]) - set(keep))
    return out


def serve_readings(cell, seed: int, device, window: float) -> dict:
    from hintbench.lib.serve_cell import ServeCell

    sc = ServeCell(cell.config, cell.traffic, cell.config_module, seed, device)
    sc.setup()
    run = sc.window(window)
    sc.release()
    got = sc.checked()

    def answers(mode):
        return {e: list(zip([r for r, _ in pairs], sc.expected([r for r, _ in pairs], mode)))
                for e, pairs in got.items()}

    ref = answers("float32")
    return {
        "port": sc.numbers("float32"),
        "port_f64": sc.numbers("float64"),
        "ref_f64": sc.numbers("float64", answers=ref),
        "control": sc.numbers("float32", answers=answers("tf32")),
        "compared": {e: len(p) for e, p in got.items()},
        "rows": sum(r.n for pairs in got.values() for r, _ in pairs),
        "attempted": run["attempted"], "failed": run["failed"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--window", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    from hintbench.lib.spec import Cell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            t = time.perf_counter()
            if cell.traffic["kind"] == "train":
                rec = train_readings(cell, seed, device)
            else:
                rec = serve_readings(cell, seed, device, args.window)
            rec.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps({k: rec[k] for k in ("seed", "port", "control", "seconds")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
