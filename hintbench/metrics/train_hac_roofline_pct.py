"""train_hac_roofline_pct: the HAC kernels' share of their roofline in the
traced training window. The least time the card needs for the blocks'
work (forward and both backward products of every block, ``lib/work.py``;
operations at the f32 ceiling or bytes at the memory's rate) over the
device time of the kernels whose names start with ``hac_block``."""

import re

HAC = re.compile(r"^hac_block")  # names as lib/trace.py shortens them


def read(ctx):
    hac_s = sum(s for name, s in ctx["trace"]["device_ops"] if HAC.match(name))
    if hac_s <= 0:
        return None
    w, run, peaks = ctx["work"], ctx["run"], ctx["peaks"]
    rows = run["steps"] * ctx["cfg"]["batch_size"]
    bound = max(rows * w["hac_flops_row"] / peaks["flops_f32"],
                (rows * w["hac_bytes_row"] + run["steps"] * w["hac_bytes_call"]) / peaks["bytes_per_s"])
    return 100.0 * bound / hac_s
