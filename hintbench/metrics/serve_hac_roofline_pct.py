"""serve_hac_roofline_pct: the HAC kernels' share of their roofline in the
traced serving window. The least time the card needs for the rows the
service answered (every block's forward or inverse, ``lib/work.py``;
operations at the f32 ceiling or bytes at the memory's rate, the weights
read once a request) over the device time of the kernels whose names start
with ``hac_block``. Padding rows are work the requests did not ask for, so
they lower this share."""

import re

HAC = re.compile(r"^hac_block")  # names as lib/trace.py shortens them


def read(ctx):
    hac_s = sum(s for name, s in ctx["trace"]["device_ops"] if HAC.match(name))
    if hac_s <= 0:
        return None
    w, run, peaks = ctx["work"], ctx["run"], ctx["peaks"]
    answered = run["attempted"] - run["failed"]
    bound = max(run["rows"] * w["hac_flops_row"] / peaks["flops_f32"],
                (run["rows"] * w["hac_bytes_row"] + answered * w["hac_bytes_call"]) / peaks["bytes_per_s"])
    return 100.0 * bound / hac_s
