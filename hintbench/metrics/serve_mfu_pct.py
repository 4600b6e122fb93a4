"""serve_mfu_pct: the whole request path's share of the card's f32 peak:
the algorithm's operations for the rows answered in the traced window
(every block and perm, ``lib/work.py``) over the window's length at
495 TFLOP/s."""


def read(ctx):
    run, tr = ctx["run"], ctx["trace"]
    if tr["window_s"] <= 0 or not run["rows"]:
        return None
    return 100.0 * run["rows"] * ctx["work"]["flops_row"] / (tr["window_s"] * ctx["peaks"]["flops_f32"])
