"""train_mfu_pct: the whole training step's share of the card's f32 peak:
the algorithm's operations of every step in the traced window (HAC
forward and both backward products, perms, loss, optimizer; ``lib/work.py``)
over the window's length at 495 TFLOP/s."""


def read(ctx):
    w, run, tr = ctx["work"], ctx["run"], ctx["trace"]
    if tr["window_s"] <= 0 or not run["steps"]:
        return None
    flops = run["steps"] * (ctx["cfg"]["batch_size"] * w["flops_row"] + w["flops_call"])
    return 100.0 * flops / (tr["window_s"] * ctx["peaks"]["flops_f32"])
