"""train_rows_per_s: training rows consumed over the window, by the host's
clock: steps x batch over the seconds of the whole epochs run."""


def read(ctx):
    run = ctx["run"]
    return run["rows"] / run["seconds"] if ctx["kind"] == "train" and run["seconds"] > 0 else None
