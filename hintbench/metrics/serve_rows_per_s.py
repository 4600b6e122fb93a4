"""serve_rows_per_s: rows answered (samples drawn and densities returned)
over the window, by the host's clock, from its start to the last answer."""


def read(ctx):
    run = ctx["run"]
    return run["rows"] / run["seconds"] if ctx["kind"] == "serve" and run["seconds"] > 0 else None
