"""serve_idle_pct: the share of the traced serving window in which no
operation ran on the device (the service's host work under its lock and
the clients' waits included)."""


def read(ctx):
    tr = ctx["trace"]
    if tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
