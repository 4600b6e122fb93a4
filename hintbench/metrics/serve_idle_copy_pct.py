"""serve_idle_copy_pct: the share of the traced serving window in which no
operation ran on the device while the service copied a request's rows:
the idle time whose innermost program span was ``serve.h2d`` or
``serve.d2h`` (``lib/spans.py``), over the window."""

COPIES = ("serve.h2d", "serve.d2h")


def read(ctx):
    tr = ctx["trace"]
    spans = tr.get("spans", {})
    if tr["window_s"] <= 0 or not any(n in spans for n in COPIES):
        return None
    return 100.0 * sum(spans[n]["idle_s"] for n in COPIES if n in spans) / tr["window_s"]
