"""serve_idle_service_pct: the share of the traced serving window in which
no operation ran on the device while the service did its other host work
(a request's preparation, the wait for the device, the launches): the idle
time whose innermost program span was a ``serve.*`` span other than the
copies, over the window. ``serve_idle_pct`` less this and
``serve_idle_copy_pct`` is the idle time outside the service: the
clients' loop."""

COPIES = ("serve.h2d", "serve.d2h")


def read(ctx):
    tr = ctx["trace"]
    spans = {n: s for n, s in tr.get("spans", {}).items() if n.startswith("serve.") and n not in COPIES}
    if tr["window_s"] <= 0 or not spans:
        return None
    return 100.0 * sum(s["idle_s"] for s in spans.values()) / tr["window_s"]
