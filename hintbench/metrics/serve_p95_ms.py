"""serve_p95_ms: the 95th percentile of every request's latency in the
window, each from the moment its client sent it to its answer; a failed
request counts as the whole window."""


def read(ctx):
    lat = ctx["run"].get("latencies_ms")
    return ctx["percentile"](lat, 95) if lat else None
