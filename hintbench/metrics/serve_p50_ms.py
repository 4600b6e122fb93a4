"""serve_p50_ms: the median request latency of the traced serving window,
each request timed from its call to its answer."""


def read(ctx):
    lat = ctx["run"]["latencies_ms"]
    return ctx["percentile"](lat, 50) if lat else None
