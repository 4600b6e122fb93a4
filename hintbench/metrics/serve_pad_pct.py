"""serve_pad_pct: the share of the rows the service computed in the traced
window that no request asked for: its buckets' padding, from the program's
counters ``serve.rows_computed`` (bucket rows over every page) and
``serve.rows`` (rows asked), as they grew over the window."""


def read(ctx):
    c = ctx.get("counters") or {}
    computed = c.get("serve.rows_computed", 0)
    if computed <= 0:
        return None
    return 100.0 * (computed - c.get("serve.rows", 0)) / computed
