"""serve_launches_per_request: the device operations (kernels, copies,
fills) launched under the program's request spans (``serve.sample``,
``serve.log_prob``) in the traced window, over the requests."""

REQUESTS = ("serve.sample", "serve.log_prob")


def read(ctx):
    spans = ctx["trace"].get("spans", {})
    n = sum(spans[r]["n"] for r in REQUESTS if r in spans)
    if not n:
        return None
    return sum(spans[r]["ops"] for r in REQUESTS if r in spans) / n
