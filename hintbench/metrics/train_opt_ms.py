"""train_opt_ms: device milliseconds a training step spends in the
optimizer (``ClampedAdam.update``): the device time of the operations
launched under the program's ``train.optimizer`` spans, over the steps."""


def read(ctx):
    spans = ctx["trace"].get("spans", {})
    step, opt = spans.get("train.step"), spans.get("train.optimizer")
    if not step or not step["n"] or not opt:
        return None
    return 1e3 * opt["ops_s"] / step["n"]
