"""train_repack_ms: device milliseconds a training step spends packing the
HAC blocks' new parameters for the kernels (the flat weights, and the
backward's layout): the device time of the operations launched under the
program's ``hac.pack`` spans, over the steps."""


def read(ctx):
    spans = ctx["trace"].get("spans", {})
    step, pack = spans.get("train.step"), spans.get("hac.pack")
    if not step or not step["n"] or not pack:
        return None
    return 1e3 * pack["ops_s"] / step["n"]
