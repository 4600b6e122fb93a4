"""train_launches_per_step: the device operations (kernels, copies,
fills) launched under the program's ``train.step`` spans in the traced
window, over the steps; the autograd engine's launches included."""


def read(ctx):
    step = ctx["trace"].get("spans", {}).get("train.step")
    if not step or not step["n"]:
        return None
    return step["ops"] / step["n"]
