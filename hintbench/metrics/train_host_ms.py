"""train_host_ms: the host's milliseconds a training step, waits on the
device left out: the seconds of the program's ``train.step`` spans in the
traced window less their seconds in calls that wait on the device
(``lib/spans.py``), over the steps. It is read under the profiler, so it
holds the profiler's own cost for each operation."""


def read(ctx):
    step = ctx["trace"].get("spans", {}).get("train.step")
    if not step or not step["n"]:
        return None
    return 1e3 * (step["host_s"] - step["blocked_s"]) / step["n"]
