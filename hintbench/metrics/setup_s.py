"""setup_s: seconds from the process's start to the window: imports, the
weights and data on the card, the kernel library loaded (built on a
checkout's first run), the first steps or the warm-up requests."""


def read(ctx):
    return ctx["setup_s"]
