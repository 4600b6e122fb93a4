"""train_nonhac_ms: device milliseconds a training step spends outside the
HAC kernels (perms, couplings' glue, loss, optimizer, re-pack, copies and
fills): every device operation of the traced window whose name does not
start with ``hac_block``, over the window's steps."""

import re

HAC = re.compile(r"^hac_block")  # names as lib/trace.py shortens them


def read(ctx):
    steps = ctx["run"]["steps"]
    if not steps or not ctx["trace"]["device_ops"]:
        return None
    rest = sum(s for name, s in ctx["trace"]["device_ops"] if not HAC.match(name))
    return 1e3 * rest / steps
