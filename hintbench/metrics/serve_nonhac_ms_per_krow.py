"""serve_nonhac_ms_per_krow: device milliseconds outside the HAC kernels
(perms, the condition feed, latents, padding and copies) for every 1,000
rows answered in the traced serving window."""

import re

HAC = re.compile(r"^hac_block")  # names as lib/trace.py shortens them


def read(ctx):
    rows = ctx["run"]["rows"]
    if not rows or not ctx["trace"]["device_ops"]:
        return None
    rest = sum(s for name, s in ctx["trace"]["device_ops"] if not HAC.match(name))
    return 1e3 * rest / (rows / 1e3)
