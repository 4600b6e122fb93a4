"""The algorithm's work: operations and bytes of the flows, counted from
the configuration's shapes, whatever implements them.

A HAC block-pass (one direction) per row: each node's two 3-layer MLPs,
2 operations a multiply-add plus one a bias element, on the node's real
widths (no padding, the condition's inputs included), then per element of
the node's lower half the coupling (scale by the clamped atan, exp,
multiply, add: 4) and the log-det sum (1). A training step counts the
block's forward and both backward products: 3 times the forward. Bytes of
a block-pass: the rows read and written once (x, the condition, y, the
log-det), f32, and the weights once per call; training adds the backward's
rows (the gradients of y and the log-det read, those of x and the condition
written) and reads the weights again and writes their gradients once.

A fixed permutation is a d x d product: 2 d^2 a row, and in training its
input gradient once more. The loss adds 3 operations an element of z and
the optimizer about 12 an element of a trainable leaf.
"""

from __future__ import annotations

import math

OPT_FLOPS_PER_PARAM = 12
LOSS_FLOPS_PER_ELEMENT = 3


def hac_row_flops(hac) -> int:
    total = 0
    for nd in hac.nodes():
        i, h, o = nd.split + hac.cond_dim, nd.hidden, nd.dim - nd.split
        total += 2 * (2 * (i * h + h * h + h * o) + (h + h + o))
        total += 5 * o
    return total


def hac_params(hac) -> int:
    return sum(2 * ((nd.split + hac.cond_dim) * nd.hidden + nd.hidden * nd.hidden + nd.hidden * (nd.dim - nd.split)
                    + 2 * nd.hidden + nd.dim - nd.split) for nd in hac.nodes())


def flow_work(flow, train: bool) -> dict:
    """Per row and per call of a whole flow: ``hac_flops_row``,
    ``hac_bytes_row``, ``hac_bytes_call`` (weights; in training, per step)
    and ``flops_row`` / ``flops_call`` of everything (HAC, perms, loss,
    optimizer)."""
    hac_f = hac_br = hac_bc = other_f = 0
    params = 0
    d, c = flow.dim, flow.cond_dim
    for kind, op in flow.ops:
        if kind == "hac":
            f, p = hac_row_flops(op), hac_params(op)
            hac_f += 3 * f if train else f
            rows = 4 * (2 * d + 1 + c)
            hac_br += 2 * rows if train else rows
            hac_bc += 4 * 3 * p if train else 4 * p
            params += p
        else:
            other_f += (2 if train else 1) * 2 * op * op
    loss_f = LOSS_FLOPS_PER_ELEMENT * d
    opt = OPT_FLOPS_PER_PARAM * params if train else 0
    return {"hac_flops_row": hac_f, "hac_bytes_row": hac_br, "hac_bytes_call": hac_bc,
            "flops_row": hac_f + other_f + loss_f, "flops_call": opt, "params": params}


def log_grid(lo: int, hi: int, k: int) -> list:
    """k sizes spaced evenly in log from lo to hi, both included."""
    return [int(round(math.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * i / (k - 1)))) for i in range(k)]
