"""The numbers that decide ``correct``, each against its limit.

Training (the first steps of the very object the window then drives,
against the plain reference's own three steps from the same weights and
batches):

* ``loss_gap``: the largest over the steps of |loss - loss_ref| over the
  sum of the magnitudes of the reference's two terms (mean 1/2 |z|^2 and
  -mean log|det J|): the loss is their difference and crosses 0 in the
  first steps, so its own size is no scale;
* ``grad_gap``: the first gradient as the optimizer took it (its first
  moment after one step over 1 - beta1: clamped, weight decay added), by
  the worst leaf: | |g| - |g_ref| | over the larger of |g_ref| and the
  median leaf's |g_ref|;
* ``change_gap``: the same of each leaf's change after the steps.

Leaves whose first reference gradient is under ``NEGLIGIBLE`` of the median
leaf's move by round-off alone and are left out of both.

Serving (every answer of a sample of the window's requests against the
reference's own answer to the same request):

* ``sample_gap``: the widest |x - x_ref| / (1 + |x_ref|) of a sampled row;
* ``logprob_gap``: the widest |lp - lp_ref| / (1 + |lp_ref|).
"""

from __future__ import annotations

import math
import statistics
import sys

import torch

NEGLIGIBLE = 1e-3


def _norms(leaves: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def worst_leaf(got: dict, ref: dict, keep) -> list:
    """[leaf, gap, |ref|] of the kept leaf whose norm gap is widest."""
    g, r = _norms(got), _norms(ref)
    med = statistics.median(r[k] for k in keep)
    k = max(keep, key=lambda k: abs(g[k] - r[k]) / max(r[k], med))
    return [k, abs(g[k] - r[k]) / max(r[k], med), r[k]]


def leaf_gap(got: dict, ref: dict, keep) -> float:
    return worst_leaf(got, ref, keep)[1]


def kept_leaves(ref_grad: dict) -> list:
    n = _norms(ref_grad)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= NEGLIGIBLE * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"losses": [[term1, term2] a step], "grad": {leaf:
    tensor}, "change": {leaf: tensor}}."""
    keep = kept_leaves(ref["grad"])
    return {
        "loss_gap": max(abs(sum(a) - sum(b)) / (abs(b[0]) + abs(b[1])) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"], keep),
        "change_gap": leaf_gap(prog["change"], ref["change"], keep),
    }


def widest(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        return math.inf
    return float(((got - ref).abs() / (1 + ref.abs())).max()) if got.numel() else 0.0


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}); every number is printed beside
    its limit on standard error as the run's last lines."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table


def print_table(table: dict) -> None:
    for k, v in table.items():
        flag = "ok" if v["value"] <= v["limit"] else "OVER"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {flag}", file=sys.stderr)
