"""plus_shape.unconditional_hint_4_full: the flagship HINT flow. Its plain
reference and its work counts.

[HAC, perm, HAC, perm, HAC, perm, HAC] on x in R^100: fixed Householder
permutations between the blocks only, each block a full-depth HAC tree
with the level widths ``c_internal``.
"""

from hintbench.lib.work import flow_work
from hintbench.reference.flows import HAC, Flow


def reference(cfg: dict) -> Flow:
    d, ops = cfg["ndim_x"], []
    for i in range(cfg["n_blocks"]):
        if i > 0:
            ops.append(("perm", d))
        ops.append(("hac", HAC(d, cfg["c_internal"], 0, cfg["clamp"], cfg["max_splits"], cfg["min_split_size"])))
    return Flow(ops, d, 0)


def work(cfg: dict, train: bool) -> dict:
    return flow_work(reference(cfg), train)
