"""plus_shape.conditional_recursive_cinn_4: the recursive cINN. Its plain
reference and its work counts.

[perm, HAC(y)] x 4 on x in R^100: each fixed Householder permutation is
followed by a full-depth HAC tree whose every subnet also reads the
condition y in R^4.
"""

from hintbench.lib.work import flow_work
from hintbench.reference.flows import HAC, Flow


def reference(cfg: dict) -> Flow:
    d, c, ops = cfg["ndim_x"], cfg["ndim_y"], []
    for _ in range(cfg["n_blocks"]):
        ops.append(("perm", d))
        ops.append(("hac", HAC(d, cfg["c_internal"], c, cfg["clamp"], cfg["max_splits"], cfg["min_split_size"])))
    return Flow(ops, d, c)


def work(cfg: dict, train: bool) -> dict:
    return flow_work(reference(cfg), train)
