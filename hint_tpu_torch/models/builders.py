"""Model builders (port of ``hint_tpu/models/builders.py``), one per graph
pattern of the reference's configs:

* ``inn``            - [perm, affine coupling] x n
* ``hint``           - [perm (between blocks only), HAC] x n
* ``cinn``           - [perm, conditional affine coupling] x n, one condition
* ``recursive_cinn`` - [perm, condition-fed HAC] x n
* ``conditional_hint`` - two-lane graph: per block [perm_y, perm_x (between
                       blocks only), hac_x, external y->x coupling, y-lane
                       coupling]

Chains are unrolled, one module instance per op.
"""

from __future__ import annotations

from typing import Sequence

from hint_tpu_torch.models.flow import LANE_X, LANE_Y, LANE_YX, Flow, TwoLaneFlow
from hint_tpu_torch.ops.coupling import AffineCoupling, ExternalAffineCoupling
from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling
from hint_tpu_torch.ops.householder import HouseholderPerm

DEFAULT_CLAMP = 4.0  # HAC-block default in the reference (hint.py:108)


def inn(
    dim: int,
    n_blocks: int,
    hidden: int,
    perm_fixed: bool = True,
    clamp: float = DEFAULT_CLAMP,
    compute_dtype: str = "float32",
    device=None,
) -> Flow:
    ops = []
    for _ in range(n_blocks):
        ops.append(HouseholderPerm(dim=dim, n_reflections=dim, fixed=perm_fixed))
        ops.append(AffineCoupling(dim=dim, hidden=hidden, clamp=clamp, compute_dtype=compute_dtype))
    return Flow(ops, dim=dim).to(device)


def hint(
    dim: int,
    n_blocks: int,
    c_internal: Sequence[int],
    perm_fixed: bool = True,
    max_splits: int = -1,
    min_split_size: int = 2,
    reshuffle: bool = False,
    clamp: float = DEFAULT_CLAMP,
    compute_dtype: str = "float32",
    impl: str = "levelwise",
    device=None,
) -> Flow:
    ops = []
    for i in range(n_blocks):
        if i > 0:  # perm between blocks only (unconditional_hint_4_full.py:60-65)
            ops.append(HouseholderPerm(dim=dim, n_reflections=dim, fixed=perm_fixed))
        ops.append(
            HierarchicalAffineCoupling(
                dim=dim,
                c_internal=tuple(c_internal),
                clamp=clamp,
                max_splits=max_splits,
                min_split_size=min_split_size,
                reshuffle=reshuffle,
                compute_dtype=compute_dtype,
                impl=impl,
            )
        )
    return Flow(ops, dim=dim).to(device)


def cinn(
    dim: int,
    cond_dim: int,
    n_blocks: int,
    hidden: int,
    perm_fixed: bool = False,
    clamp: float = DEFAULT_CLAMP,
    compute_dtype: str = "float32",
    device=None,
) -> Flow:
    ops = []
    for _ in range(n_blocks):
        ops.append(HouseholderPerm(dim=dim, n_reflections=dim, fixed=perm_fixed))
        ops.append(
            AffineCoupling(
                dim=dim, cond_dim=cond_dim, hidden=hidden, clamp=clamp, compute_dtype=compute_dtype
            )
        )
    return Flow(ops, dim=dim, cond_dim=cond_dim).to(device)


def recursive_cinn(
    dim: int,
    cond_dim: int,
    n_blocks: int,
    c_internal: Sequence[int],
    perm_fixed: bool = True,
    max_splits: int = -1,
    clamp: float = DEFAULT_CLAMP,
    compute_dtype: str = "float32",
    impl: str = "levelwise",
    device=None,
) -> Flow:
    ops = []
    for _ in range(n_blocks):
        ops.append(HouseholderPerm(dim=dim, n_reflections=dim, fixed=perm_fixed))
        ops.append(
            HierarchicalAffineCoupling(
                dim=dim,
                cond_dim=cond_dim,
                c_internal=tuple(c_internal),
                clamp=clamp,
                max_splits=max_splits,
                compute_dtype=compute_dtype,
                impl=impl,
            )
        )
    return Flow(ops, dim=dim, cond_dim=cond_dim).to(device)


def conditional_hint(
    dim_x: int,
    dim_y: int,
    n_blocks: int,
    c_internal: Sequence[int],
    hidden_external: int,
    hidden_y: int,
    perm_fixed: bool = True,
    max_splits: int = -1,
    clamp: float = DEFAULT_CLAMP,
    compute_dtype: str = "float32",
    impl: str = "levelwise",
    device=None,
) -> TwoLaneFlow:
    steps = []
    for i in range(n_blocks):
        if i > 0:  # perms between blocks only (conditional_hint_8_full.py:62-70)
            steps.append((LANE_Y, HouseholderPerm(dim=dim_y, n_reflections=dim_y, fixed=perm_fixed)))
            steps.append((LANE_X, HouseholderPerm(dim=dim_x, n_reflections=dim_x, fixed=perm_fixed)))
        steps.append(
            (
                LANE_X,
                HierarchicalAffineCoupling(
                    dim=dim_x,
                    c_internal=tuple(c_internal),
                    clamp=clamp,
                    max_splits=max_splits,
                    compute_dtype=compute_dtype,
                    impl=impl,
                ),
            )
        )
        steps.append(
            (
                LANE_YX,
                ExternalAffineCoupling(
                    dim=dim_x, cond_dim=dim_y, hidden=hidden_external, clamp=clamp,
                    compute_dtype=compute_dtype,
                ),
            )
        )
        steps.append(
            (
                LANE_Y,
                AffineCoupling(dim=dim_y, hidden=hidden_y, clamp=clamp, compute_dtype=compute_dtype),
            )
        )
    return TwoLaneFlow(steps, dim_y=dim_y, dim_x=dim_x).to(device)
