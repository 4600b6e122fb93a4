"""Model builders (port of ``hint_tpu/models/builders.py``).

Only the ``hint`` family is ported: [HAC, perm, HAC, perm, ...] with a
fixed (or trainable) Householder permutation between blocks only
(configs/plus_shape/unconditional_hint_4_full.py:58-72 of the reference).
The other families wait for ROADMAP M3 (inn) and M7 (cinn,
recursive_cinn, conditional_hint).
"""

from __future__ import annotations

from typing import Sequence

from hint_tpu_torch.models.flow import Flow
from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling
from hint_tpu_torch.ops.householder import HouseholderPerm

DEFAULT_CLAMP = 4.0  # HAC-block default in the reference (hint.py:108)


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
