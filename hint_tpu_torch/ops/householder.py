"""Householder permutation (port of ``hint_tpu/ops/householder.py``).

``Q = H_1 H_2 ... H_n`` is built as one matrix by a log-depth pairwise
product, so applying it is one ``x @ Q``. ``fixed=True`` stores ``Q`` as the
buffer ``q_fixed`` (frozen, saved with the model); ``fixed=False`` keeps the
reflection vectors ``vs`` as a parameter and rebuilds ``Q`` per call.

Convention: row-vector action, forward ``y = x @ Q``, inverse
``x = y @ Q^T``; log|det J| = 0.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hint_tpu_torch.ops.base import Bijector


def householder_matrix_product(vs: torch.Tensor) -> torch.Tensor:
    """Q = H_1 @ H_2 @ ... @ H_n via log-depth pairwise tree reduction.

    vs: (n_reflections, d). Returns (d, d) orthogonal Q.
    """
    n, d = vs.shape
    vn = vs / torch.linalg.norm(vs, dim=-1, keepdim=True)
    hs = torch.eye(d, dtype=vs.dtype, device=vs.device)[None] - 2.0 * torch.einsum(
        "ni,nj->nij", vn, vn
    )
    while hs.shape[0] > 1:
        m = hs.shape[0]
        if m % 2 == 1:
            hs = torch.cat([torch.bmm(hs[0 : m - 1 : 2], hs[1 : m - 1 : 2]), hs[-1:]])
        else:
            hs = torch.bmm(hs[0::2], hs[1::2])
    return hs[0]


class HouseholderPerm(Bijector):
    def __init__(self, dim: int, n_reflections: int = 1, fixed: bool = True, cond_dim: int = 0):
        super().__init__(dim, cond_dim)
        if cond_dim > 0:
            raise NotImplementedError(
                "conditional HouseholderPerm is not ported yet (ROADMAP M7)"
            )
        self.n_reflections = n_reflections
        self.fixed = fixed
        if fixed:
            self.register_buffer("q_fixed", torch.zeros(dim, dim))
        else:
            self.vs = nn.Parameter(torch.zeros(n_reflections, dim))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        vs = torch.randn(
            (self.n_reflections, self.dim), generator=generator, device=generator.device
        )
        if self.fixed:
            self.q_fixed.copy_(householder_matrix_product(vs))
        else:
            self.vs.copy_(vs)

    def _q(self) -> torch.Tensor:
        return self.q_fixed if self.fixed else householder_matrix_product(self.vs)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None):
        return x @ self._q(), self._zeros_logdet(x)

    def inverse(self, y: torch.Tensor, cond: Optional[torch.Tensor] = None):
        return y @ self._q().T, self._zeros_logdet(y)
