"""Householder permutation (port of ``hint_tpu/ops/householder.py``).

``Q = H_1 H_2 ... H_n`` is built as one matrix by a log-depth pairwise
product, so applying it is one ``x @ Q``. ``fixed=True`` stores ``Q`` as the
buffer ``q_fixed`` (frozen, saved with the model); ``fixed=False`` keeps the
reflection vectors ``vs`` as a parameter and rebuilds ``Q`` per call.
Conditional (``cond_dim > 0``): per-sample reflection vectors come from a
linear map of the condition (``w_cond``, ``b_cond``) and the reflections
are applied one after another as vector operations; no stock config runs
this path.

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


def _apply_reflections_seq(vs: torch.Tensor, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Apply per-sample reflections one after another (vs: (B, n, d),
    x: (B, d)), in reversed order for the inverse."""
    vs = vs / torch.linalg.norm(vs, dim=-1, keepdim=True)
    order = range(vs.shape[1])
    for i in reversed(order) if reverse else order:
        v = vs[:, i, :]
        x = x - 2.0 * torch.sum(x * v, dim=-1, keepdim=True) * v
    return x


class HouseholderPerm(Bijector):
    def __init__(self, dim: int, n_reflections: int = 1, fixed: bool = True, cond_dim: int = 0):
        super().__init__(dim, cond_dim)
        if cond_dim > 0 and fixed:
            raise ValueError("conditional HouseholderPerm cannot be fixed")
        self.n_reflections = n_reflections
        self.fixed = fixed
        if cond_dim > 0:
            self.w_cond = nn.Parameter(torch.zeros(cond_dim, n_reflections * dim))
            self.b_cond = nn.Parameter(torch.zeros(n_reflections * dim))
        elif fixed:
            self.register_buffer("q_fixed", torch.zeros(dim, dim))
        else:
            self.vs = nn.Parameter(torch.zeros(n_reflections, dim))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        if self.cond_dim > 0:
            for leaf, scale in ((self.w_cond, self.cond_dim**-0.5), (self.b_cond, 1.0)):
                leaf.copy_(scale * torch.randn(leaf.shape, generator=generator, device=generator.device))
            return
        vs = torch.randn(
            (self.n_reflections, self.dim), generator=generator, device=generator.device
        )
        if self.fixed:
            self.q_fixed.copy_(householder_matrix_product(vs))
        else:
            self.vs.copy_(vs)

    def _q(self) -> torch.Tensor:
        return self.q_fixed if self.fixed else householder_matrix_product(self.vs)

    def _cond_vs(self, cond: torch.Tensor) -> torch.Tensor:
        vs = cond @ self.w_cond + self.b_cond
        return vs.reshape(cond.shape[0], self.n_reflections, self.dim)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None):
        if self.cond_dim > 0:
            return _apply_reflections_seq(self._cond_vs(cond), x, reverse=False), self._zeros_logdet(x)
        return x @ self._q(), self._zeros_logdet(x)

    def inverse(self, y: torch.Tensor, cond: Optional[torch.Tensor] = None):
        if self.cond_dim > 0:
            return _apply_reflections_seq(self._cond_vs(cond), y, reverse=True), self._zeros_logdet(y)
        return y @ self._q().T, self._zeros_logdet(y)
