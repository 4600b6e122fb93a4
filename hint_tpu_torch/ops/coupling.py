"""Affine coupling bijectors (port of ``hint_tpu/ops/coupling.py``).

* ``AffineCoupling``: two-sided (GLOW/RealNVP-style) affine coupling with an
  optional concatenated condition, the block of the ``inn`` and ``cinn``
  families and of the y lane of two-lane conditional HINT.
* ``ExternalAffineCoupling``: scale and shift of the whole input, driven
  purely by an external condition; the y->x coupling of two-lane conditional
  HINT. It counts towards the x lane's log-det.

Both use the soft clamp ``e(s) = exp(clamp * 0.636 * atan(s))`` of
``ops/clamp``. Each subnet is an ``nn.ParameterDict`` ``{w0 b0 w1 b1 w2 b2}``
under the JAX package's name (``f1``, ``f2``; ``f``), so the ``state_dict``
keys are its tree's key paths. Plain PyTorch: the JAX package leaves these
products to XLA too.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hint_tpu_torch.ops.base import Bijector
from hint_tpu_torch.ops.clamp import soft_clamp_exp, soft_clamp_log
from hint_tpu_torch.ops.subnets import MLPSpec


def _subnet_params(spec: MLPSpec) -> nn.ParameterDict:
    """Zeroed leaves of one subnet, in the order ``MLPSpec.init`` fills them."""
    dims = [(spec.in_dim, spec.hidden), (spec.hidden, spec.hidden), (spec.hidden, spec.out_dim)]
    leaves = {}
    for i, (fan_in, fan_out) in enumerate(dims):
        leaves[f"w{i}"] = nn.Parameter(torch.zeros(fan_in, fan_out))
        leaves[f"b{i}"] = nn.Parameter(torch.zeros(fan_out))
    return nn.ParameterDict(leaves)


@torch.no_grad()
def _init_subnet(params: nn.ParameterDict, spec: MLPSpec, generator: torch.Generator) -> None:
    for k, v in spec.init(generator).items():
        params[k].copy_(v)


class AffineCoupling(Bijector):
    """Split ``x`` into ``(x1, x2)`` at ``dim // 2``. Subnet ``f1`` maps
    ``x1 (+ cond)`` to ``(s2, t2)``, which transform ``x2``; ``f2`` maps the
    transformed ``y2 (+ cond)`` to ``(s1, t1)``, which transform ``x1``. The
    log-det is the sum of both clamped log-scales."""

    def __init__(
        self,
        dim: int,
        cond_dim: int = 0,
        hidden: int = 64,
        clamp: float = 4.0,
        compute_dtype: str = "float32",
    ):
        super().__init__(dim, cond_dim)
        self.hidden = hidden
        self.clamp = clamp
        self.compute_dtype = compute_dtype
        self.split1 = dim // 2
        self.split2 = dim - dim // 2
        self.spec1 = MLPSpec(self.split1 + cond_dim, hidden, 2 * self.split2, compute_dtype)
        self.spec2 = MLPSpec(self.split2 + cond_dim, hidden, 2 * self.split1, compute_dtype)
        self.f1 = _subnet_params(self.spec1)
        self.f2 = _subnet_params(self.spec2)

    def init(self, generator: torch.Generator) -> None:
        _init_subnet(self.f1, self.spec1, generator)
        _init_subnet(self.f2, self.spec2, generator)

    def _st(self, spec: MLPSpec, params, h: torch.Tensor, cond: Optional[torch.Tensor], out_dim: int):
        if self.cond_dim > 0:
            h = torch.cat([h, cond], dim=-1)
        a = spec.apply(params, h)
        return a[:, :out_dim], a[:, out_dim:]

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None):
        x1, x2 = x[:, : self.split1], x[:, self.split1 :]
        s2, t2 = self._st(self.spec1, self.f1, x1, cond, self.split2)
        y2 = soft_clamp_exp(s2, self.clamp) * x2 + t2
        s1, t1 = self._st(self.spec2, self.f2, y2, cond, self.split1)
        y1 = soft_clamp_exp(s1, self.clamp) * x1 + t1
        logdet = soft_clamp_log(s2, self.clamp).sum(-1) + soft_clamp_log(s1, self.clamp).sum(-1)
        return torch.cat([y1, y2], dim=-1), logdet

    def inverse(self, y: torch.Tensor, cond: Optional[torch.Tensor] = None):
        y1, y2 = y[:, : self.split1], y[:, self.split1 :]
        s1, t1 = self._st(self.spec2, self.f2, y2, cond, self.split1)
        x1 = (y1 - t1) / soft_clamp_exp(s1, self.clamp)
        s2, t2 = self._st(self.spec1, self.f1, x1, cond, self.split2)
        x2 = (y2 - t2) / soft_clamp_exp(s2, self.clamp)
        logdet = -(soft_clamp_log(s2, self.clamp).sum(-1) + soft_clamp_log(s1, self.clamp).sum(-1))
        return torch.cat([x1, x2], dim=-1), logdet


class ExternalAffineCoupling(Bijector):
    """``(s, t) = F(cond)``; ``y = e(s) * x + t``. Requires ``cond_dim > 0``."""

    def __init__(
        self,
        dim: int,
        cond_dim: int,
        hidden: int = 64,
        clamp: float = 4.0,
        compute_dtype: str = "float32",
    ):
        super().__init__(dim, cond_dim)
        if cond_dim <= 0:
            raise ValueError("ExternalAffineCoupling requires cond_dim > 0")
        self.hidden = hidden
        self.clamp = clamp
        self.compute_dtype = compute_dtype
        self.spec = MLPSpec(cond_dim, hidden, 2 * dim, compute_dtype)
        self.f = _subnet_params(self.spec)

    def init(self, generator: torch.Generator) -> None:
        _init_subnet(self.f, self.spec, generator)

    def _st(self, cond: torch.Tensor):
        a = self.spec.apply(self.f, cond)
        return a[:, : self.dim], a[:, self.dim :]

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None):
        s, t = self._st(cond)
        return soft_clamp_exp(s, self.clamp) * x + t, soft_clamp_log(s, self.clamp).sum(-1)

    def inverse(self, y: torch.Tensor, cond: Optional[torch.Tensor] = None):
        s, t = self._st(cond)
        return (y - t) / soft_clamp_exp(s, self.clamp), -soft_clamp_log(s, self.clamp).sum(-1)
