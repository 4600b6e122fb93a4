"""Single-lane invertible chain (port of ``Flow`` in ``hint_tpu/models/flow.py``).

The chain's bijectors are submodules named by op index, ``b0``, ``b1``, ...,
the keys of the JAX package's parameter tree. Chains are always unrolled;
the JAX package's scanned layout exists only in memory there, and its
checkpoints are written unrolled.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from hint_tpu_torch.ops.base import Bijector


def _op_key(i: int) -> str:
    return f"b{i}"


class Flow(nn.Module):
    """Invertible chain. ``cond_dim > 0`` threads one condition to every op
    that declares a ``cond_dim``."""

    def __init__(self, bijectors: Sequence[Bijector], dim: int, cond_dim: int = 0):
        super().__init__()
        for i, b in enumerate(bijectors):
            self.add_module(_op_key(i), b)
        self.dim = dim
        self.cond_dim = cond_dim

    @property
    def bijectors(self) -> Tuple[Bijector, ...]:
        return tuple(self.children())

    def init(self, generator: torch.Generator) -> None:
        for b in self.bijectors:
            b.init(generator)

    def trainable_mask(self) -> Dict[str, bool]:
        return {
            f"{_op_key(i)}.{k}": v
            for i, b in enumerate(self.bijectors)
            for k, v in b.trainable_mask().items()
        }

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None):
        logdet = torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)
        for b in self.bijectors:
            x, j = b(x, cond if b.cond_dim > 0 else None)
            logdet = logdet + j
        return x, logdet

    def inverse(self, z: torch.Tensor, cond: Optional[torch.Tensor] = None):
        logdet = torch.zeros(z.shape[:1], dtype=z.dtype, device=z.device)
        for b in reversed(self.bijectors):
            z, j = b.inverse(z, cond if b.cond_dim > 0 else None)
            logdet = logdet + j
        return z, logdet
