"""Coupling subnet: 3-layer ReLU MLP (port of ``hint_tpu/ops/subnets.py``).

Params are a flat dict ``{w0,b0,w1,b1,w2,b2}`` with ``(in, out)`` weight
orientation. Products take the compute dtype's operands and accumulate in
float32; parameters stay float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from hint_tpu_torch.ops.base import matmul_f32acc


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    in_dim: int
    hidden: int
    out_dim: int
    compute_dtype: str = "float32"

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from ``generator``
        on its device (torch.nn.Linear-like)."""
        dims = [(self.in_dim, self.hidden), (self.hidden, self.hidden), (self.hidden, self.out_dim)]
        params = {}
        for i, (fan_in, fan_out) in enumerate(dims):
            bound = 1.0 / math.sqrt(max(fan_in, 1))
            for name, shape in ((f"w{i}", (fan_in, fan_out)), (f"b{i}", (fan_out,))):
                params[name] = torch.empty(shape, device=generator.device).uniform_(
                    -bound, bound, generator=generator
                )
        return params

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(3):
            h = matmul_f32acc(h, params[f"w{i}"], self.compute_dtype) + params[f"b{i}"]
            if i < 2:
                h = torch.relu(h)
        return h

    @property
    def n_params(self) -> int:
        return (
            self.in_dim * self.hidden
            + self.hidden * self.hidden
            + self.hidden * self.out_dim
            + 2 * self.hidden
            + self.out_dim
        )
