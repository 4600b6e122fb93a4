"""Flow graphs (port of ``hint_tpu/models/flow.py``): the single-lane chain
``Flow`` and the two-lane conditional-HINT graph ``TwoLaneFlow``.

The bijectors are submodules named by op (or step) index, ``b0``, ``b1``, ...,
the keys of the JAX package's parameter tree. Chains are always unrolled;
the JAX package's scanned layout exists only in memory there, and its
checkpoints are written unrolled. ``remat=True`` (``with_remat``) checkpoints
each bijector's forward: the backward recomputes its activations from its
input (identical math, less memory).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hint_tpu_torch.ops.base import Bijector


def _op_key(i: int) -> str:
    return f"b{i}"


# lanes of the steps of a TwoLaneFlow
LANE_Y = "y"  # bijector acts on the y lane
LANE_X = "x"  # bijector acts on the x lane (unconditioned)
LANE_YX = "y->x"  # bijector acts on the x lane, conditioned on the current y state


def with_remat(model):
    """Turn activation rematerialization on in ``model`` and return it."""
    model.remat = True
    return model


def _apply(b: Bijector, h: torch.Tensor, c: Optional[torch.Tensor], remat: bool):
    """One bijector's forward, checkpointed where ``remat`` asks for it."""
    if remat and torch.is_grad_enabled():
        return checkpoint(b, h, c, use_reentrant=False)
    return b(h, c)


class Flow(nn.Module):
    """Invertible chain. ``cond_dim > 0`` threads one condition to every op
    that declares a ``cond_dim``."""

    def __init__(self, bijectors: Sequence[Bijector], dim: int, cond_dim: int = 0, remat: bool = False):
        super().__init__()
        for i, b in enumerate(bijectors):
            self.add_module(_op_key(i), b)
        self.dim = dim
        self.cond_dim = cond_dim
        self.remat = remat

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
            x, j = _apply(b, x, cond if b.cond_dim > 0 else None, self.remat)
            logdet = logdet + j
        return x, logdet

    def inverse(self, z: torch.Tensor, cond: Optional[torch.Tensor] = None):
        logdet = torch.zeros(z.shape[:1], dtype=z.dtype, device=z.device)
        for b in reversed(self.bijectors):
            z, j = b.inverse(z, cond if b.cond_dim > 0 else None)
            logdet = logdet + j
        return z, logdet


class TwoLaneFlow(nn.Module):
    """Conditional HINT: joint invertible map (y, x) <-> (z_y, z_x).

    ``steps`` is a linear sequence of (lane, bijector). Ops never move mass
    between lanes; ``LANE_YX`` ops read the current y-lane state as their
    condition, which is invertible because they do not modify y. Log-dets
    are kept per lane: ``logdet_x`` covers exactly the x-lane ops
    (``LANE_X`` and ``LANE_YX``)."""

    def __init__(
        self, steps: Sequence[Tuple[str, Bijector]], dim_y: int, dim_x: int, remat: bool = False
    ):
        super().__init__()
        for i, (lane, b) in enumerate(steps):
            if lane not in (LANE_Y, LANE_X, LANE_YX):
                raise ValueError(f"unknown lane {lane!r}")
            self.add_module(_op_key(i), b)
        self.lanes = tuple(lane for lane, _ in steps)
        self.dim_y = dim_y
        self.dim_x = dim_x
        self.remat = remat

    @property
    def steps(self) -> Tuple[Tuple[str, Bijector], ...]:
        return tuple(zip(self.lanes, self.children()))

    def init(self, generator: torch.Generator) -> None:
        for _, b in self.steps:
            b.init(generator)

    def trainable_mask(self) -> Dict[str, bool]:
        return {
            f"{_op_key(i)}.{k}": v
            for i, (_, b) in enumerate(self.steps)
            for k, v in b.trainable_mask().items()
        }

    def forward(self, y: torch.Tensor, x: torch.Tensor):
        """Returns (z_y, z_x, logdet_y, logdet_x)."""
        ld_y = torch.zeros(y.shape[:1], dtype=y.dtype, device=y.device)
        ld_x = torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)
        for lane, b in self.steps:
            if lane == LANE_Y:
                y, j = _apply(b, y, None, self.remat)
                ld_y = ld_y + j
            else:
                x, j = _apply(b, x, y if lane == LANE_YX else None, self.remat)
                ld_x = ld_x + j
        return y, x, ld_y, ld_x

    def inverse(self, z_y: torch.Tensor, z_x: torch.Tensor):
        """Exact inverse; returns (y, x, logdet_y, logdet_x)."""
        ld_y = torch.zeros(z_y.shape[:1], dtype=z_y.dtype, device=z_y.device)
        ld_x = torch.zeros(z_x.shape[:1], dtype=z_x.dtype, device=z_x.device)
        for lane, b in reversed(self.steps):
            if lane == LANE_Y:
                z_y, j = b.inverse(z_y)
                ld_y = ld_y + j
            else:
                # the y-lane state here equals its forward-time value: later
                # y-ops are already inverted and this op does not modify y
                z_x, j = b.inverse(z_x, z_y if lane == LANE_YX else None)
                ld_x = ld_x + j
        return z_y, z_x, ld_y, ld_x
