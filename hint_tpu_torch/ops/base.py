"""Bijector protocol, devices and matmul precision for the PyTorch port.

A bijector is an ``nn.Module`` that owns its parameters and buffers under
the JAX package's leaf names, so a module's ``state_dict`` keys are the
JAX parameter tree's key paths joined by dots (``L3.w1``, ``q_fixed``).

    bij.init(generator)            # fill parameters from a torch.Generator
    y, logdet = bij(x, cond)       # forward
    x, logdet_inv = bij.inverse(y, cond)
    mask = bij.trainable_mask()    # {state_dict key: bool}

``logdet`` has shape ``(batch,)`` and ``logdet_inv == -logdet``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def exact_f32_matmul() -> None:
    """Full-f32 products on the card (no TF32), the counterpart of the JAX
    package's ``Precision.HIGHEST`` (ops/subnets.py, ops/hac.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def matmul_f32acc(a: torch.Tensor, w: torch.Tensor, compute_dtype: str, spec: str = None):
    """``a @ w`` (or ``einsum(spec, a, w)``) with operands rounded to
    ``compute_dtype`` and float32 accumulation, like
    ``preferred_element_type=float32`` in JAX. bf16 x bf16 products are
    exact in f32, so rounding the operands and multiplying in f32 is the
    same arithmetic."""
    if compute_dtype == "bfloat16":
        a = a.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    elif compute_dtype != "float32":
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    return torch.einsum(spec, a, w) if spec else a @ w


class Bijector(nn.Module):
    """Base class: ``dim`` is the width of the flat feature axis it
    transforms, ``cond_dim`` the width of the condition fed to its
    subnets (0 = none)."""

    def __init__(self, dim: int = 0, cond_dim: int = 0):
        super().__init__()
        self.dim = dim
        self.cond_dim = cond_dim

    def init(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None):
        raise NotImplementedError

    def inverse(self, y: torch.Tensor, cond: Optional[torch.Tensor] = None):
        raise NotImplementedError

    def trainable_mask(self) -> Dict[str, bool]:
        """True where a state entry is trainable. Default: parameters are,
        buffers (frozen maps such as ``q_fixed``) are not."""
        params = {name for name, _ in self.named_parameters()}
        return {k: k in params for k in self.state_dict()}

    @staticmethod
    def _zeros_logdet(x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)
