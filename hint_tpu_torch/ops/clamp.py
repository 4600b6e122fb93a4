"""Soft clamp for coupling scales (port of ``hint_tpu/ops/clamp.py``).

``e(s) = exp(clamp * 0.636 * atan(s))`` bounds ``log e(s)`` to
``(-clamp, clamp)``; the constant is the reference's truncated 2/pi.
"""

import torch

#: 2/pi, truncated exactly as in the reference (hint.py:57) for parity.
ATAN_SCALE = 0.636


def soft_clamp_log(s: torch.Tensor, clamp: float) -> torch.Tensor:
    """log of the clamped scale: ``clamp * 0.636 * atan(s)``."""
    return clamp * ATAN_SCALE * torch.atan(s)


def soft_clamp_exp(s: torch.Tensor, clamp: float) -> torch.Tensor:
    """Clamped multiplicative scale: ``exp(clamp * 0.636 * atan(s))``."""
    return torch.exp(soft_clamp_log(s, clamp))
