"""Multi-kernel MMD with inverse-multiquadric kernels (port of
``hint_tpu/evaluation/mmd.py``).

The reference metric (rejection_sampling.py:56-73 of the reference):
``k(d²) = Σ_i C_i^{a_i} ((C_i + d²)/a_i)^{-a_i}`` over squared pairwise
distances, with the reference's default width/exponent pairs, and the mean
of ``k(dxx) + k(dyy) − 2 k(dxy)``. The Gram matrices are float32 products
with TF32 off (``exact_f32_matmul``), the counterpart of the JAX package's
``Precision.HIGHEST``; in JAX they are XLA products, not a Pallas kernel, so
here they are plain ``torch.matmul``. The squared distances keep the JAX
package's order of terms, ``rx + ry − 2·xy``, and its clip at 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from hint_tpu_torch.ops.base import exact_f32_matmul, resolve_device

DEFAULT_WIDTHS_EXPONENTS: Tuple[Tuple[float, float], ...] = (
    (0.5, 1.0),
    (0.2, 1.0),
    (0.2, 0.5),
)  # rejection_sampling.py:56


def _sq_dists(x: torch.Tensor, y: torch.Tensor):
    xx = x @ x.T
    yy = y @ y.T
    xy = x @ y.T
    rx = torch.diagonal(xx)[None, :]
    ry = torch.diagonal(yy)[None, :]
    dxx = torch.clamp(rx.T + rx - 2.0 * xx, min=0.0)
    dyy = torch.clamp(ry.T + ry - 2.0 * yy, min=0.0)
    dxy = torch.clamp(rx.T + ry - 2.0 * xy, min=0.0)
    return dxx, dyy, dxy


def multi_mmd(
    x,
    y,
    widths_exponents: Sequence[Tuple[float, float]] = DEFAULT_WIDTHS_EXPONENTS,
    mesh=None,
    device=None,
) -> torch.Tensor:
    """Biased multi-kernel MMD estimate between samples x and y, a 0-d
    tensor. ``x`` and ``y`` are tensors (computed where they lie, in their
    dtype) or arrays (moved as float32 to ``device``, CUDA unless named)."""
    if mesh is not None:
        raise NotImplementedError("sharded MMD is not ported yet (ROADMAP M8)")
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float32, device=resolve_device(device))
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    exact_f32_matmul()
    dxx, dyy, dxy = _sq_dists(x, y)
    xx = torch.zeros_like(dxx)
    yy = torch.zeros_like(dyy)
    xy = torch.zeros_like(dxy)
    for c, a in widths_exponents:
        xx = xx + c**a * ((c + dxx) / a) ** -a
        yy = yy + c**a * ((c + dyy) / a) ** -a
        xy = xy + c**a * ((c + dxy) / a) ** -a
    return torch.mean(xx + yy - 2.0 * xy)
