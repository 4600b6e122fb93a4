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

With a ``mesh`` (``hint_tpu_torch.parallel``) each rank takes its block of
rows of the three kernel matrices (its x rows against all x, its y rows
against all y, its x rows against all y), sums their entries and one
all-reduce adds the ranks' sums. Row counts that the ranks do not divide
are evaluated unsharded, as in ``hint_tpu``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from hint_tpu_torch.ops.base import exact_f32_matmul, resolve_device
from hint_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_sum, shard_batch

DEFAULT_WIDTHS_EXPONENTS: Tuple[Tuple[float, float], ...] = (
    (0.5, 1.0),
    (0.2, 1.0),
    (0.2, 0.5),
)  # rejection_sampling.py:56


def _sq_dists(x: torch.Tensor, y: torch.Tensor, mesh=None):
    """Squared distances of the x rows to all x, of the y rows to all y and
    of the x rows to all y; under a mesh, of this rank's block of rows. The
    squared norms are the Gram products' diagonals, each rank's from its
    block and gathered."""
    xb, yb = (x, y) if mesh is None else (shard_batch(x, mesh), shard_batch(y, mesh))
    xx, yy, xy = xb @ x.T, yb @ y.T, xb @ y.T
    rows = torch.arange(xb.shape[0], device=x.device)
    lo = 0 if mesh is None else mesh.rank * len(rows)
    rxb, ryb = xx[rows, lo + rows], yy[rows, lo + rows]
    rx, ry = (rxb, ryb) if mesh is None else (all_gather_rows(rxb, mesh), all_gather_rows(ryb, mesh))
    dxx = torch.clamp(rxb[:, None] + rx[None, :] - 2.0 * xx, min=0.0)
    dyy = torch.clamp(ryb[:, None] + ry[None, :] - 2.0 * yy, min=0.0)
    dxy = torch.clamp(rxb[:, None] + ry[None, :] - 2.0 * xy, min=0.0)
    return dxx, dyy, dxy


def _kernel(d2: torch.Tensor, widths_exponents) -> torch.Tensor:
    k = torch.zeros_like(d2)
    for c, a in widths_exponents:
        k = k + c**a * ((c + d2) / a) ** -a
    return k


def multi_mmd(
    x,
    y,
    widths_exponents: Sequence[Tuple[float, float]] = DEFAULT_WIDTHS_EXPONENTS,
    mesh=None,
    device=None,
) -> torch.Tensor:
    """Biased multi-kernel MMD estimate between samples x and y, a 0-d
    tensor. ``x`` and ``y`` are tensors (computed where they lie, in their
    dtype) or arrays (moved as float32 to ``device``, CUDA unless named;
    under a mesh, to the mesh's device)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float32, device=mesh.device if mesh is not None else resolve_device(device))
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    exact_f32_matmul()
    if mesh is not None and (x.shape[0] % mesh.size or y.shape[0] % mesh.size):
        mesh = None
    dxx, dyy, dxy = _sq_dists(x, y, mesh)
    k = _kernel(dxx, widths_exponents) + _kernel(dyy, widths_exponents) - 2.0 * _kernel(dxy, widths_exponents)
    if mesh is None:
        return torch.mean(k)
    # the mean over the whole matrices: the ranks' sums over the entries
    return all_reduce_sum(k.sum()[None], mesh)[0] / (x.shape[0] * y.shape[0])
