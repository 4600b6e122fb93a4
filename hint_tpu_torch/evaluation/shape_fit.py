"""Parametric ideal-shape fitting, the shape-realism metric (port of
``hint_tpu/evaluation/shape_fit.py``).

The reference fits one curve at a time with torch autograd on the CPU,
looping restarts in Python (best_shape_fit.py:100-129, 238-261 of the
reference). Here, as in ``hint_tpu``, every curve and every restart of a
batch is fitted at once: the parameters are one ``(B, restarts, P)`` tensor
on the device, and each of the 400 (plus) or 100 (lens) SGD steps takes the
gradient of the summed loss, which is each restart's own gradient since
restarts share nothing. Products are written out elementwise (the outlines'
rotations, the point-to-segment projections), so they are exact float32 on
every device and no matmul precision setting reaches them.

Semantics kept from ``hint_tpu`` (and the reference):

* plus loss: mean over points of the min squared distance to the 12
  outline segments + corner_weight · mean over corners of the min squared
  distance to the points, corner_weight = 1 − i/n_steps in float32
  (best_shape_fit.py:54-65,115); the minima are ``torch.amin``, whose
  gradient splits evenly over tied entries as ``jnp.min``'s does;
* plus outline with the ±0.01 arm clamps (best_shape_fit.py:26-50), the
  clip of the projection as ``jnp.clip`` computes it (max, then min);
* lens loss: two-sided mean-of-minima squared distance between the
  parameterized prototype and the points (best_shape_fit.py:203-209);
  prototype = circle(0,0,1.5) ∩ circle(3.6,0,3.0), resolution 64, centered;
* SGD momentum 0.2, lr 0.1 (angle 0.01), decay 0.1^(1/steps) raised to the
  float32 step index (best_shape_fit.py:108-110, 244-246);
* 9 xy-shift restarts for plus, the dominant angle and its antipode for
  lens; the winner by the reference's early break at 0.005 over the
  restarts in order (``_select_restart``, best_shape_fit.py:122-129).

Difference by design: the plus angle seed of a single curve
(``fit_plus_shape_to_points``) comes from the batched numpy RANSAC
(``dominant_angles_ransac_batch``) on a batch of one, not from scikit-learn's
``RANSACRegressor``; the batch path of ``hint_tpu`` uses the same numpy
RANSAC. Hausdorff distances come from ``hint_tpu_torch.data.geometry``.

With a ``mesh`` (``hint_tpu_torch.parallel``) the batched fits and the
IoU/DICE rasters run data-parallel: the curves are padded to a multiple of
the ranks, each rank fits or rasterizes its block of them on the mesh's
device, and every rank gathers all the results (``hint_tpu`` shards them
over its mesh).

Run ``python -m hint_tpu_torch.evaluation.shape_fit [--device cpu]`` for the
plus and lens self-checks (IoU ≳ 0.9 plus, ≳ 0.85 lens on clean shapes).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from hint_tpu_torch.data import geometry
from hint_tpu_torch.ops.base import resolve_device
from hint_tpu_torch.parallel.mesh import map_rows

PLUS_STEPS = 400  # best_shape_fit.py:113
LENS_STEPS = 100  # best_shape_fit.py:249
MOMENTUM = 0.2
LR_MAIN = 0.1
LR_ANGLE = 0.01
EARLY_BREAK_LOSS = 0.005  # best_shape_fit.py:123

# 9 restart shifts (best_shape_fit.py:100)
PLUS_XYSHIFTS = np.array(
    [(0, 0), (-1.5, -1.5), (-1.5, 0), (-1.5, 1.5), (0, -1.5), (0, 1.5), (1.5, -1.5), (1.5, 0), (1.5, 1.5)],
    np.float32,
)


def _rotate(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """``points @ [[c, s], [-s, c]]`` for points (..., 2) and an angle
    that broadcasts to ``points[..., 0]``."""
    c, s = torch.cos(angle), torch.sin(angle)
    px, py = points[..., 0], points[..., 1]
    return torch.stack([px * c - py * s, px * s + py * c], dim=-1)


# -- plus shape ----------------------------------------------------------------


def plus_segments(params: torch.Tensor) -> torch.Tensor:
    """(..., 12, 2, 2) outline segments of the plus from (..., 9) vectors
    [xlength, ylength, xwidth, ywidth, xshift, yshift, xoffset, yoffset, angle]
    (best_shape_fit.py:26-50)."""
    xlength, ylength, xwidth, ywidth, xshift, yshift, xoffset, yoffset, angle = params.unbind(-1)
    xleft, xbottom = xshift - xlength / 2, -xwidth / 2
    xright, xtop = xshift + xlength / 2, xwidth / 2
    yleft, ybottom = -ywidth / 2, yshift - ylength / 2
    yright, ytop = ywidth / 2, yshift + ylength / 2
    xleft = torch.minimum(xleft, yleft - 0.01)
    xright = torch.maximum(xright, yright + 0.01)
    ytop = torch.maximum(ytop, xtop + 0.01)
    ybottom = torch.minimum(ybottom, xbottom - 0.01)
    corners = torch.stack(
        [
            torch.stack(p, dim=-1)
            for p in (
                (xleft, xtop), (yleft, xtop), (yleft, ytop), (yright, ytop),
                (yright, xtop), (xright, xtop), (xright, xbottom), (yright, xbottom),
                (yright, ybottom), (yleft, ybottom), (yleft, xbottom), (xleft, xbottom),
            )
        ],
        dim=-2,
    )
    segs = torch.stack([corners, torch.roll(corners, -1, dims=-2)], dim=-2)
    offset = torch.stack([xoffset, yoffset], dim=-1)[..., None, None, :]
    return _rotate(segs, angle[..., None, None]) + offset


def _sq_dist_points_to_segments(points: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
    """Squared distance from each point to each segment a→b
    (best_shape_fit.py:15-22): points (B, N, 2), segs (B, R, S, 2, 2) ->
    (B, R, S, N)."""
    a, b = segs[..., 0, :], segs[..., 1, :]
    n = b - a
    length = torch.sqrt(torch.sum(n * n, dim=-1))
    n = n / length[..., None]
    ap = a[..., None, :] - points[:, None, None, :, :]  # (B, R, S, N, 2)
    proj = -(ap[..., 0] * n[..., None, 0] + ap[..., 1] * n[..., None, 1])
    t = torch.minimum(length[..., None], torch.maximum(proj.new_zeros(()), proj))
    short = ap + t[..., None] * n[..., None, :]
    return torch.sum(short**2, dim=-1)


def plus_loss(points: torch.Tensor, params: torch.Tensor, corner_weight) -> torch.Tensor:
    """(best_shape_fit.py:54-65) for points (B, N, 2) and params (B, R, 9):
    the loss of every restart, (B, R)."""
    segs = plus_segments(params)
    d = _sq_dist_points_to_segments(points, segs)
    point_term = torch.amin(d, dim=-2).mean(dim=-1)
    corners = segs[..., 0, :]  # (B, R, 12, 2)
    cd = torch.sum((corners[..., :, None, :] - points[:, None, None, :, :]) ** 2, dim=-1)
    corner_term = torch.amin(cd, dim=-1).mean(dim=-1)
    return point_term + corner_weight * corner_term


# -- lens shape ----------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def lens_prototype() -> np.ndarray:
    """Centered lens outline: circle(0,0,1.5) ∩ circle(3.6,0,3.0),
    resolution 64, closed ring (best_shape_fit.py:222-226)."""
    c0 = geometry.circle_polygon(0.0, 0.0, 1.5, resolution=64)
    c1 = geometry.circle_polygon(3.6, 0.0, 3.0, resolution=64)
    ring = geometry.convex_intersection(c0, c1)
    ring = np.concatenate([ring, ring[:1]], axis=0)  # shapely exterior closes
    return (ring - ring.mean(axis=0)).astype(np.float32)


def lens_points(prototype: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Prototype (P, 2) rotated, scaled, shifted by (..., 4) vectors [x, y,
    scale, angle] (best_shape_fit.py:195-199): (..., P, 2)."""
    x, y, scale, angle = params.unbind(-1)
    shift = torch.stack([x, y], dim=-1)[..., None, :]
    return _rotate(prototype, angle[..., None]) * scale[..., None, None] + shift


def lens_loss(prototype, points, params, fit_weight=1.0):
    """(best_shape_fit.py:203-209) for points (B, N, 2) and params (B, R, 4):
    (B, R)."""
    lens = lens_points(prototype, params)  # (B, R, P, 2)
    d = torch.sum((lens[..., None, :, :] - points[:, None, :, None, :]) ** 2, dim=-1)  # (B, R, N, P)
    return torch.amin(d, dim=-1).mean(dim=-1) + fit_weight * torch.amin(d, dim=-2).mean(dim=-1)


# -- fitting engine --------------------------------------------------------------


def _sgd_fit(loss_of, params0: torch.Tensor, lr_vec: torch.Tensor, n_steps: int, decay: float):
    """SGD+momentum with per-parameter lr and per-step exponential decay over
    every restart at once; returns (final params, loss at the last step), as
    ``hint_tpu``'s ``lax.scan`` does. ``loss_of(params, i)`` gets the float32
    step index for annealed weights and returns one loss per restart."""
    steps = torch.arange(n_steps, dtype=torch.float32, device=params0.device)
    decay_t = torch.tensor(decay, dtype=torch.float32, device=params0.device)
    params, buf, loss = params0, torch.zeros_like(params0), None
    for k in range(n_steps):
        i = steps[k]
        with torch.enable_grad():
            p = params.detach().requires_grad_()
            loss = loss_of(p, i)
            (g,) = torch.autograd.grad(loss.sum(), p)
        buf = MOMENTUM * buf + g
        params = params - lr_vec * decay_t**i * buf
    return params.detach(), loss.detach()


def _fit_plus_restarts(points: torch.Tensor, angle: torch.Tensor, n_steps: int = PLUS_STEPS):
    """Fit all 9 restarts of every curve: points (B, N, 2), angle (B,);
    returns (params (B, 9, 9), losses (B, 9))."""
    center = points.mean(dim=1)
    shifts = torch.as_tensor(PLUS_XYSHIFTS, device=points.device)
    B, R = points.shape[0], shifts.shape[0]
    column = lambda v: v[:, None].expand(B, R)  # noqa: E731
    const = lambda v: points.new_full((B, R), v)  # noqa: E731
    params0 = torch.stack(
        [const(5.0), const(5.0), const(2.0), const(2.0), shifts[None, :, 0].expand(B, R),
         shifts[None, :, 1].expand(B, R), column(center[:, 0]), column(center[:, 1]), column(angle)],
        dim=-1,
    )
    lr_vec = torch.tensor([LR_MAIN] * 8 + [LR_ANGLE], dtype=torch.float32, device=points.device)
    decay = 0.1 ** (1.0 / n_steps)

    def loss_of(params, i):
        return plus_loss(points, params, corner_weight=1.0 - i / n_steps)

    return _sgd_fit(loss_of, params0, lr_vec, n_steps, decay)


def _fit_lens_restarts(points: torch.Tensor, angle: torch.Tensor, n_steps: int = LENS_STEPS):
    """Fit both angle restarts of every curve: points (B, N, 2), angle (B,);
    returns (params (B, 2, 4), losses (B, 2))."""
    proto = torch.as_tensor(lens_prototype(), device=points.device)
    center = points.mean(dim=1)
    angles = torch.stack([angle, torch.remainder(angle + math.pi, 2 * math.pi)], dim=1)  # (B, 2)
    B = points.shape[0]
    params0 = torch.stack(
        [center[:, None, 0].expand(B, 2), center[:, None, 1].expand(B, 2), points.new_full((B, 2), 2.0), angles],
        dim=-1,
    )
    lr_vec = torch.tensor([LR_MAIN] * 3 + [LR_ANGLE], dtype=torch.float32, device=points.device)
    decay = 0.1 ** (1.0 / n_steps)

    def loss_of(params, i):
        return lens_loss(proto, points, params)

    return _sgd_fit(loss_of, params0, lr_vec, n_steps, decay)


def _select_restart(params: np.ndarray, losses: np.ndarray) -> np.ndarray:
    """Reference winner: restarts run in order with an early break once a
    loss < 0.005 appears; the winner is the min over the evaluated prefix
    (best_shape_fit.py:122-129). Diverged (non-finite) restarts never win."""
    losses = np.where(np.isfinite(losses), losses, np.inf)
    below = np.nonzero(losses < EARLY_BREAK_LOSS)[0]
    end = below[0] + 1 if len(below) else len(losses)
    k = int(np.argmin(losses[:end]))
    return params[k]


def dominant_angles_ransac_batch(
    curves: np.ndarray,
    residual_threshold: float = 0.05,
    n_trials: int = 100,
    seed: int = 0,
) -> np.ndarray:
    """Vectorized RANSAC line angles for (B, N, 2) curves in one numpy pass
    (a copy of ``hint_tpu``'s).

    2-point line hypotheses, inlier count at ``residual_threshold`` on
    |y - (ax+b)|, least-squares refit on the best hypothesis's inliers — the
    procedure of best_shape_fit.py:83-89 — for all B curves × ``n_trials``
    hypotheses at once. The angle only seeds the multi-restart fitter, which
    refines it over 9 shifts.
    """
    curves = np.asarray(curves, np.float64)
    b, npts, _ = curves.shape
    x, y = curves[..., 0], curves[..., 1]
    rng = np.random.RandomState(seed)
    i1 = rng.randint(0, npts, size=(b, n_trials))
    # distinct second index: shift by a nonzero offset mod N
    i2 = (i1 + rng.randint(1, npts, size=(b, n_trials))) % npts
    rows = np.arange(b)[:, None]
    x1, y1 = x[rows, i1], y[rows, i1]
    x2, y2 = x[rows, i2], y[rows, i2]
    dx = x2 - x1
    degenerate = np.abs(dx) < 1e-12
    a = np.where(degenerate, 0.0, (y2 - y1) / np.where(degenerate, 1.0, dx))
    c = y1 - a * x1
    # residuals: (B, T, N)
    resid = np.abs(y[:, None, :] - a[..., None] * x[:, None, :] - c[..., None])
    inlier = resid <= residual_threshold
    counts = np.where(degenerate, -1, inlier.sum(-1))
    best = counts.argmax(1)
    mask = inlier[rows[:, 0], best]  # (B, N)
    # least-squares refit on the inlier set (simple linear regression);
    # curves with <2 inliers or x-degenerate inlier sets keep the best
    # hypothesis's slope instead of a refit over a biased denominator
    w = mask.astype(np.float64)
    n_in = w.sum(1)
    safe_n = np.maximum(n_in, 1.0)
    mx, my = (w * x).sum(1) / safe_n, (w * y).sum(1) / safe_n
    cov = (w * (x - mx[:, None]) * (y - my[:, None])).sum(1)
    var = (w * (x - mx[:, None]) ** 2).sum(1)
    a_best = a[rows[:, 0], best]
    slope = np.where(
        (n_in >= 2) & (var > 1e-12), cov / np.maximum(var, 1e-12), a_best
    )
    return np.arctan2(slope, 1.0).astype(np.float32)


def dominant_angle_lens(points: np.ndarray) -> float:
    """Angle of the most distant point pair (best_shape_fit.py:231-235)."""
    d = np.sum((points[None, :, :] - points[:, None, :]) ** 2, axis=-1)
    i, j = np.unravel_index(int(d.argmax()), d.shape)
    v = points[j] - points[i]
    return float(-np.arctan2(v[0], v[1]))


def _fit_batch(fit, curves, angles, device, mesh) -> np.ndarray:
    dev = mesh.device if mesh is not None else resolve_device(device)
    curves = torch.as_tensor(np.asarray(curves, np.float32), device=dev)
    angles = torch.as_tensor(np.asarray(angles, np.float32), device=dev)
    params, losses = map_rows(fit, mesh, curves, angles)
    params, losses = params.cpu().numpy(), losses.cpu().numpy()
    return np.stack([_select_restart(params[i], losses[i]) for i in range(len(params))])


def fit_plus_shapes_batch(curves: np.ndarray, mesh=None, device=None) -> np.ndarray:
    """Best-fit (B, 9) plus params for (B, N, 2) curves: RANSAC angle seeds
    on the host, then the 400-step fit of B × 9 restarts on the device."""
    if len(curves) == 0:
        return np.zeros((0, 9), np.float32)
    return _fit_batch(_fit_plus_restarts, curves, dominant_angles_ransac_batch(curves), device, mesh)


def fit_lens_shapes_batch(curves: np.ndarray, mesh=None, device=None) -> np.ndarray:
    """Best-fit (B, 4) lens params for (B, N, 2) curves."""
    if len(curves) == 0:
        return np.zeros((0, 4), np.float32)
    angles = np.array([dominant_angle_lens(c) for c in curves], np.float32)
    return _fit_batch(_fit_lens_restarts, curves, angles, device, mesh)


def fit_plus_shape_to_points(points: np.ndarray, device=None) -> np.ndarray:
    """Best-fit 9-vector plus params for one (N, 2) curve (its angle seed
    from the batched numpy RANSAC on a batch of one)."""
    return fit_plus_shapes_batch(np.asarray(points)[None], device=device)[0]


def fit_lens_shape_to_points(points: np.ndarray, device=None) -> np.ndarray:
    """Best-fit 4-vector lens params for one (N, 2) curve."""
    return fit_lens_shapes_batch(np.asarray(points)[None], device=device)[0]


# -- metrics ---------------------------------------------------------------------


def _plus_corners(params: np.ndarray) -> np.ndarray:
    return plus_segments(torch.as_tensor(np.asarray(params, np.float32)))[..., 0, :].numpy()


def _lens_outline(params: np.ndarray) -> np.ndarray:
    return lens_points(torch.as_tensor(lens_prototype()), torch.as_tensor(np.asarray(params, np.float32))).numpy()


def iou_and_dice_plus(params: np.ndarray, points: np.ndarray) -> Tuple[float, float]:
    """(best_shape_fit.py:133-139)."""
    return geometry.iou_and_dice(_plus_corners(params), points)


def iou_and_dice_lens(params: np.ndarray, points: np.ndarray) -> Tuple[float, float]:
    """(best_shape_fit.py:265-271)."""
    return geometry.iou_and_dice(_lens_outline(params), points)


def hausdorff_plus(params: np.ndarray, points: np.ndarray, max_dist: float = 0.02):
    """Densified plus outline vs curve (best_shape_fit.py:153-156)."""
    from hint_tpu_torch.data.fourier import PlusShapeModel

    dense = PlusShapeModel().densify_polyline(_plus_corners(params), max_dist=max_dist)
    return geometry.hausdorff(dense, points)


def hausdorff_lens(params: np.ndarray, points: np.ndarray):
    """(best_shape_fit.py:275-277)."""
    return geometry.hausdorff(_lens_outline(params), points)


# -- batched device scoring --------------------------------------------------------
#
# Every outline of a batch in one call, and the even-odd rasterization of
# IoU/DICE on the device (the crossing-number semantics of
# geometry.points_in_polygon; float32 on the device against the host's
# float64 can move the odd boundary pixel, <0.5 % of a 512² raster).


def lens_outlines_batch(params: np.ndarray, device=None) -> np.ndarray:
    """(B, P, 2) lens outlines for a (B, 4) parameter batch."""
    dev = resolve_device(device)
    proto = torch.as_tensor(lens_prototype(), device=dev)
    return lens_points(proto, torch.as_tensor(np.asarray(params, np.float32), device=dev)).cpu().numpy()


def plus_outlines_batch(params: np.ndarray, device=None) -> np.ndarray:
    """(B, 12, 2) plus corner outlines for a (B, 9) parameter batch."""
    dev = resolve_device(device)
    return plus_segments(torch.as_tensor(np.asarray(params, np.float32), device=dev))[:, :, 0, :].cpu().numpy()


def _even_odd_inside(xs: torch.Tensor, ys: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """Even-odd inside test of the pixel grids (B, R rows at ``ys``, C
    columns at ``xs``) against polygons (B, M, 2): (B, R * C), rows major.
    A row's crossing of each edge does not depend on the column, so it is
    computed once per row; a pixel is inside where an odd number of the
    row's crossings lie strictly right of it, counted by a sorted search."""
    x0, y0 = poly[..., 0], poly[..., 1]
    x1, y1 = torch.roll(x0, -1, dims=-1), torch.roll(y0, -1, dims=-1)
    py = ys[:, :, None]
    a0, b0, a1, b1 = (t[:, None, :] for t in (x0, y0, x1, y1))
    cond = (b0 <= py) != (b1 <= py)
    x_int = a0 + (py - b0) * (a1 - a0) / (b1 - b0)
    crossings = torch.where(cond, x_int, torch.full_like(x_int, -float("inf"))).sort(dim=-1).values
    px = xs[:, None, :].expand(-1, ys.shape[1], -1).contiguous()
    right = poly.shape[1] - torch.searchsorted(crossings, px, right=True)
    return (right % 2 == 1).reshape(xs.shape[0], -1)


def _linspace(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) grids from (B,) ends, as ``jnp.linspace`` builds them:
    lo * (1 - t) + hi * t for t = i / (n - 1), the last point exactly ``hi``."""
    t = (torch.arange(n - 1, dtype=lo.dtype, device=lo.device) / (n - 1))[None, :]
    return torch.cat([lo[:, None] * (1 - t) + hi[:, None] * t, hi[:, None]], dim=1)


def _iou_dice_chunk(poly_a: torch.Tensor, poly_b: torch.Tensor, resolution: int):
    lo = torch.minimum(poly_a.amin(dim=1), poly_b.amin(dim=1)) - 1e-6
    hi = torch.maximum(poly_a.amax(dim=1), poly_b.amax(dim=1)) + 1e-6
    xs, ys = _linspace(lo[:, 0], hi[:, 0], resolution), _linspace(lo[:, 1], hi[:, 1], resolution)
    in_a = _even_odd_inside(xs, ys, poly_a)  # meshgrid "xy": x varies fastest
    in_b = _even_odd_inside(xs, ys, poly_b)
    inter = (in_a & in_b).sum(1).float()
    union = (in_a | in_b).sum(1).float()
    a_area, b_area = in_a.sum(1).float(), in_b.sum(1).float()
    zero = torch.zeros_like(union)
    iou = torch.where(union == 0, zero, inter / torch.clamp(union, min=1.0))
    dice = torch.where(union == 0, zero, 2.0 * inter / torch.clamp(a_area + b_area, min=1.0))
    return iou, dice


def iou_and_dice_batch(
    polys_a: np.ndarray, polys_b: np.ndarray, resolution: int = 512, chunk: int = 32,
    mesh=None, device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterized IoU/DICE for a batch of (fitted outline, curve) pairs on
    the device, ``chunk`` pairs at a time. polys_a (B, Ma, 2), polys_b
    (B, Mb, 2). Under a mesh the chunk is rounded up to a multiple of the
    ranks, as in ``hint_tpu``, and each rank rasterizes its block of it."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    if mesh is not None:
        chunk = -(-chunk // mesh.size) * mesh.size
    ious, dices = [], []
    for s in range(0, len(polys_a), chunk):
        a = torch.as_tensor(np.asarray(polys_a[s : s + chunk], np.float32), device=dev)
        b = torch.as_tensor(np.asarray(polys_b[s : s + chunk], np.float32), device=dev)
        i, d = map_rows(lambda a, b: _iou_dice_chunk(a, b, resolution), mesh, a, b)
        ious.append(i.cpu().numpy())
        dices.append(d.cpu().numpy())
    if not ious:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    return np.concatenate(ious), np.concatenate(dices)


# -- self-checks (reference demo entry points, best_shape_fit.py:160-191,281-313) --


def check_plus_shape_fitting(verbose: bool = True, device=None):
    from hint_tpu_torch.data.fourier import PlusShapeModel

    model = PlusShapeModel()
    curve = model.generate_plus_shape()
    coeffs = model.fourier_coeffs(curve, n_coeffs=model.n_parameters // 4)
    pts = model.trace_fourier_curves(coeffs[None])[0].astype(np.float32)
    dense = model.trace_fourier_curves(coeffs[None], n_points=1000)[0]
    params = fit_plus_shape_to_points(pts, device=device)
    iou, dice = iou_and_dice_plus(params, pts)
    mh, ah = hausdorff_plus(params, dense)
    if verbose:
        print(f"IoU:  {iou:.3f}\nDICE: {dice:.3f}")
        print(f"max Hausdorff: {mh:.3f}\navg Hausdorff: {ah:.3f}")
    return iou, dice, mh, ah


def check_lens_shape_fitting(verbose: bool = True, device=None):
    from hint_tpu_torch.data.fourier import LensShapeModel

    model = LensShapeModel()
    curve = model.generate_lens_shape()
    coeffs = model.fourier_coeffs(curve, n_coeffs=model.n_parameters // 4)
    pts = model.trace_fourier_curves(coeffs[None])[0].astype(np.float32)
    dense = model.trace_fourier_curves(coeffs[None], n_points=1000)[0]
    params = fit_lens_shape_to_points(pts, device=device)
    iou, dice = iou_and_dice_lens(params, pts)
    mh, ah = hausdorff_lens(params, dense)
    if verbose:
        print(f"IoU:  {iou:.3f}\nDICE: {dice:.3f}")
        print(f"max Hausdorff: {mh:.3f}\navg Hausdorff: {ah:.3f}")
    return iou, dice, mh, ah


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="plus and lens shape-fit self-checks")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    device = ap.parse_args().device
    check_plus_shape_fitting(device=device)
    check_lens_shape_fitting(device=device)
