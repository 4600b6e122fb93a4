"""The plus-shape prior sweep on the card: the CUDA engine behind
``evaluation.abc.prepare_samples(engine="tpu")`` (port of
``hint_tpu/data/plus_tpu.py``; the engine keeps ``hint_tpu``'s name).

The whole plus pipeline (data.py:167-252, on the host in ``data/fourier.py``
and ``data/geometry.py``) as batched PyTorch on the device:

* the union outline of the two bars is built in closed form instead of the
  host's split-and-chain walk (``geometry.rect_union_outline``): with
  xbar = [A0,A1] x [a0,a1] and ybar = [b0,b1] x [B0,B1], each of the four
  corner regions of the union gives one vertex (a plain corner) or three
  (an arm or a staircase), picked by two sign predicates per corner
  (xlength >= 3 > 2 >= ywidth and symmetrically, so these cases are
  exhaustive). The <= 12 candidates are compacted by emit rank and rolled
  so slot 0 is the host walk's start vertex, with one ``scatter``;
* densify_polyline (data.py:176-186): segment i holds
  n_i = max(1, round(max|d|_inf / 0.2)) points with t = (j - off_i) /
  (n_i - 1); each of the (B, 256) output slots finds its segment with one
  batched ``searchsorted`` over the segments' running counts and reads its
  endpoints with ``gather``;
* centering, rotation, offset and the label y = (center, angle,
  xwidth / ywidth) are closed form (data.py:209-225);
* the 25-coefficient DFT (m = -12..12) computes only m = 0..12, by
  angle-addition recurrence from one (B, 256) trig pair; the host mirrors
  Re(-m) = Re(m), Im(-m) = -Im(m) (``_unpack_x``), so those identities and
  Im(0) = 0 hold exactly, as they do for a real polyline on the host.

Rows where f32 could disagree with the host's f64 decisions are flagged and
redrawn on the host from the same (length, width, shift, angle, offset)
draws: a corner predicate within ``PRED_EPS`` of a tie, a densify count
within ``ROUND_EPS`` of the round-half boundary (``torch.round`` rounds half
to even, as ``jnp.round`` and numpy do), or a polyline over capacity.

Parity with ``hint_tpu`` and the host engines is distributional, as in
``lens_tpu``: ``torch.Generator`` streams (Philox on the card, MT19937 on
the CPU) are neither numpy's nor JAX's, and sub-batch q of a sweep draws
from a generator seeded from (seed, q).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hint_tpu_torch.data.sweep import run_sweep

RING = 12  # union-outline capacity: 4 corners x up to 3 vertices
P2 = 256  # densified-polyline capacity (~146 points at most at these bounds)
N_COEFFS = 25  # 25 complex 2-D Fourier coefficients -> x in R^100
M_MAX = N_COEFFS // 2  # 12
MAX_DIST = 0.2  # densify_polyline's default (data.py:177)
PRED_EPS = 1e-5  # f32-vs-f64 ambiguity band on corner predicates
ROUND_EPS = 1e-5  # ambiguity band on the densify round-half boundary
N_PACK = 55  # packed columns: Re(2 x 13) | Im(2 x 12) | y(4) | flag
FLAG_COLUMN = 54


def _union_ring(A0, A1, a0, a1, b0, b1, B0, B1):
    """Closed-form union outline of xbar x ybar in the host walk's order.

    Returns (rx, ry (B, 12), V (B,), pred_margin (B,)): the compacted,
    start-rolled ring, its length, and the smallest |predicate| margin.
    """
    pl = A0 < b0  # xbar protrudes left of ybar
    pr = A1 > b1  # xbar protrudes right
    pb = B0 < a0  # ybar protrudes below xbar
    pt = B1 > a1  # ybar protrudes above

    def grp(pA, pB, full, stair, singleA, singleB):
        """One corner group: 3 candidate slots and their emit flags.
        pA & pB -> ``full`` (the arm), !pA & !pB -> ``stair`` (the
        staircase), pA only -> [singleA], pB only -> [singleB]."""
        three = pA == pB  # both or neither: 3 vertices
        cand = []
        for s in range(3):
            fx, fy = full[s]
            sx, sy = stair[s]
            cx = torch.where(pA, torch.where(pB, fx, singleA[0]), torch.where(pB, singleB[0], sx))
            cy = torch.where(pA, torch.where(pB, fy, singleA[1]), torch.where(pB, singleB[1], sy))
            cand.append((cx, cy))
        return cand, [torch.ones_like(three), three, three]

    groups = (
        grp(pl, pb, [(A0, a0), (b0, a0), (b0, B0)], [(b0, B0), (A0, B0), (A0, a0)], (A0, a0), (b0, B0)),
        grp(pr, pb, [(b1, B0), (b1, a0), (A1, a0)], [(A1, a0), (A1, B0), (b1, B0)], (A1, a0), (b1, B0)),
        grp(pr, pt, [(A1, a1), (b1, a1), (b1, B1)], [(b1, B1), (A1, B1), (A1, a1)], (A1, a1), (b1, B1)),
        grp(pl, pt, [(b0, B1), (b0, a1), (A0, a1)], [(A0, a1), (A0, B1), (b0, B1)], (A0, a1), (b0, B1)),
    )
    cand_x = torch.stack([c[0] for g in groups for c in g[0]], dim=1)
    cand_y = torch.stack([c[1] for g in groups for c in g[0]], dim=1)
    emit = torch.stack([e for g in groups for e in g[1]], dim=1)
    rank = torch.cumsum(emit.long(), dim=1)  # 1-based at the emits
    V = rank[:, -1]
    # the host walk starts at the first kept piece of xbar's bottom edge:
    # (A0, a0) when A0 < b0 (slot 0), else ring index 2
    start = torch.where(pl, 0, 2)
    target = torch.remainder(rank - 1 - start[:, None], V.clamp(min=1)[:, None])
    target = torch.where(emit, target, RING)  # the candidates not emitted go to a spare slot
    rx = torch.zeros(A0.shape[0], RING + 1, dtype=A0.dtype, device=A0.device)
    ry = torch.zeros_like(rx)
    rx = rx.scatter(1, target, cand_x)[:, :RING]
    ry = ry.scatter(1, target, cand_y)[:, :RING]
    pred_margin = torch.minimum(
        torch.minimum((A0 - b0).abs(), (A1 - b1).abs()),
        torch.minimum((B0 - a0).abs(), (B1 - a1).abs()),
    )
    return rx, ry, V, pred_margin


def _densify(rx, ry, V):
    """Batched densify_polyline (data.py:176-186).

    Segment i runs ring[i] -> ring[(i + 1) % V] and gives
    n_i = max(1, round(max|d|_inf / 0.2)) points (t = linspace(0, 1, n_i),
    shared vertices duplicated: the host's concatenation of per-piece
    linspaces). Returns (px, py (B, P2), N (B,), round_margin (B,)).
    """
    B = rx.shape[0]
    slots = torch.arange(RING, device=rx.device)[None]
    wrap = slots == (V - 1)[:, None]
    nx = torch.where(wrap, rx[:, :1], torch.roll(rx, -1, dims=1))
    ny = torch.where(wrap, ry[:, :1], torch.roll(ry, -1, dims=1))
    live = slots < V[:, None]
    frac = torch.maximum((nx - rx).abs(), (ny - ry).abs()) / MAX_DIST
    n_i = torch.where(live, torch.round(frac).long().clamp(min=1), 0)
    # distance of each count to the round-half flip point (the host rounds
    # the f64 value; an f32 count on the boundary could disagree)
    half_gap = (frac - (torch.floor(frac) + 0.5)).abs()
    round_margin = torch.where(live, half_gap, math.inf).amin(dim=1)
    cum = torch.cumsum(n_i, dim=1)
    N = cum[:, -1]
    j = torch.arange(P2, device=rx.device)
    seg = torch.searchsorted(cum, j.expand(B, P2).contiguous(), right=True).clamp(max=RING - 1)
    n = n_i.gather(1, seg).float()
    o = (cum.gather(1, seg) - n_i.gather(1, seg)).float()  # the segment's first slot
    t = (j.float() - o) / torch.clamp(n - 1.0, min=1.0)
    inside = j < N[:, None]
    px = torch.where(inside, (1.0 - t) * rx.gather(1, seg) + t * nx.gather(1, seg), 0.0)
    py = torch.where(inside, (1.0 - t) * ry.gather(1, seg) + t * ny.gather(1, seg), 0.0)
    return px, py, N, round_margin


def _dft_unique(px, py, N):
    """m = 0..12 DFT coefficients of the masked (B, P2) polyline.

    coeff_m = (1/N) sum_j p_j e^{-2 pi i m j / N}; the harmonics by
    angle-addition recurrence from the m = 1 trig pair. Returns
    (re (B, 2, 13), im (B, 2, 13)); m < 0 follows by conjugate symmetry.
    """
    j = torch.arange(P2, dtype=torch.float32, device=px.device)[None]
    vf = (j < N[:, None].float()).float()
    nf = N.float()[:, None]
    beta = -2.0 * math.pi * j / nf
    c1, s1 = torch.cos(beta) * vf, torch.sin(beta) * vf  # masked harmonics
    mxy = torch.stack([px * vf, py * vf], dim=1)  # (B, 2, P2)
    res, ims = [], []
    cm, sm = vf, torch.zeros_like(vf)  # m = 0
    for _m in range(M_MAX + 1):
        res.append((mxy * cm[:, None]).sum(-1))
        ims.append((mxy * sm[:, None]).sum(-1))
        cm, sm = cm * c1 - sm * s1, sm * c1 + cm * s1
    re = torch.stack(res, dim=2) / nf[:, :, None]  # (B, 2, 13)
    im = torch.stack(ims, dim=2) / nf[:, :, None]
    return re, im


def _pipeline(xl, yl, xw, yw, xs, ys, angle, off):
    """Ring -> densify -> transform -> DFT -> pack, for given draws.
    Returns (packed (B, 55), params (B, 9)): the params are the draws
    ``_regen_host`` replays."""
    B = xl.shape[0]
    rx, ry, V, pred_margin = _union_ring(
        xs - xl / 2, xs + xl / 2, -xw / 2, xw / 2, -yw / 2, yw / 2, ys - yl / 2, ys + yl / 2,
    )
    px, py, N, round_margin = _densify(rx, ry, V)
    nf = N.float()
    # px, py are zero past N, so plain sums are the masked sums
    mean_x = px.sum(1) / nf
    mean_y = py.sum(1) / nf
    cx, cy = px - mean_x[:, None], py - mean_y[:, None]
    ca, sa = torch.cos(angle), torch.sin(angle)
    # np.dot(coords, [[c, s], [-s, c]]): x' = x c - y s, y' = x s + y c
    qx = cx * ca[:, None] - cy * sa[:, None] + off[:, 0:1]
    qy = cx * sa[:, None] + cy * ca[:, None] + off[:, 1:2]
    # the center starts at the origin and follows -mean, the rotation and
    # the offset (data.py:209-222)
    ctr_x = (-mean_x) * ca - (-mean_y) * sa + off[:, 0]
    ctr_y = (-mean_x) * sa + (-mean_y) * ca + off[:, 1]
    re, im = _dft_unique(qx, qy, N)
    y = torch.stack([ctr_x, ctr_y, angle, xw / yw], dim=1)
    flag = ((pred_margin < PRED_EPS) | (round_margin < ROUND_EPS) | (N > P2)).float()
    packed = torch.cat(
        [re.reshape(B, 2 * (M_MAX + 1)), im[:, :, 1:].reshape(B, 2 * M_MAX), y, flag[:, None]], dim=1
    )
    params = torch.stack([xl, yl, xw, yw, xs, ys, angle], dim=1)
    return packed, torch.cat([params, off], dim=1)


def _sub_batch(gen, B, device):
    """One sub-batch of the sweep: the prior draws of generate_plus_shape's
    unconditional branch (data.py:188-215, 223, 229): lengths ~ U[3,5],
    widths ~ U[0.5,2], shifts ~ U[-1.5,1.5], angle ~ U[0, pi/2],
    offset ~ 0.5 N(0, I2); then the pipeline. The params stay on the device
    until a flagged row needs them."""
    def uniform():
        return torch.rand(B, generator=gen, device=device)

    xl = 3.0 + 2.0 * uniform()
    yl = 3.0 + 2.0 * uniform()
    xw = 0.5 + 1.5 * uniform()
    yw = 0.5 + 1.5 * uniform()
    xs = -1.5 + 3.0 * uniform()
    ys = -1.5 + 3.0 * uniform()
    angle = 0.5 * math.pi * uniform()
    off = 0.5 * torch.randn(B, 2, generator=gen, device=device)
    packed, params = _pipeline(xl, yl, xw, yw, xs, ys, angle, off)
    return packed, (params,)


def _unpack_x(packed: np.ndarray) -> np.ndarray:
    """Mirror the 50 unique coefficients into the flat 100-dim x:
    flatten_coeffs layout [Re_x(m=-12..12), Re_y(..), Im_x(..), Im_y(..)]
    with Re(-m) = Re(m), Im(-m) = -Im(m)."""
    B = packed.shape[0]
    re = packed[:, : 2 * (M_MAX + 1)].reshape(B, 2, M_MAX + 1)
    im = np.concatenate(
        [np.zeros((B, 2, 1), packed.dtype), packed[:, 2 * (M_MAX + 1) : 50].reshape(B, 2, M_MAX)],
        axis=2,
    )
    x = np.empty((B, 4 * N_COEFFS), packed.dtype)
    for d in range(2):
        x[:, d * N_COEFFS + M_MAX : (d + 1) * N_COEFFS] = re[:, d]
        x[:, d * N_COEFFS : d * N_COEFFS + M_MAX] = re[:, d, :0:-1]
        base = 2 * N_COEFFS + d * N_COEFFS
        x[:, base + M_MAX : base + N_COEFFS] = im[:, d]
        x[:, base : base + M_MAX] = -im[:, d, :0:-1]
    return x


def _regen_host(params: np.ndarray):
    """Host (f64) regeneration of flagged rows from the same draws.

    params rows are (xl, yl, xw, yw, xshift, yshift, angle, offx, offy).
    Replays generate_plus_shape (data.py:188-225) through the host
    geometry and DFT with the randomness substituted. Returns
    (x (R, 100) f32, y (R, 4) f32).
    """
    from hint_tpu_torch.data import geometry as geo
    from hint_tpu_torch.data.fourier import PlusShapeModel

    model = PlusShapeModel()
    xs_out, ys_out = [], []
    for row in np.asarray(params, np.float64):
        xl, yl, xw, yw, xshift, yshift, angle, offx, offy = row
        xbar = ((xshift - xl / 2, -xw / 2), (xshift + xl / 2, xw / 2))
        ybar = ((-yw / 2, yshift - yl / 2), (yw / 2, yshift + yl / 2))
        coords = model.densify_polyline(geo.rect_union_outline(xbar, ybar))
        center = -coords.mean(axis=0)
        coords = coords - coords.mean(axis=0)
        rot = np.array([[np.cos(angle), np.sin(angle)], [-np.sin(angle), np.cos(angle)]])
        coords = coords @ rot
        center = center @ rot + np.array([offx, offy])
        coords = coords + np.array([offx, offy])
        xs_out.append(model.flatten_coeffs(model.fourier_coeffs(coords, n_coeffs=N_COEFFS)[None])[0])
        ys_out.append([center[0], center[1], angle, xw / yw])
    return np.stack(xs_out).astype(np.float32), np.asarray(ys_out, np.float32)


def _host_finish(packed: np.ndarray, extras):
    """Unpack one dispatch's host copy; redraw flagged rows on the host
    (``extras()`` copies the dispatch's params to the host)."""
    x = _unpack_x(packed[:, :50])
    y = np.ascontiguousarray(packed[:, 50:54])
    flagged = packed[:, FLAG_COLUMN] != 0.0
    if flagged.any():
        (params,) = extras()
        x_fix, y_fix = _regen_host(params[flagged])
        x[flagged] = x_fix
        y[flagged] = y_fix
    return x, y


def sample_joint(
    n: int,
    seed: int = 0,
    sub_batch: int = 32768,
    noise: bool = True,
    group: int = 8,
    device=None,
):
    """Draw n plus-shape (x, y) prior pairs on the device (CUDA unless
    ``device`` names another). Seeding and transfers as in
    ``lens_tpu.sample_joint``. ``noise`` is accepted for the interface and
    ignored: the plus label is exact at generation time (data.py:224-225)."""
    del noise
    return run_sweep(n, seed, sub_batch, group, device, _sub_batch, _host_finish)
