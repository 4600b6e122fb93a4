"""The plus-shape data model on the device: the benchmark's inputs.

A copy of the device pipeline of the program's plus-shape prior sweep
(HINT's ``data.py:167-252``, "plus" shapes: two crossed bars, their union
outline densified, centred, rotated, offset, and described by 25 complex
Fourier coefficients of each coordinate, x in R^100; the label y is the
centre, the angle and the ratio of the bar widths, y in R^4). The sweep
redraws on the host the rare rows where f32 could disagree with the host's
f64 geometry; the benchmark keeps the device's rows as they come, since it
needs plausible inputs, not the host's bit pattern.

Sub-batch ``q`` draws from a generator seeded from ``(seed, q)``, so the
same seed gives the same rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RING = 12
P2 = 256
N_COEFFS = 25
M_MAX = N_COEFFS // 2
MAX_DIST = 0.2
SUB_BATCH = 32768


def _union_ring(A0, A1, a0, a1, b0, b1, B0, B1):
    pl, pr, pb, pt = A0 < b0, A1 > b1, B0 < a0, B1 > a1

    def grp(pA, pB, full, stair, singleA, singleB):
        three = pA == pB
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
    rank = torch.cumsum(emit.long(), dim=1)
    V = rank[:, -1]
    start = torch.where(pl, 0, 2)
    target = torch.remainder(rank - 1 - start[:, None], V.clamp(min=1)[:, None])
    target = torch.where(emit, target, RING)
    rx = torch.zeros(A0.shape[0], RING + 1, dtype=A0.dtype, device=A0.device)
    ry = torch.zeros_like(rx)
    return rx.scatter(1, target, cand_x)[:, :RING], ry.scatter(1, target, cand_y)[:, :RING], V


def _densify(rx, ry, V):
    B = rx.shape[0]
    slots = torch.arange(RING, device=rx.device)[None]
    wrap = slots == (V - 1)[:, None]
    nx = torch.where(wrap, rx[:, :1], torch.roll(rx, -1, dims=1))
    ny = torch.where(wrap, ry[:, :1], torch.roll(ry, -1, dims=1))
    live = slots < V[:, None]
    frac = torch.maximum((nx - rx).abs(), (ny - ry).abs()) / MAX_DIST
    n_i = torch.where(live, torch.round(frac).long().clamp(min=1), 0)
    cum = torch.cumsum(n_i, dim=1)
    N = cum[:, -1]
    j = torch.arange(P2, device=rx.device)
    seg = torch.searchsorted(cum, j.expand(B, P2).contiguous(), right=True).clamp(max=RING - 1)
    n = n_i.gather(1, seg).float()
    o = (cum.gather(1, seg) - n_i.gather(1, seg)).float()
    t = (j.float() - o) / torch.clamp(n - 1.0, min=1.0)
    inside = j < N[:, None]
    px = torch.where(inside, (1.0 - t) * rx.gather(1, seg) + t * nx.gather(1, seg), 0.0)
    py = torch.where(inside, (1.0 - t) * ry.gather(1, seg) + t * ny.gather(1, seg), 0.0)
    return px, py, N


def _dft(px, py, N):
    j = torch.arange(P2, dtype=torch.float32, device=px.device)[None]
    vf = (j < N[:, None].float()).float()
    nf = N.float()[:, None]
    beta = -2.0 * math.pi * j / nf
    c1, s1 = torch.cos(beta) * vf, torch.sin(beta) * vf
    mxy = torch.stack([px * vf, py * vf], dim=1)
    res, ims = [], []
    cm, sm = vf, torch.zeros_like(vf)
    for _ in range(M_MAX + 1):
        res.append((mxy * cm[:, None]).sum(-1))
        ims.append((mxy * sm[:, None]).sum(-1))
        cm, sm = cm * c1 - sm * s1, sm * c1 + cm * s1
    return torch.stack(res, dim=2) / nf[:, :, None], torch.stack(ims, dim=2) / nf[:, :, None]


def _rows(gen: torch.Generator, B: int, device) -> tuple:
    def uniform():
        return torch.rand(B, generator=gen, device=device)

    xl, yl = 3.0 + 2.0 * uniform(), 3.0 + 2.0 * uniform()
    xw, yw = 0.5 + 1.5 * uniform(), 0.5 + 1.5 * uniform()
    xs, ys = -1.5 + 3.0 * uniform(), -1.5 + 3.0 * uniform()
    angle = 0.5 * math.pi * uniform()
    off = 0.5 * torch.randn(B, 2, generator=gen, device=device)
    rx, ry, V = _union_ring(xs - xl / 2, xs + xl / 2, -xw / 2, xw / 2, -yw / 2, yw / 2, ys - yl / 2, ys + yl / 2)
    px, py, N = _densify(rx, ry, V)
    nf = N.float()
    mean_x, mean_y = px.sum(1) / nf, py.sum(1) / nf
    cx, cy = px - mean_x[:, None], py - mean_y[:, None]
    ca, sa = torch.cos(angle), torch.sin(angle)
    qx = cx * ca[:, None] - cy * sa[:, None] + off[:, 0:1]
    qy = cx * sa[:, None] + cy * ca[:, None] + off[:, 1:2]
    ctr_x = -mean_x * ca + mean_y * sa + off[:, 0]
    ctr_y = -mean_x * sa - mean_y * ca + off[:, 1]
    re, im = _dft(qx, qy, N)
    # x = [Re_x(m=-12..12), Re_y(..), Im_x(..), Im_y(..)], Re(-m) = Re(m), Im(-m) = -Im(m)
    x = torch.cat([torch.cat([re[:, d, 1:].flip(-1), re[:, d]], dim=1) for d in range(2)]
                  + [torch.cat([-im[:, d, 1:].flip(-1), im[:, d]], dim=1) for d in range(2)], dim=1)
    return x, torch.stack([ctr_x, ctr_y, angle, xw / yw], dim=1)


def generator(seed: int, index: int, device) -> torch.Generator:
    word = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


@torch.no_grad()
def plus_rows(n: int, seed: int, device) -> tuple:
    """n rows (x (n, 100), y (n, 4)) of the plus-shape data model, f32 on
    ``device``."""
    xs, ys = [], []
    for q in range(-(-n // SUB_BATCH)):
        x, y = _rows(generator(seed, q, device), SUB_BATCH, device)
        xs.append(x)
        ys.append(y)
    return torch.cat(xs)[:n].contiguous(), torch.cat(ys)[:n].contiguous()
