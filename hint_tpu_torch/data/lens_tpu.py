"""The lens-shape prior sweep on the card: the CUDA engine behind
``evaluation.abc.prepare_samples(engine="tpu")`` (port of
``hint_tpu/data/lens_tpu.py``; the engine keeps ``hint_tpu``'s name).

The ABC ground truth needs 1e8 (x, y) prior draws
(rejection_sampling.py:76). The host engines (``data/fourier.py``, the C++
generator of ``data/native.py``) draw one shape at a time; this module runs
the whole lens pipeline as batched PyTorch on the device, one sub-batch of
rows per pass:

* the two circles are the 64-gons of ``geometry.circle_polygon``; the lens
  ring is the same Sutherland-Hodgman clip as
  ``geometry.convex_intersection``, vertex for vertex in the same order. The
  ring stays convex through every pass, so the vertices inside a clip
  half-plane form one cyclic run and each pass's output is one per-row
  cyclic shift of its input with the two crossings patched in:
      no wrap:  [I_enter, v_s .. v_{x-1}, I_exit]
      wrap:     [v_0 .. v_{x-1}, I_exit, I_enter, v_s .. v_{k-1}]
  (s = entering slot, x = exiting slot), the host's stable interleave
  (geometry.py:82-86). The shift is one ``torch.gather``, the crossings'
  endpoints are read with one more and patched in with one ``scatter``;
* a batch of rings is one (B, 2, P) tensor, the x and the y plane of each
  row, P = 80 slots. Two 64-gons can meet in up to 128 vertices, but at the
  lens geometry (circle1 twice circle0's radius, 2.4 r0 away) every clip
  pass removes at least as many vertices as it adds: the ring never held
  more than its first 64 over 20,000 draws. A pass that would overflow P
  marks its row bad;
* a row is marked bad (k = 0) and redrawn on the host in f64 from the same
  (r0, theta, shift) when its f32 inside-mask is not one run (> 2
  crossings), when a crossing segment is numerically parallel to the clip
  edge (``|denom|`` within ``DENOM_EPS`` of zero relative to the two
  segments' lengths: its intersection point would be wrong), or when the
  ring would overflow P;
* the closed-ring DFT (duplicate first point, ring length n = k + 1,
  data.py:42-49,98) is a masked sum over the five harmonics, built by
  double-angle identities from one (B, P) trig pair;
* the forward process (y = the vector between the two most distant of 100
  traced curve points + noise, data.py:127-139) traces the curve with five
  multiply-adds per output in f32 (no matmul, so no global TF32 flag can
  change it), then takes the top two d^2 over the 4,851 live pairs of the
  upper triangle (column 99, the seam twin of row 0, is left out), in
  row chunks that bound the memory. Rows whose top two are within f32
  cross-engine error go to the host's f64 full-matrix refine
  (``_refine_host``); rows whose winning pair touches the seam (i0 == 0)
  need only the twin-orientation decision (``_seam_host``).

Parity with ``hint_tpu`` and with the host engines is distributional: the
host engines draw from numpy's MT19937 stream shape by shape, ``hint_tpu``
from JAX's threefry, and this module from ``torch.Generator`` (Philox on
the card, MT19937 on the CPU; the two devices give different streams).
Each sub-batch's generator is seeded from ``(seed, sub-batch index)``, so a
pool is deterministic and a smaller pool is a prefix of a larger one.
Geometry is f32 on the device against f64 on the host: vertex coordinates
agree to ~1e-5, and the host fix-ups are bit-identical to ``hint_tpu``'s.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from hint_tpu_torch.data.sweep import run_sweep

N_CIRCLE = 64  # 4 * resolution(16): geometry.circle_polygon's default
P = 80  # ring capacity (the lens rings measured <= 64 vertices; an overflow is a bad row)
N_COEFFS = 5  # 5 complex 2-D Fourier coefficients -> x in R^20
N_TRACE = 100  # trace_fourier_curves' default (data.py:51-57)
# a crossing whose |denom| is at most this times |edge|_1 * |segment|_1 is
# numerically parallel to the clip line: its row is redrawn on the host
DENOM_EPS = 1e-6
# band threshold: the f32 trace differs from the host's f64 one by ~2e-6
# relative, so a top-two gap within 1e-5 of the top may order differently
BAND_EPS = 1e-5
# memory of the screen's (rows, 4851) temporaries: about five live at once
SCREEN_BYTES = 1 << 29
# rows of the host refine's f64 distance matrices at once (20 MB, so a
# block stays in cache, where one matrix for every band row would not)
REFINE_ROWS = 256
N_PACK = 26  # packed columns: x(20) | feats(2) | y_noise(2) | flag | i1
FLAG_COLUMN = 24  # flag = band + 2 seam + 4 bad


@functools.lru_cache(maxsize=None)
def _slots(device):
    """The slot index m (1, P), its predecessor m - 1, and m == 0, kept on
    the device: built once, so no pass waits on a host-to-device copy."""
    m = torch.arange(P, device=device)[None]
    return m, m - 1, m == 0


def _run_ends(inside, prev_in):
    """Where the inside run of each ring enters (the first slot inside
    after one outside) and exits (the first slot outside after one inside),
    and the number of crossings. CUDA has no ``argmax`` for bool, so the
    two masks become one int8 code, +1 at an entry and -1 at an exit;
    PyTorch returns the first of tied extremes. A row without crossings
    gives slot 0 for both."""
    code = inside.to(torch.int8) - prev_in.to(torch.int8)
    return code.argmax(dim=1), code.argmin(dim=1), (code != 0).sum(1)


def _clip_edge(pts, k, a, e, tol):
    """One Sutherland-Hodgman pass over a batch of contiguous rings.

    ``pts`` (B, 2, P) holds each ring's x and y in slots 0..k-1 (zeros
    after); the clip edge starts at ``a`` (B, 2) and runs along ``e``
    (B, 2); ``tol`` (B,) is ``DENOM_EPS * |e|_1``. The output matches
    ``geometry.convex_intersection``'s pass vertex for vertex: slot j emits
    its crossing at order 2j and its inside vertex at 2j+1, compacted
    stably. Returns the new (pts, k); k == 0 marks a bad row.
    """
    B = pts.shape[0]
    m, m_prev, m_first = _slots(pts.device)
    valid = m < k[:, None]
    rel = pts - a[:, :, None]
    side = e[:, 0, None] * rel[:, 1] - e[:, 1, None] * rel[:, 0]
    inside = (side >= 0) & valid
    km1 = (k - 1).clamp(min=0)
    # the previous slot of j is j-1, and slot 0 wraps to k-1
    prev_in = inside.gather(1, torch.where(m_first, km1[:, None], m_prev)) & valid
    s, x, c = _run_ends(inside, prev_in)
    n_in = inside.sum(1)
    # the entering segment runs (s-1, s), the exiting one (x-1, x)
    se = torch.stack([s, x], dim=1)
    ends = torch.stack([torch.where(se == 0, km1[:, None], se - 1), se], dim=2)  # (B, crossing, end)
    q = pts.gather(2, ends.reshape(B, 1, 4).expand(B, 2, 4)).reshape(B, 2, 2, 2)  # (B, coord, crossing, end)
    p0 = q[..., 0]
    d = q[..., 1] - p0
    denom = e[:, 0, None] * d[:, 1] - e[:, 1, None] * d[:, 0]
    to_a = a[:, :, None] - p0
    num = e[:, 0, None] * to_a[:, 1] - e[:, 1, None] * to_a[:, 0]
    # a crossing segment numerically parallel to the clip line has no
    # trustworthy intersection: its row goes to the host
    flat = denom.abs() <= tol[:, None] * d.abs().sum(1)
    t = num / torch.where(flat, 1.0, denom)
    ipt = p0 + t[:, None] * d  # (B, coord, crossing): enter, exit
    wrap = s > x  # the inside run crosses the slot-0 seam
    # no wrap: out[m] = ring[m + s - 1]; wrap: out[m] = ring[m] for m < x,
    # ring[m + s - x - 2] for m > x + 1; then the two crossings patched in
    r = torch.where(wrap, s - x - 2, s - 1)
    src = torch.where(wrap[:, None] & (m < x[:, None]), m, torch.remainder(m + r[:, None], P))
    out = pts.gather(2, src[:, None].expand(B, 2, P))
    at = torch.stack([torch.where(wrap, x + 1, 0), torch.where(wrap, x, n_in + 1)], dim=1).clamp(max=P - 1)
    out.scatter_(2, at[:, None].expand(B, 2, 2), ipt)
    # c == 0: inside is constant over the ring, all kept (n_in == k, the
    # host's `continue`) or all cut (n_in == 0: degenerate). c > 2: the f32
    # mask is not one run. A parallel crossing or an overflow of P: no
    # trustworthy output.
    new_k = n_in + c
    bad = (c > 2) | (new_k > P) | ((c == 2) & flat.any(1))
    new_k = torch.where(bad, 0, new_k)
    live = (m < new_k[:, None])[:, None]
    return torch.where(live, torch.where((c == 0)[:, None, None], pts, out), 0.0), new_k


@functools.lru_cache(maxsize=None)
def _unit_circle(device):
    """cos and sin of the 64 vertex angles of ``geometry.circle_polygon``,
    computed in f64 and rounded to f32, (2, 64)."""
    ang = np.linspace(0.0, 2.0 * np.pi, N_CIRCLE, endpoint=False)
    return torch.as_tensor(np.stack([np.cos(ang), np.sin(ang)]), dtype=torch.float32, device=device)


def _lens_rings_xy(r0, theta):
    """Split-coordinate lens rings for a batch of (r0, theta) draws.

    Mirrors generate_lens_shape (data.py:85-100): circle0 at the origin
    with radius r0, circle1 at distance 0.8 (r0 + r1) along
    (sin theta, cos theta) with radius r1 = 2 r0, ring = circle0 ∩ circle1.
    Returns (px, py (B, P), k (B,)); k == 0 marks rows the host redraws.
    """
    B = r0.shape[0]
    u = _unit_circle(r0.device)
    r1 = 2.0 * r0
    dd = 0.8 * (r0 + r1)
    center = torch.stack([dd * torch.sin(theta), dd * torch.cos(theta)], dim=1)
    pts = torch.zeros(B, 2, P, dtype=torch.float32, device=r0.device)
    pts[:, :, :N_CIRCLE] = r0[:, None, None] * u
    g = center[:, :, None] + r1[:, None, None] * u  # the clip polygon, (B, 2, 64)
    e = torch.roll(g, -1, dims=2) - g
    tol = DENOM_EPS * e.abs().sum(1)
    k = torch.full((B,), N_CIRCLE, dtype=torch.int64, device=r0.device)
    for j in range(N_CIRCLE):
        pts, k = _clip_edge(pts, k, g[:, :, j], e[:, :, j], tol[:, j])
    return pts[:, 0], pts[:, 1], k


def _ring_to_x_xy(px, py, k, shift_noise):
    """Close the ring, center it with noise, DFT to flattened coefficients.

    data.py:96-100 + fourier_coeffs (data.py:42-49): coords = ring + its
    closing duplicate (n = k + 1 points), coords -= mean(coords) + 0.5 eps,
    coeffs_m = (1/n) sum_j coords_j e^{-2 pi i m j / n}, m = -2..2; flattened
    as [Re(2 x 5) | Im(2 x 5)] (flatten_coeffs, data.py:30-35).
    """
    idx = torch.arange(px.shape[1], dtype=torch.float32, device=px.device)
    vf = (idx[None] < k[:, None]).float()
    n = (k + 1).float()  # closed-ring length
    fx, fy = px[:, 0], py[:, 0]  # the closing duplicate is ring[0]
    ox = ((px * vf).sum(1) + fx) / n + 0.5 * shift_noise[:, 0]
    oy = ((py * vf).sum(1) + fy) / n + 0.5 * shift_noise[:, 1]
    cxy = torch.stack([(px - ox[:, None]) * vf, (py - oy[:, None]) * vf])  # (2, B, P)
    beta = -2.0 * math.pi * idx[None] / n[:, None]  # m = 1 angles
    c1, s1 = torch.cos(beta), torch.sin(beta)
    c2, s2 = c1 * c1 - s1 * s1, 2.0 * s1 * c1
    cms = torch.stack([c2, c1, torch.ones_like(c1), c1, c2])  # cos(m beta), m = -2..2
    sms = torch.stack([-s2, -s1, torch.zeros_like(c1), s1, s2])
    # the duplicate point's term, j = k
    bk = -2.0 * math.pi * k.float() / n
    ck1, sk1 = torch.cos(bk), torch.sin(bk)
    ck2, sk2 = ck1 * ck1 - sk1 * sk1, 2.0 * sk1 * ck1
    cks = torch.stack([ck2, ck1, torch.ones_like(ck1), ck1, ck2])  # (5, B)
    sks = torch.stack([-sk2, -sk1, torch.zeros_like(ck1), sk1, sk2])
    p0 = torch.stack([fx - ox, fy - oy])  # (2, B)
    re = ((cxy[:, None] * cms[None]).sum(-1) + cks[None] * p0[:, None]) / n  # (2, 5, B)
    im = ((cxy[:, None] * sms[None]).sum(-1) + sks[None] * p0[:, None]) / n
    return torch.cat([re.reshape(10, -1), im.reshape(10, -1)]).T.contiguous()  # (B, 20)


@functools.lru_cache(maxsize=None)
def _trace_basis(device):
    """cos and sin of 2 pi m t on the trace's grid, (2, 5, N_TRACE), f64 -> f32."""
    t = np.linspace(0.0, 1.0, N_TRACE)
    ms = np.arange(-(N_COEFFS // 2), N_COEFFS // 2 + 1)
    ang = 2.0 * np.pi * ms[:, None] * t[None]
    return torch.as_tensor(np.stack([np.cos(ang), np.sin(ang)]), dtype=torch.float32, device=device)


def _trace_xy(x):
    """trace_fourier_curves (data.py:51-57) from flattened coefficients:
    points(t) = Re(sum_m c_m e^{2 pi i m t}) = sum_m Re c_m cos - Im c_m sin,
    t = linspace(0, 1, 100). Five multiply-adds per output in f32, in m
    order: ``hint_tpu`` needs ``Precision.HIGHEST`` on its matmul here (a
    bf16-pass product flipped 0.2 % of argmaxes), and elementwise products
    are f32 whatever the process's TF32 flags. Returns (tx, ty), (B, 100)."""
    B = x.shape[0]
    real = x[:, : 2 * N_COEFFS].reshape(B, 2, N_COEFFS, 1)
    imag = x[:, 2 * N_COEFFS :].reshape(B, 2, N_COEFFS, 1)
    bc, bs = _trace_basis(x.device)
    pts = real[:, :, 0] * bc[0] - imag[:, :, 0] * bs[0]
    for m in range(1, N_COEFFS):
        pts = pts + real[:, :, m] * bc[m]
        pts = pts - imag[:, :, m] * bs[m]
    return pts[:, 0], pts[:, 1]


@functools.lru_cache(maxsize=None)
def _pairs(device):
    """(i, j) of the upper triangle, j < 99, in row-major order: 4,851 pairs."""
    i, j = np.triu_indices(N_TRACE, 1)
    live = j < N_TRACE - 1
    return (torch.as_tensor(i[live], device=device), torch.as_tensor(j[live], device=device))


def _forward_screen(x):
    """f32 device pass of the forward process: the top two pairwise d^2
    over the upper triangle (row-major first max, the reference's
    convention, fourier.py forward_process). Returns (feats, band, seam, i1):

    * ``band``: the top-two gap is within f32 cross-engine error; the host's
      f64 full-matrix refine (``_refine_host``) decides the row. An exact
      tie always lands here, so the order ``torch.topk`` gives tied values
      never decides a row.
    * ``seam``: the winning pair is (0, i1), whose twin (i1, 99) may win the
      reference's f64 argmax (the duplicated endpoint t = 1 retraces t = 0);
      ``_seam_host`` decides the orientation in f64. Column 99 is left out
      of the screen: every (i, 99) ties its twin (0, i) to ~1e-15.
    * ``i1``: the winning pair's second index (seam rows need it).
    """
    tx, ty = _trace_xy(x)
    pi, pj = _pairs(x.device)
    rows = max(1, SCREEN_BYTES // (5 * 4 * len(pi)))
    tops, poss = [], []
    for r in range(0, x.shape[0], rows):
        ax, ay = tx[r : r + rows], ty[r : r + rows]
        d0 = ax[:, pi] - ax[:, pj]
        d1 = ay[:, pi] - ay[:, pj]
        top2, pos = torch.topk(d0 * d0 + d1 * d1, 2, dim=1)
        tops.append(top2)
        poss.append(pos[:, 0])
    top2, pos = torch.cat(tops), torch.cat(poss)
    top, second = top2[:, 0], top2[:, 1]
    band = (top - second) <= BAND_EPS * top
    i0, i1 = pi[pos], pj[pos]
    seam = i0 == 0
    ends = torch.stack([i0, i1], dim=1)
    qx, qy = tx.gather(1, ends), ty.gather(1, ends)
    # y = (dy, dx): the reference stores (delta[1], delta[0]) (data.py:137)
    feats = torch.stack([qy[:, 1] - qy[:, 0], qx[:, 1] - qx[:, 0]], dim=1)
    return feats, band, seam, i1


def _sub_batch(gen, B, device):
    """One sub-batch of the sweep: the prior draws (data.py:85-100), the
    ring, x, the screen and the observation noise, packed as
    [x | feats before noise | y_noise | flag | i1] (B, 26) f32 (flag and i1
    are small integers, exact in f32). The draws (r0, theta, shift) stay
    on the device; the host reads them only when a bad row needs them."""
    def uniform(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    r0 = 1.0 + uniform(B)
    theta = 2.0 * math.pi * uniform(B)
    shift = normal(B, 2)
    y_noise = 0.05 * normal(B, 2)
    px, py, k = _lens_rings_xy(r0, theta)
    x = _ring_to_x_xy(px, py, k, shift)
    feats, band, seam, i1 = _forward_screen(x)
    flag = band.float() + 2.0 * seam.float() + 4.0 * (k == 0).float()
    packed = torch.cat([x, feats, y_noise, flag[:, None], i1.float()[:, None]], dim=1)
    return packed, (r0, theta, shift)


def _refine_host(x_rows: np.ndarray) -> np.ndarray:
    """Host f64 tie-break for band rows, the reference path's decision
    (fourier.py forward_process refinement): complex128 trace, f64
    distances, row-major first max over the full squareform matrix."""
    from hint_tpu_torch.data.fourier import LensShapeModel

    model = LensShapeModel()
    pts = model.trace_fourier_curves(model.unflatten_coeffs(x_rows))
    q = pts.astype(np.float64)  # (R, 100, 2)
    flat_idx = np.empty(len(q), np.int64)
    for r in range(0, len(q), REFINE_ROWS):  # rows in blocks: (rows, 100, 100) f64 each
        b = q[r : r + REFINE_ROWS]
        dq = np.sqrt((b[:, :, None, 0] - b[:, None, :, 0]) ** 2 + (b[:, :, None, 1] - b[:, None, :, 1]) ** 2)
        flat_idx[r : r + REFINE_ROWS] = dq.reshape(len(b), -1).argmax(axis=1)
    i0, i1 = np.unravel_index(flat_idx, (N_TRACE, N_TRACE))
    rows = np.arange(len(q))
    delta = q[rows, i1] - q[rows, i0]
    return delta[:, ::-1].copy()  # (dy, dx)


def _seam_host(x_rows: np.ndarray, i1: np.ndarray) -> np.ndarray:
    """Twin-orientation decision for seam rows: the winning pair (0, i1)
    against its seam twin (i1, 99). The reference's full-matrix argmax
    (data.py:131-133) lands on (i1, 99) iff d(i1, 99) > d(0, i1) strictly in
    f64 (equal values resolve row-major first)."""
    from hint_tpu_torch.data.fourier import LensShapeModel

    model = LensShapeModel()
    q = model.trace_fourier_curves(model.unflatten_coeffs(x_rows)).astype(np.float64)
    rows = np.arange(len(q))
    p0, pi, p99 = q[:, 0], q[rows, i1], q[:, N_TRACE - 1]
    d_twin0 = np.sqrt((pi[:, 0] - p0[:, 0]) ** 2 + (pi[:, 1] - p0[:, 1]) ** 2)
    d_twin9 = np.sqrt((p99[:, 0] - pi[:, 0]) ** 2 + (p99[:, 1] - pi[:, 1]) ** 2)
    delta = np.where((d_twin9 > d_twin0)[:, None], p99 - pi, pi - p0)
    return delta[:, ::-1].copy()  # (dy, dx)


def _regen_host(r0: np.ndarray, theta: np.ndarray, shift: np.ndarray):
    """Host (f64) regeneration of bad rows from the same (r0, theta, shift)
    draws. Returns (x (R, 20) f32, feats (R, 2) f64)."""
    from hint_tpu_torch.data import geometry as geo
    from hint_tpu_torch.data.fourier import LensShapeModel

    model = LensShapeModel()
    xs = []
    for jj in range(len(r0)):
        r = float(r0[jj])
        th = float(theta[jj])
        d = 0.8 * (r + 2 * r)
        c0 = geo.circle_polygon(0.0, 0.0, r)
        c1 = geo.circle_polygon(d * np.sin(th), d * np.cos(th), 2 * r)
        ring = geo.convex_intersection(c0, c1)
        coords = np.concatenate([ring, ring[:1]], axis=0)
        coords = coords - (coords.mean(axis=0) + 0.5 * shift[jj])
        xs.append(model.flatten_coeffs(model.fourier_coeffs(coords, n_coeffs=N_COEFFS)[None])[0])
    x = np.stack(xs).astype(np.float32)
    return x, _refine_host(x)


def _host_finish(packed: np.ndarray, extras, noise: bool):
    """Unpack one dispatch's host copy and apply the host's fixes.

    ``extras()`` copies the dispatch's (r0, theta, shift) draws to the host;
    it is called only when a bad row needs them."""
    x = np.ascontiguousarray(packed[:, :20])
    feats = packed[:, 20:22].astype(np.float64)
    y_noise = packed[:, 22:24]
    flag = packed[:, FLAG_COLUMN].astype(np.int32)
    i1 = packed[:, 25].astype(np.int32)
    band = (flag & 1) != 0
    seam = (flag & 2) != 0
    bad = (flag & 4) != 0
    if bad.any():
        r0, theta, shift = extras()
        x_fix, f_fix = _regen_host(r0[bad], theta[bad], shift[bad])
        x[bad] = x_fix
        feats[bad] = f_fix
    full = band & ~bad
    if full.any():
        feats[full] = _refine_host(x[full])
    seam_only = seam & ~band & ~bad
    if seam_only.any():
        feats[seam_only] = _seam_host(x[seam_only], i1[seam_only])
    y = feats + (y_noise.astype(np.float64) if noise else 0.0)
    return x, y.astype(np.float32)


def sample_joint(
    n: int,
    seed: int = 0,
    sub_batch: int = 32768,
    noise: bool = True,
    group: int = 8,
    device=None,
):
    """Draw n lens-shape (x, y) prior pairs on the device (CUDA unless
    ``device`` names another).

    Deterministic in (seed, sub_batch, device type): sub-batch q draws from
    a generator seeded from (seed, q), so the rows do not depend on ``n``
    or on ``group`` (sub-batches per host transfer). The host fixes
    dispatch i while the device computes dispatch i+1
    (``data.sweep.run_sweep``)."""
    return run_sweep(n, seed, sub_batch, group, device, _sub_batch,
                     lambda packed, extras: _host_finish(packed, extras, noise))
