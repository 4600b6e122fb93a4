"""The HAC block's backward kernels (``csrc/hac_block_bwd.cu``) on the CPU.

The kernels run only on a card. Here a numpy emulation of their loops reads
only what they read (the int32 level/node and workspace tables, the packed
weights, their per-unit transposes and the biases) and walks their
workspace, chunking, tiles and split-row partials; the weight kernel's
products go by its tensor-core route (3xTF32 in f32 mode: TF32 parts
rounded to nearest even to 10 mantissa bits; bf16 x bf16, or a2 against an
f32 dS/dT split exactly into three bf16 parts, in bf16 mode). It is held
to autograd
through the plain version (``plain_block_grad``) and to ``jax.grad`` through
``hint_tpu``'s ``fused_block`` (Pallas kernel in interpret mode, levelwise
VJP), with noise in every padded weight entry and exact zeros asserted at
every padded gradient entry. Tolerances, per leaf, of 1 + the leaf's
largest |ref|: f32 1e-5 (other summation orders); bf16 1e-2 (both round the
same layer-input gradients to bf16 once, after their f32 sums, but a value
on a rounding boundary can land one bf16 ulp, 2**-8, apart).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu.ops.hac import HierarchicalAffineCoupling as JHAC
from hint_tpu.ops.pallas_block import fused_block as jax_fused_block
from hint_tpu_torch.convert import params_from_numpy
from hint_tpu_torch.ops import hac_fused
from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling as THAC

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
BATCH, ROWS_PER_SPLIT = 37, 16  # three split-row chunks, the last one ragged (5 rows)
C_INTERNAL = (16, 8)
# (dim, cond_dim): odd and even widths, up to the configs' d=100, with and without a condition
SHAPES = [(7, 0), (11, 3), (20, 0), (100, 4)]


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _garbage(thac, seed):
    """Noise in every padded entry of the level stacks: the rows
    [split, in_max) of w0, the columns [out, out_max) of w2 and b2."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for li, lv in enumerate(thac.levels):
            p, n = thac.level_params(li), len(lv.nodes)
            for u in range(2 * n):
                nd = lv.nodes[u % n]
                out_i = nd.dim - nd.split
                for t in (p["w0"][u, nd.split : lv.in_max], p["w2"][u, :, out_i:], p["b2"][u, out_i:]):
                    t.copy_(torch.randn(t.shape, generator=g))
    return thac


def _block(dim, cond_dim, compute_dtype="float32", seed=0):
    thac = THAC(dim=dim, c_internal=C_INTERNAL, cond_dim=cond_dim, compute_dtype=compute_dtype, impl="fused")
    thac.init(torch.Generator().manual_seed(seed))
    return _garbage(thac, seed + 1)


def _inputs(dim, cond_dim, seed):
    rng = np.random.default_rng(200 + seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(BATCH, dim), (f(BATCH, cond_dim) if cond_dim else None), f(BATCH, dim), f(BATCH)


def _padding(thac):
    """(leaf name, index) of every padded entry of the level stacks."""
    out = []
    for li, lv in enumerate(thac.levels):
        n = len(lv.nodes)
        for u in range(2 * n):
            nd = lv.nodes[u % n]
            out_i = nd.dim - nd.split
            out += [(f"L{li}.w0", (u, slice(nd.split, lv.in_max))),
                    (f"L{li}.w2", (u, slice(None), slice(out_i, None))),
                    (f"L{li}.b2", (u, slice(out_i, None)))]
    return out


def _tf32(a):
    """f32 -> TF32 (10 mantissa bits), round to nearest even, as ``tf32_rne``."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    finite = (u & 0x7F800000) != 0x7F800000
    r = np.where(finite, (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000, u)
    return r.astype(np.uint32).view(np.float32)


def _split3(a):
    """An f32 array as hi + mid + lo, each bf16, exactly."""
    a = np.asarray(a, np.float32)
    hi = _bf16(a)
    r1 = a - hi
    mid = _bf16(r1)
    return hi, mid, _bf16(r1 - mid)


def _product(a, b, route):
    """a @ b by one of the weight kernel's tensor-core routes, each product
    exact and the sums in float64 (the tensor cores sum in f32, in their
    order)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    f = lambda u, v: u.astype(np.float64) @ v.astype(np.float64)  # noqa: E731
    if route == "tf32x3":
        ah, bh = _tf32(a), _tf32(b)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = f(al, bh) + f(ah, bl) + f(ah, bh)
    elif route == "bf16":  # both sides are bf16 values already
        assert np.array_equal(_bf16(a), a) and np.array_equal(_bf16(b), b)
        out = f(a, b)
    else:  # "bf16_b3": a bf16 side against an f32 side split in three
        assert route == "bf16_b3" and np.array_equal(_bf16(a), a)
        out = sum(f(a, p) for p in _split3(b)[::-1])
    return out.astype(np.float32)


def emulate_backward(hac, x, cond, rev, g_y, g_ld, rows_per_split=ROWS_PER_SPLIT):
    """Both backward kernels' loops in numpy. Returns ({"x", "cond", leaf
    name: gradient}, the per-split partials). The workspace starts as NaN,
    so a region read before it is written shows in the result; the partials
    too, so a gradient entry no tile writes shows."""
    pk = hac_fused._packed(hac, torch.device("cpu"))
    bwd = pk.bwd
    meta, wmeta = pk.meta.numpy(), bwd.wmeta
    W, bias = pk.weights.float().numpy(), pk.biases.numpy()
    WT = hac_fused._transposed(hac, pk).float().numpy()
    B, d = x.shape
    cd = 0 if cond is None else cond.shape[1]
    bf16 = hac.compute_dtype == "bfloat16"
    q = _bf16 if bf16 else (lambda a: a)

    # the data kernel's shared-memory carve-up, as the kernel walks it
    tb, dp, cp = hac_fused._TILE_ROWS, hac_fused._pad4(d), hac_fused._pad4(cd)
    carve = [tb * dp] * 3 + [tb * bwd.width] * 2 + [tb, tb * cp, tb * cp, tb * bwd.npc_max * cp]
    assert all(part % 4 == 0 for part in carve)  # 16-byte loads of the hidden buffers stay aligned
    assert 4 * (sum(carve) + meta.size + wmeta.size) == hac_fused._bwd_smem_bytes(
        d, bwd.width, cd, bwd.npc_max, meta.size + wmeta.size)

    n_levels = int(meta[0])
    nodes = meta[hac_fused._HDR + n_levels * hac_fused._LREC :].reshape(-1, hac_fused._NREC)
    ws = np.full(B * bwd.row_floats, np.nan, np.float32)

    def region(off, width):
        return ws[B * off : B * (off + width)].reshape(B, width)

    def level(li):
        rec = [int(v) for v in meta[hac_fused._HDR + li * hac_fused._LREC :][: hac_fused._LREC]]
        wl = [int(v) for v in wmeta[hac_fused._WHDR + li * hac_fused._WREC :][: hac_fused._WREC]]
        return rec, wl

    def chunks(n, npc):
        for i0 in range(0, n, npc):
            yield range(i0, min(i0 + npc, n))

    cs = np.float32(hac.clamp * hac_fused.ATAN_SCALE)

    # sweep 1: the forward in pass order, saving x_l, S, a1, a2 and y
    xs = x.copy()
    for step in range(n_levels):
        li = step if rev else n_levels - 1 - step
        (n, h, rows, o, node0, _, w0, w1, w2, b0, b1, b2), wl = level(li)
        in_max, uw = rows - cd, 2 * n * h
        assert wl[8] * 2 * hac_fused._pad4(h) <= bwd.width and wl[8] <= bwd.npc_max
        region(wl[0], d)[:] = xs
        S, T = np.zeros_like(xs), np.zeros_like(xs)
        for chunk in chunks(n, wl[8]):
            for i in chunk:
                off, split, out = nodes[node0 + i][:3]
                for u in (i, n + i):
                    wu0 = W[w0 + u * rows * h :][: rows * h].reshape(rows, h)
                    pre = q(xs[:, off : off + split]) @ wu0[:split] + bias[b0 + u * h :][:h]
                    if cd:
                        pre = pre + q(cond) @ wu0[in_max:]
                    a1 = q(np.maximum(pre, 0))
                    a2 = q(np.maximum(a1 @ W[w1 + u * h * h :][: h * h].reshape(h, h) + bias[b1 + u * h :][:h], 0))
                    region(wl[4], uw)[:, u * h : (u + 1) * h] = a1
                    region(wl[5], uw)[:, u * h : (u + 1) * h] = a2
                    wu2 = W[w2 + u * h * o :][: h * o].reshape(h, o)[:, :out]
                    (T if u >= n else S)[:, off + split : off + split + out] = a2 @ wu2 + bias[b2 + u * o :][:out]
        region(wl[1], d)[:] = S
        le = cs * np.arctan(S)
        xs = (xs - T) / np.exp(le) if rev else np.exp(le) * xs + T
    region(int(wmeta[0]), d)[:] = xs

    # sweep 2: reverse pass order
    g, dcond = g_y.copy(), np.zeros((B, cd), np.float32)
    for step in range(n_levels):
        li = n_levels - 1 - step if rev else step
        (n, h, rows, o, node0, _, w0, w1, w2, b0, b1, b2), wl = level(li)
        in_max, uw = rows - cd, 2 * n * h
        s, xin = region(wl[1], d), region(wl[0], d)
        e = np.exp(cs * np.arctan(s))
        if rev:
            y_next = region(level(li + 1)[1][0] if li + 1 < n_levels else int(wmeta[0]), d)
            gx = g / e
            dT, dle, g = -gx, -g * y_next - g_ld[:, None], gx
        else:
            dT, dle, g = g, g * e * xin + g_ld[:, None], g * e
        dS = dle * cs / (1 + s * s)
        region(wl[2], d)[:], region(wl[3], d)[:] = dS, dT
        for chunk in chunks(n, wl[8]):
            parts = []
            for i in chunk:
                off, split, out = nodes[node0 + i][:3]
                dxs = np.zeros((B, rows), np.float32)
                for u in (i, n + i):  # the s-unit's sum, then the t-unit's
                    dpre3 = (dT if u >= n else dS)[:, off + split : off + split + out]
                    w2t = WT[w2 + u * o * h :][: o * h].reshape(o, h)[:out]
                    p2 = q(dpre3 @ w2t) * (region(wl[5], uw)[:, u * h : (u + 1) * h] > 0)
                    p1 = q(p2 @ WT[w1 + u * h * h :][: h * h].reshape(h, h)) * (region(wl[4], uw)[:, u * h : (u + 1) * h] > 0)
                    region(wl[7], uw)[:, u * h : (u + 1) * h] = p2
                    region(wl[6], uw)[:, u * h : (u + 1) * h] = p1
                    dxs = dxs + p1 @ WT[w0 + u * h * rows :][: h * rows].reshape(h, rows)
                dxs = q(dxs)
                g[:, off : off + split] += dxs[:, :split]
                parts.append(dxs[:, in_max:])
            for part in parts:  # node order within the chunk
                dcond = dcond + part
    grads = {"x": g, "cond": dcond if cd else None}

    # the weight kernel: tiles of up to 128 x 264, each summed over split-row chunks
    plain, split_b = ("bf16", "bf16_b3") if bf16 else ("tf32x3", "tf32x3")
    n_w, n_tot = W.size, W.size + bias.size
    splits = -(-B // rows_per_split)
    partial = np.full((splits, n_tot), np.nan, np.float32)
    for li, u, layer, m0, n0 in bwd.tiles:
        (n, h, rows, o, node0, _, *offs), wl = level(li)
        off, split, out = nodes[node0 + (u if u < n else u - n)][:3]
        in_max, uw = rows - cd, 2 * n * h
        M, N = (rows, h, h)[layer], (h, h, o)[layer]
        if layer == 0:
            act = np.zeros((B, rows), np.float32)
            act[:, :split] = q(region(wl[0], d)[:, off : off + split])
            if cd:
                act[:, in_max:] = q(cond)
        else:
            act = region(wl[3 + layer], uw)[:, u * h : (u + 1) * h]
        if layer == 2:
            dpre = np.zeros((B, o), np.float32)
            dpre[:, :out] = region(wl[2 if u < n else 3], d)[:, off + split : off + split + out]
        else:
            dpre = region(wl[6 + layer], uw)[:, u * h : (u + 1) * h]
        m1, n1 = min(M, m0 + hac_fused._GRAD_ROWS), min(N, n0 + hac_fused._GRAD_COLS)
        for k in range(splits):
            r0, r1 = k * rows_per_split, min(B, (k + 1) * rows_per_split)
            blk = _product(act[r0:r1, m0:m1].T, dpre[r0:r1, n0:n1], split_b if layer == 2 else plain)
            wofs = offs[layer] + u * M * N
            view = partial[k, wofs : wofs + M * N].reshape(M, N)
            view[m0:m1, n0:n1] = blk
            if m0 == 0:
                bofs = n_w + offs[3 + layer] + u * N
                partial[k, bofs + n0 : bofs + n1] = dpre[r0:r1, n0:n1].sum(0)
    # the reduction: split order, weights rounded to bf16 once, biases not
    total = np.zeros(n_tot, np.float32)
    for k in range(splits):
        total = total + partial[k]
    if bf16:
        total[:n_w] = _bf16(total[:n_w])
    names = [f"L{li}.{k}" for li in range(n_levels) for k in hac.level_params(li)]
    for name, (o0, shape) in zip(names, bwd.leaves):
        grads[name] = total[o0 : o0 + int(np.prod(shape))].reshape(shape)
    return grads, partial


def _plain_grads(thac, x, c, r, q, rev):
    """Gradients of sum(y*r) + sum(logdet*q) by plain_block_grad."""
    names = ["x", "cond", *(k for k, _ in thac.named_parameters())]
    needs = [True, c is not None, *([True] * len(names[2:]))]
    out = hac_fused.plain_block_grad(
        thac, torch.from_numpy(x), None if c is None else torch.from_numpy(c), rev,
        torch.from_numpy(r), torch.from_numpy(q), needs)
    return {k: v.numpy() for k, v in zip(names, out) if v is not None}


def _close(got, ref, tol, what):
    """|got - ref| <= tol * (1 + max |ref|) over one leaf: the sums run in
    other orders over values up to ~2,500 with cancellation, so an entry
    near 0 carries the rounding of its largest terms."""
    err = float(np.max(np.abs(got - ref)) / (1 + np.max(np.abs(ref)))) if ref.size else 0.0
    assert np.isfinite(got).all() and err <= tol, f"{what}: max |d|/(1+max|ref|) = {err:.3e} > {tol:g}"


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rev", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("dim,cond_dim", SHAPES, ids=[f"d{d}-cond{c}" for d, c in SHAPES])
def test_backward_emulation_matches_plain(dim, cond_dim, rev, compute_dtype):
    thac = _block(dim, cond_dim, compute_dtype, seed=dim)
    x, c, r, q = _inputs(dim, cond_dim, dim)
    ref = _plain_grads(thac, x, c, r, q, rev)
    got, partial = emulate_backward(thac, x, c, rev, r, q)
    assert partial.shape[0] == 3 and not np.isnan(partial).any()  # every entry of every split written
    assert set(ref) == {k for k, v in got.items() if v is not None}
    for k in ref:
        _close(got[k], ref[k], TOL[compute_dtype], k)
    for name, idx in _padding(thac):
        assert not np.any(got[name][idx]), f"{name}{idx} padding gradient not exactly 0"
        assert not np.any(ref[name][idx]), f"{name}{idx}: the plain version's is 0 too"


@functools.lru_cache(maxsize=None)
def _jax_params(dim, cond_dim):
    jhac = JHAC(dim=dim, c_internal=C_INTERNAL, cond_dim=cond_dim)
    return jhac, jhac.init(jax.random.PRNGKey(dim))


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("dim,cond_dim", SHAPES, ids=[f"d{d}-cond{c}" for d, c in SHAPES])
def test_backward_emulation_matches_jax(dim, cond_dim, rev):
    """The emulation's gradients against jax.grad through hint_tpu's
    fused_block (f32), from the JAX package's init with noise in the padding."""
    jhac, params = _jax_params(dim, cond_dim)
    thac = THAC(dim=dim, c_internal=C_INTERNAL, cond_dim=cond_dim, impl="fused")
    thac.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    _garbage(thac, dim)
    state = {k: v.numpy() for k, v in thac.state_dict().items()}
    jparams = {lk: {k: jnp.asarray(state[f"{lk}.{k}"]) for k in lv} for lk, lv in params.items()}
    x, c, r, q = _inputs(dim, cond_dim, dim + 1)
    got, _ = emulate_backward(thac, x, c, rev, r, q)

    def loss(p, xx, cc):
        yj, ldj = jax_fused_block(jhac, p, xx, cc, rev)
        return jnp.sum(yj * r) + jnp.sum(ldj * q)

    argnums = (0, 1, 2) if cond_dim else (0, 1)
    jg = jax.grad(loss, argnums=argnums)(jparams, jnp.asarray(x), None if c is None else jnp.asarray(c))
    _close(got["x"], np.asarray(jg[1]), TOL["float32"], "x")
    if cond_dim:
        assert np.abs(got["cond"]).max() > 0
        _close(got["cond"], np.asarray(jg[2]), TOL["float32"], "cond")
    for lk, level in jg[0].items():
        for k, gj in level.items():
            _close(got[f"{lk}.{k}"], np.asarray(gj), TOL["float32"], f"{lk}.{k}")


def _constants(path):
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", path.read_text())}


def test_backward_layout_constants_match_the_wrapper():
    """The workspace-table and tile records, the weight tiles' rows and
    columns and the data tile's height are written once in
    csrc/hac_block_bwd.cu and once in hac_fused.py; the table of levels and
    nodes is the forward's (csrc/hac_common.cuh); the build hashes all
    three files."""
    k = _constants(hac_fused.SOURCES[1])
    assert (k["WHDR"], k["WREC"], k["TREC"], k["GTM"], k["GTN"], k["BTB"]) == (
        hac_fused._WHDR, hac_fused._WREC, hac_fused._TREC, hac_fused._GRAD_ROWS, hac_fused._GRAD_COLS,
        hac_fused._TILE_ROWS)
    common = _constants(hac_fused.HEADERS[0])
    assert (common["HDR"], common["LREC"], common["NREC"]) == (hac_fused._HDR, hac_fused._LREC, hac_fused._NREC)
    assert all('#include "hac_common.cuh"' in p.read_text() for p in hac_fused.SOURCES)
    # the condition's three parts (rows, gradient, a chunk's per-node gradients), padded to 4 floats
    assert hac_fused._bwd_smem_bytes(100, 576, 4, 9, 400) - hac_fused._bwd_smem_bytes(100, 576, 0, 9, 400) == 4 * 16 * 4 * 11
    assert hac_fused._bwd_smem_bytes(100, 576, 5, 9, 400) == hac_fused._bwd_smem_bytes(100, 576, 8, 9, 400)


@pytest.mark.parametrize("route", ["tf32x3", "bf16", "bf16_b3"])
def test_split_products_match_f32(route):
    """The weight kernel's tensor-core routes against float64 products at
    the top level's widths (h = 263, a 128-row tile, K = 512 batch rows):
    3xTF32 of two f32 operands, bf16 of two bf16 operands, and a bf16 side
    against an f32 side split exactly into three bf16 parts, each within
    1e-6 of |a| @ |b| per entry; one TF32 pass (~2^-11 per product) errs
    more than 1e-5 there."""
    rng = np.random.default_rng(263)
    a, b = rng.normal(size=(128, 512)).astype(np.float32), rng.normal(size=(512, 263)).astype(np.float32)
    if route != "tf32x3":
        a = _bf16(a)
    if route == "bf16":
        b = _bf16(b)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    err = float(np.max(np.abs(_product(a, b, route) - ref) / scale))
    assert err <= 1e-6, err
    if route == "tf32x3":
        one_pass = _tf32(a).astype(np.float64) @ _tf32(b).astype(np.float64)
        assert float(np.max(np.abs(one_pass - ref) / scale)) > 1e-5


@pytest.mark.parametrize("dim,cond_dim", [(20, 0), (100, 4)], ids=["d20", "d100-cond4"])
def test_backward_workspace_and_tiles_cover_the_block(dim, cond_dim):
    """Workspace regions are disjoint, 4-float aligned and fill the row;
    the weight tiles write every gradient entry exactly once."""
    thac = _block(dim, cond_dim)
    bwd = hac_fused._packed(thac, torch.device("cpu")).bwd
    wm = bwd.wmeta
    regions = [(int(wm[0]), dim)]
    for li, lv in enumerate(thac.levels):
        rec = wm[hac_fused._WHDR + hac_fused._WREC * li :][: hac_fused._WREC]
        uw = 2 * len(lv.nodes) * lv.hidden
        regions += [(int(rec[k]), dim) for k in range(4)] + [(int(rec[k]), uw) for k in range(4, 8)]
    used = np.zeros(bwd.row_floats, int)
    for off, width in regions:
        assert off % 4 == 0
        used[off : off + width] += 1
    assert used.max() == 1 and bwd.row_floats == sum(hac_fused._pad4(w) for _, w in regions)
    n_w = sum(p.numel() for k, p in thac.named_parameters() if k.split(".")[1][0] == "w")
    n_tot = sum(p.numel() for p in thac.parameters())
    offset = {name: o for name, (o, _) in zip((k for k, _ in thac.named_parameters()), bwd.leaves)}
    cover = np.zeros(n_tot, int)
    for li, u, layer, m0, n0 in bwd.tiles:
        M, N = thac.level_params(li)[f"w{layer}"].shape[1:]
        wo, bo = offset[f"L{li}.w{layer}"], offset[f"L{li}.b{layer}"]
        block = np.zeros((M, N), int)
        block[m0 : m0 + hac_fused._GRAD_ROWS, n0 : n0 + hac_fused._GRAD_COLS] = 1
        cover[wo + u * M * N : wo + (u + 1) * M * N] += block.reshape(-1)
        if m0 == 0:
            cover[bo + u * N + n0 : bo + u * N + min(N, n0 + hac_fused._GRAD_COLS)] += 1
    assert cover.min() == 1 and cover.max() == 1
    assert [shape for _, shape in bwd.leaves] == [tuple(p.shape) for p in thac.parameters()]
    assert min(o for o, s in bwd.leaves if len(s) == 3) == 0 and min(o for o, s in bwd.leaves if len(s) == 2) == n_w


def test_weight_rows_fill_the_card_with_ragged_chunks():
    for batch, n_tiles in ((10_000, 878), (10_000, 2414), (37, 878), (512, 60), (1, 1)):
        rows = hac_fused._weight_rows(batch, n_tiles)
        splits = -(-batch // rows)
        assert 1 <= rows <= batch and (splits - 1) * rows < batch
        assert splits == 1 or rows >= hac_fused._GRAD_MIN_ROWS
        assert n_tiles * splits >= min(hac_fused._GRAD_BLOCKS, n_tiles * -(-batch // hac_fused._GRAD_MIN_ROWS))


def test_backward_cpu_path_is_the_plain_version():
    """On the CPU _FusedBlock's backward is plain_block_grad: the same bits
    as autograd through plain_block; off the CPU it launches or raises; a
    reshuffle block never reaches it."""
    thac = _block(11, 3)
    x, c, r, q = (torch.from_numpy(a) for a in _inputs(11, 3, 5))
    xg, cg = x.clone().requires_grad_(), c.clone().requires_grad_()
    before = hac_fused.bwd_launches
    y, ld = hac_fused.fused_block(thac, xg, cg)
    got = torch.autograd.grad((y * r).sum() + (ld * q).sum(), [xg, cg, *thac.parameters()])
    xp, cp = x.clone().requires_grad_(), c.clone().requires_grad_()
    y, ld = hac_fused.plain_block(thac, xp, cp, False)
    ref = torch.autograd.grad((y * r).sum() + (ld * q).sum(), [xp, cp, *thac.parameters()])
    assert hac_fused.bwd_launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    needs = (True, True) + (True,) * len(list(thac.parameters()))
    meta = (torch.zeros(2, 11, device="meta"), torch.zeros(2, 3, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        hac_fused._run_block_grad(thac, *meta, False, torch.zeros(2, 11, device="meta"),
                                  torch.zeros(2, device="meta"), needs)
    # a reshuffle block's gradient is autograd through the levelwise engine on every device
    shuffled = THAC(dim=8, c_internal=(8,), reshuffle=True, impl="fused").to("meta")
    xm = torch.zeros(2, 8, device="meta", requires_grad=True)
    before = (hac_fused.launches, hac_fused.bwd_launches, hac_fused.levelwise_reshuffle_calls)
    y, ld = hac_fused.fused_block(shuffled, xm)
    got = torch.autograd.grad(y.sum() + ld.sum(), [xm, *shuffled.parameters()])
    assert (hac_fused.launches, hac_fused.bwd_launches, hac_fused.levelwise_reshuffle_calls) == (
        before[0], before[1], before[2] + 1)
    assert type(y.grad_fn).__name__ != "_FusedBlockBackward"
    assert [tuple(t.shape) for t in got] == [(2, 8), *(tuple(p.shape) for p in shuffled.parameters())]


def test_transposes_are_built_for_the_backward_only():
    """The forward's pack holds no transposes; the backward's are every
    unit's w0, w1, w2 transposed, in the packed order, built once per
    parameter version."""
    thac = _block(11, 3)
    pk = hac_fused._packed(thac, torch.device("cpu"))
    assert "_kernel_pack_t" not in thac.__dict__ and not hasattr(pk, "weights_t")
    wt = hac_fused._transposed(thac, pk)
    assert hac_fused._transposed(thac, pk) is wt and wt.dtype == pk.weights.dtype
    at = 0
    for li in range(len(thac.levels)):
        for k in ("w0", "w1", "w2"):
            w = thac.level_params(li)[k]
            assert torch.equal(wt[at : at + w.numel()].view(w.shape[0], w.shape[2], w.shape[1]), w.transpose(1, 2))
            at += w.numel()
    assert at == wt.numel() == pk.weights.numel()
    with torch.no_grad():
        thac.L0["w1"].mul_(2.0)
    assert hac_fused._transposed(thac, hac_fused._packed(thac, torch.device("cpu"))) is not wt
