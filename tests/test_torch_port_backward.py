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
import importlib.util
import re
from pathlib import Path

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
from hint_tpu_torch.utils import instrument

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


def emulate_saving_forward(hac, x, cond, rev):
    """The saving forward: the forward kernel by the route that saves in the
    block's compute dtype (``hac_fused._SAVE_ROUTE``: the tiled route in
    f32, whose chains and saves are the loop's, the wgmma route in bf16), by
    ``test_torch_port_hac``'s emulation of it (the loop's in f32), and
    its saves, which write each level's input, S, a1 and a2 and the block's
    output to the saved buffer at the workspace table's offsets. Returns (y,
    logdet, the saved buffer); the buffer starts as NaN, so a region no
    epilogue writes shows where it is read."""
    from test_torch_port_hac import _emulate_kernel, _emulate_wg_kernel  # they import this module's helpers

    bwd = hac_fused._packed(hac, torch.device("cpu")).bwd
    record = {}
    route = hac_fused._SAVE_ROUTE[hac.compute_dtype]
    assert route in (hac_fused.ROUTE_LOOP, hac_fused.ROUTE_TILED, hac_fused.ROUTE_WG)
    emulate = _emulate_wg_kernel if route == hac_fused.ROUTE_WG else _emulate_kernel
    y, ld = emulate(hac, x, cond, rev, record=record)
    B = x.shape[0]
    saved = np.full(B * bwd.saved_floats, np.nan, np.float32)
    view = lambda li, k: hac_fused.workspace_region(hac, bwd, B, torch.from_numpy(saved), li, k).numpy()  # noqa: E731
    for li in range(len(hac.levels)):
        for k, name in ((0, "x"), (1, "S"), (4, "a1"), (5, "a2")):
            view(li, k)[:] = record[li][name]
    view(None, 0)[:] = record["y"]
    return y, ld, saved


def _layout(buf, cdt, start, k_steps, n_tiles):
    """A matrix of the backward layout as the data kernel's lanes read it
    (TF32 high and low parts in f32, one bf16 matrix in bf16)."""
    from test_torch_port_hac import _tc_unit

    return _tc_unit(buf, cdt, start, k_steps, n_tiles)


def _chain_product(a, w, route):
    """a @ w as the data kernel's tensor-core route sums it, each k-step's
    products from zero and added to the running f32 sum: 3xTF32 (``w`` the
    stored high and low parts), bf16 x bf16, or an f32 ``a`` split exactly
    into three bf16 parts against bf16 ``w`` ("bf16_a3")."""
    from test_torch_port_hac import _tc_product

    if route != "bf16_a3":
        return _tc_product(a, w, "bfloat16" if route == "bf16" else "float32")
    (w,) = w
    assert np.array_equal(_bf16(w), w)
    f = lambda u, v: u.astype(np.float64) @ v.astype(np.float64)  # noqa: E731
    parts = _split3(a)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 16):
        k = slice(k0, k0 + 16)
        acc = acc + sum(f(p[:, k], w[k]) for p in parts[::-1]).astype(np.float32)
    return acc


def emulate_backward(hac, saved, cond, rev, g_y, g_ld, rows_per_split=ROWS_PER_SPLIT):
    """Both backward kernels' loops in numpy over a saved buffer
    (``emulate_saving_forward``): the data kernel's reverse chain by its
    tensor-core route, reading only what it reads (the level/node table,
    the workspace table and its tensor-core records, the backward weight
    layout as the lanes read it, the saved buffer), then the weight kernel:
    each tile's sums per row chunk, then its last chunk's sum of those in
    chunk order. Returns ({"x", "cond", leaf name: gradient}, the per-split
    partials, the gradient buffer). The gradient buffer starts as NaN, so a
    region read before it is written shows in the result; the partials and
    the gradient too, so a gradient entry no tile writes shows."""
    pk = hac_fused._packed(hac, torch.device("cpu"))
    bwd = pk.bwd
    meta, wmeta = pk.meta.numpy(), bwd.wmeta
    W, bias = pk.weights.float().numpy(), pk.biases.numpy()
    WB = hac_fused._bwd_weights(hac, pk)
    B, d = g_y.shape
    cd = 0 if cond is None else cond.shape[1]
    cdt = hac.compute_dtype
    bf16 = cdt == "bfloat16"
    q = _bf16 if bf16 else (lambda a: a)
    p23, p01 = ("bf16_a3", "bf16") if bf16 else ("tf32x3", "tf32x3")
    ks, frag = hac_fused._TC_KS[cdt], hac_fused._TC_FRAG[cdt]

    # the data kernel's shared-memory carve-up, as the kernel walks it
    tb, dp, cp = hac_fused._TC_ROWS, hac_fused._pad4(d), hac_fused._pad4(cd)
    carve = [tb * dp] * 3 + [tb * (bwd.width + hac_fused._BPAD)] * 2 + [tb, tb * cp, tb * bwd.npc_max * cp]
    assert all(part % 4 == 0 for part in carve)
    assert (bwd.width + hac_fused._BPAD) // 4 % 2 == 1  # fragment loads of the hidden buffers without bank conflicts
    assert 4 * (sum(carve) + meta.size + wmeta.size) == hac_fused._bwd_smem_bytes(
        d, bwd.width, cd, bwd.npc_max, meta.size + wmeta.size)

    n_levels = int(meta[0])
    nodes = meta[hac_fused._HDR + n_levels * hac_fused._LREC : int(meta[2])].reshape(-1, hac_fused._NREC)
    gw = np.full(B * bwd.grad_floats, np.nan, np.float32)
    sv_t, gw_t = torch.from_numpy(saved), torch.from_numpy(gw)

    def region(li, k):
        buf = sv_t if li is None or k in (0, 1, 4, 5) else gw_t
        return hac_fused.workspace_region(hac, bwd, B, buf, li, k).numpy()

    def level(li):
        rec = [int(v) for v in meta[hac_fused._HDR + li * hac_fused._LREC :][: hac_fused._LREC]]
        wl = [int(v) for v in wmeta[hac_fused._WHDR + li * hac_fused._WREC :][: hac_fused._WREC]]
        bt = [int(v) for v in wmeta[hac_fused._WHDR + n_levels * hac_fused._WREC + li * hac_fused._BREC :][
            : hac_fused._BREC]]
        return rec, wl, bt

    cs = np.float32(hac.clamp * hac_fused.ATAN_SCALE)

    # the data kernel: the levels in reverse pass order
    g, dcond = g_y.copy(), np.zeros((B, cd), np.float32)
    for step in range(n_levels):
        li = n_levels - 1 - step if rev else step
        (n, h, rows, o, node0, *_), _, (k3, kh, nh, nx, ncd, npc, o2, o1, o0) = level(li)
        in_max, hs = rows - cd, nh * 8
        assert hs == kh * ks and 2 * npc * hs <= bwd.width and npc <= bwd.npc_max
        s, xin = region(li, 1), region(li, 0)
        e = np.exp(cs * np.arctan(s))
        if rev:
            y_next = region(li + 1, 0) if li + 1 < n_levels else region(None, 0)
            gx = g / e
            dT, dle, g = -gx, -g * y_next - g_ld[:, None], gx
        else:
            dT, dle, g = g, g * e * xin + g_ld[:, None], g * e
        dS = dle * cs / (1 + s * s)
        region(li, 2)[:], region(li, 3)[:] = dS, dT
        a1, a2, p1g, p2g = region(li, 4), region(li, 5), region(li, 6), region(li, 7)
        n0t = nx + ncd
        for i0 in range(0, n, npc):
            parts = []
            for i in range(i0, min(i0 + npc, n)):
                off, split, out = nodes[node0 + i][:3]
                p1 = np.zeros((B, 2 * hs), np.float32)  # the node's s-unit's dpre1, then its t-unit's
                for which, u in enumerate((i, n + i)):
                    dpre3 = np.zeros((B, k3 * ks), np.float32)  # zeros past the node's out
                    dpre3[:, :out] = (dT if u >= n else dS)[:, off + split : off + split + out]
                    w2t = _layout(WB, cdt, o2 + u * k3 * nh * frag, k3, nh)
                    p2 = q(_chain_product(dpre3, w2t, p23)[:, :h]) * (a2[:, u] > 0)
                    p2g[:, u] = p2
                    a = np.zeros((B, hs), np.float32)
                    a[:, :h] = p2
                    w1t = _layout(WB, cdt, o1 + u * kh * nh * frag, kh, nh)
                    p1[:, which * hs : which * hs + h] = q(_chain_product(a, w1t, p01)[:, :h]) * (a1[:, u] > 0)
                    p1g[:, u] = p1[:, which * hs : which * hs + h]
                w0t = _layout(WB, cdt, o0 + i * 2 * kh * n0t * frag, 2 * kh, n0t)
                dxs = q(_chain_product(p1, w0t, p01))
                g[:, off : off + split] += dxs[:, :split]
                parts.append(dxs[:, 8 * nx : 8 * nx + cd])
            for part in parts:  # node order within the chunk
                dcond = dcond + part
    grads = {"x": g, "cond": dcond if cd else None}

    # the weight kernel: tiles of up to 128 x 264, each summed over split-row chunks
    plain, split_b = ("bf16", "bf16_b3") if bf16 else ("tf32x3", "tf32x3")
    n_w, n_tot = W.size, W.size + bias.size
    splits = -(-B // rows_per_split)
    partial = np.full((splits, n_tot), np.nan, np.float32)
    entries = []  # each tile's gradient entries: its weights, then (a row-0 tile) its biases
    for li, u, layer, m0, n0 in bwd.tiles:
        (n, h, rows, o, node0, _, *offs), wl, _ = level(li)
        off, split, out = nodes[node0 + (u if u < n else u - n)][:3]
        in_max = rows - cd
        M, N = (rows, h, h)[layer], (h, h, o)[layer]
        if layer == 0:
            act = np.zeros((B, rows), np.float32)
            act[:, :split] = q(region(li, 0)[:, off : off + split])
            if cd:
                act[:, in_max:] = q(cond)
        else:
            act = region(li, 3 + layer)[:, u]
        if layer == 2:
            dpre = np.zeros((B, o), np.float32)
            dpre[:, :out] = region(li, 2 if u < n else 3)[:, off + split : off + split + out]
        else:
            dpre = region(li, 6 + layer)[:, u]
        m1, n1 = min(M, m0 + hac_fused._GRAD_ROWS), min(N, n0 + hac_fused._GRAD_COLS)
        w_at = offs[layer] + u * M * N + (np.arange(m0, m1)[:, None] * N + np.arange(n0, n1)).ravel()
        b_at = n_w + offs[3 + layer] + u * N + np.arange(n0, n1) if m0 == 0 else np.zeros(0, np.int64)
        entries.append((w_at, b_at))
        for k in range(splits):
            r0, r1 = k * rows_per_split, min(B, (k + 1) * rows_per_split)
            blk = _product(act[r0:r1, m0:m1].T, dpre[r0:r1, n0:n1], split_b if layer == 2 else plain)
            wofs = offs[layer] + u * M * N
            view = partial[k, wofs : wofs + M * N].reshape(M, N)
            view[m0:m1, n0:n1] = blk
            if m0 == 0:
                bofs = n_w + offs[3 + layer] + u * N
                partial[k, bofs + n0 : bofs + n1] = dpre[r0:r1, n0:n1].sum(0)
    # each tile's last chunk to finish: the chunks' sums of the tile's entries
    # in chunk order from 0, weights rounded to bf16 once, biases not
    total = np.full(n_tot, np.nan, np.float32)
    for w_at, b_at in entries:
        for at, rounded in ((w_at, bf16), (b_at, False)):
            acc = np.zeros(at.size, np.float32)
            for k in range(splits):
                acc = acc + partial[k, at]
            total[at] = _bf16(acc) if rounded else acc
    names = [f"L{li}.{k}" for li in range(n_levels) for k in hac.level_params(li)]
    for name, (o0, shape) in zip(names, bwd.leaves):
        grads[name] = total[o0 : o0 + int(np.prod(shape))].reshape(shape)
    return grads, partial, gw


def _emulate(hac, x, cond, rev, g_y, g_ld):
    """The saving forward, then the backward kernels over its saved buffer."""
    _, _, saved = emulate_saving_forward(hac, x, cond, rev)
    return emulate_backward(hac, saved, cond, rev, g_y, g_ld)


def _regions(hac, buf, B, ks):
    """The regions ``ks`` of every level of a workspace buffer (``workspace_region``)."""
    bwd = hac_fused._packed(hac, torch.device("cpu")).bwd
    return [hac_fused.workspace_region(hac, bwd, B, torch.from_numpy(buf), li, k).numpy()
            for li in range(len(hac.levels)) for k in ks]


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
    got, partial, gw = _emulate(thac, x, c, rev, r, q)
    assert partial.shape[0] == 3 and not np.isnan(partial).any()  # every entry of every split written
    assert not any(np.isnan(a).any() for a in _regions(thac, gw, BATCH, (2, 3, 6, 7)))  # the data kernel writes them all
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
    got, _, _ = _emulate(thac, x, c, rev, r, q)

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
    """The workspace table's header and records (csrc/hac_common.cuh, read by
    the forward kernel where it saves and by the backward kernels), the data
    kernel's tensor-core records, hidden-buffer pad and tile height, the
    weight tiles' records, rows and columns are written once in CUDA and
    once in hac_fused.py; the table of levels and nodes is the forward's;
    the build hashes all three files. The data kernel's tile is the
    forward tensor-core route's (``TTB``)."""
    k = _constants(hac_fused.SOURCES[1])
    common = _constants(hac_fused.HEADERS[0])
    assert (k["BREC"], k["BPAD"], k["TREC"], k["GTM"], k["GTN"]) == (
        hac_fused._BREC, hac_fused._BPAD, hac_fused._TREC, hac_fused._GRAD_ROWS, hac_fused._GRAD_COLS)
    assert (common["WHDR"], common["WREC"], common["TTB"]) == (hac_fused._WHDR, hac_fused._WREC, hac_fused._TC_ROWS)
    assert (common["HDR"], common["LREC"], common["NREC"]) == (hac_fused._HDR, hac_fused._LREC, hac_fused._NREC)
    assert all('#include "hac_common.cuh"' in p.read_text() for p in hac_fused.SOURCES)
    # the profile build's phases name the data kernel's BPROF_* counters in their order
    text = hac_fused.SOURCES[1].read_text()
    enum = [e.strip() for e in text[text.index("enum { BPROF_") :].split("}")[0][len("enum {") :].split(",")]
    assert enum == [f"BPROF_{p.upper()}" for p in hac_fused.BWD_PROFILE_PHASES] + ["BPROF_N"]
    # the condition's two parts (gradient, a chunk's per-node gradients), padded to 4 floats
    assert hac_fused._bwd_smem_bytes(100, 544, 4, 9, 400) - hac_fused._bwd_smem_bytes(100, 544, 0, 9, 400) == 4 * 32 * 4 * 10
    assert hac_fused._bwd_smem_bytes(100, 544, 5, 9, 400) == hac_fused._bwd_smem_bytes(100, 544, 8, 9, 400)
    # the flagship block fits one tile in shared memory, and so does the campaign's widest (h = 358)
    for c_internal, max_splits in (((263, 131, 65, 32, 32), -1), ((358, 179), 1)):
        for cdt in ("float32", "bfloat16"):
            thac = THAC(dim=100, c_internal=c_internal, max_splits=max_splits, compute_dtype=cdt, impl="fused")
            pk = hac_fused._packed(thac, torch.device("cpu"))
            assert hac_fused._bwd_smem_bytes(100, pk.bwd.width, 0, pk.bwd.npc_max,
                                             pk.meta.numel() + pk.bwd.wmeta.size) <= hac_fused._SMEM_MAX


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
    """Workspace regions are disjoint, 4-float aligned and fill the row of
    their buffer (saved: x, S, a1, a2 of every level and the output;
    gradient: dS, dT, dpre1, dpre2); the weight tiles write every gradient
    entry exactly once."""
    thac = _block(dim, cond_dim)
    bwd = hac_fused._packed(thac, torch.device("cpu")).bwd
    wm = bwd.wmeta
    regions = {"saved": [(int(wm[0]), dim)], "grad": []}
    for li, lv in enumerate(thac.levels):
        rec = wm[hac_fused._WHDR + hac_fused._WREC * li :][: hac_fused._WREC]
        uw = 2 * len(lv.nodes) * lv.hidden
        for k in range(8):
            regions["saved" if k in (0, 1, 4, 5) else "grad"].append((int(rec[k]), dim if k < 4 else uw))
    for buf, floats in (("saved", bwd.saved_floats), ("grad", bwd.grad_floats)):
        used = np.zeros(floats, int)
        for off, width in regions[buf]:
            assert off % 4 == 0
            used[off : off + width] += 1
        assert used.max() == 1 and floats == sum(hac_fused._pad4(w) for _, w in regions[buf])
    assert (int(wm[1]), int(wm[2])) == (bwd.saved_floats, bwd.grad_floats)
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


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root as a module (it imports only the
    standard library at the top)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()


@functools.lru_cache(maxsize=None)
def _smoke_block(kind):
    dim, c_internal, cond_dim = CHIP_SMOKE.BLOCKS[kind]
    thac = THAC(dim=dim, c_internal=c_internal, cond_dim=cond_dim, impl="fused",
                max_splits=CHIP_SMOKE.MAX_SPLITS.get(kind, -1))
    return thac, hac_fused._packed(thac, torch.device("cpu"))


@pytest.mark.parametrize("batch", [37, 1660, 4096, 10_000])
@pytest.mark.parametrize("kind", list(CHIP_SMOKE.BLOCKS))
def test_weight_kernel_writes_every_gradient_entry_once(kind, batch):
    """The weight kernel's epilogue by its own index arithmetic (the level
    records' offsets, a tile's rows and columns, the row-0 tiles' biases),
    for the blocks ``chip_smoke.py`` runs: each tile's last row chunk writes
    the tile's entries, and across the tiles every entry of the packed
    weights | biases gradient is written exactly once, weights below
    ``n_w`` and biases from it; every chunk's partials sit at the same
    places, so the tiles' last chunks read apart. The chunks cover the
    batch (the last one ragged), one for every ``_GRAD_MIN_ROWS`` rows at
    most."""
    thac, pk = _smoke_block(kind)
    meta, tiles = pk.meta.numpy(), pk.bwd.tiles
    n_w, n_tot = pk.weights.numel(), pk.weights.numel() + pk.biases.numel()
    rows = hac_fused._weight_rows(batch, len(tiles))
    chunks = -(-batch // rows)
    assert (chunks - 1) * rows < batch <= chunks * rows
    assert chunks <= -(-batch // hac_fused._GRAD_MIN_ROWS)
    written = np.zeros(n_tot, np.int64)
    for li, u, layer, m0, n0 in tiles:
        lv = meta[hac_fused._HDR + li * hac_fused._LREC :][: hac_fused._LREC]
        h, in_rows, out_max = int(lv[1]), int(lv[2]), int(lv[3])
        M, N = (in_rows, h, h)[layer], (h, h, out_max)[layer]
        mt, ntc = min(hac_fused._GRAD_ROWS, M - m0), min(hac_fused._GRAD_COLS, N - n0)
        assert mt > 0 and ntc > 0
        w_at = int(lv[6 + layer]) + u * M * N + (m0 + np.arange(mt))[:, None] * N + n0 + np.arange(ntc)
        assert w_at.min() >= 0 and w_at.max() < n_w
        np.add.at(written, w_at.ravel(), 1)
        if m0 == 0:
            b_at = n_w + int(lv[9 + layer]) + u * N + n0 + np.arange(ntc)
            assert b_at.min() >= n_w and b_at.max() < n_tot
            np.add.at(written, b_at, 1)
    assert (written == 1).all()


def test_backward_cpu_path_is_the_plain_version():
    """On the CPU _FusedBlock's backward is plain_block_grad: the same bits
    as autograd through plain_block; off the CPU it launches or raises; a
    reshuffle block never reaches it."""
    thac = _block(11, 3)
    x, c, r, q = (torch.from_numpy(a) for a in _inputs(11, 3, 5))
    xg, cg = x.clone().requires_grad_(), c.clone().requires_grad_()
    before = instrument.get("hac.bwd_launches")
    y, ld = hac_fused.fused_block(thac, xg, cg)
    got = torch.autograd.grad((y * r).sum() + (ld * q).sum(), [xg, cg, *thac.parameters()])
    xp, cp = x.clone().requires_grad_(), c.clone().requires_grad_()
    y, ld = hac_fused.plain_block(thac, xp, cp, False)
    ref = torch.autograd.grad((y * r).sum() + (ld * q).sum(), [xp, cp, *thac.parameters()])
    assert instrument.get("hac.bwd_launches") == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    needs = (True, True) + (True,) * len(list(thac.parameters()))
    meta = (torch.zeros(2, 11, device="meta"), torch.zeros(2, 3, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        hac_fused._run_block_grad(thac, *meta, False, torch.zeros(2, 11, device="meta"),
                                  torch.zeros(2, device="meta"), needs)
    # a reshuffle block's gradient is autograd through the levelwise engine on every device
    shuffled = THAC(dim=8, c_internal=(8,), reshuffle=True, impl="fused").to("meta")
    xm = torch.zeros(2, 8, device="meta", requires_grad=True)
    before = tuple(map(instrument.get, ("hac.launches", "hac.bwd_launches", "hac.reshuffle_levelwise")))
    y, ld = hac_fused.fused_block(shuffled, xm)
    got = torch.autograd.grad(y.sum() + ld.sum(), [xm, *shuffled.parameters()])
    assert tuple(map(instrument.get, ("hac.launches", "hac.bwd_launches", "hac.reshuffle_levelwise"))) == (
        before[0], before[1], before[2] + 1)
    assert type(y.grad_fn).__name__ != "_FusedBlockBackward"
    assert [tuple(t.shape) for t in got] == [(2, 8), *(tuple(p.shape) for p in shuffled.parameters())]


def test_transposes_are_built_for_the_backward_only():
    """The forward's pack holds no backward layout; the backward's is every
    unit's w2^T and w1^T and every node's w0^T of its two units stacked
    along K, padded in mma-fragment order with the weights at their real
    entries (w0's x rows up to the node's split, then its condition rows
    from in_max) and exact zeros at every pad, though the parameters'
    padding holds noise; in f32 as TF32 high and low parts; built once per
    parameter version."""
    from test_torch_port_hac import _tf32_rna

    for cdt in ("float32", "bfloat16"):
        thac = _block(11, 3, cdt)
        pk = hac_fused._packed(thac, torch.device("cpu"))
        assert "_kernel_pack_bwd" not in thac.__dict__
        wb = hac_fused._bwd_weights(thac, pk)
        assert hac_fused._bwd_weights(thac, pk) is wb
        ks, frag = hac_fused._TC_KS[cdt], hac_fused._TC_FRAG[cdt]
        L = len(thac.levels)
        for li, lv in enumerate(thac.levels):
            p = {k: v.detach().float().numpy() for k, v in thac.level_params(li).items()}
            at = hac_fused._WHDR + hac_fused._WREC * L + hac_fused._BREC * li
            k3, kh, nh, nx, ncd, _, o2, o1, o0 = (int(v) for v in pk.bwd.wmeta[at : at + hac_fused._BREC])
            n, h, hs = len(lv.nodes), lv.hidden, nh * 8
            refs = []
            for u in range(2 * n):
                nd = lv.nodes[u % n]
                ref2 = np.zeros((k3 * ks, hs), np.float32)
                ref2[: nd.dim - nd.split, :h] = p["w2"][u, :, : nd.dim - nd.split].T
                ref1 = np.zeros((kh * ks, hs), np.float32)
                ref1[:h, :h] = p["w1"][u].T
                refs += [(o2 + u * k3 * nh * frag, k3, nh, ref2), (o1 + u * kh * nh * frag, kh, nh, ref1)]
            for i, nd in enumerate(lv.nodes):
                ref0 = np.zeros((2 * hs, (nx + ncd) * 8), np.float32)
                for which, u in enumerate((i, n + i)):
                    ref0[which * hs : which * hs + h, : nd.split] = p["w0"][u, : nd.split].T
                    ref0[which * hs : which * hs + h, 8 * nx : 8 * nx + 3] = p["w0"][u, lv.in_max :].T
                refs.append((o0 + i * 2 * kh * (nx + ncd) * frag, 2 * kh, nx + ncd, ref0))
            for base, kk, nn, ref in refs:
                got = _layout(wb, cdt, base, kk, nn)
                if cdt == "float32":  # TF32 high and low parts (rounded half away from zero)
                    np.testing.assert_array_equal(got[0], _tf32_rna(ref))
                    np.testing.assert_array_equal(got[1], _tf32_rna(ref - _tf32_rna(ref)))
                else:  # the packed weights are the parameters cast to bf16
                    np.testing.assert_array_equal(got[0], _bf16(ref))
        stored = 2 if cdt == "float32" else 1  # f32: TF32 high and low parts
        assert wb.dtype == pk.weights.dtype and wb.numel() == stored * pk.bwd.index.size
        with torch.no_grad():
            thac.L0["w1"].mul_(2.0)
        assert hac_fused._bwd_weights(thac, hac_fused._packed(thac, torch.device("cpu"))) is not wb


def test_saved_regions_equal_the_plain_versions_activations():
    """A saving forward's regions (the emulation of the route that saves,
    with its saves: the loop in f32, the wgmma route in bf16; both passes)
    against the plain version's per-level activations: each level's input
    and S, a1 and a2 of every unit (the levelwise engine's ReLU outputs,
    units in the packed order), the block's output; f32 1e-5, bf16 1e-2 of
    1 + the region's max |ref|."""
    for cdt in ("float32", "bfloat16"):
        thac = _block(20, 3, cdt, seed=20)
        x, c, _, _ = _inputs(20, 3, 20)
        bwd = hac_fused._packed(thac, torch.device("cpu")).bwd
        for rev in (False, True):
            y, _, saved = emulate_saving_forward(thac, x, c, rev)
            ref = _plain_activations(thac, x, c, rev)
            assert len(ref) == 4 * len(thac.levels) + 1
            for key, want in ref.items():
                li, k = (None, 0) if key == "y" else key
                got = hac_fused.workspace_region(thac, bwd, BATCH, torch.from_numpy(saved), li, k).numpy()
                _close(got, want, TOL[cdt], f"{cdt} rev={rev} region {key}")
            assert np.array_equal(hac_fused.workspace_region(thac, bwd, BATCH, torch.from_numpy(saved), None).numpy(), y)


def _plain_activations(thac, x, c, rev):
    """The plain version's saved quantities: per level (li, 0) its input,
    (li, 1) S, (li, 4) and (li, 5) a1 and a2 (B, 2 n, h), and "y", by one
    no-grad pass of the levelwise engine with its ReLUs and its per-level
    couplings recorded."""
    seen, relu = [], torch.relu
    inputs, scales = [], []
    level_st = thac._level_st

    def recording_relu(t):
        seen.append(relu(t))
        return seen[-1]

    def recording_level(li, xx, *a, **k):
        inputs.append((li, xx.detach().clone()))
        s, t = level_st(li, xx, *a, **k)
        scales.append((li, thac._scatter_lower(li, s)))
        return s, t

    torch.relu, thac._level_st = recording_relu, recording_level
    try:
        with torch.no_grad():
            y, _ = hac_fused.plain_block(thac, torch.from_numpy(x), None if c is None else torch.from_numpy(c), rev)
    finally:
        torch.relu = relu
        del thac._level_st
    out = {"y": y.numpy()}
    for k, (li, xx) in enumerate(inputs):
        out[(li, 0)], out[(li, 1)] = xx.numpy(), scales[k][1].numpy()
        a1, a2 = seen[2 * k : 2 * k + 2]  # (2, n, B, h) in pass order
        out[(li, 4)], out[(li, 5)] = (a.flatten(0, 1).transpose(0, 1).numpy() for a in (a1, a2))
    return out


def test_no_grad_calls_allocate_no_saved_buffer(monkeypatch):
    """Serving, sampling and evaluation under ``no_grad`` call the kernel
    without a saved buffer, and so does a call that needs no gradient; only
    ``_FusedBlock`` asks for one, and on the card only (the CPU's backward
    recomputes from the input)."""
    thac = _block(11, 3)
    x, c = (torch.from_numpy(a) for a in _inputs(11, 3, 6)[:2])
    calls = []
    monkeypatch.setattr(hac_fused, "saved_buffer", lambda *a: calls.append(a) or None)
    with torch.no_grad():
        hac_fused.fused_block(thac.requires_grad_(True), x, c)
    hac_fused.fused_block(thac.requires_grad_(False), x, c)
    assert calls == []
    thac.requires_grad_(True)
    y, _ = hac_fused.fused_block(thac, x, c)
    assert type(y.grad_fn).__name__ == "_FusedBlockBackward" and calls == []  # CPU: saves its input
    with pytest.raises(ValueError, match="saving forward runs on the card"):
        hac_fused._run_block(thac, x, c, False, saved=torch.zeros(1))


@pytest.mark.parametrize("cond_dim", [0, 3], ids=["hint", "cond3"])
def test_remat_checkpoints_fused_blocks_with_the_same_gradients(cond_dim):
    """``Flow(remat=True)`` checkpoints a fused block like every other
    bijector (the block no longer recomputes itself in its backward): under
    ``impl="fused"`` on the CPU its gradients equal ``remat=False``'s bit for
    bit."""
    from hint_tpu_torch.models.flow import Flow, with_remat
    from hint_tpu_torch.ops.householder import HouseholderPerm

    x, c = (torch.from_numpy(a) for a in _inputs(11, 3, 9)[:2])
    grads = {}
    for remat in (False, True):
        blocks = [_block(11, cond_dim, seed=30), HouseholderPerm(11), _block(11, cond_dim, seed=31)]
        blocks[1].init(torch.Generator().manual_seed(32))
        flow = Flow(blocks, dim=11, cond_dim=cond_dim)
        if remat:
            flow = with_remat(flow)
        z, ld = flow(x, c if cond_dim else None)
        (0.5 * (z**2).sum(1).mean() - ld.mean()).backward()
        grads[remat] = [p.grad.clone() for p in flow.parameters()]
    assert len(grads[True]) == len(grads[False]) > 0
    assert all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))
