"""Port HAC block vs the JAX package.

Params are made by the JAX package (``init``, then garbage written into the
padded rows/columns that a trainer's re-init fills), converted through
``params_from_numpy`` and fed to both packages. The port's levelwise engine
(the kernel's plain version) is held to ``hint_tpu``'s levelwise engine, its
``impl="fused"`` CPU path to ``hint_tpu``'s Pallas kernel in interpret mode,
and a numpy emulation of the CUDA kernel's loop over the packed weights to
the plain version, each with and without a condition (``cond_dim=3``: the
condition rows of ``w0`` start at ``in_max``, with noise in the rows
``[split, in_max)`` before them). The gradient of ``impl="fused"`` (``_FusedBlock``) is held
to autograd through the plain version exactly and to ``jax.grad`` through
``hint_tpu``'s ``fused_block`` at 1e-5. The kernel itself runs only on a card.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu.ops.hac import HierarchicalAffineCoupling as JHAC
from hint_tpu.ops.pallas_block import _run_fused
from hint_tpu.ops.pallas_block import fused_block as jax_fused_block
from hint_tpu_torch.convert import load_params, params_from_numpy
from hint_tpu_torch.ops import hac_fused
from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling as THAC
from hint_tpu_torch.utils import instrument
from test_torch_port_backward import _bf16, _tf32

TOL = 1e-5


def _garbage_padding(jhac, params, seed):
    """Non-zero noise in every padded entry of the level stacks."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.array, params)
    for li, lv in enumerate(jhac.levels):
        p, n = params[f"L{li}"], len(lv.nodes)
        for u in range(2 * n):
            nd = lv.nodes[u % n]
            out_i = nd.dim - nd.split
            for key, idx in (
                ("w0", (u, slice(nd.split, lv.in_max))),
                ("w2", (u, slice(None), slice(out_i, None))),
                ("b2", (u, slice(out_i, None))),
            ):
                p[key][idx] = rng.normal(size=p[key][idx].shape)
    return params


@functools.lru_cache(maxsize=None)
def _jax_params(dim, seed, kw_items):
    """JAX HAC and its init params with garbage padding (cached: JAX's
    eager init dominates these tests' time)."""
    jhac = JHAC(dim=dim, **dict(kw_items))
    return jhac, _garbage_padding(jhac, jhac.init(jax.random.PRNGKey(seed)), seed)


def _pair(dim, seed=0, **kw):
    """(JAX HAC, its params with garbage padding, port HAC holding the same)."""
    jkw = {k: v for k, v in kw.items() if k != "impl"}
    jhac, params = _jax_params(dim, seed, tuple(sorted(jkw.items())))
    if "impl" in kw:
        jhac = dataclasses.replace(jhac, impl=kw["impl"])
    thac = THAC(dim=dim, **kw)
    thac.load_state_dict(params_from_numpy(params))  # strict: same keys and shapes
    return jhac, params, thac


def _port_with_garbage(dim, seed, **kw):
    """Port HAC from its own init, with noise in every padded entry."""
    thac = THAC(dim=dim, **kw)
    thac.init(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for li, lv in enumerate(thac.levels):
            p, n = thac.level_params(li), len(lv.nodes)
            for u in range(2 * n):
                nd = lv.nodes[u % n]
                out_i = nd.dim - nd.split
                for t in (p["w0"][u, nd.split : lv.in_max], p["w2"][u, :, out_i:], p["b2"][u, out_i:]):
                    t.copy_(torch.randn(t.shape, generator=g))
    return thac


def _x(b, d, seed):
    return np.random.default_rng(100 + seed).normal(size=(b, d)).astype(np.float32)


CASES = [
    dict(dim=7, c_internal=(16, 8)),
    dict(dim=11, c_internal=(16, 8)),
    dict(dim=20, c_internal=(16, 8)),
    dict(dim=20, c_internal=(16, 8), max_splits=2),
    dict(dim=100, c_internal=(16, 8)),
    dict(dim=12, c_internal=(16, 8), reshuffle=True),
]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_tree_metadata_matches_jax(kw):
    jhac, thac = JHAC(**kw), THAC(**kw)
    assert len(jhac.levels) == len(thac.levels)
    for jl, tl in zip(jhac.levels, thac.levels):
        assert (jl.in_max, jl.out_max, jl.dim_max, jl.hidden) == (tl.in_max, tl.out_max, tl.dim_max, tl.hidden)
        np.testing.assert_array_equal(jl.out_mask, tl.out_mask)
        assert [(n.offset, n.split, n.dim, n.index, n.leaf) for n in jl.nodes] == [
            (n.offset, n.split, n.dim, n.index, n.leaf) for n in tl.nodes
        ]
    assert thac.n_params == jhac.n_params


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_levelwise_matches_jax(kw):
    jhac, params, thac = _pair(seed=1, **kw)
    x = _x(37, kw["dim"], 1)
    jp = jax.tree.map(jnp.asarray, params)
    for jf, tf in ((jhac.forward, thac.forward), (jhac.inverse, thac.inverse)):
        yj, ldj = jax.jit(jf)(jp, jnp.asarray(x))
        with torch.no_grad():
            yt, ldt = tf(torch.from_numpy(x))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=TOL, atol=TOL)


def test_conditional_levelwise_matches_jax():
    """Condition rows of w0 start at in_max, not at split (hac.py:181-186)."""
    kw = dict(c_internal=(16, 8), cond_dim=3)
    jhac, params, thac = _pair(8, seed=7, **kw)
    x, c = _x(6, 8, 7), _x(6, 3, 8)
    jp = jax.tree.map(jnp.asarray, params)
    ref = THAC(dim=8, impl="reference", **kw)
    ref.load_state_dict(thac.state_dict())
    for jf, tf, rf in ((jhac.forward, thac.forward, ref.forward), (jhac.inverse, thac.inverse, ref.inverse)):
        yj, ldj = jax.jit(jf)(jp, jnp.asarray(x), jnp.asarray(c))
        with torch.no_grad():
            for yt, ldt in (tf(torch.from_numpy(x), torch.from_numpy(c)), rf(torch.from_numpy(x), torch.from_numpy(c))):
                np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL, atol=TOL)
                np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=TOL, atol=TOL)


BF16_TOL = 2e-2


@pytest.mark.parametrize("kw", [CASES[1], CASES[4], dict(CASES[1], cond_dim=3)], ids=["d11", "d100", "d11-cond3"])
def test_bf16_levelwise_matches_jax(kw):
    """compute_dtype="bfloat16": forward, inverse and log-det of the port's
    levelwise engine against hint_tpu's, the weights carried across by
    ``load_params``, within 2e-2 of 1+|ref| (the couplings' bf16 bound):
    both round the same layer inputs and weights to bf16 and sum in f32, but
    in other orders, so an activation on a rounding boundary can land one
    bf16 ulp (2**-8) apart."""
    jkw = dict(kw, compute_dtype="bfloat16")
    jhac, params = _jax_params(kw["dim"], 10, tuple(sorted((k, v) for k, v in jkw.items() if k != "dim")))
    thac = THAC(**jkw)
    load_params(thac, params)
    cd = kw.get("cond_dim", 0)
    x, c = _x(37, kw["dim"], 10), (_x(37, cd, 11) if cd else None)
    jp = jax.tree.map(jnp.asarray, params)
    f32 = THAC(**kw)  # the same weights without the bf16 roundings
    load_params(f32, params)

    def err(got, ref):
        return float(np.max(np.abs(got - ref) / (1 + np.abs(ref))))

    ct = None if c is None else torch.from_numpy(c)
    for jf, tf, ff in ((jhac.forward, thac.forward, f32.forward), (jhac.inverse, thac.inverse, f32.inverse)):
        yj, ldj = jax.jit(jf)(jp, jnp.asarray(x), None if c is None else jnp.asarray(c))
        with torch.no_grad():
            yt, ldt = tf(torch.from_numpy(x), ct)
            yf, _ = ff(torch.from_numpy(x), ct)
        for got, ref in ((yt.numpy(), np.asarray(yj)), (ldt.numpy(), np.asarray(ldj))):
            assert np.isfinite(got).all() and err(got, ref) <= BF16_TOL, err(got, ref)
        # the roundings are taken: the port's bf16 lies nearer hint_tpu's bf16 than f32 does
        assert err(yt.numpy(), np.asarray(yj)) < 0.1 * err(yf.numpy(), np.asarray(yj))


@pytest.mark.parametrize("kw", [CASES[1], CASES[3], CASES[5]], ids=["d11", "d20-ms2", "d12-reshuffle"])
def test_reference_oracle_matches_levelwise(kw):
    _, _, thac = _pair(seed=2, **kw)
    ref = THAC(impl="reference", **kw)
    ref.load_state_dict(thac.state_dict())
    x = torch.from_numpy(_x(9, kw["dim"], 2))
    with torch.no_grad():
        for a, b in ((thac(x), ref(x)), (thac.inverse(x), ref.inverse(x))):
            np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=TOL, atol=TOL)
        y, ld = thac(x)
        x2, ld_inv = thac.inverse(y)
    np.testing.assert_allclose(x2.numpy(), x.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ld_inv.numpy(), -ld.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "dim,max_splits,rev,batch,tile_b,cond_dim",
    [(6, -1, False, 9, None, 0), (11, -1, False, 9, None, 0), (20, 2, False, 9, None, 0),
     (10, -1, True, 7, None, 0), (10, -1, False, 37, 16, 0),
     (11, -1, False, 9, None, 3), (10, -1, True, 7, None, 3), (20, 2, False, 37, 16, 3)],
    ids=["d6", "d11", "d20-ms2", "inverse", "ragged37-tile16",
         "d11-cond3", "inverse-cond3", "d20-ms2-ragged37-tile16-cond3"],
)
def test_fused_cpu_matches_pallas_interpret(dim, max_splits, rev, batch, tile_b, cond_dim):
    """The port's impl='fused' on a CPU tensor (its plain version) against
    the JAX package's Pallas kernel run in interpret mode, with and without
    a condition."""
    jhac, params, thac = _pair(
        dim, seed=3, c_internal=(16, 8), max_splits=max_splits, impl="fused", cond_dim=cond_dim)
    x = _x(batch, dim, 3)
    c = _x(batch, cond_dim, 13) if cond_dim else None
    yj, ldj = _run_fused(
        jhac, jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        None if c is None else jnp.asarray(c), rev=rev, tile_b=tile_b)
    before = instrument.get("hac.launches")
    with torch.no_grad():
        yt, ldt = (thac.inverse if rev else thac.forward)(
            torch.from_numpy(x), None if c is None else torch.from_numpy(c))
    assert instrument.get("hac.launches") == before  # CPU tensors never reach the kernel
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=TOL, atol=TOL)


def _kernel_constants():
    """The ``constexpr int`` constants of csrc/hac_block.cu and the header
    it shares with the backward kernel."""
    text = "".join(p.read_text() for p in (hac_fused.SOURCES[0], *hac_fused.HEADERS))
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _emulate_kernel(hac, x, cond, rev, record=None):
    """The CUDA kernel's loop in numpy, reading only what the kernel reads:
    the int32 metadata table, the flat packed weight/bias buffers and the
    condition rows. The shared-memory carve-up is walked as the kernel walks
    it and must end where ``_smem_bytes`` says. ``record`` (a dict) gets
    what a saving forward writes: per level its input, S, a1 and a2 (B, 2 n,
    h), and the block's output under "y"."""
    pk = hac_fused._packed(hac, torch.device("cpu"))
    meta, wts, bias = pk.meta.numpy(), pk.weights.float().numpy(), pk.biases.numpy()
    cond_dim = 0 if cond is None else cond.shape[1]
    tb, dp, cp = hac_fused._TILE_ROWS, hac_fused._pad4(x.shape[1]), hac_fused._pad4(cond_dim)
    carve = [tb * dp] * 3 + [tb * pk.width] * 2 + [tb, tb * cp]  # xs S T a1 a2 lds cnd
    assert all(part % 4 == 0 for part in carve)  # 16-byte loads of a1/a2 stay aligned
    assert 4 * (sum(carve) + meta.size) == hac_fused._smem_bytes(x.shape[1], pk.width, cond_dim, meta.size)
    n_levels = meta[0]
    nodes = meta[hac_fused._HDR + n_levels * hac_fused._LREC : int(meta[2])].reshape(-1, hac_fused._NREC)
    cs = np.float32(hac.clamp * hac_fused.ATAN_SCALE)
    q = (lambda a: torch.from_numpy(a).bfloat16().float().numpy()) if hac.compute_dtype == "bfloat16" else (lambda a: a)
    xs, ld = x.copy(), np.zeros(x.shape[0], np.float32)
    for step in range(n_levels):
        li = step if rev else n_levels - 1 - step
        rec = meta[hac_fused._HDR + li * hac_fused._LREC :][: hac_fused._LREC]
        n, h, rows, o, node0, upc, w0, w1, w2, b0, b1, b2 = (int(v) for v in rec)
        in_max = rows - cond_dim
        assert upc * hac_fused._pad4(h) <= pk.width
        S, T = np.zeros_like(xs), np.zeros_like(xs)
        acts = np.zeros((2, x.shape[0], 2 * n, h), np.float32)
        for u0 in range(0, 2 * n, upc):
            for u in range(u0, min(u0 + upc, 2 * n)):
                off, split, out = nodes[node0 + (u if u < n else u - n)][:3]
                wu0 = wts[w0 + u * rows * h :][: rows * h].reshape(rows, h)
                wu1 = wts[w1 + u * h * h :][: h * h].reshape(h, h)
                wu2 = wts[w2 + u * h * o :][: h * o].reshape(h, o)[:, :out]
                pre = q(xs[:, off : off + split]) @ wu0[:split] + bias[b0 + u * h :][:h]
                if cond_dim:  # condition rows start at in_max; [split, in_max) stays unread
                    pre = pre + q(cond) @ wu0[in_max : in_max + cond_dim]
                a1 = q(np.maximum(pre, 0))
                a2 = q(np.maximum(a1 @ wu1 + bias[b1 + u * h :][:h], 0))
                acts[0, :, u], acts[1, :, u] = a1, a2
                dst = T if u >= n else S
                dst[:, off + split : off + split + out] = a2 @ wu2 + bias[b2 + u * o :][:out]
        if record is not None:
            record[li] = {"x": xs.copy(), "S": S.copy(), "a1": acts[0], "a2": acts[1]}
        le = cs * np.arctan(S)
        xs = (xs - T) / np.exp(le) if rev else np.exp(le) * xs + T
        ld += -le.sum(1) if rev else le.sum(1)
    if record is not None:
        record["y"] = xs.copy()
    return xs, ld


COND_CASES = [dict(CASES[1], cond_dim=3), dict(CASES[4], cond_dim=4)]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [CASES[1], CASES[3], CASES[4], *COND_CASES],
                         ids=["d11", "d20-ms2", "d100", "d11-cond3", "d100-cond4"])
def test_kernel_loop_emulation_matches_plain(kw, compute_dtype):
    """Offsets, chunking and padding-skipping of the kernel's packed view,
    checked on the CPU against the plain version. bf16 rounds the same
    values at the same points, but the f32 sums run in another order, so an
    activation on a rounding boundary can land one bf16 ulp (2**-8) apart
    and move an output by ~1e-3 relative: 1e-2 there, 1e-5 in f32."""
    thac = _port_with_garbage(seed=4, compute_dtype=compute_dtype, **kw)
    x = _x(21, kw["dim"], 4)
    c = _x(21, kw["cond_dim"], 14) if kw.get("cond_dim") else None
    tol = TOL if compute_dtype == "float32" else 1e-2
    for rev in (False, True):
        ye, lde = _emulate_kernel(thac, x, c, rev)
        with torch.no_grad():
            yp, ldp = hac_fused.plain_block(
                thac, torch.from_numpy(x), None if c is None else torch.from_numpy(c), rev)
        np.testing.assert_allclose(ye, yp.numpy(), rtol=tol, atol=tol)
        np.testing.assert_allclose(lde, ldp.numpy(), rtol=tol, atol=tol)


def _emulate_tiled_kernel(hac, x, cond, rev, record=None, sms=hac_fused._SMS):
    """The tiled route's walk in numpy (csrc/hac_block.cu,
    ``hac_block_save_kernel``), reading only what the kernel reads: its table
    (from meta[3] on), its padded weights (``_tl_packed``) as the producer's
    bulk copies land them in a ring stage (each unit's slab, 16-byte aligned,
    at the unit's region of the stage), the biases and the condition rows. Each chunk's layers 1 and 2 take one pass
    of the consumers, a quad of one unit's columns a thread, which must
    cover every column once; layer 3's items (2 rows by a quad of a unit's
    ``out_i`` columns) must cover every output once; the carve-up of a
    tile's shared memory must end where ``_tl_smem_bytes`` says. Every
    weight a thread reads comes from the stage, and the products are
    ``_emulate_kernel``'s, so a weight read from the wrong place shows as a
    difference from the loop's emulation. Returns what ``_emulate_kernel``
    returns; ``record`` gets the same. ``sms``: the SMs the tile rule fills
    (fewer take 16-row tiles at smaller batches)."""
    pk = hac_fused._packed(hac, torch.device("cpu"))
    meta, bias = pk.meta.numpy(), pk.biases.numpy()
    wts = hac_fused._tl_packed(hac, pk).numpy()  # the route's padded weights
    B, d = x.shape
    cd = 0 if cond is None else cond.shape[1]
    n_levels = int(meta[0])
    rt = meta[int(meta[3]) :]
    slots, wa, stage = (int(v) for v in rt[:3])
    tls = rt[hac_fused._TL_HDR :].reshape(-1, hac_fused._TL_LREC)
    assert len(tls) == n_levels
    rows, stages, threads, smem = hac_fused._tl_launch(B, d, cd, meta.size, hac.__dict__["_kernel_struct"][1].tl, sms)
    groups, nc = rows // hac_fused._TL_ROWS, threads - 32
    dp, cp, astr = hac_fused._pad4(d), hac_fused._pad4(cd), hac_fused._tl_astride(wa)
    carve = [stages * stage] + [rows * dp] * 3 + [rows * astr] * 2 + [rows * dp, rows * cp, rows]  # ring xs S T a1 a2 xt ct lds
    assert all(part % 4 == 0 for part in carve) and hac_fused._TL_BARS % 16 == 0  # 16-byte copies and loads
    assert hac_fused._TL_BARS + 4 * (sum(carve) + meta.size) == smem <= hac_fused._SMEM_MAX
    assert nc % 32 == 0 and nc >= slots * groups and threads <= hac_fused._TL_THREADS
    nodes = meta[hac_fused._HDR + n_levels * hac_fused._LREC : int(meta[2])].reshape(-1, hac_fused._NREC)
    cs = np.float32(hac.clamp * hac_fused.ATAN_SCALE)

    def staged(base, n_rows, ncols, u0, nu):
        """Each unit's matrix (n_rows x ncols) of a chunk's layer, read back
        from the stages the producer filled, slab by slab."""
        uf, ks = hac_fused._tl_slab(n_rows, ncols, nu, stage)
        assert nu * uf <= stage and uf % 4 == 0 and (ks == n_rows or (ks >= hac_fused._TL_KS and ks % 4 == 0))
        mats = np.full((nu, n_rows, ncols), np.nan, np.float32)
        for k0 in range(0, n_rows, ks):
            kn = min(ks, n_rows - k0)
            ring = np.full(stage, np.nan, np.float32)
            for ul in range(nu):
                gs = base + (u0 + ul) * n_rows * ncols + k0 * ncols
                assert gs % 4 == 0 and kn * ncols <= uf and gs + kn * ncols <= wts.size  # 16-byte copies, in bounds
                ring[ul * uf : ul * uf + kn * ncols] = wts[gs : gs + kn * ncols]
            for ul in range(nu):
                mats[ul, k0 : k0 + kn] = ring[ul * uf : ul * uf + kn * ncols].reshape(kn, ncols)
        return mats

    xs, ld = x.copy(), np.zeros(B, np.float32)
    for step in range(n_levels):
        li = step if rev else n_levels - 1 - step
        rec = meta[hac_fused._HDR + li * hac_fused._LREC :][: hac_fused._LREC]
        n, h, in_rows, o, node0, _, _, _, _, b0, b1, b2 = (int(v) for v in rec)
        upc, w0, w1, w2 = (int(v) for v in tls[li])
        in_max, hp = in_rows - cd, hac_fused._pad4(h)
        qu, q3 = hp // 4, hac_fused._pad4(o) // 4
        assert upc * qu <= slots and upc * hp <= wa
        S, T = np.zeros_like(xs), np.zeros_like(xs)
        acts = np.zeros((2, B, 2 * n, h), np.float32)
        for u0 in range(0, 2 * n, upc):
            nu = min(upc, 2 * n - u0)
            # layers 1 and 2: thread (warp, lane) holds quad warp * (32 / groups) + lane % (32 / groups)
            qw = 32 // groups
            quads = [w * qw + lane % qw for w in range(nc // 32) for lane in range(32) if lane // qw == 0]
            cover = np.zeros((nu, hp), int)
            for q in quads:
                if q // qu < nu:
                    cover[q // qu, 4 * (q % qu) : 4 * (q % qu) + 4] += 1
            assert (cover[:, :h] == 1).all()
            # layer 3: items of 2 rows (r3 + rows / 2 i) by a quad of a unit's columns, in rounds
            nr3 = rows // hac_fused._TL_ROWS3
            items = nr3 * nu * q3
            hits = np.zeros((rows, nu, 4 * q3), int)
            for it in range(-(-items // nc) * nc):
                if it < items:
                    r3, g3 = it % nr3, it // nr3
                    for i in range(hac_fused._TL_ROWS3):
                        hits[r3 + nr3 * i, g3 // q3, 4 * (g3 % q3) : 4 * (g3 % q3) + 4] += 1
            assert (hits[:, :, :o] == 1).all()
            op = hac_fused._pad4(o)
            m0, m1, m2 = (staged(w0, in_rows, hp, u0, nu)[:, :, :h], staged(w1, h, hp, u0, nu)[:, :, :h],
                          staged(w2, h, op, u0, nu)[:, :, :o])
            for ul in range(nu):
                u = u0 + ul
                off, split, out = nodes[node0 + (u if u < n else u - n)][:3]
                pre = xs[:, off : off + split] @ m0[ul, :split] + bias[b0 + u * h :][:h]
                if cd:  # condition rows start at in_max; [split, in_max) stays unread
                    pre = pre + cond @ m0[ul, in_max : in_max + cd]
                a1 = np.maximum(pre, 0)
                a2 = np.maximum(a1 @ m1[ul] + bias[b1 + u * h :][:h], 0)
                acts[0, :, u], acts[1, :, u] = a1, a2
                dst = T if u >= n else S
                dst[:, off + split : off + split + out] = a2 @ m2[ul, :, :out] + bias[b2 + u * o :][:out]
        if record is not None:
            record[li] = {"x": xs.copy(), "S": S.copy(), "a1": acts[0], "a2": acts[1]}
        le = cs * np.arctan(S)
        xs = (xs - T) / np.exp(le) if rev else np.exp(le) * xs + T
        ld += -le.sum(1) if rev else le.sum(1)
    if record is not None:
        record["y"] = xs.copy()
    return xs, ld


@pytest.mark.parametrize("batch,sms", [(21, hac_fused._SMS), (300, 16)], ids=["8-row", "16-row"])
@pytest.mark.parametrize("kw", [CASES[1], CASES[3], CASES[4], *COND_CASES, dict(dim=42, c_internal=(102, 51, 25, 12))],
                         ids=["d11", "d20-ms2", "d100", "d11-cond3", "d100-cond4", "d42-miniboone"])
def test_tiled_emulation_is_the_loops(kw, batch, sms):
    """The tiled route's walk (``_emulate_tiled_kernel``: its table, the
    weights as its bulk copies stage them, its threads' quads and layer-3
    items, its shared memory; 8- and 16-row tiles) gives the loop's
    emulation exactly, y, the log-det and every saved region, forward and
    inverse, with noise in every padded weight; both within 1e-5 of the
    plain version."""
    thac = _port_with_garbage(seed=4, compute_dtype="float32", **kw)
    hac_fused._structure(thac, torch.device("cpu"))
    x = _x(batch, kw["dim"], 4)
    c = _x(batch, kw["cond_dim"], 14) if kw.get("cond_dim") else None
    for rev in (False, True):
        rec_t, rec_l = {}, {}
        yt, ldt = _emulate_tiled_kernel(thac, x, c, rev, record=rec_t, sms=sms)
        yl, ldl = _emulate_kernel(thac, x, c, rev, record=rec_l)
        assert np.array_equal(yt, yl) and np.array_equal(ldt, ldl)
        assert rec_t.keys() == rec_l.keys()
        for k in rec_l:
            for name in ("x", "S", "a1", "a2") if k != "y" else ():
                assert np.array_equal(rec_t[k][name], rec_l[k][name]), (k, name)
        assert np.array_equal(rec_t["y"], rec_l["y"])
        with torch.no_grad():
            yp, ldp = hac_fused.plain_block(thac, torch.from_numpy(x), None if c is None else torch.from_numpy(c), rev)
        np.testing.assert_allclose(yt, yp.numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ldt, ldp.numpy(), rtol=TOL, atol=TOL)


# the training blocks the tiled route's rule is held to: (dim, c_internal,
# cond_dim, training batch, quad slots, rows of a tile at that batch)
TILED_BLOCKS = {
    "conditional": (100, (267, 133, 66), 4, 10_000, 136, 16),
    "flagship": (100, (263, 131, 65, 32, 32), 0, 10_000, 136, 16),
    "power": (6, (200, 100, 50, 25), 0, 1660, 100, 8),
    "gas": (8, (184, 92, 46, 23), 0, 853, 96, 8),
    "miniboone": (42, (102, 51, 25, 12), 0, 300, 26, 8),
}


@pytest.mark.parametrize("kind", list(TILED_BLOCKS))
def test_tiled_route_plan_fits_the_card_and_fills_its_waves(kind):
    """f32 saves by the tiled route, bf16 by the wgmma route; serving is
    unchanged. The tiled route's rule on a training block: the quad slots
    hold the widest unit and cost no more thread time than any other count
    (the condition-fed and flagship blocks: one pass of their two level-0
    units, every other level's chunks full but for each unit's pad to a
    quad); the tile's shared memory (the sum ``tl_smem_bytes`` and the
    emulation's carve-up agree on) fits in 227 KB with three slabs in
    flight and at most 576 threads; at batch 10,000 the 625 tiles of 16
    rows leave no mostly empty last wave on 132 SMs (4.7 waves; the loop's
    16-row tiles two an SM: 2.4), and at the UCI batches 8-row tiles give
    more tiles (more SMs busy) than 16-row ones would."""
    assert hac_fused._SAVE_ROUTE == {"float32": hac_fused.ROUTE_TILED, "bfloat16": hac_fused.ROUTE_WG}
    assert hac_fused._FWD_ROUTE == {"float32": hac_fused.ROUTE_TC, "bfloat16": hac_fused.ROUTE_LOOP}
    dim, c_internal, cond_dim, batch, slots, rows = TILED_BLOCKS[kind]
    thac = THAC(dim=dim, c_internal=c_internal, cond_dim=cond_dim, impl="fused")
    st = hac_fused._structure(thac, torch.device("cpu"))
    tl, meta_len = st.tl, st.meta.numel()
    assert tl.slots == slots and int(st.meta[3]) + tl.table.size == meta_len
    quads = [hac_fused._pad4(lv.hidden) // 4 for lv in thac.levels]
    upc = [int(u) for u in tl.table[hac_fused._TL_HDR :: hac_fused._TL_LREC]]
    assert max(quads) <= slots and all(u * q <= slots for u, q in zip(upc, quads))
    if kind in ("conditional", "flagship"):
        assert upc[:2] == [2, 4] and tl.width == 544
    got = hac_fused._tl_launch(batch, dim, cond_dim, meta_len, tl)
    assert got is not None
    r, stages, threads, smem = got
    assert (r, stages) == (rows, 3) and smem <= hac_fused._SMEM_MAX == 232_448 and threads <= hac_fused._TL_THREADS
    tiles = -(-batch // r)
    waves = tiles / hac_fused._SMS
    if batch >= 10_000:
        assert tiles == 625 and waves % 1 >= 0.5  # 4.73 waves
        loop_waves = -(-batch // hac_fused._TILE_ROWS) / (2 * hac_fused._SMS)
        assert round(loop_waves, 2) == 2.37
    else:
        assert -(-batch // 16) < hac_fused._SMS and tiles > -(-batch // 16)
    # the shared-memory sum counts every part: a row more, a stage more, a wider chunk
    base = hac_fused._tl_smem_bytes(dim, cond_dim, r, tl.width, tl.stage, stages, meta_len)
    assert base == smem
    assert hac_fused._tl_smem_bytes(dim, cond_dim, r + 1, tl.width, tl.stage, stages, meta_len) - base == 4 * (
        4 * hac_fused._pad4(dim) + 2 * hac_fused._tl_astride(tl.width) + hac_fused._pad4(cond_dim) + 1)
    assert hac_fused._tl_smem_bytes(dim, cond_dim, r, tl.width, tl.stage, stages + 1, meta_len) - base == 4 * tl.stage
    # a bf16 block has no tiled table
    bst = hac_fused._structure(THAC(dim=dim, c_internal=c_internal, cond_dim=cond_dim, impl="fused",
                                    compute_dtype="bfloat16"), torch.device("cpu"))
    assert bst.tl is None and int(bst.meta[3]) == 0


def test_tiled_route_rows_follow_the_batch():
    """16-row tiles from the batch at which they give every SM one (132 x
    16 rows), 8-row tiles below; a block too wide for 16-row tiles takes 8."""
    thac = THAC(dim=100, c_internal=(267, 133, 66), cond_dim=4, impl="fused")
    st = hac_fused._structure(thac, torch.device("cpu"))
    rows = {b: hac_fused._tl_launch(b, 100, 4, st.meta.numel(), st.tl)[0] for b in (1, 37, 2096, 2097, 2112, 2113)}
    assert rows == {1: 8, 37: 8, 2096: 8, 2097: 16, 2112: 16, 2113: 16}
    assert hac_fused._tl_launch(10_000, 100, 4, st.meta.numel(), st.tl, sms=700)[0] == 8
    wide = st.tl._replace(stage=40_000)  # a ring stage of 160 KB: one 8-row tile with one slab in flight
    assert hac_fused._tl_launch(10_000, 100, 4, st.meta.numel(), wide)[:2] == (8, 1)
    assert hac_fused._tl_launch(10_000, 100, 4, st.meta.numel(), st.tl._replace(stage=60_000)) is None


def _tc_unit(buf, cdt, start, k_steps, n_tiles):
    """One unit's K x N matrix read back from a tensor-core layout (``buf``:
    the forward's ``_tc_packed`` weights or the backward's ``_bwd_weights``) as the
    kernels' lanes read it: fragment (k-step, n8 tile) after fragment,
    k-step major; lane = 4 g + t holds TF32's rows t, t + 4 of column g (the
    high parts, then the low parts: two matrices), or bf16's rows 2t, 2t + 1,
    2t + 8, 2t + 9 (one matrix)."""
    ks, frag = hac_fused._TC_KS[cdt], hac_fused._TC_FRAG[cdt]
    flat = buf.float().numpy()[start : start + k_steps * n_tiles * frag]
    tile, within = np.divmod(np.arange(flat.size), frag)
    kt, nt = np.divmod(tile, n_tiles)
    lane, j = np.divmod(within, frag // 32)
    g, t = np.divmod(lane, 4)
    if cdt == "float32":
        part, j = np.divmod(j, 2)
        k = t + 4 * j
    else:
        part, k = np.zeros_like(j), 2 * t + (j & 1) + 8 * (j >> 1)
    out = np.full((part.max() + 1, k_steps * ks, n_tiles * 8), np.nan, np.float32)
    out[part, kt * ks + k, nt * 8 + g] = flat
    assert not np.isnan(out).any()
    return list(out)


def _tf32_rna(a):
    """f32 -> TF32, rounded half away from zero (the wrapper's split of the weights)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tc_levels(pk):
    meta = pk.meta.numpy()
    return meta[int(meta[2]) : int(meta[3]) or None].reshape(-1, hac_fused._TLREC)  # the tiled route's table follows


def _tc_product(a, w, cdt):
    """a @ w as the tensor-core route sums it, ``w`` as ``_tc_unit`` reads
    it, each k-step's products summed from zero and added to the running f32
    sum: f32 by 3xTF32 from the stored high and low parts; bf16 products of
    bf16 values."""
    f = lambda u, v: u.astype(np.float64) @ v.astype(np.float64)  # noqa: E731
    if cdt == "bfloat16":
        (w,) = w
        assert np.array_equal(_bf16(a), a) and np.array_equal(_bf16(w), w)
        acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
        for k0 in range(0, a.shape[1], 16):
            acc = acc + f(a[:, k0 : k0 + 16], w[k0 : k0 + 16]).astype(np.float32)
        return acc
    wh, wl = w
    ah = _tf32(a)
    al = _tf32(a - ah)
    acc = np.zeros((a.shape[0], wh.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        acc = acc + (f(al[:, k], wh[k]) + f(ah[:, k], wl[k]) + f(ah[:, k], wh[k])).astype(np.float32)
    return acc


def _emulate_tc_kernel(hac, x, cond, rev):
    """The 3xTF32 route's loop in numpy (f32 blocks), reading only what it
    reads: the metadata table with its tensor-core records, the padded
    weights as the lanes read them (``_tc_unit``), the f32 biases and the
    condition rows. The shared-memory carve-up must end where
    ``_tc_smem_bytes`` says, and a chunk must fit the hidden buffers."""
    pk = hac_fused._packed(hac, torch.device("cpu"))
    tp = hac_fused._tc_packed(hac, pk)
    cdt = hac.compute_dtype
    assert cdt == "float32"
    meta, bias = pk.meta.numpy(), pk.biases.numpy()
    cond_dim = 0 if cond is None else cond.shape[1]
    tb, dp, cp = hac_fused._TC_ROWS, hac_fused._pad4(x.shape[1]), hac_fused._pad4(cond_dim)
    carve = 4 * (3 * tb * dp + tb + tb * cp) + 4 * 2 * tb * (tp.width + hac_fused._TC_PAD)
    assert carve + 4 * meta.size == hac_fused._tc_smem_bytes(x.shape[1], tp.width, cond_dim, meta.size)
    ks = hac_fused._TC_KS[cdt]
    n_levels = int(meta[0])
    nodes = meta[hac_fused._HDR + n_levels * hac_fused._LREC : int(meta[2])].reshape(-1, hac_fused._NREC)
    cs = np.float32(hac.clamp * hac_fused.ATAN_SCALE)
    xs, ld = x.copy(), np.zeros(x.shape[0], np.float32)
    for step in range(n_levels):
        li = step if rev else n_levels - 1 - step
        n, h, _, o, node0, _, _, _, _, b0, b1, b2 = (int(v) for v in meta[hac_fused._HDR + li * hac_fused._LREC :][: hac_fused._LREC])
        kh, k1, nh, n3, upc, w0, w1, w2 = (int(v) for v in _tc_levels(pk)[li])
        hs = nh * 8
        assert hs == kh * ks and upc * hs <= tp.width
        S, T = np.zeros_like(xs), np.zeros_like(xs)
        for u in range(2 * n):  # chunks only group units; each unit's sums are its own
            off, split, out = (int(v) for v in nodes[node0 + (u if u < n else u - n)][:3])
            kx = -(-split // ks) * ks  # layer 1 reads x from its node's offset on, then the condition
            a0 = np.zeros((x.shape[0], kx + -(-cond_dim // ks) * ks), np.float32)  # zeros past split, cond_dim
            a0[:, :split] = xs[:, off : off + split]
            if cond_dim:
                a0[:, kx : kx + cond_dim] = cond
            m0 = [m[: a0.shape[1]] for m in _tc_unit(tp.weights, cdt, w0 + u * k1 * nh * hac_fused._TC_FRAG[cdt], k1, nh)]
            pre = np.zeros((x.shape[0], hs), np.float32)
            pre[:, :h] = _tc_product(a0, m0, cdt)[:, :h] + bias[b0 + u * h :][:h]
            a1 = np.maximum(pre, 0)
            m1 = _tc_unit(tp.weights, cdt, w1 + u * kh * nh * hac_fused._TC_FRAG[cdt], kh, nh)
            pre = np.zeros((x.shape[0], hs), np.float32)
            pre[:, :h] = _tc_product(a1, m1, cdt)[:, :h] + bias[b1 + u * h :][:h]
            a2 = np.maximum(pre, 0)
            m2 = _tc_unit(tp.weights, cdt, w2 + u * kh * n3 * hac_fused._TC_FRAG[cdt], kh, n3)
            dst = T if u >= n else S
            dst[:, off + split : off + split + out] = _tc_product(a2, m2, cdt)[:, :out] + bias[b2 + u * o :][:out]
        le = cs * np.arctan(S)
        xs = (xs - T) / np.exp(le) if rev else np.exp(le) * xs + T
        ld += -le.sum(1) if rev else le.sum(1)
    return xs, ld


def _wg_walk(layer, u0, nu, n, kh, n3, w):
    """The items of a chunk's layer that warpgroup ``w`` of the wgmma route
    takes, as the kernel's ``wg_items`` deals them: (unit in chunk, first
    column, columns). Layers 1-2: every unit's 32-column groups of its hs =
    16 kh columns, in turn to each of the k warpgroups; layer 3: group grp
    of a unit of node i to warpgroup (i + grp) % k."""
    k = hac_fused._WG_GROUPS
    if layer < 2:
        groups = [(ul, c0) for ul in range(nu) for c0 in range(0, 16 * kh, 32)]
        return [(ul, c0, min(32, 16 * kh - c0)) for ul, c0 in groups[w::k]]
    return [(ul, c0, min(32, 8 * n3 - c0)) for ul in range(nu) for c0 in range(0, 8 * n3, 32)
            if ((u0 + ul) % n + c0 // 32) % k == w]


def _wg_slices(hac):
    """Every weight slice of the wgmma route as its warpgroups' producers
    copy them, read back from ``_tc_packed``'s bf16 weights at the table's
    stream offsets: {(level, unit, layer, first column): (columns x K)
    matrix}, each slice in core-matrix order (8 x 8 blocks, K within 8
    rows). Returns them, the route's width and the table."""
    pk = hac_fused._packed(hac, torch.device("cpu"))
    tp = hac_fused._tc_packed(hac, pk)
    meta = pk.meta.numpy()
    table = meta[int(meta[2]) :].reshape(-1, hac_fused._WLREC)
    wts = tp.weights.float()
    slices = {}
    for li, lv in enumerate(hac.levels):
        n = len(lv.nodes)
        kh, k1x, kc, n3, upc, *streams = (int(v) for v in table[li][: 5 + hac_fused._WG_GROUPS])
        for w in range(hac_fused._WG_GROUPS):
            at = streams[w]
            for u0 in range(0, 2 * n, upc):
                for layer in range(3):
                    k = 16 * (k1x + kc) if layer == 0 else 16 * kh
                    for ul, c0, cols in _wg_walk(layer, u0, min(upc, 2 * n - u0), n, kh, n3, w):
                        blk = wts[at : at + cols * k].view(cols // 8, k // 8, 8, 8)
                        slices[(li, u0 + ul, layer, c0)] = blk.permute(0, 2, 1, 3).reshape(cols, k)
                        at += cols * k
    return slices, tp.width, table


def _wg_product(a, b):
    """a @ b.T as the wgmma route sums it, a and b bf16 values: each k-step's
    16 products summed from zero, then added to the f32 sum."""
    a64, b64 = a.double(), b.double()
    acc = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], 16):
        acc = acc + (a64[:, k0 : k0 + 16] @ b64[:, k0 : k0 + 16].T).float()
    return acc


def _emulate_wg_kernel(hac, x, cond, rev, record=None):
    """The wgmma route in torch (bf16 blocks), reading only what it reads:
    the metadata table with its wgmma records, the weight slices as its
    producers copy them (``_wg_slices``), the f32 biases and the condition
    rows. 64-row tiles (the last padded with zero rows), each level's units
    in chunks of the table's units, each chunk's layers as the warpgroups'
    items of up to 32 columns, operands rounded to bf16, k16 steps summed as
    the kernel sums them (``_wg_product``); layer 3 writes S, and the t-unit's items (after the s-unit's,
    by the same warpgroup) couple. The shared-memory carve-up must end where
    ``_wg_smem_bytes`` says. ``record`` (a dict) gets what a saving forward
    writes, keyed as ``_emulate_kernel``'s."""
    slices, width, table = _wg_slices(hac)
    pk = hac_fused._packed(hac, torch.device("cpu"))
    meta, bias = pk.meta.numpy(), torch.from_numpy(pk.biases.numpy())
    B, d = x.shape
    cd = 0 if cond is None else cond.shape[1]
    dp, cp = hac_fused._pad4(d), hac_fused._pad4(cd)
    for stages in (1, 2, 3):
        k = hac_fused._WG_GROUPS  # consumer warpgroups, each with its stages and its log-det row
        carve = 256 + k * stages * 64 * width + 4 * (64 * (2 * dp + cp + k) + 3 * width) + 4 * 64 * width
        assert carve + 4 * meta.size == hac_fused._wg_smem_bytes(d, width, cd, meta.size, stages)
    rows = -(-B // 64) * 64  # whole 64-row tiles
    xs = torch.zeros(rows, d)
    xs[:B] = torch.from_numpy(x)
    cnd = torch.zeros(rows, cd)
    if cd:
        cnd[:B] = torch.from_numpy(cond)
    q = lambda t: t.bfloat16().float()  # noqa: E731
    ld = torch.zeros(rows)
    cs = torch.tensor(hac.clamp * hac_fused.ATAN_SCALE, dtype=torch.float32)
    n_levels = int(meta[0])
    nodes = meta[hac_fused._HDR + n_levels * hac_fused._LREC : int(meta[2])].reshape(-1, hac_fused._NREC)
    for step in range(n_levels):
        li = step if rev else n_levels - 1 - step
        n, h, _, o, node0, _, _, _, _, b0, b1, b2 = (int(v) for v in meta[hac_fused._HDR + li * hac_fused._LREC :][: hac_fused._LREC])
        kh, k1x, kc, n3, upc = (int(v) for v in table[li][:5])
        hs = 16 * kh
        assert upc * hs <= width and upc * 16 * (k1x + kc) <= width and upc * o <= width  # a1, a2, inputs, b2
        S = torch.zeros(rows, d)
        acts = torch.zeros(2, rows, 2 * n, h)
        if record is not None:
            record[li] = {"x": xs[:B].numpy().copy()}
        for u0 in range(0, 2 * n, upc):
            nu = min(upc, 2 * n - u0)
            a1, a2 = torch.zeros(rows, width), torch.zeros(rows, width)
            for layer in range(3):
                for w in range(hac_fused._WG_GROUPS):
                    for ul, c0, cols in _wg_walk(layer, u0, nu, n, kh, n3, w):
                        u = u0 + ul
                        off, split, out = (int(v) for v in nodes[node0 + u % n][:3])
                        if layer == 0:  # x's split columns, zeros to 16 k1x, the condition, zeros
                            a = torch.zeros(rows, 16 * (k1x + kc))
                            a[:, :split] = q(xs[:, off : off + split])
                            a[:, 16 * k1x : 16 * k1x + cd] = q(cnd)
                        else:
                            a = (a1 if layer == 1 else a2)[:, ul * hs : (ul + 1) * hs]
                        p = _wg_product(a, slices[(li, u, layer, c0)])
                        c = torch.arange(c0, c0 + cols)
                        if layer < 2:
                            real = c < h
                            pre = p + torch.where(real, bias[[b0, b1][layer] + u * h + c.clamp(max=h - 1)], 0.0)
                            v = q(torch.where(real, pre.clamp(min=0), 0.0))
                            (a1 if layer == 0 else a2)[:, ul * hs + c] = v
                            acts[layer, :, u, c[real]] = v[:, real]
                        else:
                            real = c < out
                            col = off + split + c[real]
                            v = p[:, real] + bias[b2 + u * o + c[real]]
                            if u < n:
                                S[:, col] = v
                            else:
                                le = cs * torch.atan(S[:, col])
                                xs[:, col] = (xs[:, col] - v) / torch.exp(le) if rev else torch.exp(le) * xs[:, col] + v
                                ld += -le.sum(1) if rev else le.sum(1)
        if record is not None:
            record[li].update(S=S[:B].numpy().copy(), a1=acts[0, :B].numpy().copy(), a2=acts[1, :B].numpy().copy())
    if record is not None:
        record["y"] = xs[:B].numpy().copy()
    return xs[:B].numpy(), ld[:B].numpy()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [CASES[1], CASES[3], CASES[4], *COND_CASES],
                         ids=["d11", "d20-ms2", "d100", "d11-cond3", "d100-cond4"])
def test_tc_kernel_emulation_matches_plain(kw, compute_dtype):
    """The dtype's tensor-core route against the plain version, at the
    cases and tolerances of ``test_kernel_loop_emulation_matches_plain``:
    in f32 the 3xTF32 route (padded fragment layout, per-k-step 3xTF32
    sums), in bf16 the wgmma route (its slices, 64-row tiles, bf16 operands,
    per-k-step sums)."""
    thac = _port_with_garbage(seed=4, compute_dtype=compute_dtype, **kw)
    x = _x(21, kw["dim"], 4)
    c = _x(21, kw["cond_dim"], 14) if kw.get("cond_dim") else None
    tol = TOL if compute_dtype == "float32" else 1e-2
    emulate = _emulate_tc_kernel if compute_dtype == "float32" else _emulate_wg_kernel
    for rev in (False, True):
        ye, lde = emulate(thac, x, c, rev)
        with torch.no_grad():
            yp, ldp = hac_fused.plain_block(
                thac, torch.from_numpy(x), None if c is None else torch.from_numpy(c), rev)
        np.testing.assert_allclose(ye, yp.numpy(), rtol=tol, atol=tol)
        np.testing.assert_allclose(lde, ldp.numpy(), rtol=tol, atol=tol)


# bf16 blocks for the wgmma route against hint_tpu: a unit wider than 256
# (h = 263: nine items of a layer, three warpgroup items of 32 columns each
# and more), a condition-fed block and a two-level cut tree
WG_CASES = [dict(dim=11, c_internal=(263, 8)), dict(dim=11, c_internal=(16, 8), cond_dim=3),
            dict(dim=20, c_internal=(16, 8), max_splits=2)]
WG_IDS = ["d11-h263", "d11-cond3", "d20-ms2"]


@pytest.mark.parametrize("kw", WG_CASES[:2], ids=WG_IDS[:2])
def test_wg_emulation_matches_plain_and_jax(kw):
    """The wgmma route's emulation (its slices, 64-row tiles with a ragged
    second one, bf16 operands, k16 steps in the order it takes) against the
    plain version, hint_tpu's bf16 levelwise engine and its Pallas kernel in
    interpret mode, on the same numpy-seeded weights carried across by
    ``load_params``, forward and inverse: y and the log-det within 2e-2 of
    1+|ref| (the couplings' bf16 bound: an activation on a rounding boundary
    can land one bf16 ulp apart), and nearer hint_tpu's bf16 than the f32
    plain version of the same weights is. (On the cut tree of WG_CASES[2]
    hint_tpu's own Pallas kernel and levelwise engine are 1.98e-2 apart on
    the inverse's log-det at these weights, so that case is held to the
    plain version only, below.)"""
    jkw = dict(kw, compute_dtype="bfloat16")
    jhac, params = _jax_params(kw["dim"], 12, tuple(sorted((k, v) for k, v in jkw.items() if k != "dim")))
    thac = THAC(**jkw)
    load_params(thac, params)
    f32 = THAC(**kw)
    load_params(f32, params)
    cd = kw.get("cond_dim", 0)
    x, c = _x(70, kw["dim"], 12), (_x(70, cd, 13) if cd else None)
    jp, jc = jax.tree.map(jnp.asarray, params), None if c is None else jnp.asarray(c)
    ct = None if c is None else torch.from_numpy(c)

    def err(got, ref):
        return float(np.max(np.abs(got - np.asarray(ref)) / (1 + np.abs(np.asarray(ref)))))

    for rev in (False, True):
        ye, lde = _emulate_wg_kernel(thac, x, c, rev)
        with torch.no_grad():
            yp, ldp = hac_fused.plain_block(thac, torch.from_numpy(x), ct, rev)
            yf, _ = hac_fused.plain_block(f32, torch.from_numpy(x), ct, rev)
        yj, ldj = jax.jit(jhac.inverse if rev else jhac.forward)(jp, jnp.asarray(x), jc)
        yk, ldk = _run_fused(dataclasses.replace(jhac, impl="fused"), jp, jnp.asarray(x), jc, rev=rev)
        for ref_y, ref_ld in ((yp.numpy(), ldp.numpy()), (yj, ldj), (yk, ldk)):
            for got, ref in ((ye, ref_y), (lde, ref_ld)):
                assert np.isfinite(got).all() and err(got, ref) <= BF16_TOL, err(got, ref)
        assert err(ye, yj) < 0.1 * err(yf.numpy(), yj)  # the bf16 roundings are taken


@pytest.mark.parametrize("kw", WG_CASES, ids=WG_IDS)
def test_wg_emulation_matches_plain_with_noisy_padding(kw):
    """The wgmma route's emulation against the plain version at the bf16
    tolerance of ``test_kernel_loop_emulation_matches_plain`` (1e-2), with
    noise in every padded weight (the slices hold zeros there), forward and
    inverse, ragged 64-row tiles."""
    thac = _port_with_garbage(seed=5, compute_dtype="bfloat16", **kw)
    cd = kw.get("cond_dim", 0)
    x, c = _x(70, kw["dim"], 5), (_x(70, cd, 15) if cd else None)
    for rev in (False, True):
        ye, lde = _emulate_wg_kernel(thac, x, c, rev)
        with torch.no_grad():
            yp, ldp = hac_fused.plain_block(thac, torch.from_numpy(x), None if c is None else torch.from_numpy(c), rev)
        np.testing.assert_allclose(ye, yp.numpy(), rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(lde, ldp.numpy(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kw", WG_CASES, ids=WG_IDS)
def test_wg_saving_regions_equal_the_plain_versions_activations(kw):
    """The wgmma route's saving variant, emulated: what it writes to the
    saved buffer (each level's input and S, every unit's a1 and a2 as the
    bf16 values it made, widened; the output) against the bf16 plain
    version's activations within 1e-2 of 1 + the region's max |ref|, forward
    and inverse; y equal to the emulation's own output."""
    from test_torch_port_backward import _plain_activations

    thac = _port_with_garbage(seed=6, compute_dtype="bfloat16", **kw)
    cd = kw.get("cond_dim", 0)
    x, c = _x(70, kw["dim"], 6), (_x(70, cd, 16) if cd else None)
    names = {0: "x", 1: "S", 4: "a1", 5: "a2"}
    for rev in (False, True):
        record = {}
        y, _ = _emulate_wg_kernel(thac, x, c, rev, record=record)
        ref = _plain_activations(thac, x, c, rev)
        assert len(ref) == 4 * len(thac.levels) + 1 and np.array_equal(record["y"], y)
        for key, want in ref.items():
            got = record["y"] if key == "y" else record[key[0]][names[key[1]]]
            assert got.shape == want.shape, key
            assert float(np.max(np.abs(got - want)) / (1 + np.max(np.abs(want)))) <= 1e-2, key


def _unit_matrices(hac, li, u):
    """The real K x N matrices of unit ``u`` of level ``li`` as its layers
    multiply them, in the padding of the dtype's tensor-core route: layer
    1's rows are the node's split rows of w0, zeros to the x part's last
    k-step, then the condition rows from in_max; every pad zero."""
    cdt = hac.compute_dtype
    ks = hac_fused._TC_KS["float32"] if cdt == "float32" else hac_fused._WG_KS
    lv, cd = hac.levels[li], hac.cond_dim
    p = {k: v.detach().float().numpy() for k, v in hac.level_params(li).items()}
    nd, h = lv.nodes[u % len(lv.nodes)], lv.hidden
    out = nd.dim - nd.split
    hs, n3 = -(-h // ks) * ks, -(-lv.out_max // 8) * 8
    kx = -(-(nd.split if cdt == "float32" else lv.in_max) // ks) * ks  # the condition's first row
    ref0 = np.zeros((-(-lv.in_max // ks) * ks + -(-cd // ks) * ks, hs), np.float32)
    ref0[: nd.split, :h] = p["w0"][u, : nd.split]
    ref0[kx : kx + cd, :h] = p["w0"][u, lv.in_max :]
    ref1 = np.zeros((hs, hs), np.float32)
    ref1[:h, :h] = p["w1"][u]
    ref2 = np.zeros((hs, n3), np.float32)
    ref2[:h, :out] = p["w2"][u, :, :out]
    return ref0, ref1, ref2


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_tc_layout_holds_the_weights_and_zeros(compute_dtype):
    """Every unit's padded matrix in the dtype's tensor-core layout holds the
    packed weights at its real entries (layer 1: the node's split rows, then
    the condition rows from in_max) and exact zeros at every pad, though the
    parameters' padding holds noise: in f32 the 3xTF32 fragments (high and
    low parts), in bf16 the wgmma route's slices as its two warpgroups'
    producers copy them, each column of a unit's layer in exactly one slice.
    Built once per parameter version like the packed buffers, from one cached
    index."""
    thac = _port_with_garbage(20, seed=6, c_internal=(16, 8), max_splits=2, cond_dim=3,
                              compute_dtype=compute_dtype)
    pk = hac_fused._packed(thac, torch.device("cpu"))
    tp = hac_fused._tc_packed(thac, pk)
    route = hac_fused._FWD_ROUTE[compute_dtype] if compute_dtype == "float32" else hac_fused.ROUTE_WG
    if compute_dtype == "bfloat16":
        slices = _wg_slices(thac)[0]
    for li, lv in enumerate(thac.levels):
        for u in range(2 * len(lv.nodes)):
            refs = _unit_matrices(thac, li, u)
            if compute_dtype == "float32":
                kh, k1, nh, n3, _, w0, w1, w2 = (int(v) for v in _tc_levels(pk)[li])
                frag = hac_fused._TC_FRAG[compute_dtype]
                for base, kk, nn, ref in ((w0 + u * k1 * nh * frag, k1, nh, refs[0]),
                                          (w1 + u * kh * nh * frag, kh, nh, refs[1]),
                                          (w2 + u * kh * n3 * frag, kh, n3, refs[2])):
                    got = _tc_unit(tp.weights, compute_dtype, base, kk, nn)  # TF32 high, low (half away from 0)
                    np.testing.assert_array_equal(got[0], _tf32_rna(ref))
                    np.testing.assert_array_equal(got[1], _tf32_rna(ref - _tf32_rna(ref)))
            else:
                for layer, ref in enumerate(refs):
                    cols = sorted((c0, m) for (l2, u2, lay, c0), m in slices.items() if (l2, u2, lay) == (li, u, layer))
                    got = torch.cat([m for _, m in cols]).T.numpy()  # K x N
                    np.testing.assert_array_equal(got, _bf16(ref))
    index = thac._kernel_struct[1].index[route]
    assert hac_fused._tc_packed(thac, hac_fused._packed(thac, torch.device("cpu"))) is tp
    with torch.no_grad():
        thac.L0["w1"].mul_(2.0)
    again = hac_fused._tc_packed(thac, hac_fused._packed(thac, torch.device("cpu")))
    assert again is not tp and not torch.equal(again.weights, tp.weights)
    # the gather's index is built once per structure and dtype
    assert thac._kernel_struct[1].index[route] is index
    stored = 2 if compute_dtype == "float32" else 1  # f32: TF32 high and low parts
    assert again.weights.numel() == tp.weights.numel() == stored * thac._kernel_struct[1].tc.index.size


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_tc_layout_is_built_only_for_the_route_that_takes_it(compute_dtype):
    """The packed buffers hold the flat weights only, in every compute dtype;
    the layout of the dtype's tensor-core route (3xTF32 in f32, wgmma in
    bf16) is gathered from them on that route's first launch for a
    parameter version (``_tc_packed``) and cached beside it, so that a step
    whose kernels take the loop or the tiled route never builds it."""
    thac = _port_with_garbage(20, seed=7, c_internal=(16, 8), max_splits=2, compute_dtype=compute_dtype)
    pk = hac_fused._packed(thac, torch.device("cpu"))
    n_w = sum(p.numel() for k, p in thac.named_parameters() if k.split(".")[1][0] == "w")
    assert pk.weights.numel() == n_w and pk.weights.untyped_storage().nbytes() == n_w * pk.weights.element_size()
    assert "_kernel_pack_tc" not in thac.__dict__ and thac._kernel_struct[1].index == {}
    tp = hac_fused._tc_packed(thac, pk)
    assert set(thac._kernel_struct[1].index) == {hac_fused.ROUTE_TC if compute_dtype == "float32"
                                                 else hac_fused.ROUTE_WG}
    assert tp.weights.dtype == pk.weights.dtype
    assert hac_fused._tc_packed(thac, pk) is tp
    with torch.no_grad():
        thac.L0["w1"].mul_(2.0)
    pk2 = hac_fused._packed(thac, torch.device("cpu"))
    tp2 = hac_fused._tc_packed(thac, pk2)
    assert pk2 is not pk and tp2 is not tp and not torch.equal(tp2.weights, tp.weights)


def test_kernel_layout_constants_match_the_wrapper():
    """The int32 table's record sizes and the tile heights are written once
    in csrc/ and once in hac_fused.py; the shared-memory check
    counts the condition tile."""
    k = _kernel_constants()
    text = hac_fused.SOURCES[0].read_text()
    assert (k["HDR"], k["LREC"], k["NREC"], k["TLREC"], k["WLREC"], k["TB"]) == (
        hac_fused._HDR, hac_fused._LREC, hac_fused._NREC, hac_fused._TLREC, hac_fused._WLREC, hac_fused._TILE_ROWS)
    # the tensor-core routes' tiles, pads and slices, and the route each dtype takes
    assert (k["TTB"], k["TPAD_F32"]) == (hac_fused._TC_ROWS, hac_fused._TC_PAD)
    assert (k["WTB"], k["WNT"], k["WMAX_STAGES"], k["WBARS"], k["SMEM_MAX"]) == (
        hac_fused._WG_ROWS, hac_fused._WG_TILES, hac_fused._WG_MAX_STAGES, hac_fused._WG_BARS, hac_fused._SMEM_MAX)
    assert k["WGS"] == hac_fused._WG_GROUPS
    assert (k["ROUTE_LOOP"], k["ROUTE_TC"], k["ROUTE_WG"], k["ROUTE_TILED"]) == (
        hac_fused.ROUTE_LOOP, hac_fused.ROUTE_TC, hac_fused.ROUTE_WG, hac_fused.ROUTE_TILED)
    assert (k["ROUTE_F32"], k["ROUTE_BF16"]) == (hac_fused._FWD_ROUTE["float32"], hac_fused._FWD_ROUTE["bfloat16"])
    assert (k["SAVE_ROUTE_F32"], k["SAVE_ROUTE_BF16"]) == (
        hac_fused._SAVE_ROUTE["float32"], hac_fused._SAVE_ROUTE["bfloat16"])
    # 3xTF32 serves only; f32 saves by the loop's chains on the tiled route
    assert hac_fused._SAVE_ROUTE["float32"] == hac_fused.ROUTE_TILED
    assert (k["TL_RT"], k["TL_R3"], k["TL_KS"], k["TL_MAX_STAGES"], k["TL_THREADS"], k["TL_BARS"], k["TL_HDR"]) == (
        hac_fused._TL_ROWS, hac_fused._TL_ROWS3, hac_fused._TL_KS, hac_fused._TL_MAX_STAGES, hac_fused._TL_THREADS,
        hac_fused._TL_BARS, hac_fused._TL_HDR)
    assert k["TL_LREC"] == hac_fused._TL_LREC
    # the profile build's phases name the kernel's PROF_* counters in their order
    enum = [e.strip() for e in text[text.index("enum { PROF_") :].split("}")[0][len("enum {") :].split(",")]
    assert enum[-1] == "PROF_N" and dict(zip(hac_fused.PROFILE_PHASES, enum[:-1])) == {
        "load": "PROF_LOAD", "group_start": "PROF_GSTART", "products": "PROF_GROUP", "group_store": "PROF_EPI",
        "layer_wait": "PROF_WAIT", "couple": "PROF_COUPLE", "couple_wait": "PROF_COUPLE_WAIT", "store": "PROF_STORE",
    } and len(hac_fused.PROFILE_PHASES) == len(enum) - 1
    common = hac_fused.HEADERS[0].read_text()  # the product loop's traits, shared with the backward data kernel
    for cdt, bf in (("float32", "false"), ("bfloat16", "true")):
        body = common[common.index(f"template <> struct Tc<{bf}>") :][:400]
        assert f"KS = {hac_fused._TC_KS[cdt]};" in body and f"FRAG = {hac_fused._TC_FRAG[cdt]};" in body
    # conflict-free fragment loads: the row stride over the fragment's word step is odd
    for width in (hac_fused._TC_MIN_WIDTH, 512):
        assert (width + hac_fused._TC_PAD) // 4 % 2 == 1
    assert hac_fused._smem_bytes(100, 544, 4, 400) - hac_fused._smem_bytes(100, 544, 0, 400) == 4 * 16 * 4
    assert hac_fused._smem_bytes(100, 544, 5, 400) == hac_fused._smem_bytes(100, 544, 8, 400)
    wide = THAC(dim=8, c_internal=(8,), impl="fused", cond_dim=3500)  # the condition tile alone is too large
    with pytest.raises(ValueError, match="shared memory"):
        hac_fused._packed(wide, torch.device("cpu"))
    # the flagship block fits two slices a warpgroup, the widest block of the campaign one
    for c_internal, ms, stages in (((263, 131, 65, 32, 32), -1, 2), ((358, 179), 1, 1)):
        flag = THAC(dim=100, c_internal=c_internal, max_splits=ms, impl="fused", compute_dtype="bfloat16")
        st = hac_fused._structure(flag, torch.device("cpu"))
        assert hac_fused._wg_stages(100, st.tc.width, 0, st.meta.numel()) == stages


def test_packed_view_is_cached_per_parameter_version():
    thac = _port_with_garbage(11, seed=5, c_internal=(16, 8))
    a = hac_fused._packed(thac, torch.device("cpu"))
    assert hac_fused._packed(thac, torch.device("cpu")) is a
    with torch.no_grad():
        thac.L0["w1"].mul_(2.0)
    b = hac_fused._packed(thac, torch.device("cpu"))
    assert b is not a and not torch.equal(a.weights, b.weights)
    bf = THAC(dim=11, c_internal=(16, 8), compute_dtype="bfloat16")
    bf.load_state_dict(thac.state_dict())
    assert hac_fused._packed(bf, torch.device("cpu")).weights.dtype == torch.bfloat16


def test_fused_wrapper_refuses_what_the_kernel_lacks():
    """Off the CPU the wrapper launches or raises; it never falls back."""
    thac = THAC(dim=8, c_internal=(8,), impl="fused")
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        hac_fused.fused_block(thac, torch.zeros(2, 8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):  # under autograd too
        hac_fused.fused_block(thac, torch.zeros(2, 8, device="meta"))
    # a reshuffle block is not the kernel's: it runs the levelwise engine on
    # every device, as hint_tpu's fused_block does (pallas_block.py:361-362)
    shuffled = THAC(dim=8, c_internal=(8,), reshuffle=True, impl="fused").to("meta")
    before = (instrument.get("hac.launches"), instrument.get("hac.reshuffle_levelwise"))
    with torch.no_grad():
        y, ld = hac_fused.fused_block(shuffled, torch.zeros(2, 8, device="meta"))
    assert y.shape == (2, 8) and ld.shape == (2,) and y.device.type == "meta"
    assert (instrument.get("hac.launches"), instrument.get("hac.reshuffle_levelwise")) == (before[0], before[1] + 1)
    # neither is rematerialised by the block itself: Flow(remat=True) checkpoints both alike
    assert not hasattr(shuffled, "rematerializes") and not hasattr(thac, "rematerializes")


def test_fused_wrapper_demands_the_condition_the_block_declares():
    """A condition-fed block without a condition, or a condition for a block
    that takes none, raises on every device (the JAX package's ``_run_fused``
    silently takes ``cond_dim = 0`` for ``cond=None``); a condition of the
    wrong width or type raises before any launch."""
    cond = THAC(dim=8, c_internal=(8,), impl="fused", cond_dim=2)
    plain = THAC(dim=8, c_internal=(8,), impl="fused")
    for device in ("cpu", "meta"):
        x, c = torch.zeros(2, 8, device=device), torch.zeros(2, 2, device=device)
        with pytest.raises(ValueError, match="cond_dim=2 but the condition is missing"):
            hac_fused.fused_block(cond, x)
        with pytest.raises(ValueError, match="cond_dim=0 but the condition is given"):
            hac_fused.fused_block(plain, x, c)
    x = torch.zeros(2, 8, device="meta")
    for bad in (torch.zeros(2, 3, device="meta"), torch.zeros(3, 2, device="meta"),
                torch.zeros(2, 2, device="meta", dtype=torch.float64), torch.zeros(2, 2)):
        with torch.no_grad(), pytest.raises(ValueError, match="float32 condition"):
            hac_fused.fused_block(cond, x, bad)
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):  # launches or raises
        hac_fused.fused_block(cond, x, torch.zeros(2, 2, device="meta"))
    before = instrument.get("hac.launches")
    with torch.no_grad():  # on the CPU the plain version takes the condition
        y, ld = hac_fused.fused_block(cond, torch.zeros(2, 8), torch.zeros(2, 2))
    assert y.shape == (2, 8) and ld.shape == (2,) and instrument.get("hac.launches") == before


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("dim,cond_dim", [(7, 0), (20, 0), (11, 3)], ids=["7", "20", "11-cond3"])
def test_fused_block_gradients_match_plain_and_jax(dim, cond_dim, rev):
    """Gradients of sum(y*r) + sum(logdet*q) through ``_FusedBlock`` for x,
    the condition and every level parameter: equal to autograd through the
    plain version bit for bit (the backward runs the same code from the same
    x), and to jax.grad through hint_tpu's fused_block (Pallas kernel in
    interpret mode, levelwise VJP) within 1e-5."""
    jhac, params, thac = _pair(dim, seed=6, c_internal=(16, 8), impl="fused", cond_dim=cond_dim)
    plain = THAC(dim=dim, c_internal=(16, 8), cond_dim=cond_dim)
    plain.load_state_dict(thac.state_dict())
    rng = np.random.default_rng(dim)
    x, r = _x(9, dim, 6), rng.normal(size=(9, dim)).astype(np.float32)
    q = rng.normal(size=(9,)).astype(np.float32)
    c = _x(9, cond_dim, 16) if cond_dim else None

    def torch_grads(hac):
        xt = torch.from_numpy(x).requires_grad_()
        ct = None if c is None else torch.from_numpy(c).requires_grad_()
        y, ld = (hac.inverse if rev else hac.forward)(xt, ct)
        ((y * torch.from_numpy(r)).sum() + (ld * torch.from_numpy(q)).sum()).backward()
        grads = {"x": xt.grad, **{k: p.grad for k, p in hac.named_parameters()}}
        return y, grads if c is None else {**grads, "cond": ct.grad}

    y, fused = torch_grads(thac)
    assert type(y.grad_fn).__name__ == "_FusedBlockBackward"
    _, ref = torch_grads(plain)
    assert set(fused) == set(ref) == {"x", *thac.state_dict(), *(["cond"] if cond_dim else [])}
    for k in ref:
        assert torch.equal(fused[k], ref[k]), k

    def loss(p, xx, cc):
        yj, ldj = jax_fused_block(jhac, p, xx, cc, rev)
        return jnp.sum(yj * r) + jnp.sum(ldj * q)

    jc = None if c is None else jnp.asarray(c)
    if c is None:
        gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jc)
    else:
        gp, gx, gc = jax.grad(loss, argnums=(0, 1, 2))(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jc)
        assert bool(fused["cond"].abs().max() > 0)
        np.testing.assert_allclose(fused["cond"].numpy(), np.asarray(gc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(fused["x"].numpy(), np.asarray(gx), rtol=TOL, atol=TOL)
    for lk, level in gp.items():
        for k, g in level.items():
            np.testing.assert_allclose(fused[f"{lk}.{k}"].numpy(), np.asarray(g), rtol=TOL, atol=TOL, err_msg=f"{lk}.{k}")


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "inverse"])
def test_reshuffle_fused_block_matches_hint_tpu(rev):
    """A reshuffle block under impl="fused" (the levelwise engine, with its
    gradient by autograd, no kernel launch) against hint_tpu's fused_block,
    which sends such a block to its levelwise engine and differentiates it:
    outputs, and the gradients of sum(y*r) + sum(logdet*q) for x and every
    level parameter, within 1e-5."""
    jhac, params, thac = _pair(12, seed=9, c_internal=(16, 8), reshuffle=True, impl="fused")
    rng = np.random.default_rng(12)
    x, r = _x(9, 12, 9), rng.normal(size=(9, 12)).astype(np.float32)
    q = rng.normal(size=(9,)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    before = tuple(map(instrument.get, ("hac.launches", "hac.bwd_launches", "hac.reshuffle_levelwise")))
    y, ld = (thac.inverse if rev else thac.forward)(xt)
    ((y * torch.from_numpy(r)).sum() + (ld * torch.from_numpy(q)).sum()).backward()
    assert (instrument.get("hac.launches"), instrument.get("hac.bwd_launches")) == before[:2]
    assert instrument.get("hac.reshuffle_levelwise") == before[2] + 1
    assert y.grad_fn is not None and type(y.grad_fn).__name__ != "_FusedBlockBackward"

    def loss(p, xx):
        yj, ldj = jax_fused_block(jhac, p, xx, None, rev)
        return jnp.sum(yj * r) + jnp.sum(ldj * q), (yj, ldj)

    (_, (yj, ldj)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ldj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=TOL, atol=TOL)
    grads = dict(thac.named_parameters())
    assert grads
    for name, p in grads.items():
        lk, k = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[lk][k]), rtol=TOL, atol=TOL, err_msg=name)


def test_fused_block_takes_the_function_only_where_a_gradient_is_asked():
    thac = _port_with_garbage(11, seed=8, c_internal=(16, 8), impl="fused")
    x = torch.from_numpy(_x(5, 11, 8))
    with torch.no_grad():
        assert thac(x)[0].grad_fn is None
    assert type(thac(x)[0].grad_fn).__name__ == "_FusedBlockBackward"
    thac.requires_grad_(False)
    assert thac(x)[0].grad_fn is None  # serving: nothing requires a gradient
    xg = x.clone().requires_grad_()  # gradient for x alone
    (gx,) = torch.autograd.grad(thac(xg)[0].sum(), xg)
    assert gx.shape == x.shape and all(p.grad is None for p in thac.parameters())
