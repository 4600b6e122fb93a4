"""Port HAC block vs the JAX package.

Params are made by the JAX package (``init``, then garbage written into the
padded rows/columns that a trainer's re-init fills), converted through
``params_from_numpy`` and fed to both packages. The port's levelwise engine
(the kernel's plain version) is held to ``hint_tpu``'s levelwise engine, its
``impl="fused"`` CPU path to ``hint_tpu``'s Pallas kernel in interpret mode,
and a numpy emulation of the CUDA kernel's loop over the packed weights to
the plain version. The kernel itself runs only on a card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu.ops.hac import HierarchicalAffineCoupling as JHAC
from hint_tpu.ops.pallas_block import _run_fused
from hint_tpu_torch.convert import params_from_numpy
from hint_tpu_torch.ops import hac_fused
from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling as THAC

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
    "dim,max_splits,rev,batch,tile_b",
    [(6, -1, False, 9, None), (11, -1, False, 9, None), (20, 2, False, 9, None),
     (10, -1, True, 7, None), (10, -1, False, 37, 16)],
    ids=["d6", "d11", "d20-ms2", "inverse", "ragged37-tile16"],
)
def test_fused_cpu_matches_pallas_interpret(dim, max_splits, rev, batch, tile_b):
    """The port's impl='fused' on a CPU tensor (its plain version) against
    the JAX package's Pallas kernel run in interpret mode."""
    jhac, params, thac = _pair(dim, seed=3, c_internal=(16, 8), max_splits=max_splits, impl="fused")
    x = _x(batch, dim, 3)
    yj, ldj = _run_fused(jhac, jax.tree.map(jnp.asarray, params), jnp.asarray(x), None, rev=rev, tile_b=tile_b)
    before = hac_fused.launches
    with torch.no_grad():
        yt, ldt = (thac.inverse if rev else thac.forward)(torch.from_numpy(x))
    assert hac_fused.launches == before  # CPU tensors never reach the kernel
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=TOL, atol=TOL)


def _emulate_kernel(hac, x, rev):
    """The CUDA kernel's loop in numpy, reading only what the kernel reads:
    the int32 metadata table and the flat packed weight/bias buffers."""
    pk = hac_fused._packed(hac, torch.device("cpu"))
    meta, wts, bias = pk.meta.numpy(), pk.weights.float().numpy(), pk.biases.numpy()
    n_levels = meta[0]
    nodes = meta[hac_fused._HDR + n_levels * hac_fused._LREC :].reshape(-1, hac_fused._NREC)
    cs = np.float32(hac.clamp * hac_fused.ATAN_SCALE)
    q = (lambda a: torch.from_numpy(a).bfloat16().float().numpy()) if hac.compute_dtype == "bfloat16" else (lambda a: a)
    xs, ld = x.copy(), np.zeros(x.shape[0], np.float32)
    for step in range(n_levels):
        li = step if rev else n_levels - 1 - step
        rec = meta[hac_fused._HDR + li * hac_fused._LREC :][: hac_fused._LREC]
        n, h, rows, o, node0, upc, w0, w1, w2, b0, b1, b2 = (int(v) for v in rec)
        S, T = np.zeros_like(xs), np.zeros_like(xs)
        for u0 in range(0, 2 * n, upc):
            for u in range(u0, min(u0 + upc, 2 * n)):
                off, split, out = nodes[node0 + (u if u < n else u - n)][:3]
                wu0 = wts[w0 + u * rows * h :][: rows * h].reshape(rows, h)[:split]
                wu1 = wts[w1 + u * h * h :][: h * h].reshape(h, h)
                wu2 = wts[w2 + u * h * o :][: h * o].reshape(h, o)[:, :out]
                a1 = q(np.maximum(q(xs[:, off : off + split]) @ wu0 + bias[b0 + u * h :][:h], 0))
                a2 = q(np.maximum(a1 @ wu1 + bias[b1 + u * h :][:h], 0))
                dst = T if u >= n else S
                dst[:, off + split : off + split + out] = a2 @ wu2 + bias[b2 + u * o :][:out]
        le = cs * np.arctan(S)
        xs = (xs - T) / np.exp(le) if rev else np.exp(le) * xs + T
        ld += -le.sum(1) if rev else le.sum(1)
    return xs, ld


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [CASES[1], CASES[3], CASES[4]], ids=["d11", "d20-ms2", "d100"])
def test_kernel_loop_emulation_matches_plain(kw, compute_dtype):
    """Offsets, chunking and padding-skipping of the kernel's packed view,
    checked on the CPU against the plain version. bf16 rounds the same
    values at the same points, but the f32 sums run in another order, so an
    activation on a rounding boundary can land one bf16 ulp (2**-8) apart
    and move an output by ~1e-3 relative: 1e-2 there, 1e-5 in f32."""
    thac = _port_with_garbage(seed=4, compute_dtype=compute_dtype, **kw)
    x = _x(21, kw["dim"], 4)
    tol = TOL if compute_dtype == "float32" else 1e-2
    for rev in (False, True):
        ye, lde = _emulate_kernel(thac, x, rev)
        with torch.no_grad():
            yp, ldp = hac_fused.plain_block(thac, torch.from_numpy(x), None, rev)
        np.testing.assert_allclose(ye, yp.numpy(), rtol=tol, atol=tol)
        np.testing.assert_allclose(lde, ldp.numpy(), rtol=tol, atol=tol)


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
    cond = THAC(dim=8, c_internal=(8,), impl="fused", cond_dim=2)
    with pytest.raises(NotImplementedError, match="conditional"):
        hac_fused.fused_block(cond, torch.zeros(2, 8, device="meta"), torch.zeros(2, 2, device="meta"))
    with pytest.raises(NotImplementedError, match="backward"):
        hac_fused.fused_block(thac, torch.zeros(2, 8, device="meta"))
    with torch.no_grad(), pytest.raises(NotImplementedError, match="reshuffle"):
        hac_fused.fused_block(THAC(dim=8, c_internal=(8,), reshuffle=True), torch.zeros(2, 8, device="meta"))
