"""The port's coupling bijectors and the conditional Householder permutation
against the JAX package: ``AffineCoupling`` (with and without a condition,
odd ``dim``), ``ExternalAffineCoupling`` and ``HouseholderPerm(cond_dim>0)``.

Weights and inputs are made with numpy from a seed and go through both
packages. Tolerances: 1e-5 in f32 (both sum in float32, in different
orders); 2e-2 in bf16 (both round the same operands to bf16, but an
activation on a rounding boundary can land one bf16 ulp apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu.ops.coupling import AffineCoupling as JaxAffine
from hint_tpu.ops.coupling import ExternalAffineCoupling as JaxExternal
from hint_tpu.ops.householder import HouseholderPerm as JaxPerm
from hint_tpu_torch.convert import load_params, params_to_numpy
from hint_tpu_torch.ops.coupling import AffineCoupling, ExternalAffineCoupling
from hint_tpu_torch.ops.householder import HouseholderPerm

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BATCH = 13


def _numpy_params(module, seed):
    """A tree of the module's keys and shapes, filled by numpy."""
    rng = np.random.default_rng(seed)
    tree = params_to_numpy(module)
    return jax.tree.map(lambda a: (0.4 * rng.normal(size=a.shape)).astype(np.float32), tree)


def _inputs(dim, cond_dim, seed):
    rng = np.random.default_rng(100 + seed)
    x = rng.normal(size=(BATCH, dim)).astype(np.float32)
    c = rng.normal(size=(BATCH, cond_dim)).astype(np.float32) if cond_dim else None
    return x, c


def _compare(jbij, tbij, params, x, c, tol):
    """Forward, inverse, log-dets and the round trip of both packages."""
    load_params(tbij, params)  # strict: the JAX tree's keys and shapes
    jp = jax.tree.map(jnp.asarray, params)
    jc = None if c is None else jnp.asarray(c)
    tc = None if c is None else torch.from_numpy(c)
    with torch.no_grad():
        for jf, tf in ((jbij.forward, tbij.forward), (jbij.inverse, tbij.inverse)):
            yj, ldj = jf(jp, jnp.asarray(x), jc)
            yt, ldt = tf(torch.from_numpy(x), tc)
            assert yt.shape == x.shape and ldt.shape == (BATCH,)
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=tol, atol=tol)
            np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=tol, atol=tol)
        y, ld = tbij(torch.from_numpy(x), tc)
        x2, ld_inv = tbij.inverse(y, tc)
    np.testing.assert_allclose(x2.numpy(), x, rtol=10 * tol, atol=10 * tol)
    np.testing.assert_allclose(ld_inv.numpy(), -ld.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,cond_dim", [(8, 0), (7, 0), (8, 3), (11, 2)],
                         ids=["d8", "d7-odd", "d8-c3", "d11-odd-c2"])
def test_affine_coupling_matches_jax(dim, cond_dim, compute_dtype):
    kw = dict(dim=dim, cond_dim=cond_dim, hidden=16, clamp=2.0, compute_dtype=compute_dtype)
    jbij, tbij = JaxAffine(**kw), AffineCoupling(**kw)
    assert sorted(tbij.state_dict()) == sorted(
        f"{f}.{k}" for f in ("f1", "f2") for k in ("w0", "b0", "w1", "b1", "w2", "b2"))
    jshapes = jax.tree.map(lambda a: a.shape, jbij.init(jax.random.PRNGKey(0)))
    assert jshapes == jax.tree.map(lambda a: a.shape, params_to_numpy(tbij))
    x, c = _inputs(dim, cond_dim, dim)
    _compare(jbij, tbij, _numpy_params(tbij, dim), x, c, TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_external_affine_coupling_matches_jax(compute_dtype):
    kw = dict(dim=9, cond_dim=3, hidden=16, clamp=2.0, compute_dtype=compute_dtype)
    jbij, tbij = JaxExternal(**kw), ExternalAffineCoupling(**kw)
    jshapes = jax.tree.map(lambda a: a.shape, jbij.init(jax.random.PRNGKey(0)))
    assert jshapes == jax.tree.map(lambda a: a.shape, params_to_numpy(tbij))
    x, c = _inputs(9, 3, 1)
    _compare(jbij, tbij, _numpy_params(tbij, 1), x, c, TOL[compute_dtype])
    with pytest.raises(ValueError, match="cond_dim > 0"):
        ExternalAffineCoupling(dim=9, cond_dim=0)


def test_coupling_init_fills_every_leaf_and_is_seeded():
    a, b = AffineCoupling(dim=7, cond_dim=2, hidden=8), AffineCoupling(dim=7, cond_dim=2, hidden=8)
    a.init(torch.Generator().manual_seed(3))
    b.init(torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb) and bool(va.abs().sum() > 0), k
    bound = 1.0 / np.sqrt(3 + 2)  # f1 reads split1 + cond_dim inputs
    assert float(a.f1["w0"].detach().abs().max()) <= bound
    assert all(a.trainable_mask().values()) and set(a.trainable_mask()) == set(a.state_dict())
    ext = ExternalAffineCoupling(dim=5, cond_dim=2, hidden=8)
    ext.init(torch.Generator().manual_seed(4))
    assert ext.f["w2"].shape == (8, 10) and bool(ext.f["w2"].abs().sum() > 0)


@pytest.mark.parametrize("n_reflections", [1, 4])
def test_conditional_householder_matches_jax(n_reflections):
    kw = dict(dim=6, cond_dim=3, n_reflections=n_reflections, fixed=False)
    jbij, tbij = JaxPerm(**kw), HouseholderPerm(**kw)
    assert sorted(tbij.state_dict()) == ["b_cond", "w_cond"]
    jshapes = jax.tree.map(lambda a: a.shape, jbij.init(jax.random.PRNGKey(0)))
    assert jshapes == jax.tree.map(lambda a: a.shape, params_to_numpy(tbij))
    x, c = _inputs(6, 3, 2)
    _compare(jbij, tbij, _numpy_params(tbij, 2), x, c, TOL["float32"])
    with torch.no_grad():  # orthogonal per sample: norms kept, log-det zero
        y, ld = tbij(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(y.norm(dim=1).numpy(), np.linalg.norm(x, axis=1), rtol=1e-5)
    assert not ld.any()
    with pytest.raises(ValueError, match="cannot be fixed"):
        HouseholderPerm(dim=6, cond_dim=3, fixed=True)
    tbij.init(torch.Generator().manual_seed(0))
    assert bool(tbij.w_cond.abs().sum() > 0) and all(tbij.trainable_mask().values())
