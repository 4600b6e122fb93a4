"""Port op primitives vs the JAX package: soft clamp, MLPSpec and the
Householder product/permutation, on the same numpy inputs, at 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu.ops import clamp as jclamp
from hint_tpu.ops.householder import HouseholderPerm as JPerm
from hint_tpu.ops.householder import householder_matrix_product as j_hmp
from hint_tpu.ops.subnets import MLPSpec as JMLP
from hint_tpu_torch.ops import clamp as tclamp
from hint_tpu_torch.ops.householder import HouseholderPerm as TPerm
from hint_tpu_torch.ops.householder import householder_matrix_product as t_hmp
from hint_tpu_torch.ops.subnets import MLPSpec as TMLP

TOL = 1e-6


def test_soft_clamp_matches_jax():
    s = np.random.default_rng(0).normal(scale=3.0, size=(64, 9)).astype(np.float32)
    assert tclamp.ATAN_SCALE == jclamp.ATAN_SCALE == 0.636
    for clamp in (1.0, 4.0):
        np.testing.assert_allclose(
            tclamp.soft_clamp_log(torch.from_numpy(s), clamp).numpy(),
            np.asarray(jclamp.soft_clamp_log(jnp.asarray(s), clamp)), rtol=TOL, atol=TOL,
        )
        np.testing.assert_allclose(
            tclamp.soft_clamp_exp(torch.from_numpy(s), clamp).numpy(),
            np.asarray(jclamp.soft_clamp_exp(jnp.asarray(s), clamp)), rtol=TOL, atol=TOL,
        )


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mlp_apply_matches_jax(compute_dtype):
    spec_j = JMLP(7, 16, 5, compute_dtype)
    spec_t = TMLP(7, 16, 5, compute_dtype)
    params = {k: np.array(v) for k, v in spec_j.init(jax.random.PRNGKey(0)).items()}
    x = np.random.default_rng(1).normal(size=(11, 7)).astype(np.float32)
    yj = np.asarray(spec_j.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    yt = spec_t.apply({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=TOL, atol=TOL)
    assert spec_t.n_params == spec_j.n_params


def test_mlp_init_is_uniform_in_fan_in_bounds():
    spec = TMLP(9, 16, 4)
    p = spec.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w0": (9, 16), "b0": (16,), "w1": (16, 16), "b1": (16,), "w2": (16, 4), "b2": (4,),
    }
    for k, fan_in in (("w0", 9), ("w1", 16), ("w2", 16)):
        assert float(p[k].abs().max()) <= 1.0 / np.sqrt(fan_in)
    q = spec.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], q[k]) for k in p)


@pytest.mark.parametrize("n,d", [(1, 5), (7, 7), (20, 12)])
def test_householder_matrix_product_matches_jax(n, d):
    vs = np.random.default_rng(n).normal(size=(n, d)).astype(np.float32)
    qt = t_hmp(torch.from_numpy(vs)).numpy()
    np.testing.assert_allclose(qt, np.asarray(j_hmp(jnp.asarray(vs))), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(qt @ qt.T, np.eye(d), atol=1e-5)


def test_householder_perm_matches_jax():
    jp = JPerm(dim=10, n_reflections=10, fixed=True)
    q = np.array(jp.init(jax.random.PRNGKey(3))["q_fixed"])
    tp = TPerm(dim=10, n_reflections=10, fixed=True)
    tp.load_state_dict({"q_fixed": torch.from_numpy(q)})
    x = np.random.default_rng(2).normal(size=(6, 10)).astype(np.float32)
    for jf, tf in ((jp.forward, tp.forward), (jp.inverse, tp.inverse)):
        yj, ldj = jf({"q_fixed": jnp.asarray(q)}, jnp.asarray(x))
        yt, ldt = tf(torch.from_numpy(x))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(ldt.numpy(), np.asarray(ldj))
    assert tp.trainable_mask() == {"q_fixed": False}
    trainable = TPerm(dim=4, n_reflections=3, fixed=False)
    trainable.init(torch.Generator().manual_seed(0))
    assert trainable.trainable_mask() == {"vs": True}
    x4 = torch.randn(3, 4, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(trainable.inverse(trainable(x4)[0])[0].detach().numpy(), x4.numpy(), atol=1e-6)
