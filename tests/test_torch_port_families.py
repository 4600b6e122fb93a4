"""The port's model families against the JAX package: the ``inn``, ``cinn``,
``recursive_cinn`` and two-lane ``conditional_hint`` builders (forward,
inverse and per-lane log-dets), all 73 registered configs (``state_dict``
keys and shapes against the JAX package's ``init`` tree), and weights-only
and full-state npz files in both directions for one config of each family.

Params come from the JAX package's ``init`` and inputs from numpy with a
seed; both go through both packages. Tolerance 1e-5 (f32: both sum in
float32, in different orders)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu.configs import get_config as jax_config
from hint_tpu.models import builders as jax_builders
from hint_tpu.models.flow import TwoLaneFlow as JaxTwoLaneFlow
from hint_tpu.train import checkpoint as jax_ckpt
from hint_tpu_torch.configs import get_config, list_configs
from hint_tpu_torch.convert import load_params, params_to_numpy
from hint_tpu_torch.models import builders
from hint_tpu_torch.models.flow import LANE_X, LANE_Y, LANE_YX, TwoLaneFlow
from hint_tpu_torch.train import checkpoint

TOL = 1e-5
BATCH = 11

# (JAX builder arguments, extra arguments of the port's builder)
FAMILIES = {
    "inn": (dict(dim=9, n_blocks=3, hidden=16), {}),
    "cinn-trainable-perm": (dict(dim=9, cond_dim=3, n_blocks=2, hidden=16, perm_fixed=False), {}),
    "cinn-fixed-perm": (dict(dim=8, cond_dim=2, n_blocks=2, hidden=16, perm_fixed=True), {}),
    "recursive_cinn": (dict(dim=12, cond_dim=3, n_blocks=2, c_internal=(16, 8)), {}),
    "recursive_cinn-fused": (dict(dim=12, cond_dim=3, n_blocks=2, c_internal=(16, 8)), dict(impl="fused")),
    "recursive_cinn-ms1": (dict(dim=11, cond_dim=2, n_blocks=2, c_internal=(16, 8), max_splits=1), {}),
}
TWO_LANE = {
    "conditional_hint": (dict(dim_x=12, dim_y=4, n_blocks=3, c_internal=(16, 8), hidden_external=16, hidden_y=8), {}),
    "conditional_hint-fused-odd": (
        dict(dim_x=11, dim_y=3, n_blocks=2, c_internal=(16, 8), hidden_external=12, hidden_y=6), dict(impl="fused")),
    "conditional_hint-trainable-perm": (
        dict(dim_x=8, dim_y=2, n_blocks=2, c_internal=(8,), hidden_external=8, hidden_y=4, perm_fixed=False), {}),
}


def _builder(name):
    return name.split("-")[0]


def _inputs(*dims, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(BATCH, d)).astype(np.float32) for d in dims]


def _init_params(jflow, seed):
    """The JAX model's init as numpy, subnet weights halved: a random chain at
    full init scale is too ill-conditioned to invert to 1e-4 in f32."""
    params = jax.tree.map(np.array, jflow.init(jax.random.PRNGKey(seed)))
    for op in params.values():
        for sub in (v for v in op.values() if isinstance(v, dict)):
            for leaf in sub.values():
                leaf *= 0.5
    return params


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_single_lane_builder_matches_jax(name):
    jkw, extra = FAMILIES[name]
    jflow = getattr(jax_builders, _builder(name))(**jkw)
    flow = getattr(builders, _builder(name))(**jkw, **extra, device="cpu")
    assert [type(b).__name__ for b in flow.bijectors] == [type(b).__name__ for b in jflow.bijectors]
    assert (flow.dim, flow.cond_dim) == (jflow.dim, jflow.cond_dim)
    params = _init_params(jflow, 1)
    load_params(flow, params)  # strict: the JAX tree's keys and shapes
    cond_dim = jkw.get("cond_dim", 0)
    x, c = _inputs(jkw["dim"], cond_dim, seed=2)
    jargs = (jnp.asarray(c),) if cond_dim else ()
    targs = (torch.from_numpy(c),) if cond_dim else ()
    with torch.no_grad():
        for jf, tf in ((jflow.forward, flow.forward), (jflow.inverse, flow.inverse)):
            yj, ldj = jf(params, jnp.asarray(x), *jargs)
            yt, ldt = tf(torch.from_numpy(x), *targs)
            _close(yt, yj)
            _close(ldt, ldj)
        z, ld = flow(torch.from_numpy(x), *targs)
        x2, ld_inv = flow.inverse(z, *targs)
    _close(x2, x, 1e-4)  # the round trip crosses every exp-scaled coupling twice
    _close(ld_inv, -ld.numpy())
    jmask = {k: bool(v) for k, v in _leaves(jflow.trainable_mask(params))}
    assert flow.trainable_mask() == jmask


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name", list(TWO_LANE))
def test_two_lane_builder_matches_jax(name):
    """(z_y, z_x, logdet_y, logdet_x) of the two-lane graph, both directions;
    the y->x couplings read the current y-lane state."""
    jkw, extra = TWO_LANE[name]
    jflow = jax_builders.conditional_hint(**jkw)
    flow = builders.conditional_hint(**jkw, **extra, device="cpu")
    assert isinstance(flow, TwoLaneFlow) and (flow.dim_y, flow.dim_x) == (jflow.dim_y, jflow.dim_x)
    assert [(lane, type(b).__name__) for lane, b in flow.steps] == [
        (lane, type(b).__name__) for lane, b in jflow.steps]
    assert {LANE_Y, LANE_X, LANE_YX} == set(flow.lanes)
    params = _init_params(jflow, 3)
    load_params(flow, params)
    y, x = _inputs(jkw["dim_y"], jkw["dim_x"], seed=4)
    with torch.no_grad():
        for jf, tf in ((jflow.forward, flow.forward), (jflow.inverse, flow.inverse)):
            outs_j = jf(params, jnp.asarray(y), jnp.asarray(x))
            outs_t = tf(torch.from_numpy(y), torch.from_numpy(x))
            assert [tuple(t.shape) for t in outs_t] == [y.shape, x.shape, (BATCH,), (BATCH,)]
            for t, j in zip(outs_t, outs_j):
                _close(t, j)
        z_y, z_x, ld_y, ld_x = flow(torch.from_numpy(y), torch.from_numpy(x))
        y2, x2, ldi_y, ldi_x = flow.inverse(z_y, z_x)
        # the x lane reads y: another y moves z_x and the x-lane log-det
        _, z_x_other, _, ld_x_other = flow(torch.from_numpy(y) + 1.0, torch.from_numpy(x))
    _close(y2, y, 1e-4)
    _close(x2, x, 1e-4)
    _close(ldi_y, -ld_y.numpy())
    _close(ldi_x, -ld_x.numpy())
    assert float((z_x_other - z_x).abs().max()) > 1e-3 and float((ld_x_other - ld_x).abs().max()) > 1e-4
    jmask = {k: bool(v) for k, v in _leaves(jflow.trainable_mask(params))}
    assert flow.trainable_mask() == jmask
    with pytest.raises(ValueError, match="unknown lane"):
        TwoLaneFlow([("z", flow.b0)], dim_y=1, dim_x=1)


# -- all registered configs ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init_shapes(bijector):
    """Key paths and shapes of one JAX bijector's init tree, without running
    it (bijectors are frozen dataclasses: equal blocks share one entry)."""
    tree = jax.eval_shape(bijector.init, jax.random.PRNGKey(0))
    return {k: tuple(v.shape) for k, v in _leaves(tree)}


@pytest.mark.parametrize("name", list_configs())
def test_config_builds_with_jax_key_paths_and_shapes(name):
    """Every registered config builds in the port, and its ``state_dict``
    has the key paths and shapes of the JAX package's unrolled init tree
    (``{"b<i>": bijector.init(...)}`` over the model's ops or steps)."""
    jmodel = jax_config(name).build_model(scan_blocks=False)
    ops = [b for _, b in jmodel.steps] if isinstance(jmodel, JaxTwoLaneFlow) else jmodel.bijectors
    expected = {
        f"b{i}.{k}": shape for i, b in enumerate(ops) for k, shape in _jax_init_shapes(b).items()
    }
    cfg = get_config(name)
    model = cfg.build_model(device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == expected
    assert isinstance(model, TwoLaneFlow) == (cfg.model_type == "conditional_hint")
    assert set(model.trainable_mask()) == set(expected)


def test_build_model_passes_the_family_arguments():
    cfg = get_config("plus_shape.conditional_hint_8_full")
    model = cfg.build_model(impl="fused", compute_dtype="bfloat16", device="cpu")
    hacs = [b for _, b in model.steps if type(b).__name__ == "HierarchicalAffineCoupling"]
    assert len(hacs) == 8 and all(b.impl == "fused" and b.cond_dim == 0 for b in hacs)
    assert model.b1.hidden == cfg.hidden == 152 and model.b2.hidden == cfg.hidden_y == 76
    assert model.b1.compute_dtype == model.b2.compute_dtype == hacs[0].compute_dtype == "bfloat16"
    rc = get_config("plus_shape.conditional_recursive_cinn_4").build_model(impl="fused", device="cpu")
    hacs = [b for b in rc.bijectors if type(b).__name__ == "HierarchicalAffineCoupling"]
    assert len(hacs) == 4 and all(b.impl == "fused" and b.cond_dim == 4 for b in hacs)
    assert hacs[0].c_internal == (267, 133, 66) and rc.cond_dim == 4
    no_hidden_y = dataclasses.replace(get_config("lens_shape.conditional_hint_1_full"), hidden_y=None)
    assert no_hidden_y.build_model(device="cpu").b2.hidden == no_hidden_y.hidden // 2
    with pytest.raises(ValueError, match="unknown model_type"):
        dataclasses.replace(cfg, model_type="other").build_model(device="cpu")


# -- checkpoints of each new family, both ways ----------------------------------------------------

SHRUNK = {
    "inn": ("lens_shape.unconditional_inn_2", dict(hidden=16)),
    "cinn": ("lens_shape.conditional_cinn_2", dict(hidden=16)),  # trainable perms: vs
    "recursive_cinn": ("plus_shape.conditional_recursive_cinn_4", dict(n_blocks=2, c_internal=(16, 8), max_splits=2)),
    "conditional_hint": ("lens_shape.conditional_hint_2_full",
                         dict(c_internal=(16, 8), hidden=16, hidden_y=8, max_splits=2)),
}


@pytest.mark.parametrize("family", list(SHRUNK))
def test_params_and_full_state_npz_move_both_ways(tmp_path, family):
    name, shrink = SHRUNK[family]
    jcfg, cfg = dataclasses.replace(jax_config(name), **shrink), dataclasses.replace(get_config(name), **shrink)
    jtr, tr = jcfg.make_trainer(), cfg.make_trainer(device="cpu")
    jstate = jtr.init_state(jax.random.PRNGKey(2))
    ones = jax.tree.map(lambda p: jnp.full_like(p, 0.25), jstate.params)
    jstate = jstate._replace(
        opt=jstate.opt._replace(mu=ones, nu=ones, step=jnp.asarray(5, jnp.int32)),
        epoch=jnp.asarray(2, jnp.int32))
    ref = dict(_leaves(jax.tree.map(np.asarray, jstate.params)))
    if family == "cinn":
        assert "b0.vs" in ref
    if family == "conditional_hint":
        assert {"b0.L0.w0", "b1.f.w0", "b2.f1.w0"} <= set(ref)

    # JAX -> port, full state and weights only
    jax_full, jax_weights = str(tmp_path / "jax_full.npz"), str(tmp_path / "jax_weights.npz")
    jax_ckpt.save_npz(jax_full, jstate, model=jtr.model)
    jax_ckpt.save_params_npz(jax_weights, jstate.params, model=jtr.model)
    state = checkpoint.load_npz(jax_full, tr.init_state(7))
    assert state.epoch == 2 and state.opt.step == 5
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    assert set(state.opt.mu) == {k for k, m in tr.model.trainable_mask().items() if m}
    assert all(bool((m == 0.25).all()) for m in state.opt.mu.values())
    other = cfg.build_model(device="cpu")
    load_params(other, checkpoint.load_params_npz(jax_weights))
    for k, v in other.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)

    # port -> JAX, full state and weights only
    port_full, port_weights = str(tmp_path / "port_full.npz"), str(tmp_path / "port_weights.npz")
    checkpoint.save_npz(port_full, state)
    checkpoint.save_params_npz(port_weights, state.model)
    with np.load(port_full) as a, np.load(jax_full) as b:
        assert sorted(a.files) == sorted(b.files)
    template = jstate._replace(params=jax.tree.map(jnp.zeros_like, jstate.params))  # structure only
    back = jax_ckpt.load_npz(port_full, template, model=jtr.model)
    assert int(back.epoch) == 2 and int(back.opt.step) == 5
    for k, v in _leaves(jax.tree.map(np.asarray, back.params)):
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    weights = jax_ckpt.load_params_npz(port_weights, template.params, model=jtr.model)
    for k, v in _leaves(jax.tree.map(np.asarray, weights)):
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    assert params_to_numpy(state.model).keys() == jstate.params.keys()
