"""The port's training slice against the JAX package: LR schedule, the
optimizer's update rule, a 24-step trajectory with injected init and
batches for every trainer kind (unconditional ``hint``, ``cinn``,
condition-fed ``recursive_cinn``, two-lane ``conditional_hint``), the x-lane
NLL, the epoch loop's batching, exact resume, and the CLI.

Inputs come from numpy with a seed (or from the JAX package's init) and go
through both packages. Tolerances: the schedule 5e-7 relative (the JAX
package computes it in float32, eps 1.2e-7, the port in Python floats); one optimizer
step 1e-6; a 24-step trajectory 1e-4 on every per-step loss and every final
leaf, padding included (both sum in float32, in different orders, through
24 Adam steps; the bound of ``tests/test_trajectory_parity.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hint_tpu.models import builders as jax_builders
from hint_tpu.models.flow import Flow as JaxFlow
from hint_tpu.ops.hac import HierarchicalAffineCoupling as JaxHAC
from hint_tpu.train import optim as jax_optim
from hint_tpu.train.trainer import Trainer as JaxTrainer
from hint_tpu_torch import cli
from hint_tpu_torch.convert import params_from_numpy, params_to_numpy
from hint_tpu_torch.models import builders
from hint_tpu_torch.models.flow import Flow, with_remat
from hint_tpu_torch.ops import hac_fused
from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling
from hint_tpu_torch.parallel import Mesh
from hint_tpu_torch.serve import InferenceService
from hint_tpu_torch.train import checkpoint, optim
from hint_tpu_torch.train.trainer import CONDITIONAL_CINN, CONDITIONAL_HINT, UNCONDITIONAL, Trainer

N_STEPS, BATCH = 24, 64
HYPER = dict(
    lr_init=0.01, pre_low_lr=3, final_decay=0.01, n_epochs=N_STEPS, adam_betas=(0.9, 0.95),
    l2_weight_reg=1.86e-5, init_scale=0.005, batch_size=BATCH, noise_std=0.0,
)
MODELS = {
    "hac-d8": dict(family="hint", dim=8, n_blocks=1),
    "flow2-d11": dict(family="hint", dim=11, n_blocks=2),
    "cinn-d9": dict(family="cinn", dim=9, cond_dim=3, n_blocks=2),  # trainable perms (vs)
    "rcinn-d12": dict(family="recursive_cinn", dim=12, cond_dim=3, n_blocks=2),
    "chint-d12": dict(family="conditional_hint", dim=12, cond_dim=4, n_blocks=2),
}
KINDS = {"hint": UNCONDITIONAL, "cinn": CONDITIONAL_CINN, "recursive_cinn": CONDITIONAL_CINN,
         "conditional_hint": CONDITIONAL_HINT}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


# -- LR schedule and update rule ---------------------------------------------------------


@pytest.mark.parametrize("semantics", ["legacy", "modern"])
@pytest.mark.parametrize("pre_low_lr", [0, 1, 3])
def test_lr_schedule_matches_jax(semantics, pre_low_lr):
    epochs = np.arange(50)
    ref = np.asarray(jax_optim.lr_schedule(epochs, 0.01, pre_low_lr, 0.01, 50, semantics))
    ours = [optim.lr_schedule(int(e), 0.01, pre_low_lr, 0.01, 50, semantics) for e in epochs]
    assert all(isinstance(v, float) for v in ours)
    np.testing.assert_allclose(ours, ref, rtol=5e-7, atol=0)
    with pytest.raises(ValueError, match="semantics"):
        optim.lr_schedule(0, 0.01, 3, 0.01, 50, "other")
    assert (optim.GRAD_CLAMP, optim.ADAM_EPS, optim.WARMUP_FACTOR) == (
        jax_optim.GRAD_CLAMP, jax_optim.ADAM_EPS, jax_optim.WARMUP_FACTOR)


def test_optimizer_step_matches_jax_on_injected_gradients():
    """Three updates from injected gradient trees (entries beyond the ±5
    clamp included): every trainable leaf within 1e-6 of make_optimizer's,
    moments too; the frozen Q unmoved and without moments."""
    flow = builders.hint(11, 2, (16, 8), device="cpu")
    flow.init(torch.Generator().manual_seed(0))
    params = params_to_numpy(flow)
    jflow = jax_builders.hint(11, 2, (16, 8))
    jparams = jax.tree.map(jnp.asarray, params)
    mask = jflow.trainable_mask(jparams)
    assert dict(_leaves(mask)) == {k: np.asarray(v) for k, v in flow.trainable_mask().items()}
    init_fn, update_fn = jax_optim.make_optimizer((0.9, 0.95), 1.86e-5, mask)
    jstate = init_fn(jparams)
    opt = optim.ClampedAdam(flow, (0.9, 0.95), 1.86e-5)
    assert "b1.q_fixed" not in opt.mu and set(opt.mu) == {k for k, m in flow.trainable_mask().items() if m}
    q_before = flow.b1.q_fixed.clone()
    rng = np.random.default_rng(0)
    for step, lr in enumerate((3e-4, 1e-2, 5e-3)):
        grads = jax.tree.map(lambda p: (4.0 * rng.normal(size=p.shape)).astype(np.float32), params)
        updates, jstate = update_fn(jax.tree.map(jnp.asarray, grads), jstate, jparams, lr)
        jparams = jax_optim.apply_updates(jparams, updates)
        flat = dict(_leaves(grads))
        for k, p in opt.params.items():
            p.grad = torch.from_numpy(flat[k].copy())
        opt.update(lr)
        assert opt.step == step + 1 == int(jstate.step)
        assert all(p.grad is None for p in opt.params.values())
    ours = flow.state_dict()
    for k, ref in _leaves(jparams):
        np.testing.assert_allclose(ours[k].numpy(), ref, rtol=0, atol=1e-6, err_msg=k)
    for name, jm in (("mu", jstate.mu), ("nu", jstate.nu)):
        for k, m in getattr(opt, name).items():
            np.testing.assert_allclose(m.numpy(), dict(_leaves(jm))[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert torch.equal(flow.b1.q_fixed, q_before)


def test_init_trainables_overwrites_every_entry_and_keeps_frozen():
    flow = builders.hint(11, 2, (16, 8), device="cpu")
    flow.init(torch.Generator().manual_seed(0))
    q = flow.b1.q_fixed.clone()
    optim.init_trainables(flow, torch.Generator().manual_seed(1), 0.005)
    for k, p in optim.trainable_parameters(flow).items():
        assert bool((p != 0).all()), k  # padding included
        assert 0.002 < float(p.detach().std()) < 0.008 or p.numel() < 30, k
    assert torch.equal(flow.b1.q_fixed, q)
    again = builders.hint(11, 2, (16, 8), device="cpu")
    again.init(torch.Generator().manual_seed(0))
    optim.init_trainables(again, torch.Generator().manual_seed(1), 0.005)
    assert all(torch.equal(a, b) for a, b in zip(flow.state_dict().values(), again.state_dict().values()))


# -- 24-step trajectory -------------------------------------------------------------------


def _batches(dim, seed=7):
    rng = np.random.RandomState(seed)
    return (1.5 * rng.randn(N_STEPS, BATCH, dim) + 0.01 * rng.randn(N_STEPS, BATCH, dim)).astype(np.float32)


def _conditions(cond_dim, seed=8):
    """Per-step y batches; zero columns wide for an unconditional model."""
    return np.random.RandomState(seed).randn(N_STEPS, BATCH, cond_dim).astype(np.float32)


def _lrs():
    return [optim.lr_schedule(e, 0.01, 3, 0.01, N_STEPS, "legacy") for e in range(N_STEPS)]


def _jax_model(dim, n_blocks, family="hint", cond_dim=0):
    if family == "cinn":
        return jax_builders.cinn(dim, cond_dim, n_blocks, 16, perm_fixed=False)
    if family == "recursive_cinn":
        return jax_builders.recursive_cinn(dim, cond_dim, n_blocks, (16, 8))
    if family == "conditional_hint":
        return jax_builders.conditional_hint(dim, cond_dim, n_blocks, (16, 8), hidden_external=16, hidden_y=8)
    if n_blocks == 1:
        return JaxFlow(bijectors=(JaxHAC(dim=dim, c_internal=(16, 8)),), dim=dim)
    return jax_builders.hint(dim, n_blocks, (16, 8), perm_fixed=True)


def _port_model(dim, n_blocks, impl, family="hint", cond_dim=0):
    if family == "cinn":  # no HAC block: impl does not apply
        return builders.cinn(dim, cond_dim, n_blocks, 16, perm_fixed=False, device="cpu")
    if family == "recursive_cinn":
        return builders.recursive_cinn(dim, cond_dim, n_blocks, (16, 8), impl=impl, device="cpu")
    if family == "conditional_hint":
        return builders.conditional_hint(
            dim, cond_dim, n_blocks, (16, 8), hidden_external=16, hidden_y=8, impl=impl, device="cpu")
    if n_blocks == 1:
        return Flow([HierarchicalAffineCoupling(dim=dim, c_internal=(16, 8), impl=impl)], dim=dim)
    return builders.hint(dim, n_blocks, (16, 8), perm_fixed=True, impl=impl, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_trajectory(name):
    """(init params, per-step losses, final params) of the JAX package's
    Trainer.step_fn over the injected batches (levelwise engine)."""
    kw = MODELS[name]
    tr = JaxTrainer(model=_jax_model(**kw), kind=KINDS[kw["family"]], **HYPER)  # the kinds' names are shared
    state = tr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, state.params)
    batches, ys, lrs = _batches(kw["dim"]), _conditions(kw.get("cond_dim", 0)), _lrs()
    nk = jax.random.PRNGKey(99)  # inert: noise_std=0
    losses = []
    for k in range(N_STEPS):
        state, terms = tr.step_fn(state, jnp.asarray(batches[k]), jnp.asarray(ys[k]), nk, lrs[k])
        losses.append(float(np.asarray(terms).sum()))
    final = jax.tree.map(np.array, state.params)
    x_te, y_te = jnp.asarray(batches[0]), jnp.asarray(ys[0])
    eval_terms, nll_x = tr.eval_epoch(state.params, x_te, y_te, nk, full_batch=True, return_nll_x=True)
    return init, losses, final, (np.asarray(eval_terms), nll_x)


@pytest.mark.parametrize("impl", ["levelwise", "fused"])
@pytest.mark.parametrize("name", list(MODELS))
def test_trajectory_matches_jax_trainer(name, impl):
    init, ref_losses, ref_final, (ref_eval, ref_nll_x) = _jax_trajectory(name)
    kw = MODELS[name]
    tr = Trainer(model=_port_model(impl=impl, **kw), kind=KINDS[kw["family"]], device="cpu", **HYPER)
    state = tr.init_state(0)
    state.model.load_state_dict(params_from_numpy(init))
    batches, lrs = _batches(kw["dim"]), _lrs()
    ys = [torch.from_numpy(y) for y in _conditions(kw["cond_dim"])] if "cond_dim" in kw else [None] * N_STEPS
    g = torch.Generator().manual_seed(0)  # inert: noise_std=0
    losses = [
        float(tr.train_step(state, torch.from_numpy(batches[k]), ys[k], g, lrs[k]).sum())
        for k in range(N_STEPS)
    ]
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0] - 0.1  # it trains
    final = state.model.state_dict()
    for k, ref in _leaves(ref_final):  # whole leaves: padding moves by coupled L2 alone
        np.testing.assert_allclose(final[k].numpy(), ref, rtol=0, atol=1e-4, err_msg=k)
    assert state.opt.step == N_STEPS
    # the trained state's evaluation, with the x-lane NLL of a two-lane model
    terms, nll_x = tr.eval_epoch(torch.from_numpy(batches[0]), ys[0], g, full_batch=True, return_nll_x=True)
    np.testing.assert_allclose(terms, ref_eval, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(terms, tr.eval_epoch(torch.from_numpy(batches[0]), ys[0], g, full_batch=True))
    if kw["family"] == "conditional_hint":
        np.testing.assert_allclose(nll_x, ref_nll_x, rtol=0, atol=1e-4)
        assert abs(nll_x - float(terms.sum())) > 1e-3  # the y lane's share is left out
    else:
        assert np.isnan(nll_x) and np.isnan(ref_nll_x)


BF16_STEPS = 6


@functools.lru_cache(maxsize=None)
def _jax_bf16_trajectory():
    """hint_tpu's Trainer.step_fn on the two-block hint flow of ``flow2-d11``
    with compute_dtype="bfloat16", over the first injected batches."""
    tr = JaxTrainer(model=jax_builders.hint(11, 2, (16, 8), perm_fixed=True, compute_dtype="bfloat16"),
                    kind=UNCONDITIONAL, **HYPER)
    state = tr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, state.params)
    batches, lrs, nk = _batches(11), _lrs(), jax.random.PRNGKey(99)
    losses = []
    for k in range(BF16_STEPS):
        state, terms = tr.step_fn(state, jnp.asarray(batches[k]), jnp.zeros((BATCH, 0)), nk, lrs[k])
        losses.append(float(np.asarray(terms).sum()))
    return init, losses, jax.tree.map(np.array, state.params)


@pytest.mark.parametrize("impl", ["levelwise", "fused"])
def test_bf16_trajectory_matches_jax_trainer(impl):
    """Six bf16 steps (compute_dtype="bfloat16") from injected params and
    batches, as ``test_trajectory_matches_jax_trainer`` drives the f32 ones,
    at its bound: every per-step loss and every final leaf within 1e-4. Both
    packages round the same layer inputs and weights to bf16 and sum in f32,
    in other orders (measured: losses 3e-7 relative, leaves 4.4e-6). The same
    steps without the bf16 roundings move the leaves more than ten times as
    far from hint_tpu's, so the bf16 path is the one held."""
    init, ref_losses, ref_final = _jax_bf16_trajectory()
    batches, lrs, g = _batches(11), _lrs(), torch.Generator().manual_seed(0)
    finals = {}
    for dtype in ("bfloat16", "float32"):
        model = builders.hint(11, 2, (16, 8), perm_fixed=True, compute_dtype=dtype, impl=impl, device="cpu")
        tr = Trainer(model=model, kind=UNCONDITIONAL, device="cpu", **HYPER)
        state = tr.init_state(0)
        state.model.load_state_dict(params_from_numpy(init))
        losses = [float(tr.train_step(state, torch.from_numpy(batches[k]), None, g, lrs[k]).sum())
                  for k in range(BF16_STEPS)]
        finals[dtype] = state.model.state_dict()
        if dtype == "bfloat16":
            np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)
            assert state.opt.step == BF16_STEPS
    errs = {dt: max(float(np.abs(f[k].numpy() - ref).max()) for k, ref in _leaves(ref_final)) for dt, f in finals.items()}
    for k, ref in _leaves(ref_final):  # whole leaves, padding included
        np.testing.assert_allclose(finals["bfloat16"][k].numpy(), ref, rtol=0, atol=1e-4, err_msg=k)
    assert errs["bfloat16"] < 0.1 * errs["float32"], errs


def test_two_lane_remat_is_the_same_math_and_skips_fused_blocks(monkeypatch):
    """``remat=True`` gives a two-lane flow the same gradients as without it,
    and checkpoints every bijector, the fused HAC blocks included."""
    y, x = torch.from_numpy(_conditions(4)[0]), torch.from_numpy(_batches(12)[0])
    grads = {}
    for remat in (False, True):
        flow = _port_model(12, 2, "levelwise", "conditional_hint", 4)
        flow.init(torch.Generator().manual_seed(3))
        if remat:
            assert with_remat(flow) is flow and flow.remat
        z_y, z_x, ld_y, ld_x = flow(y, x)
        (0.5 * (z_x**2).sum(1).mean() + 0.5 * (z_y**2).sum(1).mean() - (ld_y + ld_x).mean()).backward()
        grads[remat] = [p.grad.clone() for p in flow.parameters()]
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    fused = with_remat(_port_model(12, 2, "fused", "conditional_hint", 4))
    fused.init(torch.Generator().manual_seed(3))
    wrapped = []
    monkeypatch.setattr("hint_tpu_torch.models.flow.checkpoint",
                        lambda b, *a, **k: (wrapped.append(type(b).__name__), b(*a))[1])
    fused(y, x)
    # every step, the fused HAC blocks too: their saving forward is re-run before the backward
    block = ["ExternalAffineCoupling", "AffineCoupling"]
    hac = "HierarchicalAffineCoupling"
    assert wrapped == [hac, *block, "HouseholderPerm", "HouseholderPerm", hac, *block]


def test_remat_is_the_same_math_and_skips_fused_blocks(monkeypatch):
    """``remat=True`` gives the same gradients as without it, and checkpoints
    every bijector, the fused HAC blocks included."""
    x = torch.from_numpy(_batches(11)[0])
    grads = {}
    for remat in (False, True):
        flow = builders.hint(11, 2, (16, 8), device="cpu")
        flow.init(torch.Generator().manual_seed(3))
        if remat:
            assert with_remat(flow) is flow and flow.remat
        z, ld = flow(x)
        (0.5 * (z**2).sum(1).mean() - ld.mean()).backward()
        grads[remat] = [p.grad.clone() for p in flow.parameters()]
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    fused = with_remat(builders.hint(11, 2, (16, 8), impl="fused", device="cpu"))
    fused.init(torch.Generator().manual_seed(3))
    wrapped = []
    monkeypatch.setattr("hint_tpu_torch.models.flow.checkpoint",
                        lambda b, *a, **k: (wrapped.append(type(b).__name__), b(*a))[1])
    fused(x)
    # every bijector, the fused blocks too: their saving forward is re-run before the backward
    assert wrapped == ["HierarchicalAffineCoupling", "HouseholderPerm", "HierarchicalAffineCoupling"]


def test_pack_key_changes_with_every_optimizer_step():
    """The kernel's packed weights are rebuilt after an in-place update (the
    parameter's version moves) and after a replaced ``.data`` (its pointer
    moves)."""
    tr = Trainer(model=_port_model(8, 1, "fused"), kind=UNCONDITIONAL, device="cpu", **HYPER)
    state = tr.init_state(0)
    hac = state.model.b0
    a = hac_fused._packed(hac, torch.device("cpu"))
    key_a = hac._kernel_pack[0]
    assert hac_fused._packed(hac, torch.device("cpu")) is a
    tr.train_step(state, torch.from_numpy(_batches(8)[0]), None, torch.Generator().manual_seed(0), 1e-2)
    b = hac_fused._packed(hac, torch.device("cpu"))
    key_b = hac._kernel_pack[0]
    assert b is not a and key_b != key_a and not torch.equal(a.weights, b.weights)
    hac.L0["w1"].data = hac.L0["w1"].data * 2.0
    c = hac_fused._packed(hac, torch.device("cpu"))
    assert c is not b and hac._kernel_pack[0] != key_b and not torch.equal(b.weights, c.weights)


# -- epoch loop ---------------------------------------------------------------------------


def _tiny_trainer(impl="levelwise", **kw):
    hyper = {**HYPER, "n_epochs": 4, "batch_size": 16, "noise_std": 0.01, **kw}
    return Trainer(model=_port_model(11, 2, impl), kind=UNCONDITIONAL, device="cpu", **hyper)


def test_batches_drop_last_cap_and_zero_batch_error():
    tr = _tiny_trainer(max_batches_per_epoch=100)
    g = torch.Generator().manual_seed(0)
    perm, n = tr._batches(g, 70, True)
    assert n == 4 and sorted(perm.tolist()) == list(range(70))  # 70 // 16, last 6 rows dropped
    assert _tiny_trainer(max_batches_per_epoch=3)._batches(g, 70, True)[1] == 3
    assert _tiny_trainer(max_batches_per_epoch=0)._batches(g, 70, True)[1] == 4  # 0 = no cap
    with pytest.raises(ValueError, match="zero drop-last batches"):
        tr._batches(g, 15, True)
    assert tr._batches(g, 15, False)[1] == 0
    x = torch.arange(70.0)[:, None].expand(70, 11).contiguous()
    seen = [xb for xb, yb in tr._epoch_slices(x, None, torch.Generator().manual_seed(1), True)]
    assert [tuple(xb.shape) for xb in seen] == [(16, 11)] * 4
    assert len(set(torch.cat(seen)[:, 0].tolist())) == 64  # no row twice


def test_eval_epoch_full_batch_and_whole_set_fallback():
    tr = _tiny_trainer()
    tr.init_state(0)
    x = torch.from_numpy(_batches(11)[0])  # 64 rows, 4 batches of 16
    gen = lambda: tr.epoch_generator(0, 0, 1)
    batched = tr.eval_epoch(x, None, gen())
    whole = tr.eval_epoch(x, None, gen(), full_batch=True)
    assert batched.shape == whole.shape == (2,) and np.isfinite(batched).all()
    np.testing.assert_allclose(batched, whole, rtol=0, atol=5e-3)  # other noise, same rows
    np.testing.assert_array_equal(tr.eval_epoch(x[:10], None, gen()),  # fewer rows than a batch
                                  tr.eval_epoch(x[:10], None, gen(), full_batch=True))
    np.testing.assert_array_equal(batched, tr.eval_epoch(x, None, gen()))  # same generator, same loss


def test_trainer_refuses_what_is_not_ported(monkeypatch):
    flow = _port_model(11, 2, "levelwise")
    two_lane = _port_model(12, 1, "levelwise", "conditional_hint", 4)
    with pytest.raises(TypeError, match="requires a TwoLaneFlow"):
        Trainer(model=flow, kind=CONDITIONAL_HINT, device="cpu")
    for kind in (UNCONDITIONAL, CONDITIONAL_CINN):
        with pytest.raises(TypeError, match="requires a Flow"):
            Trainer(model=two_lane, kind=kind, device="cpu")
    with pytest.raises(ValueError, match="unknown trainer kind"):
        Trainer(model=flow, kind="other", device="cpu")
    mesh = Mesh(group=None, rank=0, size=2, axis_names=("data",), device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="is not the mesh's"):
        Trainer(model=flow, kind=UNCONDITIONAL, mesh=mesh, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model=flow, kind=UNCONDITIONAL)


def _tiny_two_lane_trainer(impl="levelwise"):
    hyper = {**HYPER, "n_epochs": 4, "batch_size": 16, "noise_std": 0.01}
    model = _port_model(11, 2, impl, "conditional_hint", 3)
    return Trainer(model=model, kind=CONDITIONAL_HINT, device="cpu", **hyper)


@pytest.mark.parametrize("impl,kind", [("levelwise", UNCONDITIONAL), ("fused", UNCONDITIONAL),
                                       ("levelwise", CONDITIONAL_HINT), ("fused", CONDITIONAL_HINT)],
                         ids=["levelwise", "fused", "levelwise-hint", "fused-hint"])
def test_fit_resume_is_bit_identical(tmp_path, impl, kind):
    """fit for 4 epochs == its state saved after 2, load_npz, fit 2 more;
    for the unconditional flow and for the two-lane model on (x, y) pairs."""
    rng = np.random.default_rng(5)
    x_tr = torch.from_numpy(rng.normal(size=(70, 11)).astype(np.float32))
    x_te = torch.from_numpy(rng.normal(size=(40, 11)).astype(np.float32))
    y_tr = y_te = None
    make = _tiny_two_lane_trainer if kind == CONDITIONAL_HINT else _tiny_trainer
    if kind == CONDITIONAL_HINT:
        y_tr = torch.from_numpy(rng.normal(size=(70, 3)).astype(np.float32))
        y_te = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    path, seen = str(tmp_path / "half.npz"), []

    def save_after_two(state, epoch):
        seen.append((state.epoch, epoch))
        if epoch == 1:
            checkpoint.save_npz(path, state)

    whole, loss_whole = make(impl).fit(
        3, (x_tr, y_tr), (x_te, y_te), checkpoint_fn=save_after_two)
    assert seen == [(1, 0), (2, 1), (3, 2), (4, 3)]
    resumed_tr = make(impl)
    loaded = checkpoint.load_npz(path, resumed_tr.init_state(99))
    assert loaded.epoch == 2 and loaded.opt.step == 2 * 4
    resumed, loss_resumed = resumed_tr.fit(3, (x_tr, y_tr), (x_te, y_te), resume_state=loaded)
    assert resumed.epoch == whole.epoch == 4
    assert loss_resumed == loss_whole
    for (k, a), b in zip(whole.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k in whole.opt.mu:
        assert torch.equal(whole.opt.mu[k], resumed.opt.mu[k]) and torch.equal(whole.opt.nu[k], resumed.opt.nu[k])
    # resuming a finished run only evaluates
    _, again = resumed_tr.fit(3, (x_tr, y_tr), (x_te, y_te), resume_state=resumed)
    assert np.isfinite(again) and resumed.opt.step == 4 * 4


# -- CLI ------------------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["train", "--config", "plus_shape.unconditional_hint_4_full", "--epochs", "1"],
    ["evaluate", "--config", "plus_shape.unconditional_hint_4_full", "--ckpt", "run.npz"],
    ["sample", "--config", "plus_shape.conditional_hint_8_full", "--ckpt", "run.npz", "--y-target", "1", "2"],
    ["serve", "--config", "plus_shape.unconditional_hint_4_full", "--ckpt", "run.npz", "--port", "9000"],
], ids=["train", "evaluate", "sample", "serve"])
def test_cli_accepts_hint_tpus_xla_flags_as_no_ops(argv):
    """``--scan-blocks`` and ``--no-remat`` (hint_tpu/cli.py:32-40) parse on
    every subcommand that hint_tpu gives them, and change nothing else."""
    plain = vars(cli.parser().parse_args(argv))
    flagged = vars(cli.parser().parse_args([*argv, "--scan-blocks", "on", "--no-remat"]))
    assert (flagged.pop("scan_blocks"), flagged.pop("no_remat")) == ("on", True)
    assert (plain.pop("scan_blocks"), plain.pop("no_remat")) == ("auto", False)
    assert flagged == plain
    with pytest.raises(SystemExit):  # the same choices as hint_tpu's
        cli.parser().parse_args([*argv, "--scan-blocks", "sometimes"])


def test_cli_train_evaluate_sample_on_cpu(tmp_path, capsys):
    name = "lens_shape.unconditional_hint_1_full"
    ckpt, out = str(tmp_path / "run.npz"), str(tmp_path / "s.npy")
    data = ["--config", name, "--device", "cpu", "--n-train", "48", "--n-test", "32",
            "--cache-dir", str(tmp_path / "data")]
    final = cli.main(["train", *data, "--impl", "fused", "--epochs", "1", "--batch-size", "16",
                      "--max-batches", "2", "--save", ckpt, "--seed", "1"])
    text = capsys.readouterr().out
    assert "99,578 trainable parameters" in text and "lr=3.00e-04" in text and np.isfinite(final)
    with np.load(ckpt) as arrays:
        assert int(arrays["epoch"]) == 1 and int(arrays["opt_step"]) == 2
        assert {"params['b0']['L0']['w0']", "mu['b0']['L0']['w0']", "nu['b0']['L0']['w0']"} <= set(arrays.files)
    total = cli.main(["evaluate", *data, "--ckpt", ckpt])
    assert np.isfinite(total) and "per-dim likelihood" in capsys.readouterr().out
    cli.main(["sample", "--config", name, "--device", "cpu", "--ckpt", ckpt, "--n", "5", "--out", out])
    x = np.load(out)
    assert x.shape == (5, 20) and np.isfinite(x).all()
    svc = InferenceService.from_checkpoint(name, ckpt, device="cpu")
    np.testing.assert_array_equal(x, svc.sample(5, seed=0))
    resumed = cli.main(["train", *data, "--epochs", "2", "--batch-size", "16", "--max-batches", "2",
                        "--resume", ckpt, "--seed", "1"])
    assert "resuming from" in capsys.readouterr().out and np.isfinite(resumed)
    cli.main(["list", "lens_shape.unconditional_hint"])
    assert capsys.readouterr().out.split() == [
        "lens_shape.unconditional_hint_1_full", "lens_shape.unconditional_hint_2_full"]
    with pytest.raises(FileNotFoundError, match="uci_data"):  # UCI configs read --uci-root
        cli.main(["train", "--config", "uci_data.power_hint_4", "--device", "cpu", "--uci-root", str(tmp_path)])
