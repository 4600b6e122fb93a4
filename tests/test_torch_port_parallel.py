"""The port's data parallelism (``hint_tpu_torch.parallel``) on the CPU,
held to ``hint_tpu``'s sharded paths on its 8-device virtual mesh.

One 2-rank gloo world, spawned once for the module, runs the port's side
(``tests/torch_parallel_world.py``, which imports no JAX) and saves what
every rank computed; each test compares one result. The model is
``tests/test_parallel.py``'s: ``builders.hint(dim=12, n_blocks=2,
c_internal=(16, 8))`` at batch 64, with the parameters, rows and noise
injected (``noise_std=0``, the rows noised beforehand).
"""

from __future__ import annotations

import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_world as world_side
from hint_tpu.evaluation import abc as jax_abc
from hint_tpu.evaluation.mmd import multi_mmd as jax_mmd
from hint_tpu.models import builders as jax_builders
from hint_tpu.parallel import batch_sharding
from hint_tpu.parallel import make_mesh as jax_make_mesh
from hint_tpu.train.trainer import UNCONDITIONAL as JAX_UNCONDITIONAL
from hint_tpu.train.trainer import Trainer as JaxTrainer
from hint_tpu_torch.parallel import Mesh, make_mesh, pad_rows, shard_batch
from hint_tpu_torch.parallel.dryrun import _lens_curves, gather_bits, spawn, special_rows
from hint_tpu_torch.parallel.mesh import check_backend
from hint_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
RANKS = 2


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _jax_trainer(mesh=None, **kw):
    hyper = dict(kind=JAX_UNCONDITIONAL, batch_size=world_side.BATCH, max_batches_per_epoch=1,
                 l2_weight_reg=world_side.L2, adam_betas=world_side.BETAS, noise_std=0.0)
    model = jax_builders.hint(dim=world_side.DIM, n_blocks=world_side.N_BLOCKS, c_internal=world_side.C_INTERNAL)
    return JaxTrainer(model=model, mesh=mesh, **{**hyper, **kw})


def _local_grads(params, x):
    """The port's single-process gradient of the mean loss over rows x, per
    trainable leaf, and the step's trainer and state."""
    tr = Trainer(model=world_side.small_model(), kind="unconditional", device="cpu", noise_std=0.0,
                 l2_weight_reg=world_side.L2, adam_betas=world_side.BETAS)
    state = world_side._load(tr, params)
    tr._loss(torch.from_numpy(x), None)[0].backward()
    return {k: p.grad.numpy().copy() for k, p in state.opt.params.items()}


def _clamp_rows(params, base):
    """Rows whose first half (rank 0's) gives gradient entries past the
    clamp of 5 where the whole batch's stay inside it."""
    for scale in (2, 4, 8, 16, 32, 64):
        x = base.copy()
        x[: len(x) // 2] *= scale
        g0, g1 = _local_grads(params, x[: len(x) // 2]), _local_grads(params, x[len(x) // 2 :])
        if any(((np.abs(g0[k]) > 6) & (np.abs((g0[k] + g1[k]) / 2) < 4)).any() for k in g0):
            return x
    raise AssertionError("no scale puts one rank's gradient past the clamp")


def _inputs():
    rng = np.random.default_rng(0)
    trainer = _jax_trainer()
    params = dict(_flat(jax.device_get(trainer.init_state(jax.random.PRNGKey(0)).params)))
    x = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    steps = x(world_side.STEPS, world_side.BATCH, world_side.DIM)
    steps = steps + 0.01 * x(*steps.shape)  # noised beforehand: noise_std=0 in both packages
    base = np.unique(x(300, 3), axis=0)
    pool_y = np.concatenate([base, base[:200], base[:201]])  # 701 rows, duplicates tie across chunks
    return {
        **{f"param:{k}": v for k, v in params.items()},
        "x_steps": steps,
        "x_clamp": _clamp_rows(params, x(world_side.BATCH, world_side.DIM)),
        "x_eval": x(world_side.BATCH, world_side.DIM),
        "pool_x": np.arange(len(pool_y), dtype=np.float32)[:, None],
        "pool_y": pool_y,
        "pool_target": base[5] + 0.01,
        "mmd_x": x(64, 20),
        "mmd_y": 0.8 * x(64, 20) + 0.3,
        "lens_curves": _lens_curves(11, 3),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's]) of one 2-rank gloo world,
    also saved to ``results.npz`` beside the inputs."""
    tmp = tmp_path_factory.mktemp("world")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    results = spawn(world_side.run, RANKS, str(tmp / "inputs.npz"), backend="gloo", device="cpu", timeout_s=60)
    np.savez(tmp / "results.npz", **{f"rank{r}|{k}": v for r, res in enumerate(results) for k, v in res.items()})
    return inputs, results


def _params(inputs):
    return {k.split(":", 1)[1]: v for k, v in inputs.items() if k.startswith("param:")}


def _tree(result, prefix):
    return {k.split(":", 1)[1]: v for k, v in result.items() if k.startswith(prefix + ":")}


def _assert_tree_close(got, ref, tol=TOL):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol, err_msg=k)


# -- the mesh -------------------------------------------------------------------------------


def test_collectives_mesh_and_registry(world):
    _, results = world
    for rank, res in enumerate(results):
        np.testing.assert_array_equal(res["gathered"], np.array([[1.0] * 3, [2.0] * 3, [2.0] * 3], np.float32))
        np.testing.assert_array_equal(res["reduced"], np.arange(4.0) * 3)
        np.testing.assert_array_equal(res["mesh"], [rank, RANKS, RANKS])
        assert "the world runs backend='gloo', not 'nccl'" in res["backend_error"]
        assert str(res["registry_device"]) == "cpu"
        np.testing.assert_array_equal(res["subgroup"], [0, 1] if rank == 0 else [-1, -1])
        np.testing.assert_array_equal(res["subgroup_sum"], [1.0, 1.0] if rank == 0 else [])


def _expected_gathers(ranks: int) -> dict:
    """What ``dryrun.gather_bits`` must return over ``ranks`` ranks: each
    rank's rows in rank order, bit for bit."""
    out = {}
    for dtype, int_dtype in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
        rows = torch.cat([special_rows(r, dtype) for r in range(ranks)])
        out[f"gather_bits_{str(dtype).split('.')[1]}"] = rows.view(int_dtype)
    out["map_rows_bits"] = torch.neg(torch.zeros(7, 3)).view(torch.int32)
    return out


@pytest.mark.parametrize("ranks", [1, RANKS], ids=["one_rank", "two_ranks"])
def test_all_gather_rows_and_map_rows_keep_every_bit(world, tmp_path, ranks):
    """-0.0, ±Inf and NaN payloads in f32 and bf16 rows, ragged over the
    ranks, come back bit for bit; ``map_rows`` of a function that returns
    -0.0 returns -0.0 (a sum of the values would give +0.0)."""
    if ranks == 1:
        with world_side.one_rank_mesh(tmp_path) as mesh:
            results = [gather_bits(mesh)]
    else:
        results = world[1]
    expected = _expected_gathers(ranks)
    assert (expected["map_rows_bits"] == torch.tensor(-0.0).view(torch.int32)).all()
    for res in results:
        for key, ref in expected.items():
            got = torch.from_numpy(res[key])
            assert got.dtype == ref.dtype and torch.equal(got, ref), key


def test_pad_rows_and_shard_batch_take_contiguous_blocks():
    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    padded, n = pad_rows(a, 4, value=-1.0)
    assert n == 5 and padded.shape == (8, 2) and (padded[5:] == -1).all()
    t, n = pad_rows(torch.from_numpy(a), 5)
    assert n == 5 and torch.equal(t, torch.from_numpy(a))
    meshes = [Mesh(group=None, rank=r, size=4, axis_names=("data",), device=torch.device("cpu"), backend="gloo")
              for r in range(4)]
    blocks = [shard_batch(padded, m) for m in meshes]
    np.testing.assert_array_equal(np.concatenate(blocks), padded)  # rank order is row order
    assert all(b.shape == (2, 2) for b in blocks)
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch(a, meshes[1])


def test_nccl_without_a_card_and_a_missing_world_raise():
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        check_backend("nccl", 1)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        spawn(world_side.run, RANKS, "unused.npz", backend="nccl")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):  # the default: NCCL on CUDA, never the CPU
        spawn(world_side.run, RANKS, "unused.npz")
    with pytest.raises(ValueError, match="backend must be one of"):
        check_backend("mpi", 1)
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(device="cpu")


def test_no_string_names_m8_in_the_port():
    out = subprocess.run(["git", "grep", "-n", "-I", "-e", r"\bM8\b", "--", "hint_tpu_torch"],
                         cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 1 and not out.stdout, out.stdout


# -- training -------------------------------------------------------------------------------


def test_init_state_broadcasts_rank_0s_parameters(world):
    _, results = world
    single = Trainer(model=world_side.small_model(), kind="unconditional", device="cpu")
    single.init_state(0)
    ref = {k: v.numpy() for k, v in single.model.state_dict().items()}
    for res in results:  # rank 1 drew from seed 1 and received rank 0's
        got = _tree(res, "init")
        assert set(got) == set(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)


@pytest.mark.parametrize("jax_devices", [1, 8], ids=["single_device", "mesh8"])
def test_dp_step_matches_hint_tpu(world, jax_devices):
    """One step over 2 ranks equals hint_tpu's single-device step and its
    8-device-mesh step on the same parameters and rows."""
    inputs, results = world
    mesh = jax_make_mesh(8) if jax_devices == 8 else None
    trainer = _jax_trainer(mesh)
    state = trainer.init_state(jax.random.PRNGKey(0))
    x, y = jnp.asarray(inputs["x_steps"][0]), jnp.zeros((world_side.BATCH, 0))
    if mesh is not None:
        x, y = jax.device_put(x, batch_sharding(mesh)), jax.device_put(y, batch_sharding(mesh))
    new, terms = trainer.step_fn(state, x, y, jax.random.PRNGKey(2), jnp.asarray(world_side.LR))
    ref = dict(_flat(jax.device_get(new.params)))
    for res in results:
        np.testing.assert_allclose(res["terms0"], np.asarray(terms), rtol=0, atol=TOL)
        _assert_tree_close(_tree(res, "params1"), ref)


def test_dp_trajectory_matches_hint_tpu(world):
    inputs, results = world
    trainer = _jax_trainer()
    state = trainer.init_state(jax.random.PRNGKey(0))
    y, lr = jnp.zeros((world_side.BATCH, 0)), jnp.asarray(world_side.LR)
    for k in range(world_side.STEPS):
        state, terms = trainer.step_fn(state, jnp.asarray(inputs["x_steps"][k]), y, jax.random.PRNGKey(k), lr)
        np.testing.assert_allclose(results[0][f"terms{k}"], np.asarray(terms), rtol=0, atol=TOL)
    _assert_tree_close(_tree(results[0], "params3"), dict(_flat(jax.device_get(state.params))))


def test_replicas_are_bit_identical_after_three_steps(world):
    _, (r0, r1) = world
    a, b = _tree(r0, "params3"), _tree(r1, "params3")
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    for k in range(world_side.STEPS):
        np.testing.assert_array_equal(r0[f"terms{k}"], r1[f"terms{k}"])


def test_gradient_is_reduced_before_the_clamp(world):
    """Rank 0's rows push gradient entries past ±5 where the whole batch's
    stay inside: the first moment after one step is that of the whole
    batch's gradient, clamped, not the mean of the ranks' clamped ones."""
    inputs, results = world
    params, x = _params(inputs), inputs["x_clamp"]
    half = len(x) // 2
    g0, g1 = _local_grads(params, x[:half]), _local_grads(params, x[half:])
    single = Trainer(model=world_side.small_model(), kind="unconditional", device="cpu", noise_std=0.0,
                     l2_weight_reg=world_side.L2, adam_betas=world_side.BETAS)
    state = world_side._load(single, params)
    terms = single.train_step(state, torch.from_numpy(x), None, torch.Generator(), world_side.LR)
    ref = {k: v.numpy() for k, v in state.opt.mu.items()}
    b1 = world_side.BETAS[0]
    clamped_per_rank = {k: (1 - b1) * ((np.clip(g0[k], -5, 5) + np.clip(g1[k], -5, 5)) / 2
                                       + world_side.L2 * params[k]) for k in ref}
    for res in results:
        got = _tree(res, "clamp_mu")
        _assert_tree_close(got, ref, tol=1e-6)
        np.testing.assert_allclose(res["clamp_terms"], terms.numpy(), rtol=1e-6)
        assert max(float(np.abs(got[k] - clamped_per_rank[k]).max()) for k in ref) > 0.05
        _assert_tree_close(_tree(res, "clamp_params"), {k: v.numpy() for k, v in single.model.state_dict().items()})


@pytest.mark.parametrize("full_batch", [True, False], ids=["full_batch", "batched"])
def test_eval_epoch_matches_hint_tpu(world, full_batch):
    inputs, results = world
    trainer = _jax_trainer(batch_size=world_side.BATCH // 2, max_batches_per_epoch=2)
    state = trainer.init_state(jax.random.PRNGKey(0))
    ref = trainer.eval_epoch(state.params, jnp.asarray(inputs["x_eval"]), None, jax.random.PRNGKey(3),
                             full_batch=full_batch)
    for res in results:
        np.testing.assert_allclose(res["eval_full" if full_batch else "eval_batched"], ref, rtol=0, atol=TOL)


def test_undivided_rows_raise_as_in_hint_tpu(world):
    inputs, results = world
    for res in results:
        assert str(res["eval_undivided_error"]).startswith("ValueError: 63 rows do not divide over 2 ranks")
        assert str(res["step_undivided_error"]).startswith("ValueError: 63 rows do not divide over 2 ranks")
    trainer = _jax_trainer(mesh=jax_make_mesh(8))
    state = trainer.init_state(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="divisible by 8"):
        trainer.eval_epoch(state.params, jnp.asarray(inputs["x_eval"][:63]), None, jax.random.PRNGKey(3),
                           full_batch=True)


def test_checkpoint_and_monitor_run_on_rank_0_only(world):
    _, (r0, r1) = world
    assert {k: int(r0[f"calls:{k}"]) for k in ("checkpoint", "update_losses", "finish", "update_progress")} == {
        "checkpoint": 2, "update_losses": 2, "finish": 1, "update_progress": 2}
    assert all(int(r1[k]) == 0 for k in r1 if k.startswith("calls:"))
    assert np.isfinite(r0["fit_final"]) and r0["fit_final"] == r1["fit_final"]


# -- evaluation -----------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["unconditional", "two_lane", "rcinn"])
def test_sharded_sampling_matches_unsharded(world, family):
    _, results = world
    for res in results:
        for n in (16, 11):  # 11 rows pad to 12
            got, ref = res[f"sample_{family}_{n}_sharded"], res[f"sample_{family}_{n}_unsharded"]
            assert got.shape == ref.shape and ref.shape[0] == n and np.isfinite(ref).all()
            np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("chunk", [333, 16_000_000])
def test_quantile_abc_selects_hint_tpus_rows(world, chunk):
    """A 701-row pool with duplicate rows: the same rows (ties included) as
    hint_tpu's quantile_ABC on its 8-device mesh, on both ranks."""
    inputs, results = world
    ref, thr = jax_abc.quantile_ABC(inputs["pool_x"], inputs["pool_y"], inputs["pool_target"], n=50,
                                    device_chunk=chunk, mesh=jax_make_mesh(8))
    for res in results:
        np.testing.assert_array_equal(res[f"abc_{chunk}"], ref)
        assert float(res[f"abc_{chunk}_threshold"]) == thr
        np.testing.assert_array_equal(res["abc_tensor_pool"], res["abc_333"])


@pytest.mark.parametrize("n", [64, 63], ids=["sharded", "undivided"])
def test_multi_mmd_matches_hint_tpus_sharded_value(world, n):
    inputs, results = world
    ref = float(jax_mmd(jnp.asarray(inputs["mmd_x"][:n]), jnp.asarray(inputs["mmd_y"][:n]), mesh=jax_make_mesh(8)))
    for res in results:
        np.testing.assert_allclose(float(res[f"mmd_{n}"]), ref, rtol=TOL, atol=0)


@pytest.mark.parametrize("what", ["lens", "iou", "dice"])
def test_shape_fits_and_iou_dice_sharded_match_unsharded(world, what):
    """The lens fits (the plus fits share ``_fit_batch`` and its sharding;
    ``chip_smoke.py`` phase 15 holds them on the card) and IoU/DICE."""
    _, results = world
    for res in results:
        got, ref = res[f"{what}_sharded"], res[f"{what}_unsharded"]
        assert got.shape == ref.shape and np.isfinite(ref).all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_dryrun_at_tiny_size(world):
    """``parallel.dryrun`` over 2 ranks: every path ran (``_score_shapes``
    under the mesh among them), and both ranks hold the same results."""
    _, (r0, r1) = world
    a, b = _tree(r0, "dryrun"), _tree(r1, "dryrun")
    assert a["samples"].shape == (9, 100) and a["gt"].shape == (8, 100) and a["iou"].shape == (3,)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.isfinite(np.asarray(a[k], np.float64)).all(), k
