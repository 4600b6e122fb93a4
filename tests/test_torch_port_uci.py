"""The port's UCI path and experiment drivers against the JAX package: the
POWER, GAS and MINIBOONE loaders on crafted fixture files (the reference's
layout, ``uci_data/{power/data.npy, gas/ethylene_CO.pickle,
miniboone/data.npy}``; no real data is needed), a 6-step training
trajectory of a d=6 hint flow on POWER rows, the UCI log-likelihood lines of
``train`` and ``evaluate``, and the ``experiment`` subcommands on the CPU.

Tolerances: the loaders' arrays bit-identical (the same numpy code); the
trajectory's per-step losses, final leaves and full-batch log-likelihood
1e-4 (float32 sums in other orders through 6 Adam steps, the bound of
``tests/test_trajectory_parity.py``); hint_tpu's ``evaluate`` of the port's
checkpoint 0.01 nats (the packages draw other evaluation noise, σ = 0.01).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hint_tpu_torch.configs.registry_data as port_registry
from hint_tpu import cli as jax_cli
from hint_tpu.configs import get_config as jax_config
from hint_tpu.data import loaders as jax_loaders
from hint_tpu.data import uci as jax_uci
from hint_tpu.models import builders as jax_builders
from hint_tpu.train import checkpoint as jax_ckpt
from hint_tpu.train import optim as jax_optim
from hint_tpu.train.trainer import Trainer as JaxTrainer
from hint_tpu_torch import cli
from hint_tpu_torch.configs import get_config
from hint_tpu_torch.convert import params_from_numpy
from hint_tpu_torch.data import loaders, uci
from hint_tpu_torch.evaluation.metrics import uci_log_likelihood
from hint_tpu_torch.models import builders
from hint_tpu_torch.train.trainer import UNCONDITIONAL, Trainer

POWER = "uci_data.power_hint_4"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread in this file: its tests run many small ops (400
    SGD steps of a shape fit, short training runs), which slow down by
    orders of magnitude when every test worker of a shared machine spreads
    each op over all of its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def uci_root(tmp_path_factory):
    """POWER (8 raw columns; two are deleted to reach d=6), MINIBOONE
    (43 columns; the last is dropped after normalization) and, with pandas,
    a GAS frame whose correlation pruning drops columns."""
    root = tmp_path_factory.mktemp("uci")
    rng = np.random.default_rng(0)
    os.makedirs(root / "uci_data/power")
    np.save(root / "uci_data/power/data.npy", rng.standard_normal((3000, 8)) * np.arange(1, 9))
    os.makedirs(root / "uci_data/miniboone")
    np.save(root / "uci_data/miniboone/data.npy", rng.standard_normal((900, 43)).astype(np.float32))
    try:
        import pandas as pd
    except ImportError:
        return str(root)
    os.makedirs(root / "uci_data/gas")
    n = 1200
    base = rng.standard_normal((n, 10))
    frame = pd.DataFrame({"Meth": base[:, 0], "Eth": base[:, 1], "Time": np.arange(n, dtype=float)})
    for i in range(8):
        frame[f"S{i}"] = base[:, 2 + i % 8] + 0.01 * rng.standard_normal(n)
    frame["S8"] = frame["S0"] * 1.0001  # correlated with S0: pruned
    frame["S9"] = -frame["S1"]  # anti-correlated: kept (the threshold is signed)
    frame.to_pickle(root / "uci_data/gas/ethylene_CO.pickle")
    return str(root)


@pytest.mark.parametrize("name", ["Power", "Miniboone", "Gas"])
def test_uci_loaders_are_bit_identical_to_hint_tpus(uci_root, name):
    if name == "Gas":
        pytest.importorskip("pandas")
    ours, theirs = getattr(uci, name)(uci_root), getattr(jax_uci, name)(uci_root)
    assert ours.n_dims == theirs.n_dims == {"Power": 6, "Miniboone": 42, "Gas": 9}[name]
    for split in ("trn", "val", "tst"):
        np.testing.assert_array_equal(getattr(ours, split), getattr(theirs, split))
    data = np.vstack([ours.trn, ours.val])  # z-scored by train+val moments
    np.testing.assert_allclose(data.mean(axis=0), 0.0, atol=1e-6 if name != "Gas" else 0.1)
    key = name.lower()
    (x, y), (xt, yt) = loaders.prepare_uci_data(key, uci_root)
    (xr, yr), (xtr, ytr) = jax_loaders.prepare_uci_data(key, uci_root)
    for a, b in ((x, xr), (y, yr), (xt, xtr), (yt, ytr)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    cfg = {"Power": POWER, "Miniboone": "uci_data.miniboone_inn_8", "Gas": "uci_data.gas_hint_4"}[name]
    (x2, _), (xt2, _) = get_config(cfg).load_data("unused", uci_root)
    np.testing.assert_array_equal(x2, x)
    np.testing.assert_array_equal(xt2, xt)
    with pytest.raises(ValueError, match="Dataset not known"):
        loaders.prepare_uci_data("higgs", uci_root)


def test_power_replays_the_reference_recipe(tmp_path):
    """RandomState(42): shuffle, then voltage, gap and sub-metering noise,
    applied as hstack(gap, voltage, sm, time), after deleting columns 3
    then 1 (the replay of tests/test_uci_byte_parity.py)."""
    n = 50
    raw = np.arange(n * 8, dtype=np.float64).reshape(n, 8)
    os.makedirs(tmp_path / "uci_data/power")
    np.save(tmp_path / "uci_data/power/data.npy", raw)
    got = np.vstack(uci.Power.load_data_split_with_noise(str(tmp_path)))
    rng = np.random.RandomState(42)
    data = raw.copy()
    rng.shuffle(data)
    data = np.delete(np.delete(data, 3, axis=1), 1, axis=1)
    voltage, gap, sm = 0.01 * rng.rand(n, 1), 0.001 * rng.rand(n, 1), rng.rand(n, 3)
    np.testing.assert_array_equal(got, data + np.hstack([gap, voltage, sm, np.zeros((n, 1))]))


# -- training on UCI rows -------------------------------------------------------------------------

STEPS, BATCH = 6, 64


@pytest.mark.parametrize("impl", ["levelwise", "fused"])
def test_uci_trajectory_and_log_likelihood_match_hint_tpu(uci_root, impl):
    """A 2-block hint flow at d=6 (the POWER width; narrow c_internal) from
    hint_tpu's init, 6 steps on pre-noised POWER training rows with the
    power config's optimizer settings, then the full-batch test loss and its
    log-likelihood: per-step losses, leaves and LL within 1e-4."""
    (x_tr, _), (x_te, _) = loaders.prepare_uci_data("power", uci_root)
    rng = np.random.RandomState(3)
    rows = rng.choice(len(x_tr), (STEPS, BATCH), replace=False)
    batches = (x_tr[rows] + 0.01 * rng.randn(STEPS, BATCH, 6)).astype(np.float32)  # the injected noise
    cfg = get_config(POWER)
    hyper = dict(lr_init=cfg.lr_init, pre_low_lr=cfg.pre_low_lr, final_decay=cfg.final_decay, n_epochs=STEPS,
                 adam_betas=cfg.adam_betas, l2_weight_reg=cfg.l2_weight_reg, init_scale=cfg.init_scale,
                 batch_size=BATCH, noise_std=0.0)
    lrs = [jax_optim.lr_schedule(e, cfg.lr_init, cfg.pre_low_lr, cfg.final_decay, STEPS, "legacy")
           for e in range(STEPS)]
    jtr = JaxTrainer(model=jax_builders.hint(6, 2, (32, 16), perm_fixed=True), kind=UNCONDITIONAL, **hyper)
    state = jtr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, state.params)
    nk, none = jax.random.PRNGKey(99), jnp.zeros((BATCH, 0))  # inert: noise_std=0
    ref = []
    for k in range(STEPS):
        state, terms = jtr.step_fn(state, jnp.asarray(batches[k]), none, nk, float(lrs[k]))
        ref.append(float(np.asarray(terms).sum()))
    ref_test = float(np.asarray(jtr.eval_epoch(state.params, jnp.asarray(x_te), None, nk, full_batch=True)).sum())

    model = builders.hint(6, 2, (32, 16), perm_fixed=True, impl=impl, device="cpu")
    tr = Trainer(model=model, kind=UNCONDITIONAL, device="cpu", **hyper)
    ours = tr.init_state(0)
    ours.model.load_state_dict(params_from_numpy(init))
    g = torch.Generator().manual_seed(0)  # inert: noise_std=0
    losses = [float(tr.train_step(ours, torch.from_numpy(batches[k]), None, g, float(lrs[k])).sum())
              for k in range(STEPS)]
    np.testing.assert_allclose(losses, ref, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]
    final = ours.model.state_dict()
    for k, leaf in _leaves(jax.tree.map(np.array, state.params)):
        np.testing.assert_allclose(final[k].numpy(), leaf, rtol=0, atol=1e-4, err_msg=k)
    test = float(tr.eval_epoch(torch.from_numpy(x_te), None, g, full_batch=True).sum())
    ll, ref_ll = uci_log_likelihood(test, 6), -ref_test - 3 * np.log(2 * np.pi)
    np.testing.assert_allclose(ll, ref_ll, rtol=0, atol=1e-4)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _ll(line_name, text):
    return float(re.search(rf"^{line_name}: (-?[0-9.]+) nats$", text, re.M).group(1))


def test_cli_uci_train_and_evaluate_print_the_log_likelihood(uci_root, tmp_path, capsys):
    ckpt = str(tmp_path / "power.npz")
    args = ["--config", POWER, "--uci-root", uci_root, "--device", "cpu", "--impl", "fused"]
    final = cli.main(["train", *args, "--epochs", "2", "--max-batches", "2", "--batch-size", "256", "--save", ckpt])
    text = capsys.readouterr().out
    assert _ll("test log-likelihood", text) == round(uci_log_likelihood(final, 6), 3)
    total = cli.main(["evaluate", *args, "--ckpt", ckpt])
    text = capsys.readouterr().out
    ll = _ll("log-likelihood", text)
    assert ll == round(uci_log_likelihood(total, 6), 3) and "per-dim likelihood" in text
    # hint_tpu evaluates the port's checkpoint on the same full test batch
    jax_cli.main(["evaluate", "--config", POWER, "--uci-root", uci_root, "--ckpt", ckpt])
    assert abs(_ll("log-likelihood", capsys.readouterr().out) - ll) < 0.01
    with pytest.raises(FileNotFoundError, match="uci_data"):
        cli.main(["train", "--config", POWER, "--uci-root", str(tmp_path), "--device", "cpu"])


# -- the experiment subcommand ---------------------------------------------------------------------


def _shrink(monkeypatch, name, **fields):
    monkeypatch.setitem(port_registry.CONFIGS, name, {**port_registry.CONFIGS[name], **fields})


def test_experiment_uci_and_collect_uci_on_cpu(uci_root, tmp_path, monkeypatch, capsys):
    for name in (POWER, "uci_data.miniboone_hint_4"):
        _shrink(monkeypatch, name, n_epochs=2, max_batches_per_epoch=2)
    res = str(tmp_path / "results")
    out = cli.main(["experiment", "uci", POWER, "uci_data.miniboone_hint_4", "--uci-root", uci_root,
                    "--device", "cpu", "--impl", "fused", "--results-dir", res, "--runs", "2", "--verbose"])
    assert sorted(os.listdir(res)) == [
        "uci_data-miniboone_hint_4.npy", "uci_data-miniboone_hint_4_0.npz", "uci_data-miniboone_hint_4_1.npz",
        "uci_data-power_hint_4.npy", "uci_data-power_hint_4_0.npz", "uci_data-power_hint_4_1.npz"]
    assert all(v.shape == (2,) and np.isfinite(v).all() for v in out.values())
    collected = cli.main(["experiment", "collect-uci", POWER, "uci_data.miniboone_hint_4", "--results-dir", res])
    for name, (mean, std) in collected.items():
        lls = uci_log_likelihood(out[name], get_config(name).ndim_x)
        np.testing.assert_allclose((mean, std), (lls.mean(), lls.std()), rtol=1e-12)
    text = capsys.readouterr().out
    assert "\\pm" in text and "ERROR" not in text
    # a checkpoint of the sweep evaluates in hint_tpu
    jax_cli.main(["evaluate", "--config", POWER, "--uci-root", uci_root, "--ckpt",
                  os.path.join(res, "uci_data-power_hint_4_1.npz")])
    assert "log-likelihood" in capsys.readouterr().out


def test_experiment_shapes_collect_and_likelihood_on_cpu(tmp_path, monkeypatch, capsys):
    name = "lens_shape.unconditional_hint_1_full"
    _shrink(monkeypatch, name, n_epochs=1, max_batches_per_epoch=2, batch_size=16, n_train=48, n_test=32)
    res, cache = str(tmp_path / "results"), str(tmp_path / "data")
    common = ["--results-dir", res, "--cache-dir", cache, "--device", "cpu"]
    cli.main(["experiment", "shapes", name, "--n-eval-samples", "8", "--impl", "fused", *common])
    stem = os.path.join(res, "lens_shape-unconditional_hint_1_full_0")
    metrics, sample = np.load(stem + ".npy"), np.load(stem + "_sample.npy")
    assert metrics.shape == (4,) and sample.shape == (8, 2, 5) and os.path.exists(stem + ".npz")
    means, _ = cli.main(["experiment", "collect-shapes", name, "--results-dir", res])[name]
    np.testing.assert_array_equal(means, metrics)
    x_tr = np.load(os.path.join(cache, "lens-shape1_x_train.npy"))
    np.save(os.path.join(cache, "lens-shape1_corr.npy"), np.corrcoef(x_tr.T))
    out = cli.main(["experiment", "likelihood", name, *common])
    (lik, _), (mse, _) = out[name]
    assert np.isfinite(lik) and np.isfinite(mse) and mse >= 0
    assert "ERROR" not in capsys.readouterr().out
    jtr = jax_config(name).make_trainer()  # the sweep's checkpoint is hint_tpu's to read too
    state = jax_ckpt.load_npz(stem + ".npz", jtr.init_state(jax.random.PRNGKey(0)), model=jtr.model)
    assert int(state.epoch) == 1 and int(state.opt.step) == 2


# -- the HAC kernels at the UCI widths (numpy emulations; the kernels run on the card only) ----------

UCI_BLOCKS = {"power": (6, (200, 100, 50, 25)), "miniboone": (42, (102, 51, 25, 12))}


@pytest.mark.parametrize("kind", list(UCI_BLOCKS))
def test_kernel_emulations_hold_at_the_uci_widths(kind):
    """The shallow UCI blocks (1-dimensional halves at the leaves, so the
    tensor-core route's k-steps and n8 tiles are mostly padding): the numpy
    emulations of both forward routes and of the backward kernels over a
    saving forward's buffer (split-row chunks of 128 rows at batch 300,
    under the weight kernel's 512) against the plain version, at the bounds
    of tests/test_torch_port_hac.py and tests/test_torch_port_backward.py
    (1e-5)."""
    from test_torch_port_backward import _plain_grads, emulate_backward, emulate_saving_forward
    from test_torch_port_hac import _emulate_kernel, _emulate_tc_kernel, _port_with_garbage, _x

    from hint_tpu_torch.ops import hac_fused

    dim, c_internal = UCI_BLOCKS[kind]
    hac = _port_with_garbage(dim=dim, seed=4, c_internal=c_internal)
    x = _x(37, dim, 4)
    rng = np.random.default_rng(dim)
    xb, r = rng.normal(size=(300, dim)).astype(np.float32), rng.normal(size=(300, dim)).astype(np.float32)
    q = rng.normal(size=(300,)).astype(np.float32)
    for rev in (False, True):
        with torch.no_grad():
            yp, ldp = hac_fused.plain_block(hac, torch.from_numpy(x), None, rev)
        for emulate in (_emulate_kernel, _emulate_tc_kernel):
            ye, lde = emulate(hac, x, None, rev)
            np.testing.assert_allclose(ye, yp.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(lde, ldp.numpy(), rtol=1e-5, atol=1e-5)
        ref = _plain_grads(hac, xb, None, r, q, rev)
        saved = emulate_saving_forward(hac, xb, None, rev)[2]
        got, partial, _ = emulate_backward(hac, saved, None, rev, r, q, rows_per_split=128)
        assert partial.shape[0] == 3
        for k in ref:
            assert np.max(np.abs(got[k] - ref[k])) / (1 + np.max(np.abs(ref[k]))) <= 1e-5, k
