"""The port's campaign (``hint_tpu_torch/experiments/campaign.py``) against
``hint_tpu``'s: its constants, the report on the committed campaign record
and on fixtures, the report's helpers, the samplers of all four model kinds
on the same weights, checkpoints in both directions, the train log, shape
scores on fixed curves, comparisons on a tiny pool with a shared sampler,
the UCI and figure stages without their inputs, and ``main``'s command
lines. Tiny widths throughout (``hidden=8``, ``c_internal=(8, 4)``); no
data set at reference size.

Tolerances: report texts identical (the same records, the same formatting);
sampled x within 1e-5 of 1+|ref| in f32 (the same weights through other
matmul orders); shape scores and MMDs within 1e-5 (the same curves and
draws; the shape fits agree to ~5e-7, the MMD sums in other orders).
"""

import dataclasses
import functools
import glob
import json
import os
import pickle
import shutil
import types

import jax
import numpy as np
import pytest
import torch

import hint_tpu.configs.registry_data as jax_registry
import hint_tpu_torch.configs.registry_data as port_registry
from hint_tpu.configs import get_config as jax_config
from hint_tpu.experiments import campaign as jax_campaign
from hint_tpu_torch.configs import get_config
from hint_tpu_torch.convert import params_from_numpy
from hint_tpu_torch.experiments import campaign

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
# tiny widths per model kind, the HAC trees cut to one split: (config, overrides)
KINDS = {
    "inn": ("lens_shape.unconditional_inn_1", dict(hidden=8)),
    "cinn": ("lens_shape.conditional_cinn_1", dict(hidden=8)),
    "hint": ("lens_shape.unconditional_hint_1_full", dict(hidden=8, c_internal=(8, 4), max_splits=1)),
    "conditional_hint": ("lens_shape.conditional_hint_1_full",
                         dict(hidden=8, c_internal=(8, 4), max_splits=1, hidden_y=4)),
}
# a training run cut to one epoch of two batches on 128 generated rows
CUT = dict(n_epochs=1, batch_size=64, n_train=128, n_test=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shrink(monkeypatch, name, **overrides):
    """The same config override in both packages' registries."""
    for reg in (port_registry, jax_registry):
        monkeypatch.setitem(reg.CONFIGS, name, {**reg.CONFIGS[name], **overrides})


def _both_dirs(monkeypatch, path):
    for mod in (campaign, jax_campaign):
        monkeypatch.setattr(mod, "CAMPAIGN_DIR", str(path))


# -- constants ---------------------------------------------------------------------------


def test_constants_are_hint_tpus():
    assert campaign.MODEL_SETS == jax_campaign.MODEL_SETS
    assert campaign.ABLATION_GRID == jax_campaign.ABLATION_GRID
    assert campaign.UCI_CONFIGS == jax_campaign.UCI_CONFIGS
    assert campaign.UCI_FILES == jax_campaign.UCI_FILES
    assert campaign.DATA_MODEL_NAME == jax_campaign.DATA_MODEL_NAME
    names = campaign.ABLATION_GRID + campaign.UCI_CONFIGS + [n for v in campaign.MODEL_SETS.values() for n in v]
    for name in names:
        assert get_config(name).is_conditional == jax_config(name).is_conditional, name
    for (_, kind), configs in campaign.MODEL_SETS.items():
        assert all(get_config(n).is_conditional == (kind == "conditional") for n in configs)
    # a difference by design: the port's runs never land in hint_tpu's record
    assert campaign.CAMPAIGN_DIR == os.path.join("artifacts", "campaign_torch")
    assert jax_campaign.CAMPAIGN_DIR == "artifacts/campaign"


# -- the report --------------------------------------------------------------------------


def _mixed_basis(root):
    """tests/test_campaign.py's fixture: a fresh run 0 next to its pool and
    archived runs 1-2 of an older, unrecorded basis."""
    abc_dir, arch = root / "abc", root / "camp" / "comparisons"
    abc_dir.mkdir(parents=True)
    arch.mkdir(parents=True)
    np.save(abc_dir / "lens-shape1_x_huge.npy", np.zeros((128, 20), np.float32))
    rec0 = {"lens_shape.conditional_cinn_4": {"mmds": [0.010], "rejects": [0.0], "dists": [0.10]}}
    with open(abc_dir / "lens-shape1_conditional_comparison_0.pkl", "wb") as f:
        pickle.dump(rec0, f)
    for run, mmd in ((1, 0.5), (2, 0.9)):
        rec = {"lens_shape.conditional_cinn_4": {"mmds": [mmd], "rejects": [0.0], "dists": [0.2]}}
        with open(arch / f"lens-shape1_conditional_comparison_{run}.pkl", "wb") as f:
            pickle.dump(rec, f)
    return str(root / "camp"), str(abc_dir)


@pytest.mark.parametrize("record", ["committed", "empty", "mixed_basis"])
def test_report_is_hint_tpus(tmp_path, monkeypatch, record):
    """Both packages' REPORT.md texts are identical: on a copy of the
    committed campaign (``artifacts/campaign/`` with the divergence probes,
    read through the relative ``artifacts``), on an empty record and on the
    mixed-basis fixture."""
    monkeypatch.chdir(tmp_path)
    abc_dir = str(tmp_path / "abc_empty")
    os.makedirs(abc_dir)
    if record == "committed":
        shutil.copytree(os.path.join(REPO, "artifacts", "campaign"), tmp_path / "artifacts" / "campaign",
                        ignore=shutil.ignore_patterns("*.npz"))
        for probe in glob.glob(os.path.join(REPO, "artifacts", "diverge_*.json")):
            shutil.copy(probe, tmp_path / "artifacts")
        camp = os.path.join("artifacts", "campaign")
    elif record == "empty":
        camp = str(tmp_path / "empty")
    else:
        camp, abc_dir = _mixed_basis(tmp_path)
    _both_dirs(monkeypatch, camp)
    ref = jax_campaign.stage_report(abc_dir=abc_dir)
    got = campaign.stage_report(abc_dir=abc_dir)
    assert got == ref
    with open(os.path.join(camp, "REPORT.md")) as f:
        assert f.read() == ref
    if record == "committed":
        assert "Ablation figures: " in got and "## Divergence analysis" in got
        assert "## plus shape fit" in got and "## lens conditional posterior/prior MMD" in got
    if record == "mixed_basis":
        assert "Run 1 excluded" in got and "mean ± std over 1 training run)" in got


@pytest.mark.parametrize("config", sorted(
    set(jax_campaign.ABLATION_GRID) | {n for v in jax_campaign.MODEL_SETS.values() for n in v}
    | {"plus_shape.unconditional_hint_4_full_reshuffle", "plus_shape.unconditional_hint_32_0_small"}))
def test_grid_key_is_hint_tpus(config):
    assert campaign._grid_key(config) == jax_campaign._grid_key(config)


@pytest.mark.parametrize("vals", [[], [1.25], [1.0, 2.0, 4.5], [np.nan, 1.0, 2.0], [np.nan], [np.nan, 3.0]])
@pytest.mark.parametrize("fmt", [".3f", ".4f"])
def test_mean_std_is_hint_tpus(vals, fmt):
    assert campaign._mean_std(vals, fmt) == jax_campaign._mean_std(vals, fmt)


def test_divergence_section_is_hint_tpus(tmp_path):
    steps = [{"epoch": 0, "batch": i, "lr": 3e-4, "loss": [1.0, -2.0], "max_abs_logdet": 100.0,
              "max_abs_z": 3.0, "grad_norm": 150.0, "grad_max": 4.0} for i in range(5)]
    blown = dict(steps[-1], epoch=3, batch=0, lr=7.6e-3, loss=[1e30, 5.0], grad_norm=float("inf"))
    with open(tmp_path / "diverge_cfgA_s0.json", "w") as f:
        json.dump({"config": "cfgA", "seed": 0, "steps": steps + [blown, dict(steps[-1], epoch=3, batch=1)]}, f)
    with open(tmp_path / "diverge_cfgB_s1.json", "w") as f:
        json.dump({"config": "cfgB", "seed": 1, "steps": steps}, f)
    for probe_dir in (str(tmp_path), os.path.join(REPO, "artifacts"), str(tmp_path / "none")):
        assert campaign._divergence_section(probe_dir) == jax_campaign._divergence_section(probe_dir)
    assert "| cfgB s1 | none in 5 steps" in "\n".join(campaign._divergence_section(str(tmp_path)))


# -- samplers and checkpoints ----------------------------------------------------------------


def _jax_state(name, overrides, seed=0):
    cfg = dataclasses.replace(jax_config(name), **overrides)
    trainer = cfg.make_trainer()
    return cfg, trainer, trainer.init_state(jax.random.PRNGKey(seed))


def _inputs(cfg, n=16):
    rng = np.random.default_rng(3)
    z = rng.standard_normal((n, cfg.ndim_x)).astype(np.float32)
    y = rng.standard_normal((n, 2)).astype(np.float32)
    return z, y


def _draw(samplers, name, cfg, z, y):
    out = samplers[name](y, z) if cfg.is_conditional else samplers[name](z)
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


@pytest.mark.parametrize("kind", list(KINDS))
def test_make_samplers_match_hint_tpus(monkeypatch, kind):
    """The same numpy parameters in both packages (``params_from_numpy``);
    the same z and y give the same x, through each package's
    ``make_samplers`` (unconditional ``f(z)``, conditional ``f(y, z)``)."""
    name, overrides = KINDS[kind]
    jcfg, jtrainer, jstate = _jax_state(name, overrides)
    params = jax.tree.map(np.asarray, jstate.params)
    monkeypatch.setattr(jax_campaign, "_load_state", lambda config, seed, dtype="float32": (jcfg, jtrainer, jstate))

    def port_load(config, seed, dtype="float32", impl="levelwise", device=None):
        cfg = dataclasses.replace(get_config(name), **overrides)
        trainer = cfg.make_trainer(impl=impl, device=device)
        state = trainer.init_state(0)
        trainer.model.load_state_dict(params_from_numpy(params), strict=True)
        return cfg, trainer, state

    monkeypatch.setattr(campaign, "_load_state", port_load)
    z, y = _inputs(jcfg)
    ref = _draw(jax_campaign.make_samplers([name], seed=0), name, jcfg, z, y)
    got = _draw(campaign.make_samplers([name], seed=0, device="cpu"), name, jcfg, z, y)
    assert got.shape == ref.shape == (16, jcfg.ndim_x) and np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - ref), TOL * (1 + np.abs(ref)))


def _samples_of(pkg, name, cfg, **engine):
    z, y = _inputs(cfg)
    return _draw(pkg.make_samplers([name], seed=0, **engine), name, cfg, z, y)


def test_checkpoints_cross_load_and_the_train_log(tmp_path, monkeypatch):
    """hint_tpu's ``stage_train`` checkpoint is read by the port's
    ``_load_state`` and the port's by hint_tpu's, with equal samplers; the
    port's train log has hint_tpu's keys and is the durable record; a
    removed checkpoint is replayed to the same weights."""
    name, overrides = KINDS["hint"]
    _shrink(monkeypatch, name, **overrides, **CUT)
    cache = str(tmp_path / "data")
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jax_campaign, "CAMPAIGN_DIR", str(jdir))
    monkeypatch.setattr(campaign, "CAMPAIGN_DIR", str(pdir))
    jax_campaign.stage_train("lens", seeds=(0,), cache_dir=cache, configs=[name])
    campaign.stage_train("lens", seeds=(0,), cache_dir=cache, configs=[name], device="cpu")
    key = f"{name}|s0|float32"
    jlog, plog = jax_campaign._read_log(), campaign._read_log()
    assert set(plog) == set(jlog) == {key} and set(plog[key]) == set(jlog[key])
    assert np.isfinite(plog[key]["final_test_loss"]) and plog[key]["n_epochs"] == 1
    cfg = get_config(name)
    ckpt = os.path.basename(campaign._ckpt_path(name, 0))
    assert ckpt == os.path.basename(jax_campaign._ckpt_path(name, 0))

    # each package's checkpoint in the other's directory, the same samplers
    jax_file, port_file = str(jdir / ckpt), str(pdir / ckpt)
    for src, dst in ((jax_file, str(tmp_path / "j.npz")), (port_file, str(tmp_path / "p.npz"))):
        shutil.copy(src, dst)
    for theirs in (str(tmp_path / "j.npz"), str(tmp_path / "p.npz")):
        shutil.copy(theirs, jax_file)
        shutil.copy(theirs, port_file)
        ref = _samples_of(jax_campaign, name, cfg)
        got = _samples_of(campaign, name, cfg, device="cpu")
        np.testing.assert_array_less(np.abs(got - ref), TOL * (1 + np.abs(ref)))

    # the log is the durable record: no retrain for a removed checkpoint
    shutil.copy(str(tmp_path / "p.npz"), port_file)
    os.remove(port_file)
    campaign.stage_train("lens", seeds=(0,), cache_dir=cache, configs=[name], device="cpu")
    assert not os.path.exists(port_file) and campaign._read_log()[key] == plog[key]
    # ... and _load_state replays it to the weights it had
    monkeypatch.setattr(campaign, "_retrain_ckpt", functools.partial(campaign._retrain_ckpt, cache_dir=cache))
    campaign._load_state(name, 0, device="cpu")
    with np.load(port_file) as a, np.load(str(tmp_path / "p.npz")) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)


# -- shape scores and comparisons -------------------------------------------------------------


def test_stage_shapes_matches_hint_tpus(tmp_path, monkeypatch):
    """``sample_model`` replaced in both packages by the same 64 prior
    curves, one of them rejected: the records agree, ``seconds`` aside."""
    from hint_tpu.evaluation import sampling as jax_sampling
    from hint_tpu_torch.data.fourier import LensShapeModel
    from hint_tpu_torch.evaluation import sampling

    configs = ["lens_shape.unconditional_hint_1_full"]
    _shrink(monkeypatch, campaign.family_configs("lens")[0], n_train=256, n_test=64)
    np.random.seed(0)
    curves = LensShapeModel().sample_prior(64).astype(np.float32)
    curves[5] = np.nan  # a rejected sample
    monkeypatch.setattr(jax_sampling, "sample_model", lambda *a, **k: curves)
    monkeypatch.setattr(sampling, "sample_model", lambda *a, **k: torch.from_numpy(curves))
    stub = types.SimpleNamespace(model=None, device=torch.device("cpu"))
    monkeypatch.setattr(jax_campaign, "_load_state",
                        lambda c, s, d="float32": (jax_config(c), stub, types.SimpleNamespace(params=None)))
    monkeypatch.setattr(campaign, "_load_state", lambda c, s, d="float32", **e: (get_config(c), stub, None))
    cache = str(tmp_path / "data")
    out = {}
    for pkg, sub in ((jax_campaign, "jax"), (campaign, "port")):
        monkeypatch.setattr(pkg, "CAMPAIGN_DIR", str(tmp_path / sub))
        os.makedirs(tmp_path / sub)
        pkg.stage_shapes("lens", n=64, seeds=(0,), cache_dir=cache, configs=configs)
        with open(tmp_path / sub / "shapes_lens.json") as f:
            out[sub] = json.load(f)
    assert set(out["port"]) == set(out["jax"]) == {f"{c}|s0" for c in configs}
    for key, ref in out["jax"].items():
        got = out["port"][key]
        assert set(got) == set(ref)
        assert got["n"] == ref["n"] == 64 and got["reject_rate"] == ref["reject_rate"] == 1 / 64
        for k in ("iou", "dice", "max_h", "avg_h", "corr_mse"):
            assert abs(got[k] - ref[k]) <= TOL * (1 + abs(ref[k])), (key, k, got[k], ref[k])


def _numpy_samplers(kind):
    """The same deterministic numpy sampler for each model of a kind."""
    names = campaign.MODEL_SETS[("lens", kind)][:2]
    if kind == "unconditional":
        return {n: (lambda z, s=0.5 + i: s * z + 0.1) for i, n in enumerate(names)}
    return {n: (lambda y, z, s=0.5 + i: s * z + np.tile(y, (1, 10))) for i, n in enumerate(names)}


@pytest.mark.parametrize("kind,n_runs", [("unconditional", 2), ("conditional", 3)])
def test_stage_compare_matches_hint_tpus(tmp_path, monkeypatch, kind, n_runs):
    """The same tiny pool and numpy samplers in both packages: the pickles
    have hint_tpu's layout and their MMDs and reject rates agree."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((600, 20)).astype(np.float32)
    y = rng.standard_normal((600, 2)).astype(np.float32)
    out = {}
    for pkg, sub in ((jax_campaign, "jax"), (campaign, "port")):
        abc_dir = tmp_path / sub
        os.makedirs(abc_dir)
        np.save(abc_dir / "lens-shape1_x_huge.npy", x)
        np.save(abc_dir / "lens-shape1_y_huge.npy", y)
        samplers = _numpy_samplers(kind)
        monkeypatch.setattr(pkg, "make_samplers", lambda *a, **k: samplers)
        np.random.seed(11)  # the conditional targets come from the global stream
        extra = {"device": "cpu"} if pkg is campaign else {}
        pkg.stage_compare("lens", kind, run=0, n_runs=n_runs, sample_size=200, abc_dir=str(abc_dir), **extra)
        with open(abc_dir / f"lens-shape1_{kind}_comparison_0.pkl", "rb") as f:
            out[sub] = pickle.load(f)
    ref, got = out["jax"], out["port"]
    assert set(got) == set(ref) and all(set(got[n]) == set(ref[n]) for n in ref)
    for n in ref:
        assert len(got[n]["mmds"]) == n_runs and np.isfinite(got[n]["mmds"]).all()
        for k in ("mmds", "rejects"):
            np.testing.assert_allclose(got[n][k], ref[n][k], rtol=TOL, atol=TOL, err_msg=f"{n} {k}")


# -- stages without their inputs, and main --------------------------------------------------


def test_stage_uci_prints_hint_tpus_lines_without_data(tmp_path, capsys):
    jax_campaign.stage_uci(uci_root=str(tmp_path))
    ref = capsys.readouterr().out
    campaign.stage_uci(uci_root=str(tmp_path), device="cpu")
    got = capsys.readouterr().out
    assert got == ref and "no datasets present" in got


def test_stage_figures_skips_without_checkpoints(tmp_path, monkeypatch):
    """No checkpoints and no pools: the five static figures, hint_tpu's file
    names, and every model panel skipped with a line."""
    pytest.importorskip("matplotlib")
    from hint_tpu_torch.monitor import figures

    monkeypatch.setattr(campaign, "CAMPAIGN_DIR", str(tmp_path / "camp"))
    # the dataset panels' prior correlation from 200 draws, not 10,000 (the
    # 2,000-draw one is held to hint_tpu's in tests/test_torch_port_figures.py)
    monkeypatch.setattr(figures, "plot_dataset_example",
                        functools.partial(figures.plot_dataset_example, n_samples=200))
    paths = campaign.stage_figures(seed=0, out_dir=str(tmp_path / "figs"), cache_dir=str(tmp_path / "cache"),
                                   abc_dir=str(tmp_path / "abc"), device="cpu")
    assert [os.path.basename(p) for p in paths] == [
        "general_example.png", "metrics_illustration.png", "parameter_sensitivity.png",
        "plus-shape_example.png", "lens-shape1_example.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)
    assert os.path.exists(tmp_path / "cache" / "plus-shape_corr.npy")


ARGVS = [
    ["data", "--family", "plus"],
    ["train", "--family", "lens", "--seeds", "0", "1", "--dtype", "bfloat16", "--configs", "a", "b",
     "--max-minutes", "3", "--require-ckpt"],
    ["pool", "--family", "plus", "--n", "200000"],
    ["compare", "--family", "plus", "--kind", "conditional", "--run", "1", "--n-runs", "5", "--sample-size", "400"],
    ["compare", "--family", "lens", "--kind", "unconditional", "--run", "0"],
    ["shapes", "--family", "plus", "--n", "100", "--seeds", "0", "--configs", "c"],
    ["grid", "--seeds", "0", "--n-shapes", "100", "--max-minutes", "5", "--configs", "d"],
    ["uci", "--uci-root", "u", "--seeds", "2", "--max-minutes", "1"],
    ["figures", "--seed", "1", "--n-abc-panels", "3"],
    ["report"],
]
STAGES = ["stage_data", "stage_train", "stage_pool", "stage_compare", "stage_shapes", "stage_grid", "stage_uci",
          "stage_figures", "stage_report"]


@pytest.mark.parametrize("argv", ARGVS, ids=[a[0] + str(i) for i, a in enumerate(ARGVS)])
def test_main_accepts_hint_tpus_command_lines(monkeypatch, argv):
    """Every command line of hint_tpu's ``main`` reaches the same stage with
    the same arguments; the port adds its engine (``--impl``, ``--device``)
    where a stage trains or samples."""
    import hint_tpu.utils

    calls = {}
    for pkg, side in ((jax_campaign, "jax"), (campaign, "port")):
        for stage in STAGES:
            monkeypatch.setattr(pkg, stage, lambda *a, _s=stage, _side=side, **k: calls.setdefault(_side, (_s, a, k)))
    monkeypatch.setattr(hint_tpu.utils, "enable_compilation_cache", lambda: None)
    jax_campaign.main(argv)
    campaign.main(argv)
    (js, ja, jk), (ps, pa, pk) = calls["jax"], calls["port"]
    assert ps == js and pa == ja
    engine = {k: pk.pop(k) for k in ("impl", "device") if k in pk}
    assert pk.items() >= jk.items() and set(pk) - set(jk) <= {"dtype"}
    trains_or_samples = js not in ("stage_data", "stage_pool", "stage_report")
    assert engine == ({"impl": "levelwise", "device": "cuda"} if trains_or_samples else {})
    campaign.main([*argv, "--impl", "fused", "--device", "cpu"] if trains_or_samples else argv)
