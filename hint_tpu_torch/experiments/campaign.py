"""Reference-scale evaluation campaign, mean ± std over 3 training runs
(port of ``hint_tpu/experiments/campaign.py``).

Reproduces the reference's result protocol end to end
(rejection_sampling.py:216-243, run_experiments.py:97-167 and
run_uci_experiments.py:9 of the reference):

* 3 training seeds per config at the configs' own (reference) budgets:
  1M train / 100k test, 100 batches x 50 epochs for the toy families;
* ABC prior pools from the native generator, quantile-ABC ground-truth
  posteriors cached per target (the reference's cache layout);
* conditional comparisons over 1000 y-targets, unconditional ones over 100
  runs, latents shared across models (rejection_sampling.py:168-213);
* 1000-curve shape scores (run_experiments.py:115);
* a report of mean ± std over the 3 training runs.

Every stage is idempotent (it skips work whose artifact exists) and
resumable, so the campaign is driven stage by stage; the stages that train
or sample run on CUDA unless ``--device cpu`` is given, through the HAC
engine ``--impl`` (``fused``: the whole-block CUDA kernels):

    python -m hint_tpu_torch.experiments.campaign train --family plus --impl fused
    python -m hint_tpu_torch.experiments.campaign pool --family plus --n 10000000
    python -m hint_tpu_torch.experiments.campaign compare --family plus \
        --kind conditional --run 0 --impl fused
    python -m hint_tpu_torch.experiments.campaign shapes --family plus --n 1000
    python -m hint_tpu_torch.experiments.campaign report

File names and JSON keys are ``hint_tpu``'s (``train_log.json`` records
under ``"{config}|s{seed}|{dtype}"``, ``{config-with-dashes}_s{seed}.npz``
full-state checkpoints, ``shapes_{family}.json``, the ABC cache layout), so
each package reads the other's campaign. ``CAMPAIGN_DIR`` defaults to
``artifacts/campaign_torch``: a run of the port never writes into
``hint_tpu``'s committed ``artifacts/campaign/``. Seeds are ``hint_tpu``'s
numbers (``seed`` for the init, ``100 + seed`` for shape samples,
``seed + 4242`` for figures) on ``torch.Generator`` streams, so parity with
``hint_tpu`` is distributional wherever JAX's threefry drew.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import Dict, Optional

import numpy as np

CAMPAIGN_DIR = os.path.join("artifacts", "campaign_torch")

# the reference's accumulated model sets (rejection_sampling.py:218,232) plus
# the plus-shape flagship pairs
MODEL_SETS = {
    ("lens", "unconditional"): [
        "lens_shape.unconditional_inn_1",
        "lens_shape.unconditional_inn_2",
        "lens_shape.unconditional_hint_1_full",
        "lens_shape.unconditional_hint_2_full",
    ],
    ("lens", "conditional"): [
        "lens_shape.conditional_cinn_1",
        "lens_shape.conditional_cinn_2",
        "lens_shape.conditional_cinn_4",
        "lens_shape.conditional_cinn_8",
        "lens_shape.conditional_hint_1_full",
        "lens_shape.conditional_hint_2_full",
        "lens_shape.conditional_hint_4_full",
        "lens_shape.conditional_hint_8_full",
    ],
    ("plus", "unconditional"): [
        "plus_shape.unconditional_inn_4",
        "plus_shape.unconditional_hint_4_full",
    ],
    ("plus", "conditional"): [
        "plus_shape.conditional_cinn_4",
        "plus_shape.conditional_hint_4_full",
    ],
}

DATA_MODEL_NAME = {"lens": "lens-shape1", "plus": "plus-shape"}

# The reference's full plus-shape architecture-ablation train list
# (run_experiments.py:29-88, the commented-in blocks), in priority order:
# the depth/width story first (hint_{4,8,16,32}_{0..3,full}, inn_{4..32}),
# then the parameter-matched small/big grids, then the controls
# (reshuffle/constwidth/lessshrink/_Q) and the conditional extras. Configs
# already covered by MODEL_SETS are not repeated here.
ABLATION_GRID = [
    # depth sweep at default width + matching INNs
    "plus_shape.unconditional_hint_4_1",
    "plus_shape.unconditional_hint_8_1",
    "plus_shape.unconditional_hint_16_1",
    "plus_shape.unconditional_hint_4_2",
    "plus_shape.unconditional_hint_8_2",
    "plus_shape.unconditional_hint_4_3",
    "plus_shape.unconditional_hint_8_full",
    "plus_shape.unconditional_inn_8",
    "plus_shape.unconditional_inn_16",
    "plus_shape.unconditional_inn_32",
    # conditional extras (rejection_sampling.py:232 accumulates the _8 pair)
    "plus_shape.conditional_cinn_8",
    "plus_shape.conditional_hint_8_full",
    "plus_shape.conditional_recursive_cinn_4",
    # parameter-matched small grid
    "plus_shape.unconditional_hint_4_0_small",
    "plus_shape.unconditional_hint_8_0_small",
    "plus_shape.unconditional_hint_16_0_small",
    "plus_shape.unconditional_hint_32_0_small",
    "plus_shape.unconditional_hint_4_1_small",
    "plus_shape.unconditional_hint_8_1_small",
    "plus_shape.unconditional_hint_16_1_small",
    "plus_shape.unconditional_hint_4_2_small",
    "plus_shape.unconditional_hint_8_2_small",
    "plus_shape.unconditional_hint_4_3_small",
    # parameter-matched big grid
    "plus_shape.unconditional_hint_4_0_big",
    "plus_shape.unconditional_hint_8_0_big",
    "plus_shape.unconditional_hint_16_0_big",
    "plus_shape.unconditional_hint_32_0_big",
    "plus_shape.unconditional_hint_4_1_big",
    "plus_shape.unconditional_hint_8_1_big",
    "plus_shape.unconditional_hint_16_1_big",
    "plus_shape.unconditional_hint_4_2_big",
    "plus_shape.unconditional_hint_8_2_big",
    "plus_shape.unconditional_hint_4_3_big",
    # controls
    "plus_shape.unconditional_hint_4_3_reshuffle",
    "plus_shape.unconditional_hint_4_3_constwidth",
    "plus_shape.unconditional_hint_4_3_lessshrink",
    "plus_shape.unconditional_inn_4_Q",
]


def family_configs(family: str):
    return MODEL_SETS[(family, "unconditional")] + MODEL_SETS[(family, "conditional")]


def _ckpt_path(config: str, seed: int, dtype: str = "float32") -> str:
    tag = "" if dtype == "float32" else f"_{dtype}"
    return os.path.join(CAMPAIGN_DIR, f"{config.replace('.', '-')}_s{seed}{tag}.npz")


def _log_path() -> str:
    return os.path.join(CAMPAIGN_DIR, "train_log.json")


def _read_log() -> Dict:
    try:
        with open(_log_path()) as f:
            return json.load(f)
    except (OSError, ValueError):  # none yet, or unreadable: start a new one
        return {}


def _write_log(log: Dict) -> None:
    with open(_log_path(), "w") as f:
        json.dump(log, f, indent=2, sort_keys=True)


def _data_model(family: str):
    from hint_tpu_torch.data.fourier import LensShapeModel, PlusShapeModel

    return LensShapeModel() if family == "lens" else PlusShapeModel()


def _load_on_device(cfg, trainer, **where):
    """The config's (train, test) splits, each uploaded once to the
    trainer's device as (x, y); ``y`` is None for an unconditional config."""
    from hint_tpu_torch.experiments.drivers import _on_device

    return tuple(_on_device(cfg, split, trainer.device) for split in cfg.load_data(**where))


# -- stages ---------------------------------------------------------------------------


def stage_data(family: str, cache_dir: str = "data") -> None:
    """Generate + cache the toy datasets at the configs' reference sizes."""
    from hint_tpu_torch.configs import get_config

    cfg = get_config(family_configs(family)[0])
    cfg.load_data(cache_dir)
    print(f"{family}: train/test caches ready ({cfg.n_train}/{cfg.n_test})")


def _liveness_heartbeat(tag: str, n_epochs: int, every_s: float = 300.0):
    """Per-epoch ``checkpoint_fn`` that prints a flushed liveness line at
    most every ``every_s`` seconds: a long training unit is otherwise silent
    until its final summary line, and a supervisor that watches the log
    cannot tell it from a hung one."""
    t_last = [time.time()]

    def hb(_state, epoch):
        now = time.time()
        if now - t_last[0] >= every_s:
            print(f"  {tag}: epoch {epoch + 1}/{n_epochs} in progress", flush=True)
            t_last[0] = now

    return hb


def stage_train(
    family: str,
    seeds=(0, 1, 2),
    cache_dir: str = "data",
    dtype: str = "float32",
    configs=None,
    max_minutes: Optional[float] = None,
    require_ckpt: bool = False,
    impl: str = "levelwise",
    device=None,
) -> None:
    """Train every (config, seed) at the reference budget; skip existing
    checkpoints; record final test losses + wall-clock in train_log.json.

    ``require_ckpt=True`` treats only an on-disk .npz as done: checkpoints
    are bulk that may be cleaned up while the train log stays, and the
    comparison and figure stages need the weights back. Retrains are
    reproducible (cached data, ``seed`` init), so the refreshed log entry is
    checked against the old one and a final-loss drift > 0.05 nats is
    reported loudly instead of silently absorbed."""
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.train import checkpoint

    os.makedirs(CAMPAIGN_DIR, exist_ok=True)
    t_stage = time.time()
    for config in configs or family_configs(family):
        log = _read_log()
        if all(
            os.path.exists(_ckpt_path(config, s, dtype))
            or (not require_ckpt and f"{config}|s{s}|{dtype}" in log)
            for s in seeds
        ):
            continue  # nothing to do: don't pay the dataset load
        cfg = get_config(config)
        # shared across seeds; built before the dataset load, so that a
        # device that cannot be used fails before it
        trainer = cfg.make_trainer(compute_dtype=dtype, impl=impl, device=device)
        train, test = _load_on_device(cfg, trainer, cache_dir=cache_dir)
        for seed in seeds:
            path = _ckpt_path(config, seed, dtype)
            key = f"{config}|s{seed}|{dtype}"
            # the train_log is the durable record of a finished run; the
            # .npz checkpoint is a scoring convenience that may have been
            # cleaned up. Either one means done unless the caller needs the
            # weights back (require_ckpt)
            if os.path.exists(path) or (not require_ckpt and key in _read_log()):
                continue
            if max_minutes and (time.time() - t_stage) / 60 > max_minutes:
                print("stage time budget reached; re-invoke to continue")
                return
            t0 = time.time()
            state, final = trainer.fit(
                seed, train, test, full_batch_test=cfg.is_uci,
                checkpoint_fn=_liveness_heartbeat(key, cfg.n_epochs),
            )
            minutes = (time.time() - t0) / 60
            checkpoint.save_npz(path, state)
            log = _read_log()
            prev = log.get(key)
            if prev is not None and np.isfinite(prev.get("final_test_loss", np.nan)):
                drift = abs(float(final) - prev["final_test_loss"])
                if not np.isfinite(float(final)) or drift > 0.05:
                    print(
                        f"WARNING {key}: retrained final loss {float(final):.4f} "
                        f"drifts {drift:.4f} nats from the logged "
                        f"{prev['final_test_loss']:.4f}", flush=True,
                    )
            log[key] = {
                "final_test_loss": float(final),
                "per_dim_ll": float(-final / cfg.ndim_x),
                "minutes": minutes,
                "n_epochs": cfg.n_epochs,
                "batch_size": cfg.batch_size,
            }
            _write_log(log)
            print(f"{key}: loss={final:.4f} per-dim LL={-final/cfg.ndim_x:.4f} "
                  f"({minutes:.1f} min)", flush=True)


def stage_pool(family: str, n: int, abc_dir: str = "abc") -> None:
    from hint_tpu_torch.data.fourier import LensShapeModel, PlusShapeModel
    from hint_tpu_torch.evaluation.abc import prepare_samples

    factory = LensShapeModel if family == "lens" else PlusShapeModel
    prepare_samples(factory, n_total=n, out_dir=abc_dir, chunk=100_000)


def _retrain_ckpt(config: str, seed: int, dtype: str = "float32",
                  cache_dir: str = "data", impl: str = "levelwise", device=None) -> None:
    """Regenerate a cleaned-up checkpoint by replaying its training run.

    Campaign .npz checkpoints are bulk that may be deleted; the train_log
    entry is the durable record. Training is deterministic given (config,
    seed, dtype): the same init seed, the same cached dataset and the same
    device, so the replay reproduces the logged run."""
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.train import checkpoint

    cfg = get_config(config)
    trainer = cfg.make_trainer(compute_dtype=dtype, impl=impl, device=device)
    train, test = _load_on_device(cfg, trainer, cache_dir=cache_dir)
    print(f"replaying {config} seed {seed} ({dtype}) — checkpoint was cleaned up",
          flush=True)
    state, final = trainer.fit(
        seed, train, test, full_batch_test=cfg.is_uci,
        checkpoint_fn=_liveness_heartbeat(f"{config}|s{seed}", cfg.n_epochs),
    )
    key = f"{config}|s{seed}|{dtype}"
    logged = _read_log().get(key, {}).get("final_test_loss")
    if logged is not None and np.isfinite(logged):
        drift = abs(float(final) - logged)
        print(f"replay {key}: loss={float(final):.4f} "
              f"(logged {logged:.4f}, |drift|={drift:.2e})", flush=True)
    checkpoint.save_npz(_ckpt_path(config, seed, dtype), state)


def _load_state(config: str, seed: int, dtype: str = "float32", impl: str = "levelwise", device=None):
    """(cfg, trainer, state) of a campaign checkpoint on ``device``; a
    checkpoint that was cleaned up but stands in the train log is replayed
    first."""
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.train import checkpoint

    path = _ckpt_path(config, seed, dtype)
    if not os.path.exists(path) and f"{config}|s{seed}|{dtype}" in _read_log():
        _retrain_ckpt(config, seed, dtype, impl=impl, device=device)
    cfg = get_config(config)
    trainer = cfg.make_trainer(compute_dtype=dtype, impl=impl, device=device)
    state = checkpoint.load_npz(path, trainer.init_state(0))
    return cfg, trainer, state


def _sampler(cfg, model, device):
    """The shared-z comparison interface of one model: unconditional
    ``f(z) -> x``, conditional ``f(y_tiled, z) -> x``; the inverse runs
    under ``torch.no_grad()`` on ``device``, and its inputs are moved there
    once a call."""
    import torch

    from hint_tpu_torch.evaluation.sampling import sample_conditional

    def on_device(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    if cfg.model_type == "conditional_hint":
        def f(y, z):
            with torch.no_grad():
                return sample_conditional(model, on_device(y), None, z_x=on_device(z))
    elif cfg.is_conditional:
        def f(y, z):
            with torch.no_grad():
                return model.inverse(on_device(z), on_device(y))[0]
    else:
        def f(z):
            with torch.no_grad():
                return model.inverse(on_device(z))[0]
    return f


def make_samplers(configs, seed: int, dtype: str = "float32", impl: str = "levelwise", device=None) -> Dict:
    """(name -> sampler) for one training-run index, matching the
    reference's shared-z comparison interfaces: unconditional f(z) -> x,
    conditional f(y_tiled, z) -> x, each returning a tensor on the
    trainer's device."""
    samplers = {}
    for config in configs:
        cfg, trainer, _ = _load_state(config, seed, dtype, impl=impl, device=device)
        samplers[config] = _sampler(cfg, trainer.model, trainer.device)
    return samplers


def stage_compare(
    family: str,
    kind: str,
    run: int,
    n_runs: Optional[int] = None,
    sample_size: int = 4000,
    abc_dir: str = "abc",
    dtype: str = "float32",
    impl: str = "levelwise",
    device=None,
) -> None:
    """One comparison sweep for training-run index ``run``: all models of
    (family, kind) trained with seed=run, against the family's ABC pool.
    Idempotent: skips when the final comparison pickle exists."""
    from hint_tpu_torch.evaluation.abc import compare_conditional, compare_unconditional

    final = os.path.join(
        abc_dir, f"{DATA_MODEL_NAME[family]}_{kind}_comparison_{run}.pkl"
    )
    if os.path.exists(final):
        print(f"compare {family}/{kind} run {run}: cached")
        return
    configs = MODEL_SETS[(family, kind)]
    samplers = make_samplers(configs, run, dtype, impl=impl, device=device)
    dm = _data_model(family)
    if kind == "unconditional":
        compare_unconditional(
            dm, samplers, n_runs=n_runs or 100, sample_size=sample_size,
            abc_dir=abc_dir, run=run, seed=1000 + run, verbose=False, device=device,
        )
    else:
        compare_conditional(
            dm, samplers, n_runs=n_runs or 1000, sample_size=sample_size,
            abc_dir=abc_dir, run=run, seed=2000 + run, verbose=False, device=device,
        )
    print(f"compare {family}/{kind} run {run}: done")


def stage_shapes(
    family: str, n: int = 1000, seeds=(0, 1, 2), dtype: str = "float32",
    cache_dir: str = "data", configs=None, impl: str = "levelwise", device=None,
) -> None:
    """Reference-scale shape scoring (n=1000 samples per config, IoU / DICE /
    Hausdorff: run_experiments.py:115,135-167) plus the correlation-matrix
    MSE against the dataset's (run_experiments.py:211-221), per seed.
    Non-finite curves are dropped and counted, never resampled."""
    import torch

    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.evaluation.metrics import correlation_mse
    from hint_tpu_torch.evaluation.sampling import sample_model
    from hint_tpu_torch.experiments.drivers import _score_shapes

    out_path = os.path.join(CAMPAIGN_DIR, f"shapes_{family}.json")
    try:
        with open(out_path) as f:
            out = json.load(f)
    except (OSError, ValueError):  # none yet, or unreadable: score anew
        out = {}
    if all(
        f"{config}|s{seed}" in out
        for config in (configs or family_configs(family)) for seed in seeds
    ):
        return  # fully scored: skip the dataset load
    dm = _data_model(family)
    fam_key = "lens" if family == "lens" else "plus"
    # the ground-truth correlation from the cached training set (the
    # reference caches the dataset example's, plot_data.py:61-63; same
    # estimator, more rows)
    (x_tr, _), _ = get_config(family_configs(family)[0]).load_data(cache_dir)
    gt_corr = np.corrcoef(np.asarray(x_tr[:100_000]).T)
    for config in configs or family_configs(family):
        for seed in seeds:
            key = f"{config}|s{seed}"
            if key in out:
                continue
            cfg, trainer, _ = _load_state(config, seed, dtype, impl=impl, device=device)
            t0 = time.time()
            generator = torch.Generator(device=trainer.device).manual_seed(100 + seed)
            with torch.no_grad():
                x = sample_model(
                    cfg, trainer.model, n, generator,
                    y_target=cfg.vis_y_target if cfg.is_conditional else None,
                ).cpu().numpy()
            ok = np.isfinite(x).all(axis=1) & (np.abs(x).max(axis=1) < 1e3)
            metrics = _score_shapes(dm, x, fam_key, device=trainer.device)
            corr_mse = (
                correlation_mse(x[ok], gt_corr) if ok.sum() >= 3 and not cfg.is_conditional
                else float("nan")
            )
            out[key] = {
                "iou": float(metrics[0]), "dice": float(metrics[1]),
                "max_h": float(metrics[2]), "avg_h": float(metrics[3]),
                "n": n, "reject_rate": float(1 - ok.mean()),
                "corr_mse": corr_mse,
                "seconds": time.time() - t0,
            }
            with open(out_path, "w") as f:
                json.dump(out, f, indent=2, sort_keys=True)
            print(f"shapes {key}: iou={out[key]['iou']:.3f} "
                  f"rej={out[key]['reject_rate']:.3f} "
                  f"({out[key]['seconds']:.0f}s)", flush=True)


def stage_grid(
    seeds=(0, 1, 2), n_shapes: int = 1000, max_minutes: Optional[float] = None,
    configs=None, impl: str = "levelwise", device=None,
) -> None:
    """The reference's plus-shape architecture-ablation study
    (run_experiments.py:29-88 + eval_shapes.py:67-133): train every grid
    config at its reference budget and score n=1000 sampled curves, config
    by config, so that every finished config is a complete data point even
    if the stage is cut short. Idempotent at the (config, seed) level.

    Seed-major order: the full grid at seed 0 first (the reference's own
    protocol, run_experiments.py:10 sets ``n_runs = 1``), then the extra
    seeds; a run cut short yields full breadth before extra depth."""
    t0 = time.time()
    for seed in seeds:
        for config in configs or ABLATION_GRID:
            if max_minutes and (time.time() - t0) / 60 > max_minutes:
                print("grid time budget reached; re-invoke to continue")
                return
            stage_train("plus", seeds=(seed,), configs=[config], impl=impl, device=device)
            stage_shapes("plus", n=n_shapes, seeds=(seed,), configs=[config], impl=impl, device=device)


# the reference's UCI sweep (run_uci_experiments.py:11-26)
UCI_CONFIGS = [
    "uci_data.power_hint_4", "uci_data.power_hint_8",
    "uci_data.power_inn_4", "uci_data.power_inn_8",
    "uci_data.gas_hint_4", "uci_data.gas_hint_8",
    "uci_data.gas_inn_4", "uci_data.gas_inn_8",
    "uci_data.miniboone_hint_4", "uci_data.miniboone_hint_8",
    "uci_data.miniboone_inn_4", "uci_data.miniboone_inn_8",
]

# expected real-data layout (data.py:304,358,425 of the reference). The files
# are not redistributable, so the stage checks and skips cleanly until they
# appear.
UCI_FILES = {
    "power": "uci_data/power/data.npy",
    "gas": "uci_data/gas/ethylene_CO.pickle",
    "miniboone": "uci_data/miniboone/data.npy",
}


def uci_datasets_present(uci_root: str = ".") -> Dict[str, bool]:
    return {k: os.path.exists(os.path.join(uci_root, p)) for k, p in UCI_FILES.items()}


def stage_uci(
    uci_root: str = ".", seeds=(0, 1, 2), max_minutes: Optional[float] = None,
    impl: str = "levelwise", device=None,
) -> None:
    """The reference's central quantitative product: the 12-config × 3-run
    UCI sweep (run_uci_experiments.py:29-53), one command once the data
    files exist. Skips (naming the expected layout) when they don't;
    idempotent per (config, seed) through train_log.json."""
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.train import checkpoint

    present = uci_datasets_present(uci_root)
    runnable = [c for c in UCI_CONFIGS if present[c.split(".")[-1].split("_")[0]]]
    for name, ok in present.items():
        if not ok:
            print(f"uci: {name} data missing — expected {UCI_FILES[name]} "
                  f"under {os.path.abspath(uci_root)}; skipping its configs")
    if not runnable:
        print("uci: no datasets present; nothing to do")
        return
    os.makedirs(CAMPAIGN_DIR, exist_ok=True)
    t0 = time.time()
    for config in runnable:
        cfg = get_config(config)
        log = _read_log()
        todo = [
            s for s in seeds
            if f"{config}|s{s}|float32" not in log
            or not os.path.exists(_ckpt_path(config, s))
        ]
        if not todo:
            continue  # fully done: skip before paying the dataset load
        trainer = cfg.make_trainer(impl=impl, device=device)  # shared across seeds
        train, test = _load_on_device(cfg, trainer, uci_root=uci_root)
        for seed in todo:
            key = f"{config}|s{seed}|float32"
            path = _ckpt_path(config, seed)
            if max_minutes and (time.time() - t0) / 60 > max_minutes:
                print("uci stage time budget reached; re-invoke to continue")
                return
            t1 = time.time()
            state, final = trainer.fit(seed, train, test, full_batch_test=True)
            checkpoint.save_npz(path, state)
            log = _read_log()
            log[key] = {
                "final_test_loss": float(final),
                "per_dim_ll": float(-final / cfg.ndim_x),
                "ll_nats": float(-final - cfg.ndim_x / 2 * np.log(2 * np.pi)),
                "minutes": (time.time() - t1) / 60,
                "n_epochs": cfg.n_epochs,
                "batch_size": cfg.batch_size,
            }
            _write_log(log)
            print(f"{key}: LL={log[key]['ll_nats']:.3f} nats "
                  f"({log[key]['minutes']:.1f} min)", flush=True)


def stage_figures(
    seed: int = 0,
    out_dir: str = os.path.join("artifacts", "figures", "models"),
    cache_dir: str = "data",
    abc_dir: str = "abc",
    n_abc_panels: int = 2,
    impl: str = "levelwise",
    device=None,
):
    """The reference's paper-figure set (plot_data.py's ``__main__``
    products), drawn from trained campaign checkpoints: illustration
    figures, dataset example panels (which write the {name}_corr.npy prior
    correlation), the conditional correlation from the quantile-ABC pools at
    the flagship vis targets, sample panels of every MODEL_SETS config with
    a seed-``seed`` checkpoint, and model-vs-ABC posterior panels where
    per-target caches exist. Needs matplotlib."""
    import torch

    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.data.fourier import LensShapeModel, PlusShapeModel
    from hint_tpu_torch.evaluation.abc import quantile_ABC
    from hint_tpu_torch.monitor import figures

    LIMITS = {"plus-shape": (-4, 4, -4, 4), "lens-shape1": (-2.5, 2.5, -2.5, 2.5)}
    paths = [
        figures.plot_fouriercurve_example(out_dir=out_dir),
        figures.metrics_illustration(out_dir=out_dir),
        figures.show_parameter_sensitivity(out_dir=out_dir),
    ]
    for dm in (PlusShapeModel(), LensShapeModel()):
        paths.append(
            figures.plot_dataset_example(dm, limits=LIMITS[dm.name], out_dir=cache_dir)
        )
    # the conditional correlation from the campaign's quantile-ABC pools (the
    # reference derives the plus one by tol-0.05 rejection,
    # rejection_sampling.py:113-127, which evaluation.abc.correlation_conditional
    # carries; here the pool quantile is used so the stage reuses the pools)
    for family, dm_name in (("plus", "plus-shape"), ("lens", "lens-shape1")):
        f_corr = os.path.join(cache_dir, f"{dm_name}_corr_conditional.npy")
        fx = os.path.join(abc_dir, f"{dm_name}_x_huge.npy")
        if os.path.exists(f_corr) or not os.path.exists(fx):
            continue
        cfg = get_config(MODEL_SETS[(family, "conditional")][0])
        x = np.load(fx, mmap_mode="r")
        y = np.load(os.path.join(abc_dir, f"{dm_name}_y_huge.npy"), mmap_mode="r")
        sample, _ = quantile_ABC(x, y, np.asarray(cfg.vis_y_target, np.float32), device=device)
        np.save(f_corr, np.corrcoef(np.asarray(sample).T))
        print(f"figures: conditional corr GT -> {f_corr}", flush=True)
    for (family, kind), configs in MODEL_SETS.items():
        for config in configs:
            # a train_log record is enough: _load_state replays the run to
            # regenerate a cleaned-up checkpoint
            if not (os.path.exists(_ckpt_path(config, seed))
                    or f"{config}|s{seed}|float32" in _read_log()):
                print(f"figures: no seed-{seed} record for {config}, skipped",
                      flush=True)
                continue
            cfg, trainer, _ = _load_state(config, seed, impl=impl, device=device)

            def generator():  # one stream per figure, as hint_tpu reuses its key
                return torch.Generator(device=trainer.device).manual_seed(seed + 4242)

            lim = LIMITS[cfg.data_model().name]
            if kind == "unconditional":
                paths.append(figures.plot_model_unconditional(
                    cfg, trainer.model, generator(), limits=lim,
                    out_dir=out_dir, cache_dir=cache_dir))
            else:
                paths.append(figures.plot_model_conditional(
                    cfg, trainer.model, generator(), limits=lim,
                    out_dir=out_dir, cache_dir=cache_dir))
                for i in range(n_abc_panels):
                    try:
                        paths.append(figures.plot_model_conditional_abc(
                            cfg, trainer.model, generator(), i=i, limits=lim,
                            abc_dir=abc_dir, out_dir=out_dir))
                    except FileNotFoundError:
                        print(f"figures: no ABC target cache "
                              f"{abc_dir}/{cfg.data_model().name}/{i:05}.pkl — "
                              f"posterior panels for {config} skipped "
                              f"(run `campaign pool` + `compare` first)", flush=True)
                        break
            print(f"figures: {paths[-1]}", flush=True)
    return paths


def _mean_std(vals, fmt: str) -> str:
    """``mean ± std`` over the non-NaN entries; an em-dash when empty; an
    explicit ``(1 seed)`` marker instead of a fake ``± 0.0000`` when only a
    single value is available."""
    vals = np.asarray(list(vals), float)
    n = int(np.sum(~np.isnan(vals)))
    if n == 0:
        return "—"
    if n == 1:
        return f"{np.nanmean(vals):{fmt}} (1 seed)"
    return f"{np.nanmean(vals):{fmt}} ± {np.nanstd(vals):{fmt}}"


def _grid_key(config: str):
    """(kind, blocks, depth, size) parsed from a plus-shape config name;
    depth 9 encodes 'full'."""
    name = config.split(".")[-1]
    size = "small" if name.endswith("_small") else "big" if name.endswith("_big") else "base"
    core = name.removesuffix("_small").removesuffix("_big")
    parts = core.split("_")
    if parts[0] == "unconditional" and parts[1] == "hint" and len(parts) >= 4:
        depth = 9 if parts[3] == "full" else int(parts[3]) if parts[3].isdigit() else None
        if depth is not None and len(parts) == 4:
            return ("hint", int(parts[2]), depth, size)
    if parts[0] == "unconditional" and parts[1] == "inn" and len(parts) == 3:
        return ("inn", int(parts[2]), 0, size)
    return None


def _divergence_section(probe_dir: str = "artifacts") -> list:
    """Mechanism analysis of diverged grid runs, from instrumented reruns
    (``diverge_*.json`` under ``probe_dir``): per probed run, where the
    first blowup happened relative to the LR schedule."""
    import glob

    probes = sorted(glob.glob(os.path.join(probe_dir, "diverge_*.json")))
    if not probes:
        return []
    lines = ["## Divergence analysis (instrumented reruns)", "",
             "| run | first blowup | lr there | last stable gnorm | max\\|logdet\\| before | recovers? |",
             "|---|---|---|---|---|---|"]
    notes = []
    for path in probes:
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, ValueError):  # an unreadable probe is left out
            continue
        steps = d.get("steps", [])
        if not steps:
            continue

        def total(s):
            return sum(s["loss"]) if isinstance(s["loss"], list) else s["loss"]

        bad = [i for i, s in enumerate(steps)
               if not np.isfinite(total(s)) or abs(total(s)) > 1e6
               or not np.isfinite(s.get("grad_norm", 0.0))]
        run = f"{d.get('config', os.path.basename(path))} s{d.get('seed', '?')}"
        if not bad:
            lines.append(f"| {run} | none in {len(steps)} steps | — | — | — | n/a |")
            continue
        i = bad[0]
        s, prev = steps[i], steps[max(0, i - 1)]
        later_ok = any(
            np.isfinite(total(t)) and abs(total(t)) < 1e3 for t in steps[i + 1:]
        )
        lines.append(
            f"| {run} | e{s['epoch']} b{s['batch']} (step {i}) | {s['lr']:.2e} "
            f"| {prev['grad_norm']:.1e} | {prev['max_abs_logdet']:.0f} "
            f"| {'yes, then re-blows' if later_ok else 'no'} |"
        )
        notes.append((run, s, prev))
    if notes:
        lines += ["",
            "Mechanism: every probed blowup lands within ~10 steps of the "
            "warmup exit — the reference LR schedule (train_unconditional.py: "
            "pre_low_lr epochs at 3e-4, then a ×25 step to lr_init ≈ 7.6e-3) "
            "is the trigger in both cases, with two severities. "
            "hint_16_0_big (the 519-wide depth-0 stack) leaves warmup "
            "already hot — gnorm ≈ 1e4, per-sample |logdet| ≈ 370 nats vs "
            "~1e2 / ~150 for converging peers — and the first full-LR step "
            "blows it up (|z| jumps 15 orders of magnitude), re-blowing "
            "repeatedly through the probe's horizon. hint_16_1 leaves "
            "warmup healthy (gnorm ~4e2) but single full-LR steps still "
            "spike transiently (|z| → 1e12 for one batch, then immediate "
            "recovery). Whether a campaign run records NaN is then "
            "seed-dependent — an unlucky spike landing terminally (e.g. "
            "hint_16_0_big seed 0 diverged, seed 1 converged to −370.5 "
            "under the identical schedule). In both, the elementwise "
            "±5 grad clamp preserves the blown-up direction instead of "
            "rescaling it. This is a property of the reference recipe at "
            "these widths/depths, not of the TPU port: trajectories are "
            "stable through the whole warmup and explode on the LR step "
            "itself (loss/diagnostic PNGs alongside the JSONs).",
            ""]
    return lines


def stage_report(abc_dir: str = "abc") -> str:
    """Accumulate everything into ``{CAMPAIGN_DIR}/REPORT.md`` (mean ± std
    over training runs, the reference's output format); the text is
    ``hint_tpu``'s for the same records."""
    import pickle

    lines = ["# Reference-scale campaign report", ""]
    log = _read_log()

    # per-dim likelihoods, mean +- std over seeds
    lines += ["## Final test loss / per-dim likelihood (3 seeds)", "",
              "| config | test loss | per-dim LL |", "|---|---|---|"]
    by_cfg: Dict[str, list] = {}
    for key, rec in sorted(log.items()):
        config = key.split("|")[0]
        # uci_data.* entries get their own LL-normalized section below
        if key.endswith("|float32") and not config.startswith("uci_data."):
            by_cfg.setdefault(config, []).append(rec)
    for config, recs in sorted(by_cfg.items()):
        # diverged seeds (NaN loss) are excluded from the stats and counted,
        # mirroring the reference's swallow-and-continue protocol
        # (run_experiments.py:169-173)
        losses = np.array([r["final_test_loss"] for r in recs], float)
        lls = np.array([r["per_dim_ll"] for r in recs], float)
        n_div = int(np.isnan(losses).sum())
        note = f" ({n_div} seed{'s' if n_div > 1 else ''} diverged)" if n_div else ""
        if np.isnan(losses).all():
            lines.append(f"| {config} | diverged (all seeds) | — |")
            continue
        lines.append(
            f"| {config} | {_mean_std(losses, '.3f')} "
            f"| {_mean_std(lls, '.4f')}{note} |"
        )
    lines.append("")

    # bf16-vs-f32 quality: same configs, same budget
    bf16 = {}
    for key, rec in sorted(log.items()):
        if key.endswith("|bfloat16"):
            bf16.setdefault(key.split("|")[0], []).append(rec)
    if bf16:
        lines += ["## bfloat16 vs float32 final test loss (equal budget, 3 seeds)", "",
                  "| config | f32 loss | bf16 loss | delta |", "|---|---|---|---|"]
        for config, recs in sorted(bf16.items()):
            b = np.mean([r["final_test_loss"] for r in recs])
            f_recs = by_cfg.get(config)
            f = np.mean([r["final_test_loss"] for r in f_recs]) if f_recs else float("nan")
            lines.append(f"| {config} | {f:.3f} | {b:.3f} | {b - f:+.3f} |")
        lines.append("")

    # MMD comparisons. Fresh sweeps live in abc/ next to the pool they were
    # scored against; the archive under CAMPAIGN_DIR/comparisons (with its
    # PROVENANCE.json) is the fallback, so a wiped abc/ never silently drops
    # a table from the report.
    archive_dir = os.path.join(CAMPAIGN_DIR, "comparisons")
    prov_path = os.path.join(archive_dir, "PROVENANCE.json")
    provenance = {}
    if os.path.exists(prov_path):
        with open(prov_path) as f:
            provenance = json.load(f)
    for (family, kind), configs in MODEL_SETS.items():
        name = DATA_MODEL_NAME[family]
        # Collect per-run (path, source label, GT-pool basis). MMDs scored
        # against different pool sizes are NOT comparable (the quantile-ABC
        # threshold scales as (N1/N2)^(1/d_y), rejection_sampling.py:76), so
        # runs are grouped by basis and only the sharpest consistent group is
        # published.
        entries = []  # (run, path, source, basis_n_pool or -1 for unknown)
        for run in range(3):
            fname = f"{name}_{kind}_comparison_{run}.pkl"
            p = os.path.join(abc_dir, fname)
            if os.path.exists(p):
                fx = os.path.join(abc_dir, f"{name}_x_huge.npy")
                n_pool = (int(np.load(fx, mmap_mode="r").shape[0])
                          if os.path.exists(fx) else -1)
                src = (f"fresh sweep vs the live {n_pool:,}-row pool"
                       if n_pool > 0 else "fresh sweep (abc/)")
            else:
                p = os.path.join(archive_dir, fname)
                if not os.path.exists(p):
                    continue
                src = provenance.get(
                    fname, "archived record (pool size unrecorded; "
                           "r3/r4 sweeps used N=1e7)")
                m = re.search(r"([\d,]{4,})-row", src)
                n_pool = int(m.group(1).replace(",", "")) if m else -1
            entries.append((run, p, src, n_pool))
        if not entries:
            continue
        # Basis grouping applies to conditional sweeps only: unconditional
        # MMD is scored against a held-out prior sample, not the ABC pool,
        # so all runs share one basis regardless of pool size.
        if kind == "conditional":
            best = max(e[3] for e in entries)
            kept = [e for e in entries if e[3] == best]
            dropped = [e for e in entries if e[3] != best]
        else:
            kept, dropped = entries, []
        rows = {}
        sources = set()
        for run, p, src, _ in kept:
            sources.add(src)
            with open(p, "rb") as f:
                d = pickle.load(f)
            for cfg_name, rec in d.items():
                rows.setdefault(cfg_name, {"mmds": [], "rej": [], "dists": []})
                rows[cfg_name]["mmds"].append(np.nanmean(rec["mmds"]))
                rows[cfg_name]["rej"].append(np.mean(rec.get("rejects", [0.0])))
                if len(rec.get("dists", [])):
                    rows[cfg_name]["dists"].append(np.nanmean(rec["dists"]))
        if not rows:
            continue
        lines += [f"## {family} {kind} posterior/prior MMD "
                  f"(mean ± std over {len(kept)} training run"
                  f"{'s' if len(kept) != 1 else ''})", "",
                  "| model | MMD | reject rate | y-distance |", "|---|---|---|---|"]
        for cfg_name, r in sorted(rows.items()):
            d = (
                f"{np.nanmean(r['dists']):.4f}"
                if r["dists"] and np.isfinite(np.nanmean(r["dists"]))
                else "—"
            )
            lines.append(
                f"| {cfg_name} | {_mean_std(r['mmds'], '.4f')} "
                f"| {np.mean(r['rej']):.4f} | {d} |"
            )
        for src in sorted(sources):
            lines.append(f"\nGT/prior pool: {src}.")
        for run, _, src, _ in dropped:
            lines.append(
                f"\nRun {run} excluded: scored against a different GT basis "
                f"({src}) — not comparable with the table above."
            )
        lines.append("")

    # shape scores
    for family in ("lens", "plus"):
        path = os.path.join(CAMPAIGN_DIR, f"shapes_{family}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            shp = json.load(f)
        by_cfg = {}
        for key, rec in shp.items():
            by_cfg.setdefault(key.split("|")[0], []).append(rec)
        lines += [f"## {family} shape fit (n=1000 curves, 3 seeds)", "",
                  "| config | IoU | DICE | max H | avg H | reject | corr MSE |",
                  "|---|---|---|---|---|---|---|"]
        for config, recs in sorted(by_cfg.items()):
            def ms(k):
                return _mean_std((r.get(k, float("nan")) for r in recs), ".3f")
            lines.append(f"| {config} | {ms('iou')} | {ms('dice')} | {ms('max_h')} "
                         f"| {ms('avg_h')} | {ms('reject_rate')} | {ms('corr_mse')} |")
        lines.append("")

    # UCI test log-likelihood, the reference's collect_results format
    # (run_uci_experiments.py:57-76): LL = −loss − (d/2)·ln 2π, mean ± std
    uci_rows = {}
    for key, rec in sorted(log.items()):
        config = key.split("|")[0]
        if config.startswith("uci_data.") and "ll_nats" in rec:
            uci_rows.setdefault(config, []).append(rec["ll_nats"])
    if uci_rows:
        lines += ["## UCI test log-likelihood (nats, mean ± std over runs)", "",
                  "| config | LL |", "|---|---|"]
        for config, lls in sorted(uci_rows.items()):
            lls = np.array(lls, float)
            n_div = int(np.isnan(lls).sum())
            if np.isnan(lls).all():
                lines.append(f"| {config} | diverged (all runs) |")
                continue
            note = f" ({n_div} run{'s' if n_div > 1 else ''} diverged)" if n_div else ""
            lines.append(f"| {config} | {_mean_std(lls, '.3f')}{note} |")
        lines.append("")

    # control experiments: each control ablates one design choice of its
    # baseline config (run_experiments.py:30-33,41: reshuffle kills the
    # hierarchical split order, constwidth the width taper, lessshrink the
    # subnet shrink factor; inn_4_Q swaps fixed for learned permutations)
    _CONTROLS = [
        ("plus_shape.unconditional_hint_4_3", None),
        ("plus_shape.unconditional_hint_4_3_reshuffle", "hint_4_3"),
        ("plus_shape.unconditional_hint_4_3_constwidth", "hint_4_3"),
        ("plus_shape.unconditional_hint_4_3_lessshrink", "hint_4_3"),
        ("plus_shape.unconditional_inn_4", None),
        ("plus_shape.unconditional_inn_4_Q", "inn_4"),
    ]
    shp_path = os.path.join(CAMPAIGN_DIR, "shapes_plus.json")
    shp_all = None
    if os.path.exists(shp_path):
        with open(shp_path) as f:
            shp_all = json.load(f)
    if shp_all is not None:
        ctl_rows = []
        for config, base in _CONTROLS:
            ious = [r["iou"] for k, r in shp_all.items() if k.split("|")[0] == config]
            lls = [r["per_dim_ll"] for k, r in log.items()
                   if k.split("|")[0] == config and k.endswith("|float32")]
            if not ious and not lls:
                continue
            name = config.split(".")[-1]
            ctl_rows.append(f"| {name} | {'baseline' if base is None else f'ablates {base}'} "
                            f"| {_mean_std(ious, '.3f')} | {_mean_std(lls, '.4f')} |")
        if ctl_rows:
            lines += ["## plus-shape control experiments "
                      "(IoU / per-dim LL, mean ± std over seeds)", "",
                      "| config | role | IoU | per-dim LL |", "|---|---|---|---|",
                      *ctl_rows, ""]

    # architecture-ablation grid: IoU and per-dim LL vs (blocks, recursion
    # depth), per parameter-matching class: the HINT paper's central study
    if shp_all is not None:
        cells: Dict[tuple, Dict[str, list]] = {}
        for key, rec in shp_all.items():
            gk = _grid_key(key.split("|")[0])
            if gk is None:
                continue
            cell = cells.setdefault(gk, {"iou": [], "dice": [], "ll": []})
            cell["iou"].append(rec["iou"])
            cell["dice"].append(rec.get("dice", float("nan")))
        for key, rec in log.items():
            config, _, dt = key.split("|")
            if dt != "float32":
                continue
            gk = _grid_key(config)
            if gk in cells:
                cells[gk]["ll"].append(rec["per_dim_ll"])
        if cells:
            depth_label = {0: "0", 1: "1", 2: "2", 3: "3", 9: "full"}
            for size in ("base", "small", "big"):
                rows = sorted(
                    (k for k in cells if k[3] == size), key=lambda k: (k[0], k[1], k[2])
                )
                if not rows:
                    continue
                lines += [f"## plus-shape architecture ablation — {size} "
                          f"(IoU / DICE / per-dim LL, mean ± std over seeds)", "",
                          "| model | blocks | depth | IoU | DICE | per-dim LL |",
                          "|---|---|---|---|---|---|"]
                for kind, blocks, depth, _ in rows:
                    c = cells[(kind, blocks, depth, size)]
                    lines.append(
                        f"| {kind} | {blocks} | "
                        f"{depth_label[depth] if kind == 'hint' else '—'} "
                        f"| {_mean_std(c['iou'], '.3f')} | {_mean_std(c['dice'], '.3f')} "
                        f"| {_mean_std(c['ll'], '.4f')} |"
                    )
                lines.append("")
            # the tables' visual companion: host-only drawing, skipped where
            # matplotlib is not installed (a CUDA host may lack it) or the grid is empty
            try:
                from hint_tpu_torch.monitor.figures import plot_ablation_grid

                # figures under the same artifacts root as REPORT.md
                fig_dir = os.path.join(os.path.dirname(CAMPAIGN_DIR) or ".", "figures")
                figs = plot_ablation_grid(cells, out_dir=fig_dir)
            except Exception as exc:  # noqa: BLE001 - drawing only; the tables stand
                print(f"ablation figures skipped: {exc}", flush=True)
            else:
                if figs:
                    lines += ["Ablation figures: " + ", ".join(figs), ""]

    lines += _divergence_section()

    report = "\n".join(lines)
    os.makedirs(CAMPAIGN_DIR, exist_ok=True)
    with open(os.path.join(CAMPAIGN_DIR, "REPORT.md"), "w") as f:
        f.write(report)
    print(report)
    return report


def _add_engine(sp, dtype: bool = False):
    """The port's flags of a stage that trains or samples."""
    if dtype:
        sp.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="matmul compute dtype (params stay float32)")
    sp.add_argument("--impl", default="levelwise", choices=["levelwise", "reference", "fused"],
                    help="HAC engine ('fused' = whole-block CUDA kernel)")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hint_tpu_torch.experiments.campaign", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="stage", required=True)
    for s in ("data", "train", "pool", "compare", "shapes"):
        sp = sub.add_parser(s)
        sp.add_argument("--family", required=True, choices=["lens", "plus"])
        if s == "train":
            sp.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
            sp.add_argument("--configs", nargs="*", default=None)
            sp.add_argument("--max-minutes", type=float, default=None)
            sp.add_argument("--require-ckpt", action="store_true",
                            help="treat only an on-disk .npz as done "
                                 "(rebuild weights that were cleaned up)")
        if s == "pool":
            sp.add_argument("--n", type=int, default=10_000_000)
        if s == "compare":
            sp.add_argument("--kind", required=True, choices=["unconditional", "conditional"])
            sp.add_argument("--run", type=int, required=True)
            sp.add_argument("--n-runs", type=int, default=None)
            sp.add_argument("--sample-size", type=int, default=4000)
        if s == "shapes":
            sp.add_argument("--n", type=int, default=1000)
            sp.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
            sp.add_argument("--configs", nargs="*", default=None)
        if s in ("train", "compare", "shapes"):
            _add_engine(sp, dtype=True)
    gp = sub.add_parser("grid")
    gp.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    gp.add_argument("--n-shapes", type=int, default=1000)
    gp.add_argument("--max-minutes", type=float, default=None)
    gp.add_argument("--configs", nargs="*", default=None)
    _add_engine(gp)
    up = sub.add_parser("uci")
    up.add_argument("--uci-root", default=".")
    up.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    up.add_argument("--max-minutes", type=float, default=None)
    _add_engine(up)
    fp = sub.add_parser("figures")
    fp.add_argument("--seed", type=int, default=0)
    fp.add_argument("--n-abc-panels", type=int, default=2)
    _add_engine(fp)
    sub.add_parser("report")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    engine = {k: getattr(args, k) for k in ("impl", "device") if hasattr(args, k)}
    if args.stage == "data":
        stage_data(args.family)
    elif args.stage == "train":
        stage_train(args.family, tuple(args.seeds), dtype=args.dtype,
                    configs=args.configs or None, max_minutes=args.max_minutes,
                    require_ckpt=args.require_ckpt, **engine)
    elif args.stage == "pool":
        stage_pool(args.family, args.n)
    elif args.stage == "compare":
        stage_compare(args.family, args.kind, args.run, args.n_runs, args.sample_size,
                      dtype=args.dtype, **engine)
    elif args.stage == "shapes":
        stage_shapes(args.family, args.n, tuple(args.seeds), dtype=args.dtype,
                     configs=args.configs or None, **engine)
    elif args.stage == "grid":
        stage_grid(tuple(args.seeds), args.n_shapes, args.max_minutes,
                   configs=args.configs or None, **engine)
    elif args.stage == "uci":
        stage_uci(args.uci_root, tuple(args.seeds), args.max_minutes, **engine)
    elif args.stage == "figures":
        stage_figures(args.seed, n_abc_panels=args.n_abc_panels, **engine)
    elif args.stage == "report":
        stage_report()


if __name__ == "__main__":
    main()
