"""Experiment sweep drivers (port of ``hint_tpu/experiments/drivers.py``).

The reference's three driver scripts select work by editing commented-out
config-name lists and ``exec``-importing modules (run_experiments.py:12-102,
run_uci_experiments.py:11-35, eval_shapes.py:11-69 of the reference). Here,
as in ``hint_tpu``, every driver takes an explicit config-name list and
directories, and is exposed through the CLI (``python -m hint_tpu_torch
experiment ...``). Each also takes the HAC engine (``impl``), the compute
dtype and the torch device (CUDA unless named).

Kept from ``hint_tpu``, so that each package reads the other's results:

* per-config swallow-and-continue error handling (run_experiments.py:169-173);
* results layout: ``results/{config-with-dashes}_{i}.npz`` full-state
  checkpoints, ``..._{i}_sample.npy`` unflattened-coefficient samples,
  ``..._{i}.npy`` metric stacks, ``results/{config-with-dashes}.npy`` UCI
  loss arrays (run_experiments.py:113,142,167; run_uci_experiments.py:53);
* lens configs are shape-scored inline after training, plus configs by the
  separate ``eval_shapes`` pass (run_experiments.py:144-167, eval_shapes.py);
* ``test_likelihood``: per-dim likelihood of reloaded checkpoints plus
  correlation-matrix MSE against cached ground truth
  (run_experiments.py:192-236);
* UCI log-likelihood LL = −loss − (d/2)·ln 2π (run_uci_experiments.py:71-72).

Samples are drawn by the served flow's inverse (``sample_model``; under
``impl="fused"`` the HAC blocks' CUDA kernel), and shapes are scored by the
batched fitters of ``hint_tpu_torch.evaluation.shape_fit``.
"""

from __future__ import annotations

import os
import traceback
from typing import Dict, Sequence

import numpy as np
import torch


def _dash(config: str) -> str:
    return config.replace(".", "-")


def _on_device(cfg, split, device):
    """(x, y) of one split on the device; y is dropped for an unconditional
    config."""
    from hint_tpu_torch.data.loaders import to_device

    x, y = to_device(split, device)
    return x, (y if cfg.is_conditional else None)


def _train_one(config: str, seed: int, cache_dir: str, uci_root: str, monitor=None,
               impl: str = "levelwise", compute_dtype: str = "float32", device=None):
    """Train one config once; returns (cfg, trainer, state, final_test_loss)."""
    from hint_tpu_torch.configs import get_config

    cfg = get_config(config)
    train, test = cfg.load_data(cache_dir, uci_root)
    trainer = cfg.make_trainer(compute_dtype=compute_dtype, impl=impl, device=device)
    state, final = trainer.fit(
        seed, _on_device(cfg, train, trainer.device), _on_device(cfg, test, trainer.device),
        monitor=monitor, full_batch_test=cfg.is_uci,
    )
    return cfg, trainer, state, final


def _draw_sample(cfg, trainer, n: int, seed: int) -> np.ndarray:
    """n samples of x from the trained model (its inverse), on the host."""
    from hint_tpu_torch.evaluation.sampling import sample_model

    generator = torch.Generator(device=trainer.device).manual_seed(seed)
    with torch.no_grad():
        x = sample_model(cfg, trainer.model, n, generator,
                         y_target=cfg.vis_y_target if cfg.is_conditional else None)
    return x.cpu().numpy()


def _score_shapes(data_model, sample_flat: np.ndarray, family: str, mesh=None, device=None) -> np.ndarray:
    """Mean [IoU, DICE, max_h, avg_h] over sampled curves, by the batched
    fitters on the device (data-parallel over ``mesh``, on its device,
    where one is given); Hausdorff on the host."""
    from hint_tpu_torch.data import geometry
    from hint_tpu_torch.evaluation import shape_fit

    if mesh is not None:
        device = mesh.device
    coeffs = data_model.unflatten_coeffs(sample_flat)
    curves = data_model.trace_fourier_curves(coeffs).astype(np.float32)
    dense = data_model.trace_fourier_curves(coeffs, n_points=1000)
    # drop curves an undertrained flow mapped to non-finite/degenerate coords
    # (inverse through stacked exp-couplings can overflow for outlier z)
    ok = np.isfinite(curves).all(axis=(1, 2)) & (np.abs(curves).max(axis=(1, 2)) < 1e3)
    n_dropped = int((~ok).sum())
    if n_dropped:
        print(f"shape scoring: dropped {n_dropped}/{len(ok)} non-finite/degenerate curves")
    curves, dense = curves[ok], dense[ok]
    if len(curves) == 0:
        print("shape scoring: no scoreable curves (all dropped as non-finite)")
        return np.full(4, np.nan)
    if family == "lens":
        params = shape_fit.fit_lens_shapes_batch(curves, mesh=mesh, device=device)
    else:
        params = shape_fit.fit_plus_shapes_batch(curves, mesh=mesh, device=device)
    fit_ok = np.isfinite(params).all(axis=1)  # all restarts diverged otherwise
    if not fit_ok.any():
        print("shape scoring: no scoreable curves (all dropped or diverged)")
        return np.full(4, np.nan)
    params, curves, dense = params[fit_ok], curves[fit_ok], dense[fit_ok]
    if family == "lens":
        outlines = shape_fit.lens_outlines_batch(params, device=device)
        dense_outline = lambda o: o  # noqa: E731
    else:
        from hint_tpu_torch.data.fourier import PlusShapeModel

        _pm = PlusShapeModel()
        outlines = shape_fit.plus_outlines_batch(params, device=device)
        dense_outline = lambda o: _pm.densify_polyline(o, max_dist=0.02)  # noqa: E731
    iou, dice = shape_fit.iou_and_dice_batch(outlines, curves, mesh=mesh, device=device)
    haus = np.asarray(
        [geometry.hausdorff(dense_outline(outlines[j]), dense[j]) for j in range(len(curves))]
    )
    arr = np.concatenate([iou[:, None], dice[:, None], haus], axis=1)
    return arr.mean(axis=0)


def train_and_evaluate(
    configs: Sequence[str],
    n_runs: int = 1,
    n_eval_samples: int = 1000,
    results_dir: str = "results",
    cache_dir: str = "data",
    uci_root: str = ".",
    seed: int = 0,
    monitor=None,
    impl: str = "levelwise",
    compute_dtype: str = "float32",
    device=None,
) -> Dict[str, list]:
    """Toy-shape sweep: train, checkpoint, sample, score lens shapes inline
    (run_experiments.py:97-173)."""
    from hint_tpu_torch.train import checkpoint

    os.makedirs(results_dir, exist_ok=True)
    outcomes: Dict[str, list] = {}
    for config in configs:
        outcomes[config] = []
        for i in range(n_runs):
            try:
                cfg, trainer, state, final = _train_one(
                    config, seed + i, cache_dir, uci_root, monitor, impl, compute_dtype, device
                )
                checkpoint.save_npz(os.path.join(results_dir, f"{_dash(config)}_{i}.npz"), state)
                sample = _draw_sample(cfg, trainer, n_eval_samples, seed + 1000 + i)
                data_model = cfg.data_model()
                np.save(
                    os.path.join(results_dir, f"{_dash(config)}_{i}_sample.npy"),
                    data_model.unflatten_coeffs(sample),
                )
                print(config, i, "test loss:", final)
                if "lens" in config:
                    metrics = _score_shapes(data_model, sample, "lens", device=trainer.device)
                    print(config, i, "IoU/DICE/max_h/avg_h:", metrics)
                    np.save(os.path.join(results_dir, f"{_dash(config)}_{i}.npy"), metrics)
                outcomes[config].append(final)
            except Exception:  # the sweep goes on with the next run (run_experiments.py:169-173)
                print(f'ERROR with config "{config}"', i)
                traceback.print_exc()
    return outcomes


def collect_shape_results(
    configs: Sequence[str], n_runs: int = 1, results_dir: str = "results"
) -> Dict[str, tuple]:
    """mean ± std of [IoU, DICE, max_h, avg_h] over runs
    (run_experiments.py:177-188)."""
    out = {}
    for config in configs:
        rs = np.array(
            [np.load(os.path.join(results_dir, f"{_dash(config)}_{i}.npy")) for i in range(n_runs)]
        )
        means, stds = rs.mean(axis=0), rs.std(axis=0)
        out[config] = (means, stds)
        print(config)
        print(f"{means[0]:.3f} \\pm {stds[0]:.3f} & {means[3]:.3f} \\pm {stds[3]:.3f}\n")
    return out


def test_likelihood(
    configs: Sequence[str],
    n_runs: int = 1,
    results_dir: str = "results",
    cache_dir: str = "data",
    uci_root: str = ".",
    seed: int = 0,
    impl: str = "levelwise",
    compute_dtype: str = "float32",
    device=None,
) -> Dict[str, tuple]:
    """Per-dim likelihood + correlation MSE of saved checkpoints
    (run_experiments.py:192-236)."""
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.evaluation.metrics import correlation_mse
    from hint_tpu_torch.train import checkpoint
    from hint_tpu_torch.train.trainer import TEST_STREAM

    out = {}
    for config in configs:
        try:
            cfg = get_config(config)
            _, test = cfg.load_data(cache_dir, uci_root)
            trainer = cfg.make_trainer(compute_dtype=compute_dtype, impl=impl, device=device)
            x_te, y_te = _on_device(cfg, test, trainer.device)
            likelihoods, corr_mses = [], []
            for i in range(n_runs):
                state = checkpoint.load_npz(
                    os.path.join(results_dir, f"{_dash(config)}_{i}.npz"), trainer.init_state(seed)
                )
                losses = trainer.eval_epoch(
                    x_te, y_te, trainer.epoch_generator(seed + 1 + i, state.epoch, TEST_STREAM),
                    full_batch=cfg.is_uci,
                )
                likelihoods.append(-float(losses.sum()) / cfg.data_model().n_parameters)
                n = 4000 if cfg.is_conditional else 10000
                sample = _draw_sample(cfg, trainer, n, seed + 2000 + i)
                suffix = "_corr_conditional" if cfg.is_conditional else "_corr"
                corr_true = np.load(os.path.join(cache_dir, f"{cfg.data_model().name}{suffix}.npy"))
                corr_mses.append(correlation_mse(sample, corr_true))
            out[config] = (
                (float(np.mean(likelihoods)), float(np.std(likelihoods))),
                (float(np.mean(corr_mses)), float(np.std(corr_mses))),
            )
            print(config)
            print(f"{np.mean(likelihoods):.3f} \\pm {np.std(likelihoods):.3f}")
            print(f"{np.mean(corr_mses):.4f} \\pm {np.std(corr_mses):.4f}\n")
        except Exception:  # the sweep goes on with the next config
            print(f'ERROR with config "{config}"')
            traceback.print_exc()
    return out


UCI_CONFIGS = (
    "uci_data.power_hint_4", "uci_data.power_hint_8",
    "uci_data.power_inn_4", "uci_data.power_inn_8",
    "uci_data.gas_hint_4", "uci_data.gas_hint_8",
    "uci_data.gas_inn_4", "uci_data.gas_inn_8",
    "uci_data.miniboone_hint_4", "uci_data.miniboone_hint_8",
    "uci_data.miniboone_inn_4", "uci_data.miniboone_inn_8",
)  # run_uci_experiments.py:11-25


def uci_train_and_eval(
    configs: Sequence[str] = UCI_CONFIGS,
    n_runs: int = 3,
    results_dir: str = "results",
    uci_root: str = ".",
    seed: int = 0,
    monitor=None,
    impl: str = "levelwise",
    compute_dtype: str = "float32",
    device=None,
) -> Dict[str, np.ndarray]:
    """UCI benchmark sweep (run_uci_experiments.py:29-53)."""
    from hint_tpu_torch.train import checkpoint

    os.makedirs(results_dir, exist_ok=True)
    out = {}
    for config in configs:
        test_losses = []
        for i in range(n_runs):
            try:
                cfg, trainer, state, final = _train_one(
                    config, seed + i, "data", uci_root, monitor, impl, compute_dtype, device
                )
                checkpoint.save_npz(os.path.join(results_dir, f"{_dash(config)}_{i}.npz"), state)
                test_losses.append(final)
            except Exception:  # the sweep goes on with the next run
                print(f'ERROR with config "{config}"', i)
                traceback.print_exc()
        print(config)
        print(test_losses)
        np.save(os.path.join(results_dir, f"{_dash(config)}.npy"), np.array(test_losses))
        out[config] = np.array(test_losses)
    return out


def uci_collect_results(
    configs: Sequence[str] = UCI_CONFIGS, results_dir: str = "results"
) -> Dict[str, tuple]:
    """LL = −loss − (d/2)·ln 2π, mean ± std over runs
    (run_uci_experiments.py:57-76)."""
    from hint_tpu_torch.configs import get_config

    out = {}
    for config in configs:
        d = get_config(config).ndim_x
        lls = -np.load(os.path.join(results_dir, f"{_dash(config)}.npy"))
        lls -= np.log(2 * np.pi) * (d / 2)
        out[config] = (float(lls.mean()), float(lls.std()))
        print(config)
        print(f"{lls.mean():.3f} \\pm {lls.std():.3f}\n")
    return out


def eval_shapes(
    configs: Sequence[str],
    run_index: int = 0,
    results_dir: str = "results",
    device=None,
) -> Dict[str, np.ndarray]:
    """Score saved plus-shape samples (eval_shapes.py:67-121) by the batched
    fitters, one batch per config."""
    from hint_tpu_torch.data.fourier import PlusShapeModel

    data_model = PlusShapeModel()
    out = {}
    for config in configs:
        try:
            sample = np.load(os.path.join(results_dir, f"{_dash(config)}_{run_index}_sample.npy"))
            flat = data_model.flatten_coeffs(sample)
            metrics = _score_shapes(data_model, flat, "plus", device=device)
            print(config, "IoU/DICE/max_h/avg_h:", metrics)
            np.save(os.path.join(results_dir, f"{_dash(config)}_{run_index}.npy"), metrics)
            out[config] = metrics
        except Exception:  # the sweep goes on with the next config
            print(f'ERROR with config "{config}"')
            traceback.print_exc()
    return out
