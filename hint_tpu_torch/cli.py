"""Command-line interface of the port (the subcommands of ``hint_tpu/cli.py``):

    python -m hint_tpu_torch list [prefix]
    python -m hint_tpu_torch train    --config plus_shape.unconditional_hint_4_full --impl fused --save run.npz
    python -m hint_tpu_torch train    --config uci_data.power_hint_4 --uci-root . --impl fused
    python -m hint_tpu_torch evaluate --config ... --ckpt run.npz
    python -m hint_tpu_torch sample   --config ... --ckpt run.npz --n 1000 --out s.npy [--y-target 2.0 -1.0]
    python -m hint_tpu_torch serve    --config ... --ckpt run.npz --impl fused
    python -m hint_tpu_torch experiment {shapes,uci,collect-uci,collect-shapes,eval-shapes,likelihood} [configs ...]

All but ``list`` run on CUDA unless ``--device cpu`` is given. ``--ckpt`` and
``--resume`` take an npz written by either package, and ``experiment``
reads and writes the same ``results/`` layout as ``hint_tpu``. Conditional
configs train on the ``(x, y)`` pairs of their data set and sample ``x | y``
for ``--y-target`` (default: the config's ``vis_y_target``). UCI configs read
``{--uci-root}/uci_data/``, evaluate the whole test set as one batch and
print the test log-likelihood. ``train --profile-dir DIR`` records the run with
``torch.profiler`` and writes a Chrome trace into DIR; ``train --plot-dir DIR``
rewrites losses.png, latent.png and samples.png there each epoch where
matplotlib imports (the console table alone where it does not). The campaign
of the HINT paper's protocol is ``python -m hint_tpu_torch.experiments.campaign``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import numpy as np


def _add_common(p):
    p.add_argument("--config", required=True, help="registry name, e.g. plus_shape.unconditional_hint_4_full")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="matmul compute dtype (params stay float32)")
    p.add_argument("--impl", default="levelwise", choices=["levelwise", "reference", "fused"],
                   help="HAC engine ('fused' = whole-block CUDA kernel; "
                        "'reference' = recursion-order oracle)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    p.add_argument("--seed", type=int, default=0)
    # hint_tpu's flags for XLA's compile time and memory (hint_tpu/cli.py:32-40);
    # the port runs eagerly and computes the same either way
    p.add_argument("--scan-blocks", default="auto", choices=["auto", "on", "off"],
                   help="accepted for hint_tpu's command lines; a no-op here (hint_tpu: lax.scan over "
                        "repeated blocks, same math)")
    p.add_argument("--no-remat", action="store_true",
                   help="accepted for hint_tpu's command lines; a no-op (rematerialisation is off unless --remat)")


def _add_training(p):
    p.add_argument("--cache-dir", default="data", help="toy-data npy cache directory")
    p.add_argument("--uci-root", default=".", help="directory containing uci_data/")
    p.add_argument("--n-train", type=int, default=0, help="override n_train (toy data)")
    p.add_argument("--n-test", type=int, default=0, help="override n_test (toy data)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's activations in the backward pass "
                        "(less memory; impl='fused' blocks always do)")
    p.add_argument("--lr-semantics", default="legacy", choices=["legacy", "modern"],
                   help="post-warmup StepLR behavior: 'legacy' = torch-1.x closed form, "
                        "'modern' = torch>=1.4 chainable semantics (see train/optim.py)")


def _service(args):
    from hint_tpu_torch.serve import InferenceService

    return InferenceService.from_checkpoint(
        args.config, args.ckpt, impl=args.impl, compute_dtype=args.dtype, device=args.device
    )


def _config(args, **more):
    """The named config with the command line's non-zero overrides."""
    from hint_tpu_torch.configs import get_config

    overrides = {"n_train": args.n_train, "n_test": args.n_test, **more}
    return dataclasses.replace(
        get_config(args.config), **{k: v for k, v in overrides.items() if v}
    )


def _trainer(cfg, args):
    return cfg.make_trainer(
        compute_dtype=args.dtype, impl=args.impl, lr_semantics=args.lr_semantics,
        remat=args.remat, device=args.device,
    )


def _log_likelihood_line(label: str, cfg, loss: float) -> None:
    """The UCI test log-likelihood, LL = -loss - (d/2) ln 2 pi
    (run_uci_experiments.py:71-72)."""
    from hint_tpu_torch.evaluation.metrics import uci_log_likelihood

    print(f"{label}: {uci_log_likelihood(loss, cfg.ndim_x):.3f} nats")


def cmd_list(args):
    from hint_tpu_torch.configs import list_configs

    for name in list_configs(args.prefix):
        print(name)


def cmd_train(args):
    from hint_tpu_torch.data.loaders import to_device
    from hint_tpu_torch.monitor import ConsoleMonitor, make_monitor
    from hint_tpu_torch.train import checkpoint

    cfg = _config(
        args, n_epochs=args.epochs, batch_size=args.batch_size,
        max_batches_per_epoch=args.max_batches,
    )
    print(f"config: {cfg.name} (suffix {cfg.suffix})")
    if args.plot_dir:
        monitor = make_monitor(
            interactive=True, plot_dir=args.plot_dir,
            data_model=cfg.data_model() if not cfg.is_uci else None,
            y_target=cfg.vis_y_target if cfg.is_conditional else None,
        )
    else:
        monitor = ConsoleMonitor()
    trainer = _trainer(cfg, args)
    train, test = (to_device(split, trainer.device) for split in cfg.load_data(args.cache_dir, args.uci_root))
    state = trainer.init_state(args.seed)
    print(f"\nModel {cfg.suffix} has {trainer.n_trainable_params(state):,} trainable parameters.\n")

    ckpt_fn = None
    if args.save:
        def ckpt_fn(state, epoch):
            if (epoch + 1) % args.save_every == 0 or epoch + 1 == cfg.n_epochs:
                checkpoint.save_npz(args.save, state)

    resume_state = None
    if args.resume:
        resume_state = checkpoint.load_npz(args.resume, state)
        print(f"resuming from {args.resume} at epoch {resume_state.epoch}")

    if not cfg.is_conditional:
        train, test = (train[0], None), (test[0], None)
    prof = contextlib.nullcontext()
    if args.profile_dir:
        from hint_tpu_torch.utils import profile_trace

        prof = profile_trace(args.profile_dir)
    with prof:
        state, final = trainer.fit(
            args.seed, train, test, monitor=monitor, full_batch_test=cfg.is_uci,
            checkpoint_fn=ckpt_fn, resume_state=resume_state,
        )
    print(f"final test loss: {final:.6f}")
    if cfg.is_uci:
        _log_likelihood_line("test log-likelihood", cfg, final)
    if args.save:
        checkpoint.save_npz(args.save, state)
        print(f"saved checkpoint to {args.save}")
    return final


def cmd_evaluate(args):
    from hint_tpu_torch.data.loaders import to_device
    from hint_tpu_torch.train import checkpoint
    from hint_tpu_torch.train.trainer import TEST_STREAM

    cfg = _config(args)
    trainer = _trainer(cfg, args)
    x_te, y_te = to_device(cfg.load_data(args.cache_dir, args.uci_root)[1], trainer.device)
    state = checkpoint.load_npz(args.ckpt, trainer.init_state(args.seed))
    losses, nll_x = trainer.eval_epoch(
        x_te, y_te if cfg.is_conditional else None,
        trainer.epoch_generator(args.seed + 1, state.epoch, TEST_STREAM), full_batch=cfg.is_uci,
        return_nll_x=True,
    )
    total = float(losses.sum())
    print(f"test loss: {total:.6f}  terms: {losses}")
    if np.isfinite(nll_x):  # two-lane models: x-lane NLL (train_conditional.py:134)
        print(f"x-lane NLL: {nll_x:.6f}")
    print(f"per-dim likelihood: {-total / cfg.ndim_x:.4f}")  # run_experiments.py:210
    if cfg.is_uci:
        _log_likelihood_line("log-likelihood", cfg, total)
    return total


def cmd_sample(args):
    x = _service(args).sample(args.n, y_target=args.y_target or None, seed=args.seed)
    np.save(args.out, x)
    print(f"saved {args.n} samples to {args.out}")


def cmd_serve(args):
    from hint_tpu_torch.serve import serve

    svc = _service(args)
    print("warming up (every bucket once)...")
    svc.warmup()
    serve(svc, args.host, args.port)


def cmd_experiment(args):
    from hint_tpu_torch import experiments
    from hint_tpu_torch.monitor import ConsoleMonitor

    monitor = ConsoleMonitor() if args.verbose else None
    engine = dict(impl=args.impl, compute_dtype=args.dtype, device=args.device)
    configs = {"configs": args.configs} if args.configs else {}  # default: every UCI config
    if args.what == "shapes":
        return experiments.train_and_evaluate(
            args.configs, n_runs=args.runs, n_eval_samples=args.n_eval_samples,
            results_dir=args.results_dir, cache_dir=args.cache_dir,
            uci_root=args.uci_root, seed=args.seed, monitor=monitor, **engine,
        )
    if args.what == "uci":
        return experiments.uci_train_and_eval(
            **configs, n_runs=args.runs, results_dir=args.results_dir, uci_root=args.uci_root,
            seed=args.seed, monitor=monitor, **engine,
        )
    if args.what == "collect-uci":
        return experiments.uci_collect_results(**configs, results_dir=args.results_dir)
    if args.what == "collect-shapes":
        return experiments.collect_shape_results(args.configs, n_runs=args.runs, results_dir=args.results_dir)
    if args.what == "eval-shapes":
        return experiments.eval_shapes(args.configs, results_dir=args.results_dir, device=args.device)
    return experiments.test_likelihood(
        args.configs, n_runs=args.runs, results_dir=args.results_dir,
        cache_dir=args.cache_dir, uci_root=args.uci_root, seed=args.seed, **engine,
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="hint_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list registered configs")
    p.add_argument("prefix", nargs="?", default="")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("train", help="train a config")
    _add_common(p)
    _add_training(p)
    p.add_argument("--epochs", type=int, default=0, help="override n_epochs")
    p.add_argument("--batch-size", type=int, default=0, help="override batch_size")
    p.add_argument("--max-batches", type=int, default=0, help="override max_batches_per_epoch")
    p.add_argument("--save", default="", help="checkpoint path (.npz)")
    p.add_argument("--save-every", type=int, default=10)
    p.add_argument("--plot-dir", default="", help="write live loss/latent/sample PNGs here")
    p.add_argument("--profile-dir", default="", help="capture a torch.profiler trace here")
    p.add_argument("--resume", default="", help="resume exactly from a .npz checkpoint")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="evaluate a checkpoint")
    _add_common(p)
    _add_training(p)
    p.add_argument("--ckpt", required=True, help="npz checkpoint (full training state)")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("sample", help="draw samples from a checkpoint")
    _add_common(p)
    p.add_argument("--ckpt", required=True, help="npz checkpoint (params[...] entries)")
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--y-target", type=float, nargs="*", default=None,
                   help="condition of a conditional config (default: its vis_y_target)")
    p.add_argument("--out", default="samples.npy")
    p.set_defaults(fn=cmd_sample)

    p = sub.add_parser("serve", help="HTTP sample/log_prob service over a checkpoint")
    _add_common(p)
    p.add_argument("--ckpt", required=True, help="npz checkpoint (params[...] entries)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "experiment",
        help="sweep drivers (reference run_experiments / run_uci_experiments / eval_shapes)",
    )
    p.add_argument(
        "what",
        choices=["shapes", "uci", "collect-uci", "collect-shapes", "eval-shapes", "likelihood"],
    )
    p.add_argument("configs", nargs="*", help="registry config names")
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--n-eval-samples", type=int, default=1000)
    p.add_argument("--results-dir", default="results")
    p.add_argument("--cache-dir", default="data")
    p.add_argument("--uci-root", default=".")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="matmul compute dtype (params stay float32)")
    p.add_argument("--impl", default="levelwise", choices=["levelwise", "reference", "fused"],
                   help="HAC engine ('fused' = whole-block CUDA kernel)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    p.set_defaults(fn=cmd_experiment)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
