"""Command-line interface of the port (the ``serve`` and ``sample``
subcommands of ``hint_tpu/cli.py``):

    python -m hint_tpu_torch serve  --config plus_shape.unconditional_hint_4_full --ckpt run.npz --impl fused
    python -m hint_tpu_torch sample --config ... --ckpt run.npz --n 1000 --out s.npy

Both run on CUDA unless ``--device cpu`` is given. ``--ckpt`` takes an npz
written by either package.
"""

from __future__ import annotations

import argparse

import numpy as np


def _add_common(p):
    p.add_argument("--config", required=True, help="registry name, e.g. plus_shape.unconditional_hint_4_full")
    p.add_argument("--ckpt", required=True, help="npz checkpoint (params[...] entries)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="matmul compute dtype (params stay float32)")
    p.add_argument("--impl", default="levelwise", choices=["levelwise", "reference", "fused"],
                   help="HAC engine ('fused' = whole-block CUDA kernel; "
                        "'reference' = recursion-order oracle)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")


def _service(args):
    from hint_tpu_torch.serve import InferenceService

    return InferenceService.from_checkpoint(
        args.config, args.ckpt, impl=args.impl, compute_dtype=args.dtype, device=args.device
    )


def cmd_sample(args):
    x = _service(args).sample(args.n, seed=args.seed)
    np.save(args.out, x)
    print(f"saved {args.n} samples to {args.out}")


def cmd_serve(args):
    from hint_tpu_torch.serve import serve

    svc = _service(args)
    print("warming up (every bucket once)...")
    svc.warmup()
    serve(svc, args.host, args.port)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hint_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sample", help="draw samples from a checkpoint")
    _add_common(p)
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="samples.npy")
    p.set_defaults(fn=cmd_sample)

    p = sub.add_parser("serve", help="HTTP sample/log_prob service over a checkpoint")
    _add_common(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
