#!/usr/bin/env python3
"""Two checkouts of the port timed in turns on one CUDA card.

    python3 chip_turns.py --tree A_DIR --tree B_DIR [--turns 3] [--config NAME ...]
        [--dtype {float32,bfloat16}]

Each turn runs every tree once in a fresh process, in the order A B, then B
A in the next turn (A B B A A B ...), so that a drift of the card or the
host over the call falls on both. A run builds the tree's own kernels (from
its ``hint_tpu_torch/ops/csrc``), imports the tree's ``hint_tpu_torch`` and
measures, per config, with random weights from a seed:

- the fused train step in ``--dtype`` (f32 unless told) at batch 10,000 on
  random normal rows: 15 steps, each timed alone with CUDA events after 3
  warm-up steps; the split of a step into re-pack, forward, backward and
  optimizer (as ``chip_smoke.py`` phase 7 takes it); the device memory a
  step allocates beyond what is held before it (``max_memory_allocated``,
  MiB); the device-busy ms of a step
  (``torch.profiler``, the sum of its device operations' times, 3 steps);
- the forward kernel on the config's first HAC block, the trained
  weights, random rows: the saving forward at batch 10,000 (what a training
  step's forward launches) and the serving pass at n=4096 (``no_grad``),
  each by the dtype's route, CUDA events, median of 5 rounds of 10 launches
  after 3; then each backward kernel alone on that saving forward's buffer
  at batch 10,000, random cotangents: the data kernel, and the weight
  kernel with the sum over its row chunks (in a tree whose
  ``BackwardLaunch`` has ``reduce``, the weight kernel and that separate
  reduction);
- ``InferenceService.sample`` at n=4096 in the dtype (the direct calls of
  ``chip_smoke.py`` phases 3 and 8): 20 calls after warm-up, each timed
  alone on the host clock (a call returns host numpy, so it ends synced),
  and the device-busy ms of a call (3 calls).

Prints one JSON line per run, then the median of each metric per tree over
its runs, then the card's name and power limit. Imports nothing of JAX or
``hint_tpu``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

CONFIGS = ("plus_shape.conditional_hint_8_full", "plus_shape.unconditional_hint_4_full")
BATCH, N_SAMPLE = 10_000, 4096


def device_busy_ms(torch, fn, calls):
    """Device time per call: the sum of the device operations' durations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.end - e.time_range.start for e in prof.events() if e.device_type == DeviceType.CUDA)
    return busy / calls / 1e3 if busy else None


def kernel_ms(torch, fn, reps=10, rounds=5):
    """Median over rounds of the mean ms per launch, CUDA events, after 3 warm-up launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        ev[1].synchronize()
        per.append(ev[0].elapsed_time(ev[1]) / reps)
    return statistics.median(per)


def measure(tree, configs, dtype):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import hint_tpu_torch
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.ops import hac_fused
    from hint_tpu_torch.ops.base import exact_f32_matmul
    from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling
    from hint_tpu_torch.serve import InferenceService
    from hint_tpu_torch.train.checkpoint import save_params_npz

    if not os.path.abspath(hint_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {hint_tpu_torch.__file__}, not the package of {tree}")
    exact_f32_matmul()
    hac_fused.build()
    out = []
    for name in configs:
        cfg = get_config(name)
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((BATCH, cfg.ndim_x), generator=g, device="cuda")
        y = torch.randn((BATCH, cfg.ndim_y), generator=g, device="cuda") if cfg.ndim_y else None
        trainer = cfg.make_trainer(compute_dtype=dtype, impl="fused")
        state = trainer.init_state(0)
        lr = cfg.lr_init * 3e-2

        def step():
            trainer.train_step(state, x, y, g, lr)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        steps = []
        for _ in range(15):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            step()
            ev[1].record()
            ev[1].synchronize()
            steps.append(ev[0].elapsed_time(ev[1]))
        # the device memory one step allocates beyond what is held before it
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        step_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        blocks = [b for b in trainer.model.modules() if isinstance(b, HierarchicalAffineCoupling)]
        rows, host = [], []
        for _ in range(7):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            t = [time.perf_counter()]
            ev[0].record()
            for b in blocks:
                hac_fused._packed(b, x.device)
            ev[1].record()
            t.append(time.perf_counter())
            total = trainer._loss(trainer._noisy(x, g), y)[0]
            ev[2].record()
            t.append(time.perf_counter())
            total.backward()
            ev[3].record()
            t.append(time.perf_counter())
            state.opt.update(lr)
            ev[4].record()
            t.append(time.perf_counter())
            ev[4].synchronize()
            rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
            host.append([1e3 * (t[i + 1] - t[i]) for i in range(4)])
        parts = ("repack", "forward", "backward", "optimizer")
        split = dict(zip(parts, (statistics.median(col) for col in zip(*rows[2:]))))
        # the host's time to issue each part (no sync inside a part): where it
        # is near the part's CUDA-event time, the host holds the card back
        split.update(zip((f"{k}_host" for k in parts), (statistics.median(col) for col in zip(*host[2:]))))
        step_busy = device_busy_ms(torch, step, 3)
        hac = blocks[0]
        with torch.no_grad():
            xb = torch.randn((BATCH, hac.dim), generator=g, device="cuda")
            cb = torch.randn((BATCH, hac.cond_dim), generator=g, device="cuda") if hac.cond_dim else None
            saved = hac_fused.saved_buffer(hac, xb)
            save_ms = kernel_ms(torch, lambda: hac_fused._run_block(hac, xb, cb, False, saved=saved))
            x4, c4 = xb[:N_SAMPLE].contiguous(), None if cb is None else cb[:N_SAMPLE].contiguous()
            serve_ms = kernel_ms(torch, lambda: hac_fused._run_block(hac, x4, c4, False))
            gy = torch.randn((BATCH, hac.dim), generator=g, device="cuda")
            gld = torch.randn((BATCH,), generator=g, device="cuda")
            run = hac_fused.BackwardLaunch(hac, saved, cb, False, gy, gld, want_w=True)
            run.data()
            if hasattr(run, "reduce"):
                def weights():
                    run.weights()
                    run.reduce()
            else:
                weights = run.weights
            bwd_data_ms, bwd_weights_ms = kernel_ms(torch, run.data), kernel_ms(torch, weights)
        del trainer, state, saved, run

        model = cfg.build_model(compute_dtype=dtype, impl="fused")
        model.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(0.5)  # as chip_smoke.py: at full init scale the random chain's inverse overflows f32
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
            ckpt = os.path.join(tmp, "random.npz")
            save_params_npz(ckpt, model)
            svc = InferenceService.from_checkpoint(name, ckpt, impl="fused", compute_dtype=dtype)
        svc.warmup()
        for i in range(3):
            svc.sample(N_SAMPLE, seed=i)
        calls = []
        for i in range(20):
            t0 = time.perf_counter()
            svc.sample(N_SAMPLE, seed=i)
            calls.append(1e3 * (time.perf_counter() - t0))
        sample_busy = device_busy_ms(torch, lambda: svc.sample(N_SAMPLE, seed=0), 3)
        out.append({
            "config": name, "dtype": dtype, "step_ms": statistics.median(steps), "step_ms_all": steps, "split_ms": split,
            "step_mib": step_mib, "save_forward_ms": save_ms, "serve_block_ms": serve_ms,
            "bwd_data_ms": bwd_data_ms, "bwd_weights_ms": bwd_weights_ms,
            "step_device_busy_ms": step_busy, "sample_ms": statistics.median(calls), "sample_ms_all": calls,
            "sample_calls_per_s": 1e3 / statistics.median(calls), "sample_device_busy_ms": sample_busy,
        })
        del svc, model
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, help="a checkout's root (give two)")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--config", action="append", help=f"configs to time (default: {', '.join(CONFIGS)})")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the compute dtype of the step, the block and the service")
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # one run in this process, of this tree
    args = ap.parse_args()
    configs = args.config or list(CONFIGS)
    if args.measure:
        print(json.dumps(measure(args.measure, configs, args.dtype)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_turns: no CUDA card visible", file=sys.stderr)
        return 2
    if len(args.tree) != 2:
        ap.error("give two --tree")
    runs = []
    for turn in range(args.turns):
        order = args.tree if turn % 2 == 0 else args.tree[::-1]
        for tree in order:
            cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree, "--tree", tree, "--measure", tree,
                   "--dtype", args.dtype]
            for c in configs:
                cmd += ["--config", c]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
                return 1
            for r in json.loads(res.stdout.strip().splitlines()[-1]):
                r.update(tree=tree, turn=turn)
                runs.append(r)
                print(json.dumps(r), flush=True)
    keys = ("step_ms", "step_mib", "step_device_busy_ms", "save_forward_ms", "serve_block_ms", "bwd_data_ms",
            "bwd_weights_ms", "sample_ms", "sample_calls_per_s", "sample_device_busy_ms")
    for c in configs:
        for tree in args.tree:
            mine = [r for r in runs if r["tree"] == tree and r["config"] == c]
            med = {k: statistics.median(r[k] for r in mine) for k in keys}
            split = {k: statistics.median(r["split_ms"][k] for r in mine) for k in mine[0]["split_ms"]}
            print(f"{c} {args.dtype} {tree}: medians over {len(mine)} runs: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
                  + "; split " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                  + "; per run step_ms " + " / ".join(f"{r['step_ms']:.3f}" for r in mine)
                  + ", save_forward_ms " + " / ".join(f"{r['save_forward_ms']:.4f}" for r in mine)
                  + ", serve_block_ms " + " / ".join(f"{r['serve_block_ms']:.4f}" for r in mine)
                  + ", bwd_weights_ms " + " / ".join(f"{r['bwd_weights_ms']:.4f}" for r in mine)
                  + ", sample_calls_per_s " + " / ".join(f"{r['sample_calls_per_s']:.2f}" for r in mine), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
