"""One pass over every data-parallel path, and worlds of processes to run
it in (counterpart of ``__graft_entry__.dryrun_multichip``).

    torchrun --nproc-per-node 2 -m hint_tpu_torch.parallel.dryrun --device cpu
    python -m hint_tpu_torch.parallel.dryrun --nproc 2 --device cpu

Under torchrun the world is torchrun's; without it the script starts one
of ``--nproc`` processes itself (``spawn``). On CUDA, NCCL serves one card
a rank; ``--backend gloo --device cuda:0`` puts every rank on one card.
``dryrun`` trains one data-parallel step of the flagship at a few rows a
rank, evaluates it sharded, samples a row count the ranks do not divide,
runs quantile-ABC and MMD sharded, and scores shapes sharded. Only rank 0
prints.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from hint_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT_S, all_gather_rows, check_backend, init_world, make_mesh,
                                          map_rows)

FLAGSHIP = "plus_shape.unconditional_hint_4_full"


def _default_backend(device) -> str:
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def _rank_main(rank, world_size, backend, device, tmp, fn, args, timeout_s):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size))
    torch.set_num_threads(1)
    init_world(rank, world_size, backend, dist.FileStore(os.path.join(tmp, "store"), world_size), timeout_s)
    try:
        result = fn(make_mesh(backend=backend, device=device), *args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".part", path)


def spawn(fn, world_size: int, *args, backend=None, device=None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """``fn(mesh, *args)`` on every rank of a new world of ``world_size``
    processes; returns the ranks' results in rank order.

    The processes are spawned (the caller may hold a CUDA context, which a
    forked child cannot use), so ``fn`` is a module-level function and the
    arguments and results pickle. They meet through a file store in a
    temporary directory. A collective waits ``timeout_s`` for the other
    ranks, so a rank that hangs or dies fails the world in seconds; any
    rank's failure raises here, after the others are stopped. ``device``
    is every rank's device (default ``cuda:rank``); ``backend`` defaults to
    NCCL on CUDA and gloo on the CPU. Each rank computes on one CPU
    thread, as under torchrun: the threads of a rank that waits in a
    collective spin, and on a busy host they hold back the ranks that
    compute (a 2-rank CPU world took 20x as long with 8 threads a rank)."""
    backend = backend or _default_backend(device)
    check_backend(backend, world_size)
    if backend == "nccl" and world_size > 1 and device is not None:
        raise RuntimeError(f"backend='nccl' cannot put {world_size} ranks on {device}: one card a rank")
    with tempfile.TemporaryDirectory(prefix="hint_world_") as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world_size, backend, device, tmp, fn, args, timeout_s),
            nprocs=world_size, start_method="spawn", join=False,
        )
        while not ctx.join():
            pass
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _lens_curves(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, 64, endpoint=False, dtype=np.float32)
    return np.stack([
        np.stack([np.cos(t) * (1 + 0.05 * rng.standard_normal()), np.sin(t) * (1 + 0.05 * rng.standard_normal())], 1)
        for _ in range(n)
    ]).astype(np.float32)


# a NaN with a payload, by dtype: (the integer view of its bits, the bits)
NAN_BITS = {torch.float32: (torch.int32, 0x7FC00123), torch.bfloat16: (torch.int16, 0x7FC3)}


def special_rows(rank: int, dtype) -> torch.Tensor:
    """Rank ``rank``'s rows for the bit-exact gather, on the CPU: ``2 *
    rank + 1`` of them (ragged over the ranks), holding -0.0, +0.0, ±Inf,
    a NaN with a payload and the rank's number."""
    int_dtype, bits = NAN_BITS[dtype]
    nan = torch.tensor([bits], dtype=int_dtype).view(dtype)
    row = torch.cat([torch.tensor([-0.0, 0.0, float("inf"), -float("inf")], dtype=dtype), nan,
                     torch.tensor([rank + 1.0], dtype=dtype)])
    return torch.stack([row.roll(k) for k in range(2 * rank + 1)])


def gather_bits(mesh) -> dict:
    """``all_gather_rows`` of every dtype's ``special_rows``, and
    ``map_rows`` of ``torch.neg`` (row by row, a -0.0 of every +0.0) over 7
    rows of zeros, computed on the mesh's device; each as the integer view
    of its bits, in numpy. Every rank must get the ranks' ``special_rows``
    in rank order, and -0.0 from ``map_rows``, bit for bit."""
    out = {}
    for dtype, (int_dtype, _) in NAN_BITS.items():
        got = all_gather_rows(special_rows(mesh.rank, dtype).to(mesh.device), mesh)
        out[f"gather_bits_{str(dtype).split('.')[1]}"] = got.cpu().view(int_dtype).numpy()
    zeros = torch.zeros(7, 3, device=mesh.device)
    out["map_rows_bits"] = map_rows(torch.neg, mesh, zeros).cpu().view(torch.int32).numpy()
    return out


def dryrun(mesh, impl: str = "levelwise") -> dict:
    """Every sharded path once at a few rows a rank; returns what each gave
    (the same on every rank)."""
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.data.fourier import PlusShapeModel
    from hint_tpu_torch.evaluation import shape_fit
    from hint_tpu_torch.evaluation.abc import quantile_ABC
    from hint_tpu_torch.evaluation.mmd import multi_mmd
    from hint_tpu_torch.evaluation.sampling import sample_model
    from hint_tpu_torch.experiments.drivers import _score_shapes

    n = mesh.size
    cfg = get_config(FLAGSHIP)
    trainer = cfg.make_trainer(mesh=mesh, impl=impl)
    batch = 4 * n
    trainer.batch_size, trainer.max_batches_per_epoch = batch, 1
    state = trainer.init_state(0)
    gen = torch.Generator(device=mesh.device).manual_seed(1)
    x = torch.randn((batch, cfg.ndim_x), generator=gen, device=mesh.device)
    terms = trainer.train_step(state, x, None, gen, 1e-3).cpu().numpy()
    eval_terms = trainer.eval_epoch(x, None, gen, full_batch=True)
    with torch.no_grad():
        samples = sample_model(cfg, trainer.model, batch + 1, gen, mesh=mesh).cpu().numpy()
    assert terms.shape == (2,) and np.isfinite(terms).all() and np.isfinite(eval_terms).all()
    assert samples.shape == (batch + 1, cfg.ndim_x) and np.isfinite(samples).all()

    rng = np.random.default_rng(0)
    pool_x = rng.standard_normal((16 * n + 1, cfg.ndim_x)).astype(np.float32)
    pool_y = rng.standard_normal((16 * n + 1, 4)).astype(np.float32)
    gt, threshold = quantile_ABC(pool_x, pool_y, pool_y[0], n=8, mesh=mesh)
    mmd = float(multi_mmd(gt, pool_x[: len(gt)], mesh=mesh))
    assert gt.shape == (8, cfg.ndim_x) and np.isfinite(mmd)

    curves = _lens_curves(n + 1, 2)
    lens = shape_fit.fit_lens_shapes_batch(curves, mesh=mesh)
    iou, dice = shape_fit.iou_and_dice_batch(
        shape_fit.lens_outlines_batch(lens, device=mesh.device), curves, resolution=64, chunk=4, mesh=mesh)
    scores = _score_shapes(PlusShapeModel(), samples[: n + 1], "plus", mesh=mesh)
    assert iou.shape == (n + 1,) and np.isfinite(iou).all() and scores.shape == (4,)
    if mesh.rank == 0:
        print(f"dryrun OK: {n} ranks ({mesh.backend}, {mesh.device}); step terms {terms.tolist()}; eval terms "
              f"{eval_terms.tolist()}; sampled {samples.shape}, ABC gt {gt.shape}, mmd={mmd:.4f}, lens iou mean="
              f"{float(iou.mean()):.3f}, plus shape scores {scores.tolist()}", flush=True)
    return {"terms": terms, "eval_terms": eval_terms, "samples": samples, "gt": gt, "threshold": threshold,
            "mmd": mmd, "lens": lens, "iou": iou, "dice": dice, "scores": scores}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One pass over every data-parallel path of hint_tpu_torch")
    ap.add_argument("--nproc", type=int, default=2, help="ranks to spawn when not run under torchrun")
    ap.add_argument("--device", default=None, help="cpu, or one card for every rank (default cuda:LOCAL_RANK)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on CUDA, gloo on the CPU")
    ap.add_argument("--impl", choices=("levelwise", "fused"), default="levelwise")
    args = ap.parse_args(argv)
    backend = args.backend or _default_backend(args.device)
    if "WORLD_SIZE" not in os.environ:
        spawn(dryrun, args.nproc, args.impl, backend=backend, device=args.device)
        return 0
    check_backend(backend, int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])))
    init_world(backend=backend)
    try:
        dryrun(make_mesh(backend=backend, device=args.device), args.impl)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
