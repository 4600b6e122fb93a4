"""ABC / rejection-sampling baseline and model-comparison harness (port of
``hint_tpu/evaluation/abc.py``).

* the prior sweep runs into row-streamed ``.npy`` memmaps with
  chunk-granular resume, either over host CPU cores, from the native C++
  generator (``data/native.py``) or the numpy one, or on the card:
  ``engine="tpu"`` (``hint_tpu``'s name for its accelerator sweep) runs the
  batched device sweeps of ``data/{lens,plus}_tpu.py`` in this process,
  chunk after chunk (the device is the parallelism). The host workers are
  spawned, not forked: a parent that has used CUDA cannot fork safely, and
  the workers need no state of it. A partial pool records its engine, and
  the device sweep's as ``tpu-torch``: its streams are neither
  ``hint_tpu``'s nor the host's, so neither package resumes the other's;
* quantile-ABC's nearest-n search computes the distances and a
  ``torch.topk`` of each pool chunk on the device; only each chunk's
  ``n + 2`` survivors go to the host, where they are merged by distance,
  then pool row: the selection is a stable argsort of the pool's distances,
  ties included;
* MMD is ``hint_tpu_torch.evaluation.mmd.multi_mmd``;
* model comparison takes explicit (name → sampler) mappings instead of the
  reference's exec-import of config modules (rejection_sampling.py:20-30).

Cache layout and pickle contents match ``hint_tpu`` and the reference, so
results are interchangeable: ``abc/{name}_{x,y}_huge.npy``,
``abc/{name}/{i:05}.pkl``, ``abc/{name}_{un,}conditional_comparison_{run}.pkl``.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hint_tpu_torch.ops.base import resolve_device
from hint_tpu_torch.parallel.mesh import all_gather_rows

ArrayPair = Tuple[np.ndarray, np.ndarray]

# Disjoint seed space for the ABC prior pool (train=0 / test=1 streams live
# at small seeds — see prepare_samples below and data/loaders.py).
ABC_SEED_OFFSET = 0x5EED0000


# -- prior sweep -------------------------------------------------------------------


def _sample_chunk(args):
    model_factory, n, seed, engine, sub_batch, device = args
    model = model_factory()
    if engine == "tpu":
        kw = {} if sub_batch is None else {"sub_batch": sub_batch}
        if model.name == "lens-shape1":
            from hint_tpu_torch.data import lens_tpu

            return lens_tpu.sample_joint(n, seed=seed, device=device, **kw)
        if model.name == "plus-shape":
            from hint_tpu_torch.data import plus_tpu

            return plus_tpu.sample_joint(n, seed=seed, device=device, **kw)
        raise NotImplementedError(f"engine='tpu' supports the lens and plus families, got {model.name}")
    if engine in ("auto", "native"):
        from hint_tpu_torch.data import native

        try:
            # native sample_joint = prior + forward process in one pass
            return native.sample_joint(model.name, n, seed=seed)
        except native.NativeUnavailable as e:
            if engine == "native":
                raise
            print(f"native generator unavailable ({e!r}); numpy fallback (15-65x slower)")
    np.random.seed(seed)
    x = model.sample_prior(n).astype(np.float32)
    y = model.forward_process(x).astype(np.float32)
    return x, y


def prepare_samples(
    model_factory: Callable,
    n_total: int = int(1e8),
    out_dir: str = "abc",
    chunk: int = 10_000,
    n_workers: Optional[int] = None,
    seed: int = 0,
    engine: str = "auto",
    sub_batch: Optional[int] = None,
    device=None,
) -> ArrayPair:
    """Draw ``n_total`` prior samples + observations in parallel and cache to
    ``abc/{name}_{x,y}_huge.npy`` (rejection_sampling.py:76-85).

    ``model_factory`` must be picklable (the class itself works).
    ``engine``: "auto" (the C++ generator when it builds, else numpy),
    "native" (raises when it cannot be built), "numpy", or "tpu": the
    device sweep of the lens and plus families, in this process on
    ``device`` (CUDA unless named), ``sub_batch`` rows a device pass.
    """
    import multiprocessing as mp

    if engine not in ("auto", "native", "numpy", "tpu"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "tpu":
        device = resolve_device(device)
    # the engine a partial pool's .progress header records: the device
    # sweep's streams (torch.Generator) are not those of hint_tpu's engine of
    # the same name (threefry), so the two never resume each other's pool
    tag = "tpu-torch" if engine == "tpu" else engine
    model = model_factory()
    fx = os.path.join(out_dir, f"{model.name}_x_huge.npy")
    fy = os.path.join(out_dir, f"{model.name}_y_huge.npy")
    if os.path.exists(fx) and os.path.exists(fy):
        x = np.load(fx, mmap_mode="r")
        if x.shape[0] >= n_total:
            return np.load(fx, mmap_mode="r"), np.load(fy, mmap_mode="r")
    os.makedirs(out_dir, exist_ok=True)
    if engine in ("auto", "native"):  # build once in the parent, not in every worker
        from hint_tpu_torch.data import native

        try:
            native.load()
        except native.NativeUnavailable:
            if engine == "native":
                raise
    n_chunks = max(1, -(-n_total // chunk))  # ceil: never under-generate
    # memmap rows are written at i*chunk offsets; a ragged last chunk would
    # silently truncate, so the pool is rounded up instead
    n_total = n_chunks * chunk
    # Chunk i draws from stream ABC_SEED_OFFSET + seed + i: away from the
    # train (0) and test (1) streams of prepare_toy_data, so the ground-truth
    # pool never holds the training set, and a pool grown with the same chunk
    # size extends the smaller pool bit for bit.
    t0 = time.time()
    n_workers = n_workers or os.cpu_count()

    # Reference scale (1e8 rows) is 8-40 GB: rows are streamed into
    # uncompressed .npy memmaps at chunk offsets, with chunk-granular resume
    # via a sidecar progress file.
    tfx, tfy = fx + ".building", fy + ".building"
    prog_path = fx + ".progress"
    done = set()
    x_probe, y_probe = _sample_chunk((model_factory, 2, ABC_SEED_OFFSET + seed, engine, sub_batch, device))
    if os.path.exists(tfx) and os.path.exists(tfy) and os.path.exists(prog_path):
        with open(prog_path) as f:
            hdr = f.readline().split()
        # the engine is part of the pool's provenance: a partial pool is
        # resumed only under the engine that started it
        if hdr[:3] == [str(n_total), str(chunk), str(seed)]:
            if len(hdr) > 3 and hdr[3] == tag:
                with open(prog_path) as f:
                    done = {int(v) for v in f.read().split()[4:]}
            else:
                raise RuntimeError(
                    f"partial pool {tfx} was built with engine="
                    f"{hdr[3] if len(hdr) > 3 else '<unrecorded>'!r}, refusing "
                    f"to resume with engine={tag!r} — delete the .building/"
                    f".progress sidecars to rebuild from scratch"
                )
    if done:  # resume: reopen in place (header already on disk)
        xs = np.lib.format.open_memmap(tfx, mode="r+")
        ys = np.lib.format.open_memmap(tfy, mode="r+")
        if xs.shape != (n_total, x_probe.shape[1]):
            raise RuntimeError(f"partial pool {tfx} has shape {xs.shape}, expected {(n_total, x_probe.shape[1])}")
    else:
        xs = np.lib.format.open_memmap(tfx, mode="w+", dtype=np.float32, shape=(n_total, x_probe.shape[1]))
        ys = np.lib.format.open_memmap(tfy, mode="w+", dtype=np.float32, shape=(n_total, y_probe.shape[1]))
        with open(prog_path, "w") as f:
            f.write(f"{n_total} {chunk} {seed} {tag}\n")
    todo = [i for i in range(n_chunks) if i not in done]
    if todo:
        args = [(model_factory, chunk, ABC_SEED_OFFSET + seed + i, engine, sub_batch, device) for i in todo]
        with contextlib.ExitStack() as stack:
            if engine == "tpu":  # in-process serial loop: the device is the parallelism
                results = map(_sample_chunk, args)
            else:
                pool = stack.enter_context(mp.get_context("spawn").Pool(min(n_workers, len(todo))))
                results = pool.imap(_sample_chunk, args, chunksize=4)
            prog = stack.enter_context(open(prog_path, "a"))
            for j, (xc, yc) in enumerate(results):
                i = todo[j]
                xs[i * chunk : (i + 1) * chunk] = xc[:chunk]
                ys[i * chunk : (i + 1) * chunk] = yc[:chunk]
                prog.write(f"{i}\n")
                if (j + 1) % max(1, len(todo) // 100) == 0:
                    prog.flush()
                    rate = (j + 1) * chunk / max(time.time() - t0, 1e-9)
                    print(f"prepare_samples[{model.name}/{tag}]: {j + 1}/{len(todo)} chunks "
                          f"({rate:,.0f} rows/s, ETA {(len(todo) - j - 1) * chunk / rate / 60:.1f} min)",
                          flush=True)
    xs.flush()
    ys.flush()
    del xs, ys
    os.replace(tfx, fx)
    os.replace(tfy, fy)
    os.remove(prog_path)
    where = f"on {device}" if engine == "tpu" else f"{n_workers} workers"
    print(f"prepared {n_total:,} prior samples in {time.time() - t0:.1f}s ({where})")
    return np.load(fx, mmap_mode="r"), np.load(fy, mmap_mode="r")


# -- quantile ABC --------------------------------------------------------------------


def chunk_distances(y_chunk: torch.Tensor, y_target: torch.Tensor) -> torch.Tensor:
    """Float32 Euclidean distance of every row to the target. The squared
    differences are summed column after column, each step a fused
    multiply-add rounded once to float32 (emulated in float64, where the
    square is exact), as XLA's fused reduction computes it, and the square
    root is rounded correctly to float32 by way of float64 (PyTorch's
    vectorized float32 sqrt on the CPU is not): the same distances on every
    device, so a selection does not hang on the device's rounding."""
    diff = (y_chunk - y_target).double()
    d2 = (diff[:, 0] * diff[:, 0]).float()
    for j in range(1, diff.shape[1]):
        d2 = (diff[:, j] * diff[:, j] + d2.double()).float()
    return torch.sqrt(d2.double()).float()


def chunk_topk(y_chunk: torch.Tensor, y_target: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest distances of a chunk and their rows in it, ties
    to the lower row. ``torch.topk`` keeps an arbitrary subset of a tie, so
    it runs on int64 keys (the distance's float32 bits, which order like the
    non-negative floats, above the row): the k smallest keys are the first
    k rows of a stable argsort of the distances."""
    rows = torch.arange(y_chunk.shape[0], device=y_chunk.device)
    key = chunk_distances(y_chunk, y_target).view(torch.int32).long() * 2**32 + rows
    key = torch.topk(key, min(k, y_chunk.shape[0]), largest=False).values
    return (key >> 32).int().view(torch.float32), key & (2**32 - 1)


def quantile_ABC(
    x: np.ndarray, y, y_target: np.ndarray, n: int = 4000,
    device_chunk: int = 16_000_000, mesh=None, device=None,
) -> Tuple[np.ndarray, float]:
    """The ``n`` prior samples whose observations are closest to ``y_target``
    (excluding the single closest, matching the reference's ``[1:]`` slice —
    rejection_sampling.py:88-96). Returns (samples, threshold).

    Distance + top-k run chunked on the device (``y`` as a tensor: chunks
    are sliced where it lies; as an array: each chunk is uploaded to
    ``device``, CUDA unless named, or the mesh's). Ties go to the lower
    pool row, so the selection is a stable argsort of the pool's distances
    (``hint_tpu``'s follows ``lax.top_k``'s order among ties).

    With a ``mesh`` (``hint_tpu_torch.parallel``) each rank takes its
    contiguous block of every chunk, padded to the ranks' common block with
    rows at 1e15 (as ``hint_tpu``'s ``_pad_pool_rows``), keeps its block's
    ``k`` nearest under their pool rows, and the survivors of every rank
    are gathered in rank order. The chunk's ``k`` nearest are among them,
    and the merge orders by distance, then pool row: every rank selects
    the rows of the unsharded call, ties included.
    """
    dev = y.device if isinstance(y, torch.Tensor) else (
        mesh.device if mesh is not None else resolve_device(device))
    y_t = torch.as_tensor(np.asarray(y_target, np.float32).reshape(1, -1), device=dev)
    k = min(n + 2, y.shape[0])  # +1 for the dropped nearest, +1 for threshold
    best_d, best_i = [], []
    for start in range(0, y.shape[0], device_chunk):
        stop = min(start + device_chunk, y.shape[0])
        lo, hi = start, stop
        if mesh is not None:
            block = -(-(stop - start) // mesh.size)
            lo = min(start + mesh.rank * block, stop)
            hi = min(lo + block, stop)
        yc = y[lo:hi]
        if not isinstance(yc, torch.Tensor):
            yc = torch.as_tensor(np.array(yc, np.float32), device=dev)
        if mesh is not None and hi - lo < block:
            yc = torch.cat([yc, yc.new_full((block - (hi - lo), yc.shape[1]), 1e15)])
        d, i = chunk_topk(yc, y_t, k)
        i = i + lo  # pool rows
        if mesh is not None:
            real = i < hi  # the pad rows lie past the block
            both = torch.stack([d[real].double(), i[real].double()], dim=1)
            both = all_gather_rows(both, mesh)  # pool rows < 2**53: exact in float64
            d, i = both[:, 0].float(), both[:, 1].long()
        best_d.append(d.cpu().numpy())
        best_i.append(i.cpu().numpy())
    d = np.concatenate(best_d)
    i = np.concatenate(best_i)
    order = np.lexsort((i, d))[1:k]  # drop single nearest (:93)
    sel = i[order][:n]
    threshold = float(d[order[n]]) if len(order) > n else float(d[order[-1]])
    return np.ascontiguousarray(x[sel]), threshold


# -- conditional ground-truth correlation (rejection_sampling.py:105-132) -------------


def correlation_conditional(
    data_model, y_target, n: int = 4000, out_dir: str = "data", abc_dir: str = "abc",
    tol: float = 0.05, device=None,
) -> np.ndarray:
    """GT posterior correlation matrix for one target; cached like the
    reference (data/{name}_corr_conditional{_sample}.npy)."""
    y_target = np.asarray(y_target, np.float32)
    os.makedirs(out_dir, exist_ok=True)
    f_sample = os.path.join(out_dir, f"{data_model.name}_corr_conditional_sample.npy")
    if os.path.exists(f_sample):
        sample = np.load(f_sample)
    elif data_model.name.startswith("lens-shape"):
        x = np.load(os.path.join(abc_dir, f"{data_model.name}_x_huge.npy"), mmap_mode="r")
        y = np.load(os.path.join(abc_dir, f"{data_model.name}_y_huge.npy"), mmap_mode="r")
        sample, _ = quantile_ABC(x, y, y_target, n=n, device=device)
    else:  # plus-shape: target-conditioned rejection (rejection_sampling.py:113-127)
        from hint_tpu_torch.data import native

        sample = None
        try:  # native rejection loop: ~0.06 ms/trial vs ~1 ms in Python
            sample, _ = native.sample_plus_conditional(y_target, n, tol=tol)
        except native.NativeUnavailable:
            pass
        if sample is None or len(sample) < n:
            samples = []
            while len(samples) < n:
                coords, label = data_model.generate_plus_shape(forward=True, target=y_target)
                if np.sqrt(np.sum(np.square(y_target - label))) < tol:
                    samples.append(data_model.fourier_coeffs(coords, n_coeffs=data_model.n_parameters // 4))
            sample = data_model.flatten_coeffs(np.stack(samples))
    np.save(f_sample, sample)
    corr = np.corrcoef(sample.T)
    np.save(os.path.join(out_dir, f"{data_model.name}_corr_conditional.npy"), corr)
    return corr


# -- systematic comparisons ------------------------------------------------------------


def _to_numpy(sample) -> np.ndarray:
    if isinstance(sample, torch.Tensor):
        return sample.detach().cpu().numpy()
    return np.asarray(sample)


def _mmd_with_reject(sample: np.ndarray, gt: np.ndarray, device=None) -> Tuple[float, float]:
    """MMD computed on the finite rows only, with BOTH sides truncated to the
    surviving count (never resample survivors — that silently flatters a
    model whose tail diverges), plus the rejection rate to report alongside.
    mmd is NaN when <2 rows survive."""
    from hint_tpu_torch.evaluation.mmd import multi_mmd

    ok = np.isfinite(sample).all(axis=1) & (np.abs(sample).max(axis=1) < 1e6)
    k = int(ok.sum())
    rej = 1.0 - k / sample.shape[0]
    if k < 2:
        return float("nan"), rej
    return float(multi_mmd(sample[ok][:k], gt[:k], device=device)), rej


def compare_unconditional(
    data_model,
    samplers: Dict[str, Callable[[np.ndarray], np.ndarray]],
    n_runs: int = 100,
    sample_size: int = 4000,
    abc_dir: str = "abc",
    run: int = 0,
    seed: int = 0,
    verbose: bool = True,
    device=None,
) -> Dict[str, Dict[str, list]]:
    """MMD of each model's prior samples vs held-out true prior samples
    (rejection_sampling.py:135-165). ``samplers[name](z) -> x`` (an array or
    a tensor) inverts the shared latent batch. Draws are derived per run
    index from ``seed`` so an interrupted sweep resumes with identical
    latents."""
    x = np.load(os.path.join(abc_dir, f"{data_model.name}_x_huge.npy"), mmap_mode="r")
    out = {name: {"times": [], "mmds": [], "rejects": []} for name in samplers}
    for i in range(n_runs):
        rng = np.random.default_rng((seed, i))
        sel = rng.choice(x.shape[0], sample_size, replace=False)
        gt = np.ascontiguousarray(x[np.sort(sel)])
        z = rng.standard_normal((sample_size, data_model.n_parameters)).astype(np.float32)
        for name, sampler in samplers.items():
            t0 = time.time()
            sample = _to_numpy(sampler(z))
            out[name]["times"].append(time.time() - t0)
            mmd, rej = _mmd_with_reject(sample, gt, device)
            out[name]["mmds"].append(mmd)
            out[name]["rejects"].append(rej)
            if verbose:
                print(f"run {i + 1}/{n_runs} {name}: mmd={out[name]['mmds'][-1]:.5f} "
                      f"rej={rej:.3f} ({out[name]['times'][-1]:.3f}s)")
    _dump_comparison(out, os.path.join(abc_dir, f"{data_model.name}_unconditional_comparison_{run}.pkl"))
    return out


def compare_conditional(
    data_model,
    samplers: Dict[str, Callable[[np.ndarray, np.ndarray], np.ndarray]],
    n_runs: int = 1000,
    sample_size: int = 4000,
    abc_dir: str = "abc",
    run: int = 0,
    seed: int = 0,
    verbose: bool = True,
    checkpoint_every: int = 50,
    device=None,
) -> Dict[str, Dict[str, list]]:
    """Per-target posterior MMD vs quantile-ABC ground truth + forward-process
    distance (rejection_sampling.py:168-213). ``samplers[name](y_tiled, z) ->
    x``. GT posteriors cache to abc/{name}/{i:05}.pkl, reference layout. The
    observation pool is uploaded to the device once and stays there across
    targets.

    Progress checkpoints to ``<output>.partial`` every ``checkpoint_every``
    targets and resumes from it; the shared latents are derived per target
    index from ``seed``, so a resumed sweep is identical to an uninterrupted
    one.
    """
    from hint_tpu_torch.evaluation.metrics import mean_target_distance

    x = np.load(os.path.join(abc_dir, f"{data_model.name}_x_huge.npy"), mmap_mode="r")
    y = np.load(os.path.join(abc_dir, f"{data_model.name}_y_huge.npy"), mmap_mode="r")
    y = torch.as_tensor(np.array(y, np.float32), device=resolve_device(device))
    gt_dir = os.path.join(abc_dir, data_model.name)
    os.makedirs(gt_dir, exist_ok=True)
    final_path = os.path.join(abc_dir, f"{data_model.name}_conditional_comparison_{run}.pkl")
    part_path = final_path + ".partial"
    out = {name: {"times": [], "mmds": [], "dists": [], "rejects": []} for name in samplers}
    start = 0
    if os.path.exists(part_path):
        try:
            with open(part_path, "rb") as f:
                saved = pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError):  # a truncated checkpoint: start over
            saved = None
        if isinstance(saved, dict) and set(saved) == set(out):
            out = saved
            start = len(next(iter(out.values()))["mmds"])
    for i in range(start, n_runs):
        f_gt = os.path.join(gt_dir, f"{i:05}.pkl")
        cached = None
        try:
            with open(f_gt, "rb") as f:
                cached = pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError):  # missing or truncated: drawn anew
            pass
        if cached is not None and cached[1].shape[0] >= sample_size:
            y_target, gt_sample, threshold = cached
        else:
            # the observation comes from the joint sampler, not forward_process:
            # the plus-shape forward map exists only at generation time
            _, y_label = data_model.sample_joint(1)
            y_target = np.asarray(y_label, np.float32)
            gt_sample, threshold = quantile_ABC(x, y, y_target[0], n=sample_size)
            with open(f_gt, "wb") as f:
                pickle.dump((y_target, gt_sample, threshold), f)
        z = np.random.default_rng((seed, i)).standard_normal(
            (sample_size, data_model.n_parameters)
        ).astype(np.float32)
        y_tiled = np.broadcast_to(
            np.asarray(y_target, np.float32).reshape(1, -1), (sample_size, data_model.n_observations)
        )
        for name, sampler in samplers.items():
            t0 = time.time()
            sample = _to_numpy(sampler(y_tiled, z))
            out[name]["times"].append(time.time() - t0)
            mmd, rej = _mmd_with_reject(sample, gt_sample, y.device)
            out[name]["mmds"].append(mmd)
            out[name]["rejects"].append(rej)
            ok = np.isfinite(sample).all(axis=1)
            # forward-process distance only where the model defines a true
            # forward map (lens; has_forward_process=False for plus)
            out[name]["dists"].append(
                mean_target_distance(data_model, np.asarray(y_target).reshape(-1), sample[ok])
                if ok.any() and getattr(data_model, "has_forward_process", True)
                else float("nan")
            )
            if verbose:
                print(f"run {i + 1}/{n_runs} {name}: mmd={out[name]['mmds'][-1]:.5f} "
                      f"dist={out[name]['dists'][-1]:.5f} rej={rej:.3f} "
                      f"({out[name]['times'][-1]:.3f}s)")
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            _dump_comparison(out, part_path)
            print(f"compare_conditional: {i + 1}/{n_runs} targets", flush=True)
    _dump_comparison(out, final_path)
    if os.path.exists(part_path):
        os.remove(part_path)
    return out


def _dump_comparison(out: Dict, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(out, f)


def accumulate_metrics(
    data_model_name: str, conditional: bool, model_names, abc_dir: str = "abc", n_runs: int = 3
) -> Dict[str, Tuple[float, float]]:
    """mean ± std of per-run mean MMDs over the training runs
    (rejection_sampling.py:216-243)."""
    kind = "conditional" if conditional else "unconditional"
    mmds = {name: [] for name in model_names}
    for i in range(n_runs):
        path = os.path.join(abc_dir, f"{data_model_name}_{kind}_comparison_{i}.pkl")
        with open(path, "rb") as f:
            d = pickle.load(f)
        for name in model_names:
            if name in d:
                mmds[name].append(np.mean(d[name]["mmds"]))
    result = {}
    for name, vals in mmds.items():
        result[name] = (float(np.nanmean(vals)), float(np.nanstd(vals)))
        print(f"{name}: {result[name][0]:.3f} \\pm {result[name][1]:.3f}")
    return result


def check_mmd_kernels(x, y, widths_exponents=((1, 0.5), (0.2, 0.8), (0.2, 0.4)), out_path="mmd_kernels.png"):
    """Distance histograms overlaid with the MMD kernels, saved headless
    (rejection_sampling.py:33-53); needs matplotlib, imported here."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x, y = _to_numpy(x), _to_numpy(y)
    d_xx = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1).ravel()
    d_yy = np.sum((y[:, None, :] - y[None, :, :]) ** 2, axis=-1).ravel()
    d_xy = np.sum((x[:, None, :] - y[None, :, :]) ** 2, axis=-1).ravel()
    bins = np.linspace(0, 20, 100)
    plt.figure()
    for d, label in ((d_xx, "dxx"), (d_yy, "dyy"), (d_xy, "dxy")):
        plt.hist(d, bins, alpha=0.5, label=label, density=True)
    total = np.zeros_like(bins)
    for c, a in widths_exponents:
        k = c**a * ((c + bins) / a) ** -a
        total += k
        plt.plot(bins, k, label=f"{c:.2f}/{a:.2f}")
    plt.plot(bins, total, lw=2, c="k", label="sum")
    plt.legend(loc="upper right")
    plt.savefig(out_path, dpi=120)
    plt.close()
    return out_path
