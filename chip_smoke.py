#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``hint_tpu_torch``).

    python3 chip_smoke.py [--profile | --profile-only]

Needs one CUDA card and a checkout of the repository; imports nothing of
JAX or ``hint_tpu``. Three configs are driven at full width: the flagship
``plus_shape.unconditional_hint_4_full``, the condition-fed
``plus_shape.conditional_recursive_cinn_4`` (4 launches of the conditional
kernel per pass) and the two-lane ``plus_shape.conditional_hint_8_full``
(8 launches of the unconditional kernel per two-lane pass, 16 per
``/sample``); the UCI configs ``uci_data.power_hint_4`` and
``uci_data.miniboone_hint_4`` (d=6 and d=42) on fixture files, and the HAC
blocks of those and of ``uci_data.gas_hint_4`` (d=8) at their configs'
batches; the campaign's stages (``hint_tpu_torch.experiments.campaign``) on
the plus family, and the HAC blocks it trains at widths of their own (the
x lane of ``plus_shape.conditional_hint_4_full``, ``(224, 112, 56)``, and
``plus_shape.unconditional_hint_4_1``, ``(358, 179)`` with one split); and
the data-parallel path (``hint_tpu_torch.parallel``) in worlds of spawned
processes on the one card; and the port's entry points
(``hint_tpu_torch.entry``, ``hint_tpu_torch.bench``). Phases:

1. the card's name and power limit; build the forward and the backward
   kernels from ``hint_tpu_torch/ops/csrc`` (one nvcc per source, in
   parallel, sm_90a, one library) and print the build seconds and every
   kernel's registers and spills; build the native toy-data generator
   (``hint_tpu_torch/native``);
2. the kernel against its plain version (the levelwise engine) on the HAC
   block of each config and the campaign's two (``model.init`` weights, noise in every padded entry,
   the rows ``[split, in_max)`` before a condition-fed block's condition rows
   included), forward and inverse, f32 and bf16, batch 37 (ragged), 64, 4096
   and 10,000 (a UCI block: 37, its config's training batch and its whole
   test set as one batch, 204,928 rows for POWER), by the dtype's route
   (``fused_block``: 3xTF32 ``mma.sync`` in f32, ``wgmma`` in bf16), and,
   printed beside, by each route of the dtype (its tensor cores and the
   first port's CUDA-core loop); an Inf in a few rows of x (and of the
   condition) leaves every other row bit-identical, by every route;
3. serving the flagship with ``impl="fused"`` through
   ``InferenceService.from_checkpoint`` and the HTTP server: /health,
   /sample n=4096, /sample n=5000 (paged), /log_prob; the kernel's launch
   count over those requests, finite outputs, forward(inverse(z)) = z, the
   fused log_prob against the plain one, and /sample requests/s;
4. times with CUDA events (median of 5 rounds after warm-up): kernel and
   plain version per block-pass of each block at batch 4096 (serving) and
   10,000 (training; a UCI block at its training and test batches),
   beside the bound at the card's peak for the dtype (tensor cores: 3xTF32
   in f32, bf16 in bf16) and the CUDA-core bound; each route of the dtype
   alone in turns (tensor cores, loop, loop, tensor cores) beside the bound
   on that route; with ``--profile``, the tensor-core routes' cycle
   profiles (the ``build(profile=True)`` library) on each block at batch
   4096, and the backward data kernel's on the flagship block at batch
   10,000 (``--profile-only`` builds, prints that one and stops);
5. the kernel under autograd (``hac_fused._FusedBlock``: the forward
   kernel, then the backward kernels of ``csrc/hac_block_bwd.cu``) on the
   flagship block, the condition-fed block, the UCI blocks and the
   campaign's two, random rows
   at batch 37, 4096 and 10,000 (a UCI block: 37 and its training batch,
   below the weight kernel's 512 rows a chunk for two), forward and inverse, f32 and bf16: outputs against the
   plain version, the gradients of sum(y*r) + sum(logdet*q) for x, the
   condition and every level parameter against the plain version run in
   float64 (f32; the f32 plain version's own error beside) or in bf16, over
   the rows whose ReLU masks agree with the reference's (the rows that
   differ are counted, at most 1 %, and shown apart), 1 forward and 2
   backward launches per block, two calls bit-identical; at batch 10,000
   (a UCI block: its training batch) the weight kernel's f32 gradient
   against the sum in chunk order of each row chunk's own partials (a
   one-chunk weight launch over that chunk's rows), bit for bit, with
   ``torch.sum`` of those partials as the yardstick of its sum over the
   chunks, and the time of forward +
   backward, of the whole backward, of each backward kernel alone and of
   the plain versions, beside their bounds; the weight products as
   per-level-and-layer ``torch.bmm`` calls as a yardstick; the saving
   forward's regions (every level's input and S, every unit's a1 and a2,
   the output) against the plain version's activations (values and masks),
   its output bit-identical to its route's without saving (the loop in
   f32, the wgmma route in bf16); the forward kernel's time serving, and by
   the loop that saves f32 without and with saving in turns, beside the
   bound; the bf16 forward kernel by the wgmma route and by the loop,
   serving and saving, in turns, beside each route's bounds; the re-pack of
   a block's weights for a training step and for serving;
6. training the flagship through ``hint_tpu_torch.cli.main(["train", ...])``
   with ``--impl fused``: 2 epochs of 2 steps at the config's batch of 10,000
   on 20,000 generated plus-shape rows (kept, with their ``y``, for the later
   phases), 2 evaluations; the kernel's launch count (4 per train step, 4 per
   evaluation batch), the backward kernels' (2 per block and step), finite
   losses, the same run with ``--impl levelwise``
   step by step, ``--resume`` of the state after epoch 1, and the saved file
   sampled through the CLI and served with ``impl="fused"`` over HTTP;
7. flagship training times at batch 10,000 (synchronised CUDA events, median
   of 5 after warm-up): steps/s for fused and levelwise, f32 and bf16; the
   split of a fused f32 step into re-pack, forward, backward and optimizer;
   the device memory a fused and a levelwise f32 step allocate
   (``max_memory_allocated``); a ``torch.profiler`` table of the device operations and the idle gaps
   that take most of a step;
8. serving the two conditional configs as in phase 3, with the default
   ``vis_y_target`` and an explicit ``y_target`` (same seed, other samples),
   ``y`` beside ``x`` for /log_prob, forward(inverse(z, y), y) = z;
9. training them as in phase 6 on the same rows with their ``y`` (4 resp. 8
   launches per train step and per evaluation batch), ``sample --y-target``
   from the saved file;
10. their training times as in phase 7 (f32), and the share of the plain
    couplings and permutations in a two-lane step;
11. ``plus_shape.unconditional_hint_4_3_reshuffle`` at full width with
    ``impl="fused"``: its reshuffle blocks run the levelwise engine (no
    launch, the counter ``hac.reshuffle_levelwise``); one forward and
    backward at batch 4096 equal to ``impl="levelwise"`` (outputs bit for
    bit, gradients 1e-5);
12. the UCI path: fixture files in the reference's layout at the real sets'
    sizes (POWER 2,049,280 x 8, MINIBOONE 36,488 x 43, random values from a
    seed), ``train`` of ``uci_data.power_hint_4`` and
    ``uci_data.miniboone_hint_4`` through the CLI with ``--impl fused
    --uci-root`` (2 epochs x 2 steps at the configs' batches, each epoch
    evaluating the whole test set as one batch), the launch counts, finite
    losses and the UCI log-likelihood line; ``evaluate`` of the saved file;
    ``experiment uci`` and ``collect-uci`` on MINIBOONE (cut to 2 epochs x 2
    steps);
13. the evaluation path: 1,000 samples of the flagship trained in phase 6
    scored by ``experiments.drivers._score_shapes`` (the batched plus fit of
    1,000 curves x 9 restarts x 400 steps on the card, the IoU/DICE rasters,
    Hausdorff); the plus and lens shape-fit self-checks (IoU >= 0.9 and
    >= 0.85); ``prepare_samples(PlusShapeModel, engine="native")`` of a
    2,000,000-row prior pool (the reference draws 1e8); ``quantile_ABC`` for
    10 targets against a numpy stable argsort of the same distances; one
    target's top-k over the pool tiled to 1e8 rows (1.6 GB);
    ``compare_conditional`` for 5 targets with the conditional flow of phase
    9 as the sampler; ``multi_mmd`` at 4000 x 4000, d=100, against float64;
    the seconds of each stage. Then the device prior sweep:
    ``prepare_samples(engine="tpu")`` of a 2,000,000-row pool of each
    family (``data/{plus,lens}_tpu.py``), rows/s end to end beside the
    native pool's, device ms a sub-batch (CUDA events) beside the host's
    enqueue ms, the band, seam and bad shares of lens and the flag share of
    plus (each from its engine's column), a ``utils.profile_trace`` profile
    of one lens dispatch (device-busy share, top device operations), and a
    KS test per dimension of each device pool against native rows of its
    family (the native plus pool; 200,000 native lens rows), alpha 1e-4;
14. the campaign in a directory of its own, its configs cut in depth
    only (2 epochs x 2 steps at the configs' batches; 20,000 + 10,000 toy
    rows), ``impl="fused"``: ``main(["data", "--family", "plus"])``;
    ``stage_train`` of the four plus configs (launches counted, finite
    losses); a removed checkpoint replayed by ``_load_state`` within
    0.05 nats of its logged loss; ``stage_pool`` of 200,000 native rows;
    ``stage_compare`` conditional (5 targets) and unconditional (2 runs) at
    4,000 samples (finite MMDs); ``stage_shapes`` of 100 curves of the two
    hint models; ``stage_grid`` of ``plus_shape.unconditional_hint_4_1``;
    ``stage_uci`` on phase 12's fixtures (POWER and MINIBOONE; GAS absent,
    skipped); ``main(["report"])`` and its sections; ``stage_figures`` only
    where matplotlib imports; the seconds and launches of each stage;
15. data parallel: a 2-rank world (``parallel.dryrun.spawn``, gloo over
    CUDA tensors, both ranks on the one card) takes 4 fused f32 steps of the
    flagship at batch 10,000 (5,000 rows a rank) on phase 6's rows, held to
    the single process on the same rows and noise (each step's loss within
    1e-4 relative, every leaf within 1e-4 of 1+max|ref|), the two replicas
    bit-identical, 4 forward and 8 backward launches a rank and step; a
    full-batch evaluation; ``sample_model`` of 4,097 rows (padded to 4,098)
    from the flagship, ``RCINN`` and ``CHINT``, quantile-ABC over phase 13's
    pool (10 targets), ``multi_mmd`` at 4000 x 4000 and the shape fits and
    IoU/DICE of 100 curves, each against the unsharded call (within 1e-5;
    quantile-ABC the same rows); each rank's ms a step and the ms of its
    all-reduce beside the single process's step (two ranks on one card
    measure the overhead of the step, not its scaling); ``parallel.dryrun``
    with ``impl="fused"``; in each rank, ``all_gather_rows`` of ragged f32
    and bf16 rows holding -0.0, ±Inf and a NaN payload, and ``map_rows`` of
    a function returning -0.0, bit for bit. Then a 1-rank NCCL world of the
    same 4 steps and gathers, bit-identical to the single process;
16. the port's entry points: ``hint_tpu_torch.entry.entry()`` under
    ``impl="fused"`` and ``"levelwise"`` (the flagship's NLL of 1,024 rows:
    finite, fused within 1e-4 of levelwise, 4 launches), then on a second
    parameter dict (new tensors over the first's halved buffers, made after
    the first is freed: each at a freed tensor's address and version, and
    its own loss, not a stale pack's); ``python -m hint_tpu_torch.bench``
    through its supervisor for ``{fused, levelwise} x {float32, bfloat16}``
    (one JSON line each with ``bench.py``'s keys and the card's name and
    power limit; 4 forward and 8 backward launches a fused step, the 4
    forward ones in bf16 by the wgmma route; the CPU baseline in the first
    run only); ``entry.dryrun_multichip(1)``;
17. a ``{"kernels": [...]}`` line (``hac_block``, ``hac_block_conditional``,
    ``hac_block_wgmma`` (the forward kernel's bf16 route: its launches in
    the fused bf16 bench, its times serving and saving beside its bounds),
    ``hac_block_gradient``, ``hac_block_backward``,
    ``hac_block_backward_weights``, which holds the sum over the row
    chunks that a third kernel made before; each
    with the launches of every path, the campaign's, the data-parallel
    path's and the entry points' included, the UCI and the campaign blocks'
    errors and times beside their bounds), the card's line, then
    ``{"ok": true, "device": {...}}`` last.

Any failed check exits non-zero before the last line is printed.
"""

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

FLAGSHIP = "plus_shape.unconditional_hint_4_full"
RCINN = "plus_shape.conditional_recursive_cinn_4"
CHINT = "plus_shape.conditional_hint_8_full"
DIM = 100
# the HAC block of each config: (dim, c_internal, cond_dim)
BLOCKS = {
    "flagship": (DIM, (263, 131, 65, 32, 32), 0),
    "conditional": (DIM, (267, 133, 66), 4),  # RCINN: the condition-fed kernel
    "x_lane": (DIM, (152, 76, 38), 0),  # CHINT: the unconditional kernel on its x lane
    # uci_data.{power,gas,miniboone}_hint_4: shallow trees with 1-dimensional halves
    "uci_power": (6, (200, 100, 50, 25), 0),
    "uci_gas": (8, (184, 92, 46, 23), 0),
    "uci_miniboone": (42, (102, 51, 25, 12), 0),
    # the campaign's widths: the x lane of plus_shape.conditional_hint_4_full
    # and the block of plus_shape.unconditional_hint_4_1 (one split)
    "campaign_x_lane": (DIM, (224, 112, 56), 0),
    "grid_4_1": (DIM, (358, 179), 0),
}
# the depth of a block's tree where its config cuts it (max_splits; -1 full)
MAX_SPLITS = {"grid_4_1": 1}
CAMPAIGN_BLOCKS = ("campaign_x_lane", "grid_4_1")
# the UCI blocks' batches: the config's training batch and its test set,
# which evaluation takes as one batch (None: GAS reads a pandas pickle, so its
# set is not loaded on the card)
UCI_BATCHES = {"uci_power": (1660, 204_928), "uci_gas": (853, None), "uci_miniboone": (300, 3_648)}
BUCKET = 4096
# kernel vs plain version. f32: the kernel sums each product in another
# order than the plain version's matmuls, through 7 levels of exp-scaled
# couplings. bf16: both round the same activations to bf16, but one that
# sits on a rounding boundary can land one bf16 ulp (2**-8) apart.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a served flow: round trip and fused-vs-plain log_prob (f32)
ROUND_TRIP_TOL = 1e-3
LOG_PROB_TOL = (1e-3, 1e-4)  # (abs, rel)
# the backward kernels (hac_fused._FusedBlock's backward) and the f32 plain
# version (autograd through the levelwise engine) against the plain version
# in float64 on a double() copy of the block, over the rows whose ReLU masks
# agree. Both sum 10,000-row weight gradients and the reverse chain in other
# orders over values with cancellation, so the error is taken per leaf in
# units of the leaf's scale, |d| / (1 + max |ref|): the kernels' at most
# GRAD_REL times the plain version's own and at most GRAD_TOL. bf16 against
# the bf16 plain version: the same roundings, one bf16 ulp apart on a
# boundary.
GRAD_TOL, GRAD_REL, GRAD_TOL_BF16 = 1e-4, 2.0, 2e-2
# fused vs levelwise training, per-step loss (f32): the kernels sum in other
# orders than the levelwise engine (phases 2 and 5)
TRAIN_LOSS_TOL = 1e-4
# a resumed epoch against the uninterrupted one: same code, same draws; the
# kernels are deterministic, the levelwise parts' atomics are not
RESUME_TOL = 1e-5
TRAIN_BATCH = 10_000
STEPS_PER_EPOCH = 2
TRAIN_ARGS = ["--n-train", str(STEPS_PER_EPOCH * TRAIN_BATCH), "--n-test", str(TRAIN_BATCH),
              "--max-batches", str(STEPS_PER_EPOCH)]
# published H100 SXM peaks (NVIDIA data sheet): f32 CUDA cores, bf16 and
# TF32 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
# the tensor-core route per compute dtype, of the forward kernel's ROUTE_TC
# and of the backward weight kernel: (name, passes per product, peak); f32
# takes three TF32 products per product
TC_ROUTE = {"float32": ("3xTF32", 3, PEAK_FLOPS["tf32"]), "bfloat16": ("bf16", 1, PEAK_FLOPS["bfloat16"])}
# the stock config whose blocks reshuffle: impl="fused" runs them levelwise
RESHUFFLE = "plus_shape.unconditional_hint_4_3_reshuffle"
# its fused vs levelwise gradients: the same engine, but the levelwise
# backward's atomics (index ops) sum in no fixed order
RESHUFFLE_GRAD_TOL = 1e-5


class CheckFailed(AssertionError):
    pass


# the program's counters (hint_tpu_torch.utils.instrument), read from the last reset_counts()
_COUNTED_FROM = {}


def reset_counts():
    from hint_tpu_torch.utils import instrument

    _COUNTED_FROM.clear()
    _COUNTED_FROM.update(instrument.snapshot())


def counted(name):
    """The growth of the program's counter ``name`` since ``reset_counts()``."""
    from hint_tpu_torch.utils import instrument

    return instrument.get(name) - _COUNTED_FROM.get(name, 0)


def check(ok, what):
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise CheckFailed(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def block_batches(kind):
    """The batches of a block of ``BLOCKS`` in phase 2 (kernel vs plain),
    phase 4 (times) and phase 5 (gradients; the last one timed): for a UCI
    block its config's training batch and full test batch."""
    if kind in UCI_BATCHES:
        train, test = UCI_BATCHES[kind]
        full = (test,) if test else ()
        return (37, train, *full), (train, *full), (37, train)
    return (37, 64, BUCKET, TRAIN_BATCH), (BUCKET, TRAIN_BATCH), (37, BUCKET, TRAIN_BATCH)


def make_block(torch, kind, compute_dtype, requires_grad=False):
    """One HAC block of ``BLOCKS``, model.init weights, noise in the padding
    (for a condition-fed block that includes the rows [split, in_max) of w0
    that lie before its condition rows)."""
    from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling

    dim, c_internal, cond_dim = BLOCKS[kind]
    hac = HierarchicalAffineCoupling(
        dim=dim, c_internal=c_internal, cond_dim=cond_dim, compute_dtype=compute_dtype, impl="fused",
        max_splits=MAX_SPLITS.get(kind, -1),
    )
    hac.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for li, lv in enumerate(hac.levels):
            p, n = hac.level_params(li), len(lv.nodes)
            for u in range(2 * n):
                nd = lv.nodes[u % n]
                out_i = nd.dim - nd.split
                for t in (p["w0"][u, nd.split : lv.in_max], p["w2"][u, :, out_i:], p["b2"][u, out_i:]):
                    t.copy_(torch.randn(t.shape, generator=g))
    return hac.cuda().requires_grad_(requires_grad)


def block_work(hac, batch, compute_dtype, tensor_cores=False):
    """(FLOPs, bytes, bound ms, what bounds it) of one block-pass: the
    logical subnet products (the condition's layer-1 terms included), x and
    the condition read and y/logdet written once, the weights read once.
    The operations run on the f32 CUDA cores, or on the tensor-core route of
    ``compute_dtype`` (``TC_ROUTE``)."""
    flops = 2 * batch * sum(
        2 * ((nd.split + hac.cond_dim) * nd.hidden + nd.hidden * nd.hidden + nd.hidden * (nd.dim - nd.split))
        for lv in hac.levels for nd in lv.nodes
    )
    n_bias = sum(
        2 * (2 * nd.hidden + nd.dim - nd.split) for lv in hac.levels for nd in lv.nodes
    )
    wbytes = 2 if compute_dtype == "bfloat16" else 4
    nbytes = (4 * (2 * batch * hac.dim + batch + batch * hac.cond_dim)
              + wbytes * (hac.n_params - n_bias) + 4 * n_bias)
    _, passes, peak = TC_ROUTE[compute_dtype] if tensor_cores else ("", 1, PEAK_FLOPS["float32"])
    by_ops, by_bytes = passes * flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return flops, nbytes, max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def time_ms(torch, fn, reps, warmup=3, rounds=5):
    """Median over rounds of the mean ms per call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_round = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_round.append(start.elapsed_time(end) / reps)
    return statistics.median(per_round)


def http(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def rel_err(a, b):
    """max |a - b| / (1 + |b|) as a float."""
    return float(((a - b).abs() / (1 + b.abs())).max())


def randn(torch, g, *shape):
    return torch.randn(shape, generator=g, device="cuda")


# -- phase 2 ----------------------------------------------------------------------------


def routes(hac_fused, compute_dtype):
    """The forward kernel's routes by name in ``compute_dtype``: the tensor
    cores (3xTF32 ``mma.sync`` in f32, ``wgmma`` in bf16), in f32 the tiled
    route (the loop's chains fed from shared memory, which saves) and the
    first port's CUDA-core loop (csrc/hac_block.cu)."""
    if compute_dtype == "float32":
        return {"tensor_cores": hac_fused.ROUTE_TC, "tiled": hac_fused.ROUTE_TILED,
                "cuda_core_loop": hac_fused.ROUTE_LOOP}
    return {"wgmma": hac_fused.ROUTE_WG, "cuda_core_loop": hac_fused.ROUTE_LOOP}


def tc_name(compute_dtype):
    """The name of the dtype's tensor-core route in ``routes``."""
    return "tensor_cores" if compute_dtype == "float32" else "wgmma"


def route_name(hac_fused, compute_dtype, saving=False):
    """The route ``hac_block_launch`` takes for ``compute_dtype`` to serve,
    or with ``saving`` to save."""
    take = (hac_fused._SAVE_ROUTE if saving else hac_fused._FWD_ROUTE)[compute_dtype]
    return next(k for k, v in routes(hac_fused, compute_dtype).items() if v == take)


def kernel_vs_plain(torch, hac_fused, kind, blocks):
    """The kernel against its plain version on one block of ``BLOCKS``: the
    dtype's route (``fused_block``, what ``hac_block_launch`` takes) gated,
    and every route by name beside it. Returns {dtype: [max abs, max
    |d|/(1+|ref|)]} of the dtype's route and {dtype: {route: [max abs, max
    rel]}}."""
    dim, _, cond_dim = BLOCKS[kind]
    errs = {dt: [0.0, 0.0] for dt in TOL}
    by_route = {dt: {r: [0.0, 0.0] for r in routes(hac_fused, dt)} for dt in TOL}
    g = torch.Generator(device="cuda").manual_seed(2)
    for dt, hac in blocks.items():
        for batch in block_batches(kind)[0]:
            x = randn(torch, g, batch, dim)
            c = randn(torch, g, batch, cond_dim) if cond_dim else None
            for rev in (False, True):
                with torch.no_grad():
                    yp, ldp = hac_fused.plain_block(hac, x, c, rev)
                    runs = {None: hac_fused.fused_block(hac, x, c, rev)}
                    for name, route in routes(hac_fused, dt).items():
                        runs[name] = hac_fused._run_block(hac, x, c, rev, route)
                torch.cuda.synchronize()
                tag = f"{kind} {dt} {'inverse' if rev else 'forward'} B={batch}"
                for name, (yk, ldk) in runs.items():
                    d_abs = max(float((yk - yp).abs().max()), float((ldk - ldp).abs().max()))
                    d_rel = max(rel_err(yk, yp), rel_err(ldk, ldp))
                    acc = errs[dt] if name is None else by_route[dt][name]
                    acc[:] = [max(acc[0], d_abs), max(acc[1], d_rel)]
                    finite = bool(torch.isfinite(yk).all() and torch.isfinite(ldk).all())
                    what = (f"max_abs={d_abs:.3e} max_rel={d_rel:.3e} (tol {TOL[dt]:g}: |d| <= tol*(1+|ref|))")
                    if name is None:
                        check(finite and d_rel <= TOL[dt],
                              f"{tag} fused_block ({route_name(hac_fused, dt)}): {what}")
                    else:
                        print(f"  {tag} by {name}: {what}" + ("" if name == route_name(hac_fused, dt) else
                              ", not the dtype's route: printed, not gated"), flush=True)
    return errs, by_route


def inf_rows(torch, hac_fused, kind, blocks):
    """An Inf in the first column of a few rows of x (and of the condition)
    changes no other row, by every route: each other row is bit-identical
    to the run without the Inf, and finite. A read past a node's split or
    the condition's width would land on the row after it."""
    dim, _, cond_dim = BLOCKS[kind]
    g = torch.Generator(device="cuda").manual_seed(3)
    x = randn(torch, g, 64, dim)
    c = randn(torch, g, 64, cond_dim) if cond_dim else None
    bad = [5, 32, 47]
    xi, ci = x.clone(), None if c is None else c.clone()
    for t in (xi, ci):
        if t is not None:
            t[bad, 0] = float("inf")
    keep = torch.ones(64, dtype=torch.bool, device="cuda")
    keep[bad] = False
    for dt, hac in blocks.items():
        for name, route in routes(hac_fused, dt).items():
            same = True
            for rev in (False, True):
                with torch.no_grad():
                    y, ld = hac_fused._run_block(hac, x, c, rev, route)
                    yi, ldi = hac_fused._run_block(hac, xi, ci, rev, route)
                same &= bool(torch.equal(yi[keep], y[keep]) and torch.equal(ldi[keep], ld[keep])
                             and torch.isfinite(yi[keep]).all() and torch.isfinite(ldi[keep]).all())
            check(same, f"{kind} {dt} by {name}: Inf in x{' and the condition' if cond_dim else ''} of rows "
                        f"{bad} of 64, forward and inverse: every other row bit-identical and finite")


# -- phases 3 and 8 -----------------------------------------------------------------------


def serve_phase(np, torch, hac_fused, name, tmp):
    """Serve ``name`` (random weights from a seed, halved) with impl="fused"
    over HTTP and check what comes back. Returns the kernel launches of the
    checked requests and the /sample rates."""
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.serve import InferenceService, make_server
    from hint_tpu_torch.train.checkpoint import save_params_npz

    cfg = get_config(name)
    model = cfg.build_model(impl="fused")
    model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)  # at full init scale the random chain's inverse overflows f32
    ckpt = os.path.join(tmp, f"{name}.random.npz")
    save_params_npz(ckpt, model)
    del model
    svc = InferenceService.from_checkpoint(name, ckpt, impl="fused")
    plain = InferenceService.from_checkpoint(name, ckpt, impl="levelwise")
    t0 = time.perf_counter()
    svc.warmup()
    print(f"  warmup (every bucket, sample + log_prob): {time.perf_counter() - t0:.2f} s")
    n_hac = sum(type(m).__name__ == "HierarchicalAffineCoupling" for m in svc.model.modules())
    two_lane = cfg.model_type == "conditional_hint"
    dy = cfg.ndim_y
    y_rows = np.tile(np.asarray(cfg.vis_y_target, np.float32), (BUCKET, 1)) if dy else None
    with_y = {"y": y_rows.tolist()} if dy else {}
    httpd = make_server(svc, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        port = httpd.server_port
        reset_counts()
        health = http(port, "/health")
        x = np.asarray(http(port, "/sample", {"n": BUCKET, "seed": 0})["x"], np.float32)
        if dy:
            other = {"n": BUCKET, "seed": 0, "y_target": [0.5] * dy}
            x_other = np.asarray(http(port, "/sample", other)["x"], np.float32)
        x_paged = np.asarray(http(port, "/sample", {"n": 5000, "seed": 1})["x"], np.float32)
        lp = np.asarray(http(port, "/log_prob", {"x": x.tolist(), **with_y})["log_prob"], np.float32)
        launches = counted("hac.launches")
        # a two-lane /sample is one forward (for z_y) and one inverse; a paged
        # n=5000 is two pages of 4096
        per_sample = 2 if two_lane else 1
        passes = per_sample * (1 + (1 if dy else 0) + 2) + 1
        check(health == {"status": "ok", "config": name}, f"/health {health}")
        check(
            launches == n_hac * passes,
            f"kernel launches over the requests: {launches} (= {n_hac} blocks x {passes} passes)",
        )
        check(x.shape == (BUCKET, DIM) and np.isfinite(x).all(), f"/sample n={BUCKET}: {x.shape}, finite")
        if dy:
            moved = float(np.abs(x_other - x).max())
            check(x_other.shape == x.shape and np.isfinite(x_other).all() and moved > 1e-2,
                  f"/sample with y_target={[0.5] * dy} and the same seed: finite, differs from the "
                  f"default y_target={list(cfg.vis_y_target)} by up to {moved:.3f}")
        check(x_paged.shape == (5000, DIM) and np.isfinite(x_paged).all(), f"/sample n=5000: {x_paged.shape}, finite")
        check(lp.shape == (BUCKET,) and np.isfinite(lp).all(), f"/log_prob{' with y' if dy else ''}: {lp.shape}, finite")
        # the service draws the sampled latents first from the request's generator
        z = randn(torch, torch.Generator(device="cuda").manual_seed(0), BUCKET, DIM)
        with torch.no_grad():
            xd = torch.from_numpy(x).cuda()
            yd = torch.from_numpy(y_rows).cuda() if dy else None
            z_back = svc.model(yd, xd)[1] if two_lane else svc.model(xd, yd)[0]
        rt = rel_err(z_back, z)
        check(rt <= ROUND_TRIP_TOL,
              f"forward(inverse(z{', y' if dy else ''}){', y' if dy else ''}) = z: max |d|/(1+|z|) = {rt:.3e} (tol {ROUND_TRIP_TOL:g})")
        lp_plain = plain.log_prob(x, y_rows)
        lp_err = float(np.abs(lp - lp_plain).max())
        lp_ok = bool(np.all(np.abs(lp - lp_plain) <= LOG_PROB_TOL[0] + LOG_PROB_TOL[1] * np.abs(lp_plain)))
        check(lp_ok, f"fused log_prob vs plain: max_abs={lp_err:.3e} (tol {LOG_PROB_TOL[0]:g} + {LOG_PROB_TOL[1]:g}|lp|), "
              f"mean log_prob {float(lp.mean()):.3f}")
        reqs = 10
        t0 = time.perf_counter()
        for i in range(reqs):
            http(port, "/sample", {"n": BUCKET, "seed": i})
        http_rps = reqs / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for i in range(reqs):
            svc.sample(BUCKET, seed=i)
        svc_rps = reqs / (time.perf_counter() - t0)
        print(f"  /sample n={BUCKET}: {http_rps:.2f} requests/s over HTTP, "
              f"{svc_rps:.2f} calls/s to InferenceService.sample")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    return {"launches": launches, "sample_http_rps": http_rps, "sample_service_rps": svc_rps}


# -- phase 4 -------------------------------------------------------------------------------


def block_times(torch, hac_fused, kind, blocks):
    """Kernel and plain version per block-pass at the serving and the
    training batch: the dtype's route (``fused_block``) beside the bound at
    the card's peak for the dtype (the tensor cores: 3xTF32 in f32, bf16 in
    bf16; ``bound_ms``) and the CUDA-core bound of earlier rows, whatever
    route serves it; then each route alone in turns (tensor cores, loop,
    loop, tensor cores: 3xTF32 in f32, wgmma in bf16), each beside the bound
    on that route. Returns {variant: {ms, route, plain_ms, bound_ms, ...,
    routes}}."""
    dim, _, cond_dim = BLOCKS[kind]
    g = torch.Generator(device="cuda").manual_seed(4)
    variants = {}
    with torch.no_grad():
        for batch in block_batches(kind)[1]:
            xb = randn(torch, g, batch, dim)
            cb = randn(torch, g, batch, cond_dim) if cond_dim else None
            for dt, hac in blocks.items():
                for rev in (False, True):
                    name = f"{dt}_{'inverse' if rev else 'forward'}" + (
                        "" if batch == BUCKET and kind not in UCI_BATCHES else f"_b{batch}")
                    k_ms = time_ms(torch, lambda: hac_fused.fused_block(hac, xb, cb, rev), reps=20)
                    p_ms = time_ms(torch, lambda: hac_fused.plain_block(hac, xb, cb, rev), reps=5)
                    names = routes(hac_fused, dt)
                    per_route = {r: [] for r in names}
                    for r in (*names, *reversed(names)):
                        route = names[r]
                        per_route[r].append(time_ms(torch, lambda: hac_fused._run_block(hac, xb, cb, rev, route),
                                                    reps=20))
                    rt = {}
                    for r, times in per_route.items():
                        flops, nbytes, bound, bound_by = block_work(hac, batch, dt, r == tc_name(dt))
                        rt[r] = {"ms": min(times), "ms_turns": times, "bound_ms": bound, "bound_by": bound_by}
                    mine = route_name(hac_fused, dt)
                    peak = rt[tc_name(dt)]  # the card's peak for the dtype, whichever route serves it
                    cc_bound = block_work(hac, batch, dt)[2]
                    variants[name] = {"ms": k_ms, "route": mine, "plain_ms": p_ms, "bound_ms": peak["bound_ms"],
                                      "bound_by": peak["bound_by"], "cuda_core_bound_ms": cc_bound,
                                      "tflops": flops / k_ms / 1e9, "routes": rt}
                    print(f"  hac_block {kind} {name} B={batch}: kernel ({mine}) {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                          f"bound at the card's {TC_ROUTE[dt][0]} peak {peak['bound_ms']:.4f} ms by "
                          f"{peak['bound_by']} (CUDA-core bound {cc_bound:.4f}; {flops / 1e9:.3f} GFLOP, "
                          f"{nbytes / 1e6:.2f} MB), {flops / k_ms / 1e9:.2f} TFLOP/s; routes in turns: "
                          + ", ".join(f"{r} {' / '.join(f'{t:.4f}' for t in v['ms_turns'])} ms (bound on the route "
                                      f"{v['bound_ms']:.4f})" for r, v in rt.items()), flush=True)
    return variants


def route_profiles(torch, hac_fused, blocks):
    """Where the tensor-core routes' cycles go, and the f32 tiled route's
    saving forward's: the profile build of the kernel
    (``hac_fused.build(profile=True)``, clock64 counters per phase, summed
    over warps and blocks) on each block at batch 4096, forward, f32
    (3xTF32; tiled, its phases ``hac_fused.TL_PROFILE_PHASES``) and bf16
    (wgmma, its phases ``hac_fused.WG_PROFILE_PHASES``), as shares of the
    warps' cycles. The default library is put back after."""
    path, _, _ = hac_fused.build(profile=True)
    plib, lib = hac_fused._load(path), hac_fused._library()
    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    try:
        hac_fused._lib = plib
        for kind, by_dt in blocks.items():
            dim, _, cond_dim = BLOCKS[kind]
            x = randn(torch, g, BUCKET, dim)
            c = randn(torch, g, BUCKET, cond_dim) if cond_dim else None
            for dt, hac in by_dt.items():
                route = routes(hac_fused, dt)[tc_name(dt)]
                with torch.no_grad():
                    hac_fused._run_block(hac, x, c, False, route)
                    torch.cuda.synchronize()
                    hac_fused.profile_read(plib)
                    hac_fused._run_block(hac, x, c, False, route)
                    torch.cuda.synchronize()
                prof = hac_fused.profile_read(plib)
                if dt == "bfloat16":
                    prof = dict(zip(hac_fused.WG_PROFILE_PHASES, prof.values()))
                total = sum(prof.values())
                out[f"{kind}_{dt}"] = {k: v / total for k, v in prof.items()}
                print(f"  {tc_name(dt)} route profile, {kind} {dt} B={BUCKET}: "
                      + ", ".join(f"{k} {100 * v / total:.1f} %" for k, v in prof.items()), flush=True)
                if dt == "float32":  # the tiled route's saving forward, its phases TL_PROFILE_PHASES
                    saved = hac_fused.saved_buffer(hac, x)
                    with torch.no_grad():
                        hac_fused._run_block(hac, x, c, False, hac_fused.ROUTE_TILED, saved)
                        torch.cuda.synchronize()
                    tl = dict(zip(hac_fused.TL_PROFILE_PHASES, hac_fused.profile_read(plib).values()))
                    total = sum(tl.values())
                    out[f"{kind}_tiled"] = {k: v / total for k, v in tl.items()}
                    print(f"  tiled route profile (saving), {kind} B={BUCKET}: "
                          + ", ".join(f"{k} {100 * v / total:.1f} %" for k, v in tl.items()), flush=True)
    finally:
        hac_fused._lib = lib
    return out


def saving_forward(torch, hac_fused, hac, x, c, rev):
    """The saved buffer of a saving forward of ``x`` (one launch of the
    forward kernel with its save epilogue), and its (y, logdet)."""
    saved = hac_fused.saved_buffer(hac, x)
    with torch.no_grad():
        out = hac_fused._run_block(hac, x, c, rev, saved=saved)
    return saved, out


def data_kernel_profile(torch, hac_fused, kind="flagship", batch=TRAIN_BATCH):
    """Where the backward data kernel's cycles go: its profile build
    (``hac_fused.build(profile=True)``, clock64 counters per phase, summed
    over warps and blocks; a phase ends at the barrier after it) on one block
    of ``BLOCKS`` at ``batch``, forward pass, f32 and bf16, over the saved
    buffer of a saving forward, as shares of the warps' cycles and as those
    shares of the data kernel's time (CUDA events, the default library). The
    default library is put back after. Returns {dtype: {"ms": ..., "shares":
    {phase: share}}}."""
    path, _, _ = hac_fused.build(profile=True)
    plib, lib = hac_fused._load(path), hac_fused._library()
    dim, _, cond_dim = BLOCKS[kind]
    g = torch.Generator(device="cuda").manual_seed(7)
    x, gy, gld = randn(torch, g, batch, dim), randn(torch, g, batch, dim), randn(torch, g, batch)
    c = randn(torch, g, batch, cond_dim) if cond_dim else None
    out = {}
    for dt in TOL:
        hac = make_block(torch, kind, dt)
        saved, _ = saving_forward(torch, hac_fused, hac, x, c, False)
        run = hac_fused.BackwardLaunch(hac, saved, c, False, gy, gld, want_w=False)
        ms = time_ms(torch, run.data, reps=5, warmup=2)
        try:
            hac_fused._lib = run.lib = plib
            run.data()
            torch.cuda.synchronize()
            hac_fused.profile_read(plib, backward=True)
            run.data()
            torch.cuda.synchronize()
            prof = hac_fused.profile_read(plib, backward=True)
        finally:
            hac_fused._lib = run.lib = lib
        total = sum(prof.values())
        shares = {k: v / total for k, v in prof.items()}
        out[dt] = {"ms": ms, "shares": shares}
        print(f"  data kernel profile, {kind} {dt} B={batch}, forward: {ms:.4f} ms; "
              + ", ".join(f"{k} {100 * v:.1f} % ({v * ms:.4f} ms)" for k, v in shares.items()), flush=True)
    return out


# -- phase 5 -------------------------------------------------------------------------------


def backward_work(hac, batch, compute_dtype):
    """{kernel: (FLOPs, bytes, bound ms, what bounds it)} of the two backward
    kernels, each as a function of its own inputs and outputs. The data
    kernel does the forward's products once (the reverse chain, transposed);
    it reads g_y, g_logdet, the weights and, per level, the saved S, a1, a2
    and the level's input (forward pass) or output (inverse pass) that the
    saving forward wrote, and writes dx, dcond and the gradient buffer the
    weight kernel reads (every level's dS, dT and every unit's dpre1,
    dpre2). The weight kernel does the forward's products once more, reads
    both buffers (every level's input, dS, dT, a1, a2, dpre1, dpre2) and the
    condition and writes one f32 gradient per parameter (its row chunks'
    partial sums are scratch, not output). Both run on their tensor-core
    route (``TC_ROUTE``)."""
    flops, _, _, _ = block_work(hac, batch, compute_dtype)
    n_bias = sum(2 * (2 * nd.hidden + nd.dim - nd.split) for lv in hac.levels for nd in lv.nodes)
    wbytes = 2 if compute_dtype == "bfloat16" else 4
    acts = sum(2 * 2 * len(lv.nodes) * lv.hidden for lv in hac.levels)  # a1, a2 (or dpre1, dpre2) a row
    ws_row = 3 * hac.dim * len(hac.levels) + 2 * acts
    n_all = sum(p.numel() for p in hac.parameters())
    io = {
        "data": (flops, 4 * batch * (2 * hac.dim * len(hac.levels) + acts + 2 * hac.dim + 1 + hac.cond_dim
                                     + 2 * hac.dim * len(hac.levels) + acts)
                 + wbytes * (hac.n_params - n_bias) + 4 * n_bias),
        "weights": (flops, 4 * batch * (ws_row + hac.cond_dim) + 4 * n_all),
    }
    out = {}
    _, passes, peak = TC_ROUTE[compute_dtype]
    for k, (f, nbytes) in io.items():
        by_ops = passes * f / peak * 1e3
        by_bytes = nbytes / PEAK_BYTES * 1e3
        out[k] = (f, nbytes, max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes")
    return out


def saving_work(hac, batch, compute_dtype, tensor_cores=False):
    """(FLOPs, bytes, bound ms, what bounds it) of a saving forward: the
    forward's (``block_work``), its operations on the f32 CUDA cores (the
    loop) or on the dtype's tensor-core route (``TC_ROUTE``), and the saved
    buffer written once (every level's input and S, every unit's a1 and a2,
    the block's output)."""
    flops, nbytes, _, _ = block_work(hac, batch, compute_dtype)
    saved = 4 * batch * (2 * hac.dim * len(hac.levels) + hac.dim
                         + sum(2 * 2 * len(lv.nodes) * lv.hidden for lv in hac.levels))
    _, passes, peak = TC_ROUTE[compute_dtype] if tensor_cores else ("", 1, PEAK_FLOPS["float32"])
    by_ops, by_bytes = passes * flops / peak * 1e3, (nbytes + saved) / PEAK_BYTES * 1e3
    return flops, nbytes + saved, max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def bf16_forward_times(torch, hac_fused, kind, batch):
    """The bf16 forward kernel on one block of ``BLOCKS`` at ``batch`` by
    each bf16 route (``routes``), serving and saving, in turns (wgmma, loop,
    loop, wgmma), beside each route's bounds. Returns {route: {"serve": [ms,
    ms], "save": [ms, ms], "serve_bound_ms", "save_bound_ms", ...}}."""
    dim, _, cond_dim = BLOCKS[kind]
    hac = make_block(torch, kind, "bfloat16")
    g = torch.Generator(device="cuda").manual_seed(8)
    x = randn(torch, g, batch, dim)
    c = randn(torch, g, batch, cond_dim) if cond_dim else None
    saved = hac_fused.saved_buffer(hac, x)
    names = routes(hac_fused, "bfloat16")
    out = {r: {"serve": [], "save": []} for r in names}
    with torch.no_grad():
        for r in (*names, *reversed(names)):
            out[r]["serve"].append(time_ms(torch, lambda: hac_fused._run_block(hac, x, c, False, names[r]), reps=5,
                                           warmup=2))
            out[r]["save"].append(time_ms(torch, lambda: hac_fused._run_block(hac, x, c, False, names[r], saved),
                                          reps=5, warmup=2))
    for r in names:
        tc = r != "cuda_core_loop"
        _, _, serve_bound, serve_by = block_work(hac, batch, "bfloat16", tc)
        _, nbytes, bound, by = saving_work(hac, batch, "bfloat16", tc)
        out[r].update(serve_bound_ms=serve_bound, serve_bound_by=serve_by, save_bound_ms=bound, save_bound_by=by,
                      save_mb=nbytes / 1e6)
    print(f"  {kind} bf16 forward kernel at B={batch} in turns, serving / saving: " + "; ".join(
        f"{r} {' / '.join(f'{v:.4f}' for v in t['serve'])} ms (bound {t['serve_bound_ms']:.4f} by "
        f"{t['serve_bound_by']}), saving {' / '.join(f'{v:.4f}' for v in t['save'])} ms (bound "
        f"{t['save_bound_ms']:.4f} by {t['save_bound_by']}, {t['save_mb']:.1f} MB)" for r, t in out.items())
          + f"; {route_name(hac_fused, 'bfloat16')} serves, {route_name(hac_fused, 'bfloat16', saving=True)} saves",
          flush=True)
    return out


def weight_products_bmm(torch, run):
    """The weight kernel's products, act^T dpre for every unit and layer, as
    one ``torch.bmm`` per level and layer (f32, TF32 off) on the buffers
    the saving forward and the data kernel filled: a yardstick, not a kernel of the port (no
    single call computes the whole kernel: its bias sums, split-row
    partials and padding are not in it). Returns (ms, number of calls)."""
    hac, B, dev = run.hac, run.B, run.sv.device
    pairs = []
    for li, lv in enumerate(hac.levels):
        o = lv.out_max
        in_idx = torch.tensor([[nd.offset + k if k < nd.split else hac.dim for k in range(lv.in_max)]
                               for nd in lv.nodes], device=dev)
        out_idx = torch.tensor([[nd.offset + nd.split + m if m < nd.dim - nd.split else hac.dim for m in range(o)]
                                for nd in lv.nodes], device=dev)
        pad = lambda t: torch.cat([t, t.new_zeros(B, 1)], 1)  # noqa: E731
        act0 = pad(run.region(li, 0))[:, in_idx].repeat(1, 2, 1)  # (B, 2 n, in_max)
        if hac.cond_dim:
            act0 = torch.cat([act0, run.cond[:, None].expand(B, act0.shape[1], hac.cond_dim)], 2)
        dpre3 = torch.cat([pad(run.region(li, 2))[:, out_idx], pad(run.region(li, 3))[:, out_idx]], 1)
        for act, dpre in ((act0, run.region(li, 6)), (run.region(li, 4), run.region(li, 7)),
                          (run.region(li, 5), dpre3)):
            pairs.append((act.permute(1, 2, 0).contiguous(), dpre.permute(1, 0, 2).contiguous()))
    ms = time_ms(torch, lambda: [torch.bmm(a, p) for a, p in pairs], reps=5, warmup=2)
    return ms, len(pairs)


def chunk_partials(torch, hac_fused, hac, x, c, r, q, rows):
    """The weight kernel's partial sums per row chunk of ``rows`` batch
    rows, by other means: per chunk a saving forward, the data kernel and a
    one-chunk weight launch over that chunk's rows alone. Rows are
    independent in the forward and data kernels, and a chunk's rows fall
    into the same slabs either way, so in f32 these are the kernel's own
    partials. Returns a (chunks, n_tot) f32 tensor."""
    out = []
    for r0 in range(0, x.shape[0], rows):
        sl = slice(r0, min(x.shape[0], r0 + rows))
        xk, ck = x[sl].contiguous(), None if c is None else c[sl].contiguous()
        saved, _ = saving_forward(torch, hac_fused, hac, xk, ck, False)
        run = hac_fused.BackwardLaunch(hac, saved, ck, False, r[sl].contiguous(), q[sl].contiguous(), want_w=True,
                                       rows=sl.stop - sl.start)
        run.data()
        run.weights()
        out.append(run.grad)
    return torch.stack(out)


def leaf_err(got, ref):
    """(worst |d| / (1 + max |ref|) per leaf, worst |d| / (1 + |ref|) per
    entry, worst |d|) over the gradients, in float64."""
    per_leaf = per_entry = worst_abs = 0.0
    for a, b in zip(got, ref):
        d, b = (a.double() - b.double()).abs(), b.double()
        per_leaf = max(per_leaf, float(d.max() / (1 + b.abs().max())))
        per_entry = max(per_entry, float((d / (1 + b.abs())).max()))
        worst_abs = max(worst_abs, float(d.max()))
    return per_leaf, per_entry, worst_abs


def plain_activations(torch, hac_fused, hac, x, c, rev):
    """The plain version's activations on these rows, keyed by workspace
    region: (level, 0) its input and (level, 1) S, each (B, d); (level, 4)
    and (level, 5) the levelwise engine's two ReLU outputs a1, a2, each (B,
    2 n, h) with units in the packed order; (None, 0) the block's output. One
    no-grad pass of the plain version with ``torch.relu`` and the block's
    per-level s/t wrapped (``_level_st``, called once per level in pass
    order; its two ReLUs in it)."""
    seen, relu, level_st, out = [], torch.relu, hac._level_st, {}

    def recording_relu(t):
        seen.append(relu(t))  # (2, n, B, h)
        return seen[-1]

    def recording_level(li, xx, *a, **k):
        s, t = level_st(li, xx, *a, **k)
        out[(li, 0)], out[(li, 1)] = xx.clone(), hac._scatter_lower(li, s)
        return s, t

    torch.relu, hac._level_st = recording_relu, recording_level
    try:
        with torch.no_grad():
            out[(None, 0)] = hac_fused.plain_block(hac, x, c, rev)[0]
    finally:
        torch.relu = relu
        del hac._level_st
    order = range(len(hac.levels)) if rev else reversed(range(len(hac.levels)))
    for k, li in enumerate(order):
        out[(li, 4)], out[(li, 5)] = (a.flatten(0, 1).transpose(0, 1) for a in seen[2 * k : 2 * k + 2])
    return out


def relu_masks(acts, n_levels):
    """Per level, the masks [a > 0] of a1 and a2 in ``acts`` (``plain_activations``)."""
    return {li: [acts[(li, 4)] > 0, acts[(li, 5)] > 0] for li in range(n_levels)}


def saved_activations(hac_fused, hac, saved, B):
    """The regions of a saved buffer keyed as ``plain_activations``'."""
    bwd = hac_fused._packed(hac, saved.device).bwd
    keys = [(li, k) for li in range(len(hac.levels)) for k in (0, 1, 4, 5)] + [(None, 0)]
    return {key: hac_fused.workspace_region(hac, bwd, B, saved, *key) for key in keys}


def flipped_per_row(masks, ref):
    """Per row, the ReLU masks that differ from ``ref``'s, over every unit and level."""
    return sum((a != b).sum((1, 2)) for li in ref for a, b in zip(masks[li], ref[li]))


def saving_turns(torch, hac_fused, hac, x, c, saved):
    """The forward kernel by the route that saves in the block's dtype
    (``hac_fused._SAVE_ROUTE``) without and with saving into ``saved``, and
    in f32 the loop saving (the route the tiled one keeps the chains of), in
    turns (without, with, loop, loop, with, without): {"plain": [ms, ms],
    "saving": [ms, ms], "loop_saving": [ms, ms] in f32}."""
    route = hac_fused._SAVE_ROUTE[hac.compute_dtype]
    run = {"plain": lambda: hac_fused._run_block(hac, x, c, False, route),
           "saving": lambda: hac_fused._run_block(hac, x, c, False, route, saved),
           "loop_saving": lambda: hac_fused._run_block(hac, x, c, False, hac_fused.ROUTE_LOOP, saved)}
    turns = ("plain", "saving", "loop_saving", "loop_saving", "saving", "plain")
    if hac.compute_dtype != "float32" or route == hac_fused.ROUTE_LOOP:
        turns = ("plain", "saving", "saving", "plain")
    out = {name: [] for name in turns}
    with torch.no_grad():
        for name in turns:
            out[name].append(time_ms(torch, run[name], reps=5, warmup=2))
    return out


def repack_times(torch, hac_fused, hac):
    """ms of a re-pack after a parameter update: the flat weights that a
    training step's kernels read (``_packed``), and the 3xTF32 layout that
    serving gathers from them on its first launch (``_tc_packed``)."""
    dev = next(hac.parameters()).device

    def training():
        hac.__dict__.pop("_kernel_pack", None)  # as after an optimizer step
        hac_fused._packed(hac, dev)

    pk = hac_fused._packed(hac, dev)

    def serving():
        hac.__dict__.pop("_kernel_pack_tc", None)
        hac_fused._tc_packed(hac, pk)

    return {"training_ms": time_ms(torch, training, reps=5, warmup=2),
            "serving_ms": time_ms(torch, serving, reps=5, warmup=2)}


def gradient_phase(torch, hac_fused, kind):
    """_FusedBlock (the forward kernel; the backward kernels) on one block
    of ``BLOCKS``, f32 and bf16, random rows at batch 37, 4096 and 10,000,
    forward and inverse: outputs against the plain version; the gradients of
    sum(y*r) + sum(logdet*q) for x, the condition (where the block takes
    one) and every level parameter against the plain version in float64
    (f32) or in bf16; one forward and two backward launches; two calls
    bit-identical.

    ReLU's derivative jumps at 0: where a pre-activation lies within f32
    rounding of 0, the kernel or the f32 plain version can take another
    mask than the reference on that row, and its gradient then differs
    there by a whole unit's term, not by rounding. Such rows are found by
    comparing masks (the kernels' from the saving forward's buffer, the
    plain versions' from their ReLUs), counted (at most 1 % of the rows), and given a zero
    cotangent for the gradient check, so that they add nothing to any
    gradient in any version; every other row, the grid and the split-row
    sums run at full size. Where rows flipped, the errors over all rows and
    the x-gradient's worst error on flipped and on other rows are printed
    beside. Then times at batch 10,000. Returns {errors..., "times": {...}}."""
    dim, _, cond_dim = BLOCKS[kind]
    grad_batches = block_batches(kind)[2]
    timed = grad_batches[-1]
    res = {"f32_leaf": 0.0, "f32_entry": 0.0, "f32_abs": 0.0, "plain_leaf": 0.0, "plain_entry": 0.0,
           "bf16_leaf": 0.0, "bf16_abs": 0.0, "flipped_rows": {}, "all_rows_leaf": {}, "saved_vs_plain": {}}
    g = torch.Generator(device="cuda").manual_seed(5)
    for dt in TOL:
        hac = make_block(torch, kind, dt, requires_grad=True)
        h64 = copy.deepcopy(hac).double() if dt == "float32" else None
        for batch in grad_batches:
            x, r, q = randn(torch, g, batch, dim), randn(torch, g, batch, dim), randn(torch, g, batch)
            c = randn(torch, g, batch, cond_dim) if cond_dim else None
            for rev in (False, True):
                tag = f"{kind} {dt} {'inverse' if rev else 'forward'} B={batch}"

                def grads_of(fn, h, r, q, dtype=torch.float32):
                    xg = x.to(dtype).clone().requires_grad_()
                    cg = c.to(dtype).clone().requires_grad_() if cond_dim else None
                    y, ld = fn(h, xg, cg, rev)
                    wrt = [xg, cg] if cond_dim else [xg]
                    loss = (y * r.to(dtype)).sum() + (ld * q.to(dtype)).sum()
                    return (y.detach(), ld.detach()), type(y.grad_fn).__name__, torch.autograd.grad(loss, [*wrt, *h.parameters()])

                # the saving forward's regions against the plain version's
                # activations (values, masks), its output against the
                # forward without saving
                saved, (y_saved, _) = saving_forward(torch, hac_fused, hac, x, c, rev)
                kacts = saved_activations(hac_fused, hac, saved, batch)
                pacts = plain_activations(torch, hac_fused, hac, x, c, rev)
                km, plain_masks = relu_masks(kacts, len(hac.levels)), relu_masks(pacts, len(hac.levels))
                if dt == "float32":
                    ref = relu_masks(plain_activations(torch, hac_fused, h64, x.double(),
                                                       None if c is None else c.double(), rev), len(hac.levels))
                    flips_k, flips_p = flipped_per_row(km, ref), flipped_per_row(plain_masks, ref)
                else:
                    flips_k = flipped_per_row(km, plain_masks)
                    flips_p = torch.zeros_like(flips_k)
                with torch.no_grad():  # the route that saved, without saving
                    y_fwd = hac_fused._run_block(hac, x, c, rev, hac_fused._SAVE_ROUTE[dt])[0]
                torch.cuda.synchronize()
                n_sf = int((flipped_per_row(km, plain_masks) > 0).sum())
                d_sv = max(float((kacts[k] - pacts[k]).abs().max() / (1 + pacts[k].abs().max())) for k in pacts)
                same_y = torch.equal(y_saved, y_fwd)
                res["saved_vs_plain"][tag] = [n_sf, d_sv, same_y]
                del saved, kacts, pacts
                check(d_sv <= TOL[dt] and same_y,
                      f"{tag}: the saving forward's regions (every level's input and S, every unit's a1 and a2, "
                      f"the output) vs the {dt} plain version's: max |d|/(1+max|ref|) = {d_sv:.3e} (tol "
                      f"{TOL[dt]:g}); rows whose saved masks differ from the plain version's: {n_sf}; its output "
                      f"bit-identical to its route's without saving: {same_y}")
                flipped = (flips_k > 0) | (flips_p > 0)
                n_k, n_p, n_f = int((flips_k > 0).sum()), int((flips_p > 0).sum()), int(flipped.sum())
                res["flipped_rows"][tag] = [n_k, n_p]
                check(n_f <= max(1, batch // 100),
                      f"{tag}: ReLU masks against the {'float64' if dt == 'float32' else 'bf16'} plain version: "
                      f"{n_k} rows differ in the kernels (at most {int(flips_k.max())} units a row)"
                      + (f", {n_p} in the f32 plain version (at most {int(flips_p.max())})" if dt == "float32" else "")
                      + f"; {n_f} rows set aside (tol 1 % of the rows)")
                keep = (~flipped).float()
                rk, qk = r * keep[:, None], q * keep

                before = (counted("hac.launches"), counted("hac.bwd_launches"))
                out_k, fn_name, gk = grads_of(hac_fused.fused_block, hac, rk, qk)
                launched = (counted("hac.launches") - before[0], counted("hac.bwd_launches") - before[1])
                _, _, gk2 = grads_of(hac_fused.fused_block, hac, rk, qk)
                out_p, _, gp = grads_of(hac_fused.plain_block, hac, rk, qk)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(gk, gk2))
                d_out = max(rel_err(a[~flipped], b[~flipped]) for a, b in zip(out_k, out_p))
                d_out_all = max(rel_err(a, b) for a, b in zip(out_k, out_p))
                finite = all(bool(torch.isfinite(t).all()) for t in gk)
                moved = all(bool(t.abs().max() > 0) for t in gk)
                check(launched == (1, 2) and fn_name == "_FusedBlockBackward" and same and d_out <= TOL[dt],
                      f"{tag}: 1 forward + 2 backward launches through _FusedBlock ({launched}), two calls "
                      f"bit-identical: {same}, outputs vs plain over the rows whose masks agree max_rel={d_out:.3e} "
                      f"(tol {TOL[dt]:g}; over all rows {d_out_all:.3e})")
                if dt == "float32":
                    _, _, g64 = grads_of(hac_fused.plain_block, h64, rk, qk, torch.float64)
                    k_leaf, k_entry, k_abs = leaf_err(gk, g64)
                    p_leaf, p_entry, _ = leaf_err(gp, g64)
                    for key, v in (("f32_leaf", k_leaf), ("f32_entry", k_entry), ("f32_abs", k_abs),
                                   ("plain_leaf", p_leaf), ("plain_entry", p_entry)):
                        res[key] = max(res[key], v)
                    check(finite and moved and k_leaf <= GRAD_REL * p_leaf and k_leaf <= GRAD_TOL,
                          f"{tag}: gradients vs float64 over the {batch - n_f} rows whose masks agree, per leaf "
                          f"|d|/(1+max|ref|): kernels {k_leaf:.3e}, f32 plain {p_leaf:.3e} (tol {GRAD_REL:g}x plain "
                          f"and {GRAD_TOL:g}); per entry |d|/(1+|ref|): kernels {k_entry:.3e}, plain {p_entry:.3e}; "
                          "all finite and non-zero")
                else:
                    k_leaf, _, k_abs = leaf_err(gk, gp)
                    res["bf16_leaf"], res["bf16_abs"] = max(res["bf16_leaf"], k_leaf), max(res["bf16_abs"], k_abs)
                    check(finite and moved and k_leaf <= GRAD_TOL_BF16,
                          f"{tag}: gradients vs the bf16 plain version over the {batch - n_f} rows whose masks "
                          f"agree, per leaf |d|/(1+max|ref|) = {k_leaf:.3e} (tol {GRAD_TOL_BF16:g}), all finite "
                          "and non-zero")
                if n_f:
                    # the same over all rows, and where the x-gradient's error lies
                    _, _, ga = grads_of(hac_fused.fused_block, hac, r, q)
                    _, _, gpa = grads_of(hac_fused.plain_block, hac, r, q)
                    refa = grads_of(hac_fused.plain_block, h64, r, q, torch.float64)[2] if dt == "float32" else gpa
                    row_err = lambda got: (got[0].double() - refa[0].double()).abs().amax(1) / (1 + refa[0].double().abs().max())  # noqa: E731
                    ek = row_err(ga)
                    line = (f"  {tag}, all rows: per leaf |d|/(1+max|ref|) kernels {leaf_err(ga, refa)[0]:.3e}"
                            + (f", f32 plain {leaf_err(gpa, refa)[0]:.3e}" if dt == "float32" else "")
                            + f"; dx per row, kernels: worst {float(ek[flipped].max()):.3e} on the {n_f} flipped rows, "
                            f"{float(ek[~flipped].max()) if n_f < batch else 0.0:.3e} on the others")
                    if dt == "float32":
                        ep = row_err(gpa)
                        line += (f"; f32 plain: {float(ep[flipped].max()):.3e} flipped, "
                                 f"{float(ep[~flipped].max()) if n_f < batch else 0.0:.3e} others")
                    print(line, flush=True)
                    res["all_rows_leaf"][tag] = leaf_err(ga, refa)[0]
        del h64

    hac = make_block(torch, kind, "float32", requires_grad=True)
    x = randn(torch, g, timed, dim).requires_grad_()
    c = randn(torch, g, timed, cond_dim).requires_grad_() if cond_dim else None
    r, q = randn(torch, g, timed, dim), randn(torch, g, timed)
    wrt = [x, c, *hac.parameters()] if cond_dim else [x, *hac.parameters()]

    def both_ways(fn):
        y, ld = fn(hac, x, c, False)
        torch.autograd.grad(y.sum() + ld.sum(), wrt)

    n_leaves = len(list(hac.parameters()))
    everything = (True, cond_dim > 0) + (True,) * n_leaves
    inputs_only = (True, cond_dim > 0) + (False,) * n_leaves
    leaves_only = (False, False) + (True,) * n_leaves

    # each backward kernel alone, on buffers the one before it filled: the
    # saving forward, the data kernel, the weight kernel
    c0 = None if c is None else c.detach()
    saved, _ = saving_forward(torch, hac_fused, hac, x.detach(), c0, False)

    def grad_fn(fn, needs):  # the kernels read the saved buffer, the plain version the input
        inp = saved if fn is hac_fused._run_block_grad else x.detach()
        return lambda: fn(hac, inp, c0, False, r, q, needs)

    run = hac_fused.BackwardLaunch(hac, saved, c0, False, r, q, want_w=True)
    run.data()
    run.weights()
    chunks = -(-timed // run.rows)
    partials = chunk_partials(torch, hac_fused, hac, x.detach(), c0, r, q, run.rows)
    n_tiles = len(run.pk.bwd.tiles)

    def reduction_plain():  # the chunks' partials added in chunk order from 0, as the kernel adds them
        total = torch.zeros_like(partials[0])
        for k in range(chunks):
            total += partials[k]
        return total

    torch.cuda.synchronize()
    reduction_err = float((run.grad - reduction_plain()).abs().max())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(torch.equal(run.grad, reduction_plain()),
          f"{kind} B={timed}: the weight kernel's f32 gradient ({run.n_tot} floats; {n_tiles} tiles x {chunks} row "
          f"chunks of {run.rows} rows = {n_tiles * chunks} thread blocks on {sms} SMs) equals, bit for bit, the sum "
          f"in chunk order of each chunk's own partials (a one-chunk weight launch over that chunk's rows alone) "
          f"(max |d| = {reduction_err:g})")
    t = {
        "fwd_bwd_ms": time_ms(torch, lambda: both_ways(hac_fused.fused_block), reps=3, warmup=2),
        "fwd_bwd_plain_ms": time_ms(torch, lambda: both_ways(hac_fused.plain_block), reps=3, warmup=2),
        "bwd_ms": time_ms(torch, grad_fn(hac_fused._run_block_grad, everything), reps=3, warmup=2),
        "bwd_plain_ms": time_ms(torch, grad_fn(hac_fused.plain_block_grad, everything), reps=3, warmup=2),
        "data_ms": time_ms(torch, run.data, reps=5, warmup=2),
        "forward_ms": time_ms(torch, lambda: hac_fused._run_block(hac, x.detach(), c0, False), reps=5, warmup=2),
        "forward_save_turns": saving_turns(torch, hac_fused, hac, x.detach(), c0, saved),
        "repack": repack_times(torch, hac_fused, hac),
        "data_plain_ms": time_ms(torch, grad_fn(hac_fused.plain_block_grad, inputs_only), reps=3, warmup=2),
        "weights_ms": time_ms(torch, run.weights, reps=5, warmup=2),
        "weights_plain_ms": time_ms(torch, grad_fn(hac_fused.plain_block_grad, leaves_only), reps=3, warmup=2),
        "reduction_plain_ms": time_ms(torch, reduction_plain, reps=20, warmup=2),
        "reduction_library_ms": time_ms(torch, lambda: torch.sum(partials, 0), reps=20, warmup=2),
        "reduction_abs_err": reduction_err, "chunks": chunks, "weight_blocks": n_tiles * chunks,
    }
    t["bmm_ms"], n_bmm = weight_products_bmm(torch, run)
    t["batch"] = timed
    t["bf16_forward"] = bf16_forward_times(torch, hac_fused, kind, timed)
    t["forward_save_ms"] = min(t["forward_save_turns"]["saving"])
    work = backward_work(hac, timed, "float32")
    work["forward"] = block_work(hac, timed, "float32", tensor_cores=True)
    work["forward_save"] = saving_work(hac, timed, "float32")
    for k, (flops, nbytes, bound, bound_by) in work.items():
        t[f"{k}_bound_ms"], t[f"{k}_bound_by"], t[f"{k}_gflop"], t[f"{k}_mb"] = bound, bound_by, flops / 1e9, nbytes / 1e6
    # a saving forward, and the two backward kernels
    t["fwd_bwd_bound_ms"] = sum(t[f"{k}_bound_ms"] for k in ("forward_save", "data", "weights"))
    saved_mb, grad_mb = run.sv.numel() * 4 / 1e6, run.gw.numel() * 4 / 1e6
    del run, partials, saved
    print(f"  {kind} block at B={timed}: _FusedBlock forward + backward {t['fwd_bwd_ms']:.3f} ms, plain under "
          f"autograd {t['fwd_bwd_plain_ms']:.3f} ms, bound {t['fwd_bwd_bound_ms']:.4f} ms; backward "
          f"{t['bwd_ms']:.3f} ms (plain_block_grad {t['bwd_plain_ms']:.3f}); alone: data kernel {t['data_ms']:.3f} ms "
          f"(plain, x/cond only, {t['data_plain_ms']:.3f}; bound {t['data_bound_ms']:.4f} ms by {t['data_bound_by']}, "
          f"{t['data_gflop']:.2f} GFLOP, {t['data_mb']:.1f} MB), weight kernel {t['weights_ms']:.3f} ms "
          f"(plain, parameters only, {t['weights_plain_ms']:.3f}; bound {t['weights_bound_ms']:.4f} ms by "
          f"{t['weights_bound_by']} on {TC_ROUTE['float32'][0]}, {t['weights_gflop']:.2f} GFLOP, "
          f"{t['weights_mb']:.1f} MB; its sum over {chunks} row chunks as torch.sum of the chunks' partials "
          f"{t['reduction_library_ms']:.4f} ms, in plain chunk order {t['reduction_plain_ms']:.4f}); saved buffer "
          f"{saved_mb:.1f} MB, gradient buffer {grad_mb:.1f} MB", flush=True)
    turns = t["forward_save_turns"]
    loop = turns.get("loop_saving")
    if loop:
        t["forward_save_loop_ms"] = min(loop)
    print(f"  {kind} forward kernel at B={timed}: {t['forward_ms']:.4f} ms serving (bound "
          f"{t['forward_bound_ms']:.4f} ms by {t['forward_bound_by']}), {t['forward_save_ms']:.4f} ms saving by the "
          f"{route_name(hac_fused, 'float32', saving=True)} route that a saving forward takes (bound "
          f"{t['forward_save_bound_ms']:.4f} ms by {t['forward_save_bound_by']} on the f32 CUDA cores, "
          f"{t['forward_save_mb']:.1f} MB); in turns without saving {' / '.join(f'{v:.4f}' for v in turns['plain'])} "
          f"ms, saving {' / '.join(f'{v:.4f}' for v in turns['saving'])} ms"
          + (f", the loop saving {' / '.join(f'{v:.4f}' for v in loop)} ms (tiled / loop "
             f"{min(turns['saving']) / min(loop):.3f})" if loop else "")
          + f"; re-pack of the block's weights for a training step "
          f"{t['repack']['training_ms']:.4f} ms, of the 3xTF32 serving layout {t['repack']['serving_ms']:.4f} ms",
          flush=True)
    print(f"  {kind} yardstick: the weight products as {n_bmm} torch.bmm calls (one per level and layer, f32, TF32 "
          f"off) {t['bmm_ms']:.3f} ms, against the weight kernel's {t['weights_ms']:.3f} ms", flush=True)
    res["times"] = t
    return res


# -- phases 6 and 9 --------------------------------------------------------------------------


def read_counts():
    """(forward launches, those under autograd, backward launches, those of
    the weight kernel) since the last ``reset_counts()``."""
    return (counted("hac.launches"), counted("hac.launches.under_grad"), counted("hac.bwd_launches"),
            counted("hac.bwd_weight_launches"))


def train_cli(torch, name, argv):
    """Run ``cli.main(["train", ...])`` and return (final test loss, per-step
    loss terms as a (steps, 2) array). The terms are collected from
    ``Trainer.train_step`` as device tensors and read after the run."""
    from hint_tpu_torch import cli
    from hint_tpu_torch.train.trainer import Trainer

    recorded, inner = [], Trainer.train_step

    def recording(self, *args, **kwargs):
        terms = inner(self, *args, **kwargs)
        recorded.append(terms)
        return terms

    Trainer.train_step = recording
    try:
        final = cli.main(["train", "--config", name, *argv])
    finally:
        Trainer.train_step = inner
    return final, torch.stack(recorded).cpu().numpy()


def training_phase(np, torch, hac_fused, tmp, name):
    """Train ``name`` through the CLI, compare with levelwise, resume, sample
    and serve the saved file. Returns (forward kernel launches, those under
    autograd, backward kernel launches, those of the weight kernel) of the
    fused run."""
    from hint_tpu_torch import cli
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.serve import InferenceService, make_server

    cfg = get_config(name)
    cache = ["--cache-dir", os.path.join(tmp, "data")]
    final_ckpt, half_ckpt = os.path.join(tmp, f"{name}.trained.npz"), os.path.join(tmp, f"{name}.epoch1.npz")
    t0 = time.perf_counter()
    reset_counts()
    final, losses = train_cli(torch, name, ["--impl", "fused", "--epochs", "2", *TRAIN_ARGS, *cache, "--save", final_ckpt])
    launches, grad_launches = counted("hac.launches"), counted("hac.launches.under_grad")
    bwd = (counted("hac.bwd_launches"), counted("hac.bwd_weight_launches"))
    print(f"  train --impl fused: {time.perf_counter() - t0:.1f} s including any data generation", flush=True)
    steps, evals, blocks = 2 * STEPS_PER_EPOCH, 2, cfg.n_blocks
    check(losses.shape == (steps, 2), f"{steps} training steps at batch {TRAIN_BATCH}")
    check(
        launches == blocks * (steps + evals) and grad_launches == blocks * steps,
        f"kernel launches over the training run: {launches} (= {blocks} blocks x ({steps} steps + {evals} "
        f"evaluation batches)), {grad_launches} of them under autograd",
    )
    check(
        bwd == (2 * blocks * steps, blocks * steps),
        f"backward kernel launches: {bwd[0]} (= 2 x {blocks} blocks x {steps} steps: data kernel, "
        f"weight kernel), {bwd[1]} of the weight kernel",
    )
    check(bool(np.isfinite(losses).all() and np.isfinite(final)),
          f"losses finite: first step {losses[0].sum():.4f}, last step {losses[-1].sum():.4f}, test {final:.4f}")

    reset_counts()
    final_lw, losses_lw = train_cli(torch, name, ["--impl", "levelwise", "--epochs", "2", *TRAIN_ARGS, *cache])
    check(counted("hac.launches") == 0 and counted("hac.bwd_launches") == 0, "the levelwise run launches no kernel")
    a, b = losses.sum(1), losses_lw.sum(1)
    d = float(np.max(np.abs(a - b) / (1 + np.abs(b))))
    check(d <= TRAIN_LOSS_TOL and abs(final - final_lw) <= TRAIN_LOSS_TOL * (1 + abs(final_lw)),
          f"fused vs levelwise per-step loss: max |d|/(1+|loss|) = {d:.3e} (tol {TRAIN_LOSS_TOL:g})")

    # epochs 0 and 1 both lie in the warm-up, so a 1-epoch run ends in the
    # state the 2-epoch run had after its first epoch
    train_cli(torch, name, ["--impl", "fused", "--epochs", "1", *TRAIN_ARGS, *cache, "--save", half_ckpt])
    final_rs, losses_rs = train_cli(torch, name, ["--impl", "fused", "--epochs", "2", *TRAIN_ARGS, *cache, "--resume", half_ckpt])
    second = losses[STEPS_PER_EPOCH:]
    d = float(np.max(np.abs(losses_rs - second) / (1 + np.abs(second)))) if losses_rs.shape == second.shape else float("inf")
    check(d <= RESUME_TOL and abs(final_rs - final) <= RESUME_TOL * (1 + abs(final)),
          f"--resume after epoch 1 reproduces epoch 2: {len(losses_rs)} steps, max |d|/(1+|loss|) = {d:.3e} (tol {RESUME_TOL:g})")

    dy = cfg.ndim_y
    y_target = [0.5] * dy
    out = os.path.join(tmp, "samples.npy")
    cli.main(["sample", "--config", name, "--ckpt", final_ckpt, "--impl", "fused", "--n", "256", "--out", out,
              *(["--y-target", *map(str, y_target)] if dy else [])])
    x_cli = np.load(out)
    svc = InferenceService.from_checkpoint(name, final_ckpt, impl="fused")
    httpd = make_server(svc, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        with_y = {"y_target": y_target} if dy else {}
        x = np.asarray(http(httpd.server_port, "/sample", {"n": 256, "seed": 0, **with_y})["x"], np.float32)
        rows = {"y": [y_target] * 256} if dy else {}
        lp = np.asarray(http(httpd.server_port, "/log_prob", {"x": x.tolist(), **rows})["log_prob"], np.float32)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    check(x.shape == (256, DIM) and bool(np.isfinite(x).all()) and lp.shape == (256,) and bool(np.isfinite(lp).all()),
          f"trained checkpoint served with impl=fused: /sample {x.shape} and /log_prob finite, mean log_prob {float(lp.mean()):.3f}")
    check(x_cli.shape == (256, DIM) and bool(np.array_equal(x_cli, x)),
          f"`sample{' --y-target ' + ' '.join(map(str, y_target)) if dy else ''}` from the saved file: {x_cli.shape}, "
          "equal to the served /sample of the same seed")
    return (launches, grad_launches, *bwd)


# -- phases 7 and 10 --------------------------------------------------------------------------


def step_times(torch, hac_fused, name, x, y, dtypes):
    """Train-step times of ``name`` at batch 10,000 (the variants warmed up,
    then timed in turns within each round) and the split of a fused f32
    step. Returns {variant: ms per step}, the split in ms, the fused f32
    trainer and the fused f32 step as a callable."""
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling

    cfg = get_config(name)
    lr = cfg.lr_init * 3e-2
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainers = {
        f"{impl}_{dt}": cfg.make_trainer(compute_dtype=dt, impl=impl)
        for dt in dtypes for impl in ("fused", "levelwise")
    }
    states = {variant: trainer.init_state(0) for variant, trainer in trainers.items()}
    steps = {
        variant: (lambda t=trainer, st=states[variant]: t.train_step(st, x, y, gen, lr))
        for variant, trainer in trainers.items()
    }
    for step in steps.values():
        for _ in range(3):
            step()
    rounds = {variant: [] for variant in steps}
    for _ in range(5):
        for variant, step in steps.items():
            rounds[variant].append(time_ms(torch, step, reps=2, warmup=0, rounds=1))
    times = {variant: statistics.median(v) for variant, v in rounds.items()}
    peak = {}
    for variant in ("fused_float32", "levelwise_float32"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        steps[variant]()
        torch.cuda.synchronize()
        peak[variant] = (torch.cuda.max_memory_allocated() - base) / 2**20

    trainer, state = trainers["fused_float32"], states["fused_float32"]
    blocks = [b for b in trainer.model.modules() if isinstance(b, HierarchicalAffineCoupling)]
    rows = []
    for _ in range(7):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        for b in blocks:
            hac_fused._packed(b, x.device)
        ev[1].record()
        total = trainer._loss(trainer._noisy(x, gen), y)[0]
        ev[2].record()
        total.backward()
        ev[3].record()
        state.opt.update(lr)
        ev[4].record()
        ev[4].synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    split = dict(zip(("repack", "forward", "backward", "optimizer"),
                     (statistics.median(col) for col in zip(*rows[2:]))))
    return times, split, peak, trainer, steps["fused_float32"]


def print_step_times(name, times, split, peak, bound, flops):
    for variant, ms in times.items():
        print(f"  {name} train step {variant}: {ms:.3f} ms, {1e3 / ms:.2f} steps/s")
    print(f"  {name} device memory a step allocates beyond what is held before it (max_memory_allocated): "
          + ", ".join(f"{v} {mib:.1f} MiB" for v, mib in peak.items()))
    whole = sum(split.values())
    print(f"  {name} fused float32 step, bound {bound:.3f} ms ({flops / 1e9:.1f} GFLOP): " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / whole:.1f} %)" for k, v in split.items()), flush=True)


def plain_share(torch, trainer, x, y):
    """Forward + backward ms of a two-lane model's loss, and of its plain
    steps alone (the couplings and permutations: every step but the HAC
    blocks, fed the same lane tensors), by synchronised CUDA events."""
    from hint_tpu_torch.models.flow import LANE_Y, LANE_YX

    model = trainer.model
    plain_steps = [(lane, b) for lane, b in model.steps if type(b).__name__ != "HierarchicalAffineCoupling"]

    def whole():
        trainer._loss(x, y)[0].backward()

    def plain_only():
        hy, hx, total = y, x, 0.0
        for lane, b in plain_steps:
            if lane == LANE_Y:
                hy, j = b(hy, None)
            else:
                hx, j = b(hx, hy if lane == LANE_YX else None)
            total = total + j.mean()
        (total + hx.mean() + hy.mean()).backward()

    whole_ms = time_ms(torch, whole, reps=2, warmup=2)
    plain_ms = time_ms(torch, plain_only, reps=2, warmup=2)
    for p in model.parameters():
        p.grad = None
    return whole_ms, plain_ms, len(plain_steps)


def profile_step(torch, step, step_ms, steps=3):
    """torch.profiler over fused f32 train steps. Prints the ten device
    operations with most device time and the ten operations before which the
    device waited longest (idle gaps between consecutive device operations,
    summed by the operation that ended the gap). The profiler slows the
    host, so the idle share of its window overstates the idle share of a
    plain step; the device-busy time per step is also set against
    ``step_ms``, the step's time without the profiler. Returns (idle share
    of the profiled window, device-busy ms per step), or (None, None) when
    the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start,
    )
    if not kernels:
        print("  torch.profiler saw no device activity; the CUDA-event times above stand alone")
        return None, None
    busy, by_name, gaps = 0.0, {}, {}
    end = kernels[0].time_range.start
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        busy += dur
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dur)
        if e.time_range.start > end:
            n, t = gaps.get(e.name, (0, 0.0))
            gaps[e.name] = (n + 1, t + e.time_range.start - end)
        end = max(end, e.time_range.end)
    window = end - kernels[0].time_range.start
    idle = sum(t for _, t in gaps.values())
    busy_ms = busy / steps / 1e3
    print(f"  profiled {steps} fused f32 steps: {len(kernels) / steps:.0f} device operations/step, window "
          f"{window / steps / 1e3:.3f} ms/step under the profiler, device busy {busy_ms:.3f} ms/step, "
          f"idle {idle / steps / 1e3:.3f} ms/step ({100 * idle / window:.1f} % of the profiled window)")
    print(f"  device busy {busy_ms:.3f} ms of the {step_ms:.3f} ms step without the profiler: "
          f"{100 * busy_ms / step_ms:.1f} % busy, {100 * (1 - busy_ms / step_ms):.1f} % idle")
    for title, table in (("device operations by device time", by_name), ("idle gaps by the operation that ended them", gaps)):
        print(f"  top 10 {title} (per step):")
        for name, (n, t) in sorted(table.items(), key=lambda kv: -kv[1][1])[:10]:
            print(f"    {t / steps / 1e3:9.4f} ms  x{n / steps:7.1f}  {name[:100]}")
    return idle / window, busy_ms


# -- phase 11 ----------------------------------------------------------------------------


def reshuffle_phase(torch, hac_fused):
    """``RESHUFFLE`` at full width with impl="fused" against impl="levelwise"
    (the same model.init weights): one forward and backward of the NLL at
    batch 4096. Its blocks reshuffle, so impl="fused" runs them through the
    levelwise engine, as hint_tpu's fused_block does: no kernel launch,
    outputs equal bit for bit, gradients within RESHUFFLE_GRAD_TOL."""
    from hint_tpu_torch.configs import get_config

    cfg = get_config(RESHUFFLE)
    models = {impl: cfg.build_model(impl=impl) for impl in ("fused", "levelwise")}
    models["fused"].init(torch.Generator().manual_seed(0))
    models["levelwise"].load_state_dict(models["fused"].state_dict())
    x = randn(torch, torch.Generator(device="cuda").manual_seed(11), BUCKET, DIM)
    out, grads = {}, {}
    for impl, model in models.items():
        reset_counts()
        z, ld = model(x)
        loss = 0.5 * (z * z).sum(1).mean() - ld.mean()
        grads[impl] = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        out[impl] = (z.detach(), ld.detach(), (counted("hac.launches"), counted("hac.bwd_launches"),
                                               counted("hac.reshuffle_levelwise")))
    n_hac = sum(type(m).__name__ == "HierarchicalAffineCoupling" for m in models["fused"].modules())
    counts = out["fused"][2]
    same = torch.equal(out["fused"][0], out["levelwise"][0]) and torch.equal(out["fused"][1], out["levelwise"][1])
    g_err = leaf_err(grads["fused"], grads["levelwise"])[0]
    finite = all(bool(torch.isfinite(t).all()) for t in (*out["fused"][:2], *grads["fused"]))
    check(counts[0] == 0 and counts[1] == 0 and counts[2] == n_hac,
          f"{RESHUFFLE} impl=fused, B={BUCKET}: {counts[0]} hac_block and {counts[1]} backward launches, "
          f"{counts[2]} blocks through the levelwise engine (= {n_hac} reshuffle blocks)")
    check(same and finite and g_err <= RESHUFFLE_GRAD_TOL,
          f"{RESHUFFLE} impl=fused vs impl=levelwise: z and logdet bit-identical: {same}; gradients of the NLL "
          f"per leaf |d|/(1+max|ref|) = {g_err:.3e} (tol {RESHUFFLE_GRAD_TOL:g}); all finite")
    return {"launches": counts[0], "bwd_launches": counts[1], "levelwise_reshuffle_calls": counts[2],
            "outputs_bit_identical": same, "grad_max_err": g_err}


# -- phase 12 ----------------------------------------------------------------------------

UCI_CONFIGS = ("uci_data.power_hint_4", "uci_data.miniboone_hint_4")
# fixture files in the reference's layout (uci_data/{power,miniboone}/data.npy)
# at the real sets' sizes, random values from a seed: rows, raw columns
# (POWER deletes two of its 8 columns to reach d=6, MINIBOONE drops its last
# after normalization to reach d=42), and the rows of their test splits
UCI_FIXTURES = {"power": (2_049_280, 8, 204_928), "miniboone": (36_488, 43, 3_648)}


def tee_stdout(fn, *args):
    """Run ``fn(*args)`` and return (its result, what it printed), printing
    it too."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def ll_line(label, text):
    import re

    m = re.search(rf"^{label}: (-?[0-9.]+) nats$", text, re.M)
    return float(m.group(1)) if m else None


def uci_phase(np, torch, hac_fused, tmp):
    """The UCI path on fixture files: ``train`` of ``UCI_CONFIGS`` through
    the CLI with ``--impl fused --uci-root`` (2 epochs x 2 steps at the
    configs' batches; each epoch evaluates the whole test set as one batch),
    ``evaluate`` of the saved file, then ``experiment uci`` and ``collect-uci``
    on MINIBOONE (its config cut to 2 epochs x 2 steps). Counts are zeroed
    before each run and read after it. Returns {run: counts, ...}."""
    from hint_tpu_torch import cli
    from hint_tpu_torch.configs import get_config, registry_data
    from hint_tpu_torch.data.loaders import prepare_uci_data
    from hint_tpu_torch.evaluation.metrics import uci_log_likelihood

    root, secs, out = os.path.join(tmp, "uci"), {}, {"counts": {}}
    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    for name, (rows, cols, test_rows) in UCI_FIXTURES.items():
        os.makedirs(os.path.join(root, "uci_data", name))
        np.save(os.path.join(root, "uci_data", name, "data.npy"), rng.standard_normal((rows, cols)))
    secs["fixtures"] = time.perf_counter() - t0
    for name, (rows, cols, test_rows) in UCI_FIXTURES.items():
        (x_tr, _), (x_te, _) = prepare_uci_data(name, root)
        dim = {"power": 6, "miniboone": 42}[name]
        check(x_te.shape == (test_rows, dim) and x_tr.shape[1] == dim and bool(np.isfinite(x_te).all()),
              f"UCI fixture {name}: {rows:,} x {cols} raw rows -> train {x_tr.shape}, test {x_te.shape} "
              f"(hint_tpu_torch/data/uci.py: 10 % test from the end, then 10 % validation)")
    for name in UCI_CONFIGS:
        cfg = get_config(name)
        ckpt = os.path.join(tmp, f"{name}.npz")
        nb, steps, evals = cfg.n_blocks, 2 * STEPS_PER_EPOCH, 2
        t = time.perf_counter()
        reset_counts()
        (final, losses), text = tee_stdout(train_cli, torch, name, [
            "--impl", "fused", "--epochs", "2", "--max-batches", str(STEPS_PER_EPOCH), "--uci-root", root,
            "--save", ckpt])
        counts = read_counts()
        secs[f"train {name}"] = time.perf_counter() - t
        ll = ll_line("test log-likelihood", text)
        check(losses.shape == (steps, 2) and bool(np.isfinite(losses).all()) and np.isfinite(final),
              f"{name}: {steps} training steps at batch {cfg.batch_size}, losses finite (first "
              f"{losses[0].sum():.4f}, last {losses[-1].sum():.4f}, full-batch test {final:.4f})")
        check(counts == (nb * (steps + evals), nb * steps, 2 * nb * steps, nb * steps),
              f"{name}: launches {counts} = (forward {nb} blocks x ({steps} steps + {evals} full-batch "
              f"evaluations), under autograd, backward 2 x {nb} x {steps}, weight kernel)")
        check(ll is not None and abs(ll - uci_log_likelihood(final, cfg.ndim_x)) < 1e-3,
              f"{name}: the UCI log-likelihood line: {ll} nats")
        reset_counts()
        t = time.perf_counter()
        total, text = tee_stdout(cli.main, ["evaluate", "--config", name, "--uci-root", root, "--ckpt", ckpt,
                                            "--impl", "fused"])
        secs[f"evaluate {name}"] = time.perf_counter() - t
        ev = read_counts()
        ll_eval = ll_line("log-likelihood", text)
        check(ev[0] == nb and np.isfinite(total) and ll_eval is not None,
              f"{name}: evaluate of the saved file: {ev[0]} launches (one full test batch of "
              f"{UCI_FIXTURES[cfg.data][2]:,} rows through {nb} blocks), log-likelihood {ll_eval} nats")
        out["counts"][name] = tuple(a + b for a, b in zip(counts, ev))
        out[name] = {"train_ll": ll, "evaluate_ll": ll_eval, "first_loss": float(losses[0].sum()),
                     "last_loss": float(losses[-1].sum())}
    name = UCI_CONFIGS[1]
    saved = registry_data.CONFIGS[name]
    registry_data.CONFIGS[name] = {**saved, "n_epochs": 2, "max_batches_per_epoch": STEPS_PER_EPOCH}
    results = os.path.join(tmp, "results")
    try:
        reset_counts()
        t = time.perf_counter()
        swept = cli.main(["experiment", "uci", name, "--uci-root", root, "--impl", "fused",
                          "--results-dir", results])
        secs["experiment uci"] = time.perf_counter() - t
        counts = read_counts()
        collected = cli.main(["experiment", "collect-uci", name, "--results-dir", results])
    finally:
        registry_data.CONFIGS[name] = saved
    lls = uci_log_likelihood(swept[name], 42)
    check(swept[name].shape == (1,) and bool(np.isfinite(swept[name]).all()) and counts[0] > 0 and counts[2] > 0
          and abs(collected[name][0] - float(lls.mean())) < 1e-9,
          f"experiment uci {name} (2 epochs x {STEPS_PER_EPOCH} steps): test loss {swept[name]}, launches "
          f"{counts}; collect-uci log-likelihood {collected[name][0]:.3f} nats")
    out["counts"]["experiment uci"] = counts
    out["secs"] = secs
    print("  UCI phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    return out


# -- phase 13 ----------------------------------------------------------------------------

# the prior pool the host builds (the reference draws 1e8 rows; this one is
# cut to what 8 cores build in well under a minute), its chunks, the pool the
# top-k is timed on (the reference's 1e8 rows, the 2e6-row pool tiled), the
# ABC targets and the compared targets
POOL_ROWS, POOL_CHUNK, TILED_ROWS = 2_000_000, 50_000, 100_000_000
SCORE_SAMPLES = 1000  # the reference's n_eval_samples
ABC_TARGETS, COMPARE_TARGETS, ABC_N = 10, 5, 4000
# multi_mmd in float32 against float64 on the card, relative: measured
# 4.5e-7 on the CPU for two 4000-row draws of plus-shape data
MMD_TOL = 1e-5


def evaluation_phase(np, torch, hac_fused, tmp):
    """The evaluation path on the card: 1,000 samples of the flagship trained
    in phase 6 (the forward kernel's inverse) scored by ``_score_shapes``
    (1,000 curves x 9 restarts x 400 steps); the plus and lens self-checks;
    a native prior pool of ``POOL_ROWS`` plus-shape rows; quantile-ABC for
    ``ABC_TARGETS`` targets against a stable argsort of the same distances;
    one target's top-k over the pool tiled to ``TILED_ROWS`` rows;
    ``compare_conditional`` for ``COMPARE_TARGETS`` targets with the
    ``RCINN`` flow of phase 9 as the sampler (the condition-fed kernel); and
    ``multi_mmd`` at 4000 x 4000, d=100, against float64."""
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.data.fourier import PlusShapeModel
    from hint_tpu_torch.evaluation import abc, shape_fit
    from hint_tpu_torch.evaluation.mmd import multi_mmd
    from hint_tpu_torch.experiments import drivers
    from hint_tpu_torch.train import checkpoint

    secs, out = {}, {}

    def trained(name):
        trainer = get_config(name).make_trainer(impl="fused")
        checkpoint.load_npz(os.path.join(tmp, f"{name}.trained.npz"), trainer.init_state(0))
        return trainer

    cfg = get_config(FLAGSHIP)
    trainer = trained(FLAGSHIP)
    reset_counts()
    t = time.perf_counter()
    sample = drivers._draw_sample(cfg, trainer, SCORE_SAMPLES, seed=1000)
    out["sample_launches"] = counted("hac.launches")
    secs["sample"] = time.perf_counter() - t
    check(sample.shape == (SCORE_SAMPLES, DIM) and out["sample_launches"] == cfg.n_blocks,
          f"{SCORE_SAMPLES} samples of the trained {FLAGSHIP}: {sample.shape}, {out['sample_launches']} launches (its inverse)")
    from hint_tpu_torch.data import geometry

    stages = {"fit": (shape_fit, "fit_plus_shapes_batch"), "iou_dice": (shape_fit, "iou_and_dice_batch"),
              "hausdorff": (geometry, "hausdorff")}
    spent = dict.fromkeys(stages, 0.0)

    def timed(stage, fn):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[stage] += time.perf_counter() - t
        return wrapper

    inner = {stage: getattr(mod, attr) for stage, (mod, attr) in stages.items()}
    for stage, (mod, attr) in stages.items():
        setattr(mod, attr, timed(stage, inner[stage]))
    t = time.perf_counter()
    try:
        scores = drivers._score_shapes(PlusShapeModel(), sample, "plus", device="cuda")
        torch.cuda.synchronize()
    finally:
        for stage, (mod, attr) in stages.items():
            setattr(mod, attr, inner[stage])
    secs["score_shapes"] = time.perf_counter() - t
    out["score_shapes_split_s"] = spent
    print("  _score_shapes split: " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()), flush=True)
    check(scores.shape == (4,) and bool(np.isfinite(scores).all()),
          f"_score_shapes of the samples (fit_plus_shapes_batch: {SCORE_SAMPLES} curves x 9 restarts x 400 steps on the "
          f"card): IoU {scores[0]:.3f}, DICE {scores[1]:.3f}, Hausdorff max {scores[2]:.3f} avg {scores[3]:.3f}")
    out["scores"] = scores.tolist()

    t = time.perf_counter()
    np.random.seed(1)
    plus = shape_fit.check_plus_shape_fitting(verbose=False, device="cuda")
    np.random.seed(2)
    lens = shape_fit.check_lens_shape_fitting(verbose=False, device="cuda")
    secs["self-checks"] = time.perf_counter() - t
    check(plus[0] >= 0.9 and lens[0] >= 0.85,
          f"shape-fit self-checks on clean shapes: plus IoU {plus[0]:.3f} DICE {plus[1]:.3f} (>= 0.9), "
          f"lens IoU {lens[0]:.3f} DICE {lens[1]:.3f} (>= 0.85)")
    out["self_checks"] = {"plus": [float(v) for v in plus], "lens": [float(v) for v in lens]}

    abc_dir = os.path.join(tmp, "abc")
    t = time.perf_counter()
    x_pool, y_pool = abc.prepare_samples(PlusShapeModel, n_total=POOL_ROWS, chunk=POOL_CHUNK, out_dir=abc_dir,
                                         engine="native")
    secs["prior pool"] = time.perf_counter() - t
    check(x_pool.shape == (POOL_ROWS, DIM) and y_pool.shape == (POOL_ROWS, 4) and bool(np.isfinite(y_pool).all()),
          f"prepare_samples(PlusShapeModel, engine='native'): {POOL_ROWS:,} rows by {os.cpu_count()} spawned "
          f"workers in {secs['prior pool']:.1f} s ({POOL_ROWS / secs['prior pool']:,.0f} rows/s)")

    y_dev = torch.as_tensor(np.array(y_pool), device="cuda")
    rows = np.arange(POOL_ROWS)[:, None]
    pm = PlusShapeModel()
    np.random.seed(3)
    targets = [pm.sample_joint(1)[1][0].astype(np.float32) for _ in range(ABC_TARGETS)]
    same, t_abc = True, 0.0
    for tg in targets:
        t = time.perf_counter()
        sel, thr = abc.quantile_ABC(rows, y_dev, tg, n=ABC_N, device_chunk=POOL_ROWS // 4)
        t_abc += time.perf_counter() - t
        d = abc.chunk_distances(y_dev, torch.as_tensor(tg[None], device="cuda")).cpu().numpy()
        order = np.argsort(d, kind="stable")
        same &= bool(np.array_equal(sel[:, 0], order[1 : ABC_N + 1]) and thr == float(d[order[ABC_N + 1]]))
    secs[f"quantile_ABC x {ABC_TARGETS}"] = t_abc
    check(same, f"quantile_ABC, {ABC_TARGETS} targets, {ABC_N} rows each, 4 device chunks of the {POOL_ROWS:,}-row "
                "pool: selection and threshold equal a numpy stable argsort of the same float32 distances")

    reps = -(-TILED_ROWS // POOL_ROWS)
    tiled = y_dev.repeat(reps, 1)[:TILED_ROWS]
    torch.cuda.synchronize()
    fake_x = np.broadcast_to(np.zeros((1, 1), np.float32), (TILED_ROWS, 1))
    tg = torch.as_tensor(targets[0][None], device="cuda")
    times, ev_times = [], []
    for _ in range(4):
        t = time.perf_counter()
        abc.quantile_ABC(fake_x, tiled, targets[0], n=ABC_N)
        times.append(time.perf_counter() - t)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for c0 in range(0, TILED_ROWS, 16_000_000):
            abc.chunk_topk(tiled[c0 : c0 + 16_000_000], tg, ABC_N + 2)
        end.record()
        end.synchronize()
        ev_times.append(start.elapsed_time(end))
    nbytes = tiled.numel() * 4
    out["tiled_topk"] = {"rows": TILED_ROWS, "call_ms": 1e3 * statistics.median(times[1:]),
                         "device_ms": statistics.median(ev_times[1:]), "bound_ms": nbytes / PEAK_BYTES * 1e3}
    print(f"  quantile_ABC of one target over {TILED_ROWS:,} rows ({nbytes / 1e9:.1f} GB of float32 observations "
          f"on the card): {out['tiled_topk']['call_ms']:.2f} ms a call, distances and top-k on the card "
          f"{out['tiled_topk']['device_ms']:.2f} ms (CUDA events), bound {out['tiled_topk']['bound_ms']:.3f} ms "
          f"(the bytes read once at {PEAK_BYTES / 1e12:.2f} TB/s)", flush=True)
    del tiled

    rtr = trained(RCINN)

    def sampler(y_tiled, z):
        with torch.no_grad():
            y = torch.as_tensor(np.ascontiguousarray(y_tiled), device="cuda")
            return rtr.model.inverse(torch.as_tensor(z, device="cuda"), y)[0]

    reset_counts()
    t = time.perf_counter()
    compared = abc.compare_conditional(PlusShapeModel(), {"rcinn": sampler}, n_runs=COMPARE_TARGETS,
                                       sample_size=ABC_N, abc_dir=abc_dir, verbose=True)
    secs[f"compare_conditional x {COMPARE_TARGETS}"] = time.perf_counter() - t
    out["compare_launches"] = counted("hac.launches")
    mmds = compared["rcinn"]["mmds"]
    n_blocks = get_config(RCINN).n_blocks
    check(len(mmds) == COMPARE_TARGETS and bool(np.isfinite(mmds).all())
          and out["compare_launches"] == COMPARE_TARGETS * n_blocks
          and os.path.exists(os.path.join(abc_dir, "plus-shape_conditional_comparison_0.pkl")),
          f"compare_conditional, {COMPARE_TARGETS} targets, {RCINN} as the sampler: MMDs "
          f"{', '.join(f'{m:.4f}' for m in mmds)}, {out['compare_launches']} launches of the condition-fed kernel")
    out["compare_mmds"] = mmds

    xa = torch.as_tensor(np.array(x_pool[:ABC_N]), device="cuda")
    xb = torch.as_tensor(np.array(x_pool[ABC_N : 2 * ABC_N]), device="cuda")
    m32, m64 = float(multi_mmd(xa, xb)), float(multi_mmd(xa.double(), xb.double()))
    rel = abs(m32 - m64) / abs(m64)
    mmd_ms = time_ms(torch, lambda: multi_mmd(xa, xb), reps=5, warmup=1)
    check(rel <= MMD_TOL, f"multi_mmd at {ABC_N} x {ABC_N}, d=100 (two pool draws): float32 {m32:.9g} against "
                          f"float64 {m64:.9g}, relative {rel:.3e} (tol {MMD_TOL:g}); {mmd_ms:.3f} ms a call")
    out["mmd"] = {"f32": m32, "f64": m64, "rel_err": rel, "ms": mmd_ms}
    out["secs"] = secs
    print("  evaluation phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    return out


# -- phase 13: the device prior sweep -------------------------------------------------------

# the device pools (engine="tpu"): as many rows as the native pool (the
# reference draws 1e8), SWEEP_SUB_BATCH rows a device pass (8 a host
# transfer, sample_joint's default group), the pool one chunk of its
# memmaps (2 transfers, so the host's fixes of one overlap the next);
# native lens rows drawn for the KS gate; its significance per dimension
SWEEP_SUB_BATCH, SWEEP_CHUNK, NATIVE_LENS_ROWS, KS_ALPHA = 125_000, POOL_ROWS, 200_000, 1e-4
PROFILED = 2  # sub-batches in the profiled lens dispatch


def ks_stats(torch, a, b):
    """Two-sample Kolmogorov-Smirnov statistic of every column of a (n, d)
    and b (m, d), on the card: the largest gap between the two empirical
    CDFs over the pooled values."""
    stats = []
    for j in range(a.shape[1]):
        sa, sb = torch.sort(a[:, j]).values, torch.sort(b[:, j]).values
        grid = torch.cat([sa, sb])
        ca = torch.searchsorted(sa, grid, right=True).double() / len(sa)
        cb = torch.searchsorted(sb, grid, right=True).double() / len(sb)
        stats.append(float((ca - cb).abs().max()))
    return stats


def sweep_profile(torch, lens_tpu, profile_trace, trace_dir):
    """One lens dispatch of ``PROFILED`` sub-batches under
    ``utils.profile_trace``: device-busy share of the window between its
    first and last device operation, device operations per sub-batch, and
    the operations with most device time. The profiler slows the host's
    enqueue, so the busy share is a floor for the unprofiled sweep's."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile_trace(trace_dir) as prof:
        lens_tpu.sample_joint(PROFILED * SWEEP_SUB_BATCH, seed=9, sub_batch=SWEEP_SUB_BATCH, group=PROFILED)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    check(bool(kernels), "torch.profiler saw the sweep's device operations")
    busy, by_name, end = 0.0, {}, kernels[0].time_range.start
    for e in kernels:
        lo = max(e.time_range.start, end)
        busy += max(0.0, e.time_range.end - lo)  # the union of the operations' intervals
        end = max(end, e.time_range.end)
        n, dur = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, dur + e.time_range.end - e.time_range.start)
    window = end - kernels[0].time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    trace = os.listdir(trace_dir)
    print(f"  profile of one lens dispatch ({PROFILED} sub-batches of {SWEEP_SUB_BATCH:,} rows, utils.profile_trace, "
          f"{sum(os.path.getsize(os.path.join(trace_dir, f)) for f in trace) / 1e6:.1f} MB Chrome trace): "
          f"{len(kernels) / PROFILED:.0f} device operations a sub-batch, device busy {busy / 1e3:.1f} ms of a "
          f"{window / 1e3:.1f} ms window ({100 * busy / window:.1f} %), {wall * 1e3:.1f} ms wall under the profiler",
          flush=True)
    for name, (n, dur) in top:
        print(f"    {dur / PROFILED / 1e3:9.3f} ms  x{n / PROFILED:7.1f} a sub-batch  {name[:100]}")
    return {"busy_share": busy / window, "busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "ops_per_sub_batch": len(kernels) / PROFILED,
            "top": [[name, n / PROFILED, dur / PROFILED / 1e3] for name, (n, dur) in top]}


def device_pool_phase(np, torch, tmp, native_pool_s):
    """The device prior sweep (``prepare_samples(engine="tpu")``): a pool
    of ``POOL_ROWS`` rows of each family, its rows/s beside the native
    pool's (``native_pool_s`` seconds for as many plus rows, earlier in
    phase 13), device ms a sub-batch (CUDA events) beside the host's
    enqueue time, each engine's flag shares from its own column, a profile
    of one lens dispatch, and the gate: a KS test per dimension of each
    device pool against native rows of its family (the native plus pool of
    phase 13; ``NATIVE_LENS_ROWS`` native lens rows)."""
    from hint_tpu_torch.data import lens_tpu, native, plus_tpu
    from hint_tpu_torch.data.fourier import LensShapeModel, PlusShapeModel
    from hint_tpu_torch.data.sweep import sub_batch_generator
    from hint_tpu_torch.evaluation import abc
    from hint_tpu_torch.utils import profile_trace

    dev = torch.device("cuda")
    out, native_rate = {}, POOL_ROWS / native_pool_s
    c_alpha = (-0.5 * np.log(KS_ALPHA / 2)) ** 0.5
    for family, mod, model in (("plus", plus_tpu, PlusShapeModel), ("lens", lens_tpu, LensShapeModel)):
        mod.sample_joint(SWEEP_SUB_BATCH, sub_batch=SWEEP_SUB_BATCH)  # first launches of each operation
        dev_ms, host_ms, flags = [], [], []
        for q in range(3):
            gen = sub_batch_generator(1, q, dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            packed, _ = mod._sub_batch(gen, SWEEP_SUB_BATCH, dev)
            end.record()
            host_ms.append(1e3 * (time.perf_counter() - t))
            end.synchronize()
            dev_ms.append(start.elapsed_time(end))
            flags.append(packed[:, mod.FLAG_COLUMN].long().cpu().numpy())
        flags = np.concatenate(flags)
        if family == "lens":
            shares = {"band": float(((flags & 1) != 0).mean()), "seam": float(((flags & 2) != 0).mean()),
                      "bad": float(((flags & 4) != 0).mean())}
        else:
            shares = {"flagged": float((flags != 0).mean())}
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        x, y = abc.prepare_samples(model, n_total=POOL_ROWS, chunk=SWEEP_CHUNK, out_dir=os.path.join(tmp, "abc_tpu"),
                                   engine="tpu", sub_batch=SWEEP_SUB_BATCH)
        secs = time.perf_counter() - t
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        rate = POOL_ROWS / secs
        check(x.shape[0] == y.shape[0] == POOL_ROWS and bool(np.isfinite(x).all() and np.isfinite(y).all()),
              f"prepare_samples({model.__name__}, engine='tpu'): {POOL_ROWS:,} rows in {secs:.2f} s, "
              f"{rate:,.0f} rows/s end to end ({rate / native_rate:.1f}x the native pool's {native_rate:,.0f}; "
              f"1e8 rows in {1e8 / rate / 60:.1f} min), peak device memory {peak_mib:,.0f} MiB")
        d_ms = statistics.median(dev_ms)
        print(f"  {family} sub-batch of {SWEEP_SUB_BATCH:,} rows: device {d_ms:.2f} ms (CUDA events, median of 3; "
              f"{SWEEP_SUB_BATCH / d_ms * 1e3:,.0f} rows/s), host enqueue {statistics.median(host_ms):.2f} ms; "
              f"flags (column {mod.FLAG_COLUMN}, {len(flags):,} rows): "
              + ", ".join(f"{k} {100 * v:.3f} %" for k, v in shares.items()), flush=True)
        out[family] = {"rows": POOL_ROWS, "seconds": secs, "rows_per_s": rate, "native_rows_per_s": native_rate,
                       "device_ms_per_sub_batch": d_ms, "host_enqueue_ms": statistics.median(host_ms),
                       "sub_batch": SWEEP_SUB_BATCH, "flag_shares": shares, "peak_mib": peak_mib}
    out["lens"]["profile"] = sweep_profile(torch, lens_tpu, profile_trace, os.path.join(tmp, "sweep_trace"))

    t = time.perf_counter()
    native_lens = native.sample_joint("lens-shape1", NATIVE_LENS_ROWS, seed=7)
    native_s = time.perf_counter() - t
    abc_dir, tpu_dir = os.path.join(tmp, "abc"), os.path.join(tmp, "abc_tpu")
    for family, name, ref in (("plus", "plus-shape", None), ("lens", "lens-shape1", native_lens)):
        if ref is None:
            ref = tuple(np.load(os.path.join(abc_dir, f"{name}_{s}_huge.npy"), mmap_mode="r") for s in "xy")
        stats = []
        for s, r in zip("xy", ref):
            a = torch.as_tensor(np.load(os.path.join(tpu_dir, f"{name}_{s}_huge.npy")), device=dev)
            b = torch.as_tensor(np.ascontiguousarray(r), device=dev)
            stats += ks_stats(torch, a, b)
            n, m = a.shape[0], b.shape[0]
        crit = c_alpha * ((n + m) / (n * m)) ** 0.5
        worst = int(np.argmax(stats))
        out[family]["ks_max"], out[family]["ks_crit"] = max(stats), crit
        check(max(stats) < crit, f"KS per dimension, {family} device pool ({n:,} rows) against {m:,} native rows"
                                 f"{f' (drawn in {native_s:.1f} s)' if family == 'lens' else ''}: largest "
                                 f"{max(stats):.5f} (dimension {worst} of {len(stats)}) < {crit:.5f} "
                                 f"(alpha {KS_ALPHA:g} a dimension)")
    return out


# -- phase 14: the campaign ----------------------------------------------------------------

# the campaign's stages at full width, depth cut: every config it trains runs
# 2 epochs of 2 steps at its own batch (10,000 for the toy configs, on
# 20,000 + 10,000 rows); a 200,000-row prior pool (the reference's is 1e8);
# 5 conditional and 2 unconditional comparisons (1,000 and 100); 100 curves
# a shape score (1,000); one grid config; the UCI sweep cut to two configs on
# phase 12's fixture files (GAS, a pandas pickle, is absent and skipped)
CAMPAIGN_POOL, CAMPAIGN_SHAPES = 200_000, 100
CAMPAIGN_COMPARE = {"conditional": 5, "unconditional": 2}
CAMPAIGN_GRID = "plus_shape.unconditional_hint_4_1"
CAMPAIGN_UCI = ("uci_data.power_hint_4", "uci_data.miniboone_inn_4")
# a replayed checkpoint against its logged final loss (campaign.py's limit)
REPLAY_TOL = 0.05
REPORT_SECTIONS = (
    "## Final test loss / per-dim likelihood", "## plus conditional posterior/prior MMD",
    "## plus unconditional posterior/prior MMD", "## plus shape fit", "## UCI test log-likelihood",
    "## plus-shape architecture ablation — base",
)


def hac_blocks(cfg):
    """The HAC blocks of a config's flow: one a block of a hint, recursive
    cINN or two-lane model (its x lane), none in an INN or a cINN."""
    return cfg.n_blocks if cfg.model_type in ("hint", "recursive_cinn", "conditional_hint") else 0


def campaign_phase(np, torch, hac_fused, tmp):
    """The campaign (``hint_tpu_torch.experiments.campaign``) stage by
    stage in a directory of its own, its configs cut in depth only
    (``registry_data.CONFIGS``), ``impl="fused"``: data, train of the plus
    family, the replay of a removed checkpoint, a native prior pool, both
    comparisons, shape scores, one grid config, the UCI sweep on phase 12's
    fixtures, the report; the figures only where matplotlib imports. Counts
    are zeroed before each stage and read after it. Returns {"secs",
    "counts", ...}."""
    import pickle
    import re

    from hint_tpu_torch.configs import get_config, registry_data
    from hint_tpu_torch.experiments import campaign

    run, plus = os.path.join(tmp, "campaign"), campaign.family_configs("plus")
    toy = {"n_train": STEPS_PER_EPOCH * TRAIN_BATCH, "n_test": TRAIN_BATCH}
    cut = {name: {"n_epochs": 2, "max_batches_per_epoch": STEPS_PER_EPOCH,
                  **({} if name.startswith("uci_data.") else toy)} for name in (*plus, CAMPAIGN_GRID, *CAMPAIGN_UCI)}
    saved = {name: registry_data.CONFIGS[name] for name in cut}
    saved_dir, saved_uci, cwd = campaign.CAMPAIGN_DIR, campaign.UCI_CONFIGS, os.getcwd()
    out = {"secs": {}, "counts": {}}
    steps, evals = 2 * STEPS_PER_EPOCH, 2

    def stage(label, fn, *args, **kwargs):
        reset_counts()
        t = time.perf_counter()
        result, text = tee_stdout(lambda: fn(*args, **kwargs))
        out["secs"][label], out["counts"][label] = time.perf_counter() - t, read_counts()
        print(f"  campaign {label}: {out['secs'][label]:.1f} s, launches (forward, under autograd, backward, "
              f"weights) {out['counts'][label]}", flush=True)
        return result, text

    def trained(names):
        """The launches a training run of each of ``names`` makes."""
        nb = sum(hac_blocks(get_config(n)) for n in names)
        return (nb * (steps + evals), nb * steps, 2 * nb * steps, nb * steps)

    os.makedirs(run)
    try:
        for name, c in cut.items():
            registry_data.CONFIGS[name] = {**saved[name], **c}
        campaign.CAMPAIGN_DIR = os.path.join(run, "artifacts", "campaign_torch")
        campaign.UCI_CONFIGS = list(CAMPAIGN_UCI)
        os.chdir(run)
        stage("data", campaign.main, ["data", "--family", "plus"])
        stage("train", campaign.stage_train, "plus", seeds=(0,), impl="fused")
        log = campaign._read_log()
        losses = {n: log[f"{n}|s0|float32"]["final_test_loss"] for n in plus}
        check(out["counts"]["train"] == trained(plus) and bool(np.isfinite(list(losses.values())).all()),
              f"stage_train of {', '.join(plus)} (2 epochs x {STEPS_PER_EPOCH} steps at batch {TRAIN_BATCH}): "
              f"launches {out['counts']['train']} = {trained(plus)} (the HAC blocks of the hint models: forward "
              f"(steps + evaluations), under autograd, backward 2 x steps, weights); final test losses "
              + ", ".join(f"{n.split('.')[-1]} {v:.4f}" for n, v in losses.items()))

        replayed = "plus_shape.conditional_hint_4_full"
        os.remove(campaign._ckpt_path(replayed, 0))
        _, text = stage("replay", campaign._load_state, replayed, 0, impl="fused")
        m = re.search(r"replay \S+: loss=(-?[0-9.]+) \(logged (-?[0-9.]+), \|drift\|=([0-9.e+-]+)\)", text)
        drift = float(m.group(3)) if m else float("inf")
        out["replay_drift"] = drift
        check(m is not None and drift <= REPLAY_TOL and os.path.exists(campaign._ckpt_path(replayed, 0))
              and out["counts"]["replay"] == trained([replayed]),
              f"_load_state replays the removed checkpoint of {replayed}: loss {m and m.group(1)} against the logged "
              f"{m and m.group(2)}, |drift| {drift:.2e} (tol {REPLAY_TOL:g} nats), launches {out['counts']['replay']}")

        stage("pool", campaign.stage_pool, "plus", CAMPAIGN_POOL)
        rows = np.load(os.path.join("abc", "plus-shape_x_huge.npy"), mmap_mode="r").shape
        check(rows == (CAMPAIGN_POOL, DIM), f"stage_pool: a native pool of {rows} plus-shape rows in "
                                            f"{out['secs']['pool']:.1f} s")
        out["mmds"] = {}
        for kind, n_runs in CAMPAIGN_COMPARE.items():
            label = f"compare {kind}"
            stage(label, campaign.stage_compare, "plus", kind, run=0, n_runs=n_runs, impl="fused")
            with open(os.path.join("abc", f"plus-shape_{kind}_comparison_0.pkl"), "rb") as f:
                res = pickle.load(f)
            mmds = {n: res[n]["mmds"] for n in campaign.MODEL_SETS[("plus", kind)]}
            out["mmds"][kind] = mmds
            # a two-lane sample is a forward (for z_y) and an inverse
            passes = sum((2 if get_config(n).model_type == "conditional_hint" else 1) * hac_blocks(get_config(n))
                         for n in mmds)
            check(all(len(v) == n_runs and bool(np.isfinite(v).all()) for v in mmds.values())
                  and out["counts"][label][0] == n_runs * passes,
                  f"stage_compare plus/{kind}, {n_runs} runs of 4000 samples: MMDs "
                  + "; ".join(f"{n.split('.')[-1]} {', '.join(f'{x:.4f}' for x in v)}" for n, v in mmds.items())
                  + f"; {out['counts'][label][0]} launches (= {n_runs} x {passes})")

        scored = ["plus_shape.unconditional_hint_4_full", "plus_shape.conditional_hint_4_full"]
        stage("shapes", campaign.stage_shapes, "plus", n=CAMPAIGN_SHAPES, seeds=(0,), configs=scored, impl="fused")
        stage("grid", campaign.stage_grid, seeds=(0,), n_shapes=CAMPAIGN_SHAPES, configs=[CAMPAIGN_GRID],
              impl="fused")
        with open(os.path.join(campaign.CAMPAIGN_DIR, "shapes_plus.json")) as f:
            shapes = json.load(f)
        out["shapes"] = shapes
        sampled = sum((2 if get_config(n).model_type == "conditional_hint" else 1) * hac_blocks(get_config(n))
                      for n in scored)
        grid_counts = tuple(a + b for a, b in zip(trained([CAMPAIGN_GRID]), (hac_blocks(get_config(CAMPAIGN_GRID)),
                                                                           0, 0, 0)))
        check(sorted(shapes) == sorted(f"{n}|s0" for n in (*scored, CAMPAIGN_GRID))
              and all(r["n"] == CAMPAIGN_SHAPES for r in shapes.values())
              and out["counts"]["shapes"][0] == sampled and out["counts"]["grid"] == grid_counts
              and bool(np.isfinite(campaign._read_log()[f"{CAMPAIGN_GRID}|s0|float32"]["final_test_loss"])),
              f"stage_shapes ({CAMPAIGN_SHAPES} curves each; {out['counts']['shapes'][0]} launches) and stage_grid "
              f"of {CAMPAIGN_GRID} (trained and scored; launches {out['counts']['grid']}): "
              + "; ".join(f"{k.split('.')[-1]} IoU {r['iou']:.3f} DICE {r['dice']:.3f} Hausdorff {r['max_h']:.3f} "
                          f"reject {r['reject_rate']:.2f} ({r['seconds']:.1f} s)" for k, r in sorted(shapes.items())))

        _, text = stage("uci", campaign.stage_uci, uci_root=os.path.join(tmp, "uci"), seeds=(0,), impl="fused")
        log = campaign._read_log()
        lls = {n: log[f"{n}|s0|float32"]["ll_nats"] for n in CAMPAIGN_UCI}
        check("uci: gas data missing" in text and bool(np.isfinite(list(lls.values())).all())
              and out["counts"]["uci"] == trained(CAMPAIGN_UCI),
              f"stage_uci on phase 12's fixtures, GAS skipped: log-likelihood "
              + ", ".join(f"{n.split('.')[-1]} {v:.3f} nats" for n, v in lls.items())
              + f"; launches {out['counts']['uci']} = {trained(CAMPAIGN_UCI)}")

        stage("report", campaign.main, ["report"])
        with open(os.path.join(campaign.CAMPAIGN_DIR, "REPORT.md")) as f:
            text = f.read()
        missing = [h for h in REPORT_SECTIONS if h not in text]
        check(not missing, f"REPORT.md ({len(text.splitlines())} lines) has its sections: "
                           + ", ".join(REPORT_SECTIONS) + (f"; missing {missing}" if missing else ""))
        try:
            import matplotlib  # noqa: F401
        except ImportError as exc:
            print(f"  campaign figures: skipped, {exc} on this machine (stage_figures only draws)", flush=True)
        else:
            paths, _ = stage("figures", campaign.stage_figures, seed=0, impl="fused")
            check(all(os.path.getsize(p) > 0 for p in paths), f"stage_figures: {len(paths)} figures")
    finally:
        os.chdir(cwd)
        registry_data.CONFIGS.update(saved)
        campaign.CAMPAIGN_DIR, campaign.UCI_CONFIGS = saved_dir, saved_uci
    out["launches"] = tuple(sum(c[k] for c in out["counts"].values()) for k in range(4))
    print("  campaign phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in out["secs"].items()), flush=True)
    return out


# -- phase 15: data parallel ------------------------------------------------------------------

# the data-parallel path (hint_tpu_torch.parallel): a 2-rank gloo world on
# the one card (NCCL takes one card a rank), the flagship's steps at the
# config's batch of 10,000 (5,000 rows a rank) on phase 6's rows, sampling of
# a row count the ranks do not divide, quantile-ABC over phase 13's pool and
# MMD at its size, shape fits of 100 curves; then a 1-rank NCCL world of the
# same steps
DP_RANKS, DP_STEPS, DP_SAMPLES, DP_CURVES = 2, 4, 4097, 100
# a DP step against the single-process step on the same rows and noise: the
# two sum each gradient over other row blocks, and the kernels' ReLU masks
# can flip on one row where the rounding differs (phase 5)
DP_TOL = 1e-4
# a sharded evaluation against the unsharded call: the kernels compute row
# by row, but cuBLAS may round the Householder products of another M apart
DP_EVAL_TOL = 1e-5
# the collectives' wait for the other ranks, so that a hung rank fails the
# phase in seconds
DP_TIMEOUT_S = 180.0


def exact_gathers(torch, mesh):
    """``dryrun.gather_bits`` (ragged f32 and bf16 rows holding -0.0, +0.0,
    ±Inf, a NaN with a payload and the rank's number; ``map_rows`` of a
    function that makes -0.0 of every +0.0) on the card: for each, whether
    every bit came back (the integer views equal)."""
    from hint_tpu_torch.parallel.dryrun import NAN_BITS, gather_bits, special_rows

    got = gather_bits(mesh)
    out = {}
    for dtype, (int_dtype, _) in NAN_BITS.items():
        name = str(dtype).split(".")[1]
        ref = torch.cat([special_rows(r, dtype) for r in range(mesh.size)]).view(int_dtype)
        out[name] = torch.equal(torch.from_numpy(got[f"gather_bits_{name}"]), ref)
    out["map_rows"] = torch.equal(torch.from_numpy(got["map_rows_bits"]), torch.full((7, 3), -0.0).view(torch.int32))
    return out


def dp_rank(mesh, inputs_path, full):
    """One rank of phase 15 (spawned; imports nothing of JAX): ``DP_STEPS``
    fused f32 steps of the flagship over the mesh, the launches counted from
    zero just before them and read just after; with ``full``, a full-batch
    evaluation, sharded sampling of the flagship, ``RCINN`` and ``CHINT``
    (each counted), quantile-ABC, MMD, shape fits and IoU/DICE, each beside
    the unsharded call (not counted), the ms of a step and of its
    all-reduce, and ``parallel.dryrun``. Returns a dict of results."""
    import numpy as np
    import torch

    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.evaluation import abc, shape_fit
    from hint_tpu_torch.evaluation.mmd import multi_mmd
    from hint_tpu_torch.evaluation.sampling import sample_model
    from hint_tpu_torch.ops import hac_fused
    from hint_tpu_torch.ops.base import exact_f32_matmul
    from hint_tpu_torch.parallel import all_reduce_sum
    from hint_tpu_torch.parallel.dryrun import dryrun

    exact_f32_matmul()
    dev = mesh.device
    torch.cuda.set_device(dev)
    hac_fused.build()  # phase 1's library, loaded
    inp = np.load(inputs_path)
    x = torch.as_tensor(inp["x"], device=dev)
    cfg = get_config(FLAGSHIP)
    trainer = cfg.make_trainer(mesh=mesh, impl="fused")
    state = trainer.init_state(0)
    gen, lr = torch.Generator(device=dev).manual_seed(0), cfg.lr_init * 3e-2
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend, "gathers": exact_gathers(torch, mesh)}
    reset_counts()
    losses = torch.stack([trainer.train_step(state, x, None, gen, lr) for _ in range(DP_STEPS)])
    torch.cuda.synchronize()
    out["step_counts"] = read_counts()
    out["losses"] = losses.cpu().numpy()
    out["params"] = torch.cat([t.reshape(-1) for t in trainer.model.state_dict().values()]).cpu().numpy()
    if not full:
        return out

    reset_counts()
    out["eval"] = trainer.eval_epoch(x, None, torch.Generator(device=dev).manual_seed(1), full_batch=True)
    out["eval_counts"] = read_counts()
    models = {FLAGSHIP: (cfg, trainer.model)}
    for name in (RCINN, CHINT):
        other = get_config(name).make_trainer(mesh=mesh, impl="fused")
        other.init_state(0)
        models[name] = (get_config(name), other.model)
    out["sample_counts"], out["sample_err"] = {}, {}
    with torch.no_grad():
        for name, (c, model) in models.items():
            y_target = c.vis_y_target if c.is_conditional else None
            reset_counts()
            got = sample_model(c, model, DP_SAMPLES, torch.Generator(device=dev).manual_seed(2), y_target, mesh=mesh)
            torch.cuda.synchronize()
            out["sample_counts"][name] = read_counts()
            ref = sample_model(c, model, DP_SAMPLES, torch.Generator(device=dev).manual_seed(2), y_target)
            out["sample_err"][name] = (tuple(got.shape), float((got - ref).abs().max()),
                                       bool(torch.isfinite(got).all()))

    y_pool = torch.as_tensor(np.load(str(inp["pool_y"])), device=dev)
    rows = np.arange(len(y_pool))[:, None]
    same = []
    t_sharded = t_single = 0.0
    for tg in inp["targets"]:
        t = time.perf_counter()
        sel, thr = abc.quantile_ABC(rows, y_pool, tg, n=ABC_N, device_chunk=len(y_pool) // 4, mesh=mesh)
        t_sharded += time.perf_counter() - t
        t = time.perf_counter()
        ref, ref_thr = abc.quantile_ABC(rows, y_pool, tg, n=ABC_N, device_chunk=len(y_pool) // 4)
        t_single += time.perf_counter() - t
        same.append(bool(np.array_equal(sel, ref) and thr == ref_thr))
    out["abc_same"], out["abc_ms"] = same, (1e3 * t_sharded / len(same), 1e3 * t_single / len(same))
    del y_pool

    x_pool = np.load(str(inp["pool_x"]), mmap_mode="r")
    xa = torch.as_tensor(np.array(x_pool[:ABC_N]), device=dev)
    xb = torch.as_tensor(np.array(x_pool[ABC_N : 2 * ABC_N]), device=dev)
    out["mmd"] = (float(multi_mmd(xa, xb, mesh=mesh)), float(multi_mmd(xa, xb)))

    curves = inp["curves"]
    fit_s, fit_u = shape_fit.fit_plus_shapes_batch(curves, mesh=mesh), shape_fit.fit_plus_shapes_batch(curves, device=dev)
    outlines = shape_fit.plus_outlines_batch(fit_u, device=dev)
    iou_s = np.stack(shape_fit.iou_and_dice_batch(outlines, curves, mesh=mesh))
    iou_u = np.stack(shape_fit.iou_and_dice_batch(outlines, curves, device=dev))
    out["fit_err"] = float(np.abs(fit_s - fit_u).max())
    out["iou_err"] = float(np.abs(iou_s - iou_u).max())
    out["iou_mean"] = iou_u.mean(axis=1).tolist()

    out["step_ms"] = time_ms(torch, lambda: trainer.train_step(state, x, None, gen, lr), reps=5, warmup=2, rounds=3)
    flat = torch.zeros(sum(p.numel() for p in state.opt.params.values()) + 2, device=dev)
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        all_reduce_sum(flat, mesh)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    out["allreduce_ms"], out["allreduce_floats"] = statistics.median(times[2:]), flat.numel()
    out["dryrun"] = {k: np.asarray(v).tolist() for k, v in dryrun(mesh, impl="fused").items()
                     if k in ("terms", "eval_terms", "mmd", "scores")}
    return out


def data_parallel_phase(np, torch, hac_fused, tmp, x, card):
    """Phase 15: the 2-rank gloo world and the 1-rank NCCL world of
    ``dp_rank``, held to the single-process fused step on the same rows and
    noise (``DP_TOL``), the replicas to each other bit for bit and the 1-rank
    NCCL world to the single process bit for bit, the sharded evaluations to
    the unsharded calls (``DP_EVAL_TOL``; quantile-ABC the same rows).
    Returns the launches of each world and its ranks, and the times."""
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.data.fourier import PlusShapeModel
    from hint_tpu_torch.evaluation import abc
    from hint_tpu_torch.parallel.dryrun import spawn

    cfg = get_config(FLAGSHIP)
    x_pool, y_pool = abc.prepare_samples(PlusShapeModel, n_total=POOL_ROWS, chunk=POOL_CHUNK,
                                         out_dir=os.path.join(tmp, "abc"), engine="native")
    pm = PlusShapeModel()
    np.random.seed(4)
    targets = np.stack([pm.sample_joint(1)[1][0].astype(np.float32) for _ in range(ABC_TARGETS)])
    curves = pm.trace_fourier_curves(pm.unflatten_coeffs(np.array(x_pool[:DP_CURVES]))).astype(np.float32)
    inputs_path = os.path.join(tmp, "dp_inputs.npz")
    np.savez(inputs_path, x=x.cpu().numpy(), pool_x=x_pool.filename, pool_y=y_pool.filename, targets=targets,
             curves=curves)

    # the single process on the same rows and noise
    trainer = cfg.make_trainer(impl="fused")
    state = trainer.init_state(0)
    gen, lr = torch.Generator(device="cuda").manual_seed(0), cfg.lr_init * 3e-2
    ref_losses = torch.stack([trainer.train_step(state, x, None, gen, lr) for _ in range(DP_STEPS)]).cpu().numpy()
    ref_leaves = {k: t.detach().clone() for k, t in trainer.model.state_dict().items()}
    ref_params = torch.cat([t.reshape(-1) for t in ref_leaves.values()]).cpu().numpy()
    ref_eval = trainer.eval_epoch(x, None, torch.Generator(device="cuda").manual_seed(1), full_batch=True)
    single_ms = time_ms(torch, lambda: trainer.train_step(state, x, None, gen, lr), reps=5, warmup=2, rounds=3)
    del trainer, state

    out = {"secs": {}}
    t = time.perf_counter()
    ranks = spawn(dp_rank, DP_RANKS, inputs_path, True, backend="gloo", device="cuda:0", timeout_s=DP_TIMEOUT_S)
    out["secs"]["gloo world"] = time.perf_counter() - t
    blocks, steps = cfg.n_blocks, DP_STEPS
    for r in ranks:
        a, b = r["losses"].sum(1), ref_losses.sum(1)
        loss_err = float(np.max(np.abs(a - b) / np.abs(b)))
        leaf_err, offset = 0.0, 0
        for ref in ref_leaves.values():
            got = r["params"][offset : offset + ref.numel()]
            offset += ref.numel()
            ref = ref.reshape(-1).cpu().numpy()
            leaf_err = max(leaf_err, float(np.abs(got - ref).max() / (1 + np.abs(ref).max())))
        r["loss_err"], r["leaf_err"] = loss_err, leaf_err
        check(loss_err <= DP_TOL and leaf_err <= DP_TOL,
              f"rank {r['rank']} of {DP_RANKS} (gloo, cuda:0): {steps} DP steps of {FLAGSHIP}, fused f32, batch "
              f"{TRAIN_BATCH} ({TRAIN_BATCH // DP_RANKS} rows a rank), against the single process on the same rows "
              f"and noise: loss max |d|/|loss| {loss_err:.3e}, leaves max |d|/(1+max|ref|) {leaf_err:.3e} (tol {DP_TOL:g})")
        sc = r["step_counts"]
        check(sc == (blocks * steps, blocks * steps, 2 * blocks * steps, blocks * steps),
              f"rank {r['rank']} launches over the {steps} steps: {sc[1]} forward under autograd "
              f"(= {blocks} x {steps}), {sc[2]} backward (= 2 x {blocks} x {steps}: {sc[2] - sc[3]} data, "
              f"{sc[3]} weights)")
        ev_err = float(np.max(np.abs(r["eval"] - ref_eval) / (1 + np.abs(ref_eval))))
        check(r["eval_counts"][0] == blocks and ev_err <= DP_TOL,
              f"rank {r['rank']} full-batch eval epoch: {r['eval_counts'][0]} launches, terms {r['eval'].tolist()} "
              f"against the single process's, |d|/(1+|ref|) {ev_err:.3e}")
        for name, (shape, err, finite) in r["sample_err"].items():
            check(shape == (DP_SAMPLES, DIM) and finite and err <= DP_EVAL_TOL,
                  f"rank {r['rank']} sample_model of {name}, n={DP_SAMPLES} padded to {DP_SAMPLES + 1}: {shape}, "
                  f"{r['sample_counts'][name][0]} launches, max |d| to the unsharded call {err:.3e} "
                  f"(tol {DP_EVAL_TOL:g})")
        check(all(r["abc_same"]), f"rank {r['rank']} quantile_ABC over the {POOL_ROWS:,}-row pool, {ABC_TARGETS} "
              f"targets: the unsharded call's rows and thresholds ({r['abc_ms'][0]:.1f} ms a target sharded, "
              f"{r['abc_ms'][1]:.1f} unsharded)")
        m_s, m_u = r["mmd"]
        check(abs(m_s - m_u) <= DP_EVAL_TOL * abs(m_u),
              f"rank {r['rank']} multi_mmd at {ABC_N} x {ABC_N}, d=100: {m_s:.9g} against unsharded {m_u:.9g}")
        check(r["fit_err"] <= DP_EVAL_TOL and r["iou_err"] <= DP_EVAL_TOL,
              f"rank {r['rank']} fit_plus_shapes_batch and iou_and_dice_batch of {DP_CURVES} curves: max |d| to "
              f"unsharded {r['fit_err']:.3e} and {r['iou_err']:.3e}; IoU {r['iou_mean'][0]:.3f}, DICE {r['iou_mean'][1]:.3f}")
        check(all(r["gathers"].values()), f"rank {r['rank']} all_gather_rows of ragged f32 and bf16 rows holding "
              f"-0.0, ±Inf and a NaN payload, and map_rows of a function returning -0.0, bit for bit: {r['gathers']}")
    check(np.array_equal(ranks[0]["params"], ranks[1]["params"]) and np.array_equal(ranks[0]["losses"], ranks[1]["losses"]),
          f"the {DP_RANKS} replicas bit-identical after {steps} steps ({ranks[0]['params'].size:,} floats)")
    print(f"  DP step at batch {TRAIN_BATCH} ({card}): " + ", ".join(
        f"rank {r['rank']} {r['step_ms']:.3f} ms (all-reduce of {r['allreduce_floats']:,} floats over gloo through "
        f"the host {r['allreduce_ms']:.3f} ms)" for r in ranks)
        + f"; single process {single_ms:.3f} ms. Both ranks share one card: this measures the overhead of the "
          f"data-parallel step, not its scaling", flush=True)

    t = time.perf_counter()
    (nccl,) = spawn(dp_rank, 1, inputs_path, False, backend="nccl", timeout_s=DP_TIMEOUT_S)
    out["secs"]["nccl world"] = time.perf_counter() - t
    check(np.array_equal(nccl["params"], ref_params) and np.array_equal(nccl["losses"], ref_losses)
          and nccl["step_counts"] == ranks[0]["step_counts"] and all(nccl["gathers"].values()),
          f"1-rank NCCL world: {steps} steps bit-identical to the single process (losses and "
          f"{ref_params.size:,} floats), {nccl['step_counts'][1]} forward and {nccl['step_counts'][2]} backward "
          f"launches; the gathers bit for bit {nccl['gathers']}")
    out.update(single_step_ms=single_ms, ranks=[{k: r[k] for k in (
        "rank", "loss_err", "leaf_err", "step_counts", "eval_counts", "sample_counts", "sample_err", "abc_same",
        "abc_ms", "mmd", "fit_err", "iou_err", "step_ms", "allreduce_ms", "allreduce_floats", "dryrun")}
        for r in ranks], nccl={"step_counts": nccl["step_counts"]})
    print("  data-parallel phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in out["secs"].items()), flush=True)
    return out


# -- phase 16: the port's entry points -------------------------------------------------------

# hint_tpu_torch.bench through its supervisor, one child process a
# combination, at bench.py's batch and steps; the CPU baseline in the first
# only (HINT_TPU_BENCH_REF_STEPS=0 in the others); one retry
BENCH_RUNS = (("fused", "float32"), ("fused", "bfloat16"), ("levelwise", "float32"), ("levelwise", "bfloat16"))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "dtype", "impl", "device"}
BENCH_TIMEOUT_S = 300
# entry(impl="fused") against entry(impl="levelwise"): phase 6's loss gate
ENTRY_TOL = 1e-4


def entry_losses(torch, hac_fused, fused, plain, params, x):
    """(fused loss, its launch counts, levelwise loss) of one parameter dict."""
    with torch.no_grad():
        reset_counts()
        loss = float(fused(params, x))
        counts = read_counts()
        return loss, counts, float(plain(params, x))


def entry_phase(np, torch, hac_fused, card):
    """Phase 16: ``entry()`` under both impls (the fused loss against the
    levelwise one, 4 launches), a second parameter dict of new tensors
    over the first's halved buffers, made after the first is freed (its
    own loss, not a stale pack's), the bench through
    its supervisor for each of ``BENCH_RUNS``, ``dryrun_multichip(1)``.
    Returns what each gave."""
    from hint_tpu_torch import bench
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.entry import dryrun_multichip, entry

    out = {"secs": {}}
    t = time.perf_counter()
    fused, (params, x) = entry(impl="fused")
    plain, _ = entry(impl="levelwise")
    n_blocks = get_config(FLAGSHIP).n_blocks
    losses = {}
    for which in ("first", "second"):
        if which == "second":
            # the first dict's buffers halved through tensors of their own
            # version counters, the first dict freed, then the second made
            # of new tensors over the same buffers: each at a freed
            # tensor's address and version, which a pack keyed on them
            # alone would take for the first's
            buffers = {k: torch.from_dlpack(v) for k, v in params.items()}
            for v in buffers.values():
                v.mul_(0.5)
            addrs = {k: (v.data_ptr(), v._version) for k, v in params.items()}
            del params
            params = {k: torch.from_dlpack(v) for k, v in buffers.items()}
            out["reused_addresses"] = sum((v.data_ptr(), v._version) == addrs[k] for k, v in params.items())
            check(out["reused_addresses"] == len(params),
                  f"the second dict: {out['reused_addresses']} of {len(params)} tensors at a freed one's address "
                  "and version")
        loss, counts, ref = entry_losses(torch, hac_fused, fused, plain, params, x)
        err = abs(loss - ref) / (1 + abs(ref))
        losses[which] = {"fused": loss, "levelwise": ref, "err": err, "launches": counts[0]}
        check(np.isfinite(loss) and err <= ENTRY_TOL and counts[0] == n_blocks,
              f"entry(impl='fused') on the {which} parameter dict"
              + (" (new tensors over the freed one's halved buffers)" if which == "second" else "")
              + f", x {tuple(x.shape)}: loss {loss:.7g} against levelwise {ref:.7g}, |d|/(1+|ref|) {err:.3e} "
              f"(tol {ENTRY_TOL:g}), {counts[0]} launches (= {n_blocks} blocks)")
    check(losses["first"]["fused"] != losses["second"]["fused"], "the two dicts' losses differ")
    out["entry"] = losses
    out["secs"]["entry"] = time.perf_counter() - t

    root = os.path.dirname(os.path.abspath(__file__))
    name, power_limit = (v.strip() for v in card.rsplit(",", 1))
    out["bench"], out["bench_launches"] = [], [0] * len(bench.LAUNCH_COUNTS)
    for i, (impl, dtype) in enumerate(BENCH_RUNS):
        t = time.perf_counter()
        env = dict(os.environ, HINT_TPU_BENCH_IMPL=impl, HINT_TPU_BENCH_DTYPE=dtype, HINT_TPU_BENCH_ATTEMPTS="2",
                   HINT_TPU_BENCH_BACKOFF="10", HINT_TPU_BENCH_REF_STEPS=str(bench.REF_STEPS if i == 0 else 0))
        env.pop("HINT_TPU_BENCH_CHILD", None)
        proc = subprocess.run([sys.executable, "-m", "hint_tpu_torch.bench"], cwd=root, env=env,
                              capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        secs = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        for line in lines:
            print(f"  {line}", flush=True)
        check(proc.returncode == 0 and len(lines) == 1,
              f"python -m hint_tpu_torch.bench, impl={impl} {dtype}: exit {proc.returncode}, {len(lines)} stdout "
              f"line(s) in {secs:.1f} s" + ("" if proc.returncode == 0 else "\n" + proc.stderr[-3000:]))
        res = json.loads(lines[0])
        notes = [ln.split(bench.NOTE, 1)[1] for ln in proc.stderr.splitlines() if bench.NOTE in ln]
        note = json.loads(notes[-1])
        steps, launches = note["steps"], note["launches"]
        # a fused step: a saving forward of every block (by the wgmma route
        # in bf16, the tiled route in f32) and its two backward kernels
        saves = hac_fused._SAVE_ROUTE[dtype]
        want = {"forward": n_blocks, "forward_under_autograd": n_blocks, "backward": 2 * n_blocks,
                "backward_weights": n_blocks, "forward_wgmma": n_blocks * (saves == hac_fused.ROUTE_WG),
                "forward_tiled": n_blocks * (saves == hac_fused.ROUTE_TILED)} if impl == "fused" else {}
        check(set(res) == BENCH_KEYS and res["metric"] == "train_steps_per_sec" and res["unit"] == "steps/s"
              and (res["impl"], res["dtype"]) == (impl, dtype) and np.isfinite(res["value"]) and res["value"] > 0
              and ((res["vs_baseline"] is not None and np.isfinite(res["vs_baseline"])) if i == 0
                   else res["vs_baseline"] is None)
              and res["device"] == {"name": name, "power_limit": power_limit}
              and launches == {k: want.get(k, 0) * steps for k in bench.LAUNCH_COUNTS},
              f"bench {impl} {dtype}: bench.py's keys and the card, {res['value']} steps/s "
              f"({1e3 / res['value']:.3f} ms a step), vs_baseline {res['vs_baseline']}, launches over {steps} "
              f"steps {launches}")
        out["bench_launches"] = [a + launches[k] for a, k in zip(out["bench_launches"], bench.LAUNCH_COUNTS)]
        out["bench"].append({**res, "steps": steps, "launches": launches, "secs": secs,
                             "baseline_steps_per_sec": note["baseline_steps_per_sec"]})
    out["baseline_steps_per_sec"] = out["bench"][0]["baseline_steps_per_sec"]
    check(out["baseline_steps_per_sec"] is not None and out["baseline_steps_per_sec"] > 0,
          f"the torch-CPU baseline at batch {bench.BATCH}: {out['baseline_steps_per_sec']} steps/s on the host")
    out["secs"]["bench"] = sum(b["secs"] for b in out["bench"])

    t = time.perf_counter()
    dryrun_multichip(1)
    out["secs"]["dryrun_multichip(1)"] = time.perf_counter() - t
    print("  entry-points phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in out["secs"].items()), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="On-card smoke test of hint_tpu_torch")
    ap.add_argument("--profile", action="store_true",
                    help="phases 4 and 5 also build the kernels' cycle-profile library and print the forward "
                         "kernel's and the backward data kernel's profiles")
    ap.add_argument("--profile-only", action="store_true",
                    help="build, print the backward data kernel's profile on the flagship block at batch "
                         f"{TRAIN_BATCH} and stop (no result lines)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.ops import hac_fused
    from hint_tpu_torch.ops.base import exact_f32_matmul

    exact_f32_matmul()
    card = card_line()
    print(f"card: {card}", flush=True)
    t_start = time.perf_counter()

    # -- 1. build ---------------------------------------------------------------
    print("phase 1: build", flush=True)
    lib, build_s, log = hac_fused.build()
    print(f"  built {os.path.relpath(lib)} in {build_s:.2f} s")
    from hint_tpu_torch.data import native

    t = time.perf_counter()
    native.load()  # the toy data and the prior pool ask for it; a failed build fails the run
    print(f"  native toy-data generator {os.path.relpath(native._LIB_PATH)} loaded in "
          f"{time.perf_counter() - t:.2f} s")
    for line in log.splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    if args.profile_only:
        print(f"profile: the backward data kernel at batch {TRAIN_BATCH} ({card})", flush=True)
        data_kernel_profile(torch, hac_fused)
        return 0

    # -- 2. kernel vs plain version ------------------------------------------------
    print("phase 2: hac_block kernel vs plain version (the HAC block of each config)", flush=True)
    blocks = {kind: {dt: make_block(torch, kind, dt) for dt in TOL} for kind in BLOCKS}
    checked = {kind: kernel_vs_plain(torch, hac_fused, kind, blocks[kind]) for kind in BLOCKS}
    errs = {kind: v[0] for kind, v in checked.items()}
    for kind in BLOCKS:
        inf_rows(torch, hac_fused, kind, blocks[kind])

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        # -- 3. serving the flagship through the kernel ------------------------------------
        print(f"phase 3: serve {FLAGSHIP} impl=fused over HTTP", flush=True)
        served = {FLAGSHIP: serve_phase(np, torch, hac_fused, FLAGSHIP, tmp)}

        # -- 4. timings ----------------------------------------------------------------
        print(f"phase 4: block-pass times at batch {BUCKET} and {TRAIN_BATCH} (the UCI blocks at their configs' "
              f"batches), CUDA events ({card})", flush=True)
        variants = {kind: block_times(torch, hac_fused, kind, blocks[kind]) for kind in BLOCKS}
        profiles = route_profiles(torch, hac_fused, blocks) if args.profile else {}
        data_profiles = data_kernel_profile(torch, hac_fused) if args.profile else {}

        # -- 5. the kernel under autograd ---------------------------------------------------
        print("phase 5: hac_block under autograd (_FusedBlock: forward kernel, backward kernels) vs plain version",
              flush=True)
        grads = {kind: gradient_phase(torch, hac_fused, kind)
                 for kind in ("flagship", "conditional", *UCI_BATCHES, *CAMPAIGN_BLOCKS)}
        del blocks

        # -- 6. training through the CLI ----------------------------------------------------
        print(f"phase 6: train {FLAGSHIP} --impl fused through the CLI, batch {TRAIN_BATCH}", flush=True)
        trained = {FLAGSHIP: training_phase(np, torch, hac_fused, tmp, FLAGSHIP)}
        data = os.path.join(tmp, "data")
        x = torch.from_numpy(np.load(os.path.join(data, "plus-shape_x_train.npy"))[:TRAIN_BATCH].astype(np.float32)).cuda()
        y = torch.from_numpy(np.load(os.path.join(data, "plus-shape_y_train.npy"))[:TRAIN_BATCH].astype(np.float32)).cuda()

        # -- 7. training times ----------------------------------------------------------------
        print(f"phase 7: {FLAGSHIP} train-step times at batch {TRAIN_BATCH}, CUDA events ({card})", flush=True)
        step_ms, splits, step_bound, step_mib = {}, {}, {}, {}

        def time_steps(name, y_in, dtypes):
            times, split, peak, trainer, fused_step = step_times(torch, hac_fused, name, x, y_in, dtypes)
            # the saving forward (on the f32 CUDA cores), the backward's
            # reverse chain and its weight sums (each as many products as
            # the forward, on 3xTF32)
            hac = next(m for m in trainer.model.modules() if type(m).__name__ == "HierarchicalAffineCoupling")
            fwd = get_config(name).n_blocks * block_work(hac, TRAIN_BATCH, "float32")[0]
            flops = 3 * fwd
            step_ms[name], splits[name], step_mib[name] = times, split, peak
            _, passes, peak_rate = TC_ROUTE["float32"]
            step_bound[name] = (fwd / PEAK_FLOPS["float32"] + passes * 2 * fwd / peak_rate) * 1e3
            print_step_times(name, times, split, peak, step_bound[name], flops)
            return trainer, fused_step

        _, fused_step = time_steps(FLAGSHIP, None, tuple(TOL))
        idle_share, busy_ms = profile_step(torch, fused_step, step_ms[FLAGSHIP]["fused_float32"])
        del fused_step

        # -- 8. serving the conditional configs ------------------------------------------------
        for name in (RCINN, CHINT):
            print(f"phase 8: serve {name} impl=fused over HTTP", flush=True)
            served[name] = serve_phase(np, torch, hac_fused, name, tmp)

        # -- 9. training the conditional configs -------------------------------------------------
        for name in (RCINN, CHINT):
            print(f"phase 9: train {name} --impl fused through the CLI, batch {TRAIN_BATCH}", flush=True)
            trained[name] = training_phase(np, torch, hac_fused, tmp, name)

        # -- 10. their training times ---------------------------------------------------------------
        print(f"phase 10: conditional train-step times at batch {TRAIN_BATCH}, CUDA events ({card})", flush=True)
        time_steps(RCINN, y, ("float32",))
        two_lane, _ = time_steps(CHINT, y, ("float32",))
        whole_ms, plain_ms, n_plain = plain_share(torch, two_lane, x, y)
        print(f"  {CHINT} forward + backward {whole_ms:.3f} ms; its {n_plain} plain couplings and "
              f"permutations alone {plain_ms:.3f} ms ({100 * plain_ms / whole_ms:.1f} %)", flush=True)
        del two_lane

        # -- 11. the reshuffle config under impl="fused" -------------------------------------
        print(f"phase 11: {RESHUFFLE} impl=fused (levelwise blocks) vs impl=levelwise, batch {BUCKET}", flush=True)
        reshuffled = reshuffle_phase(torch, hac_fused)

        # -- 12. the UCI path -------------------------------------------------------------------
        print(f"phase 12: UCI configs {', '.join(UCI_CONFIGS)} on fixture files through the CLI", flush=True)
        uci_run = uci_phase(np, torch, hac_fused, tmp)

        # -- 13. the evaluation path ------------------------------------------------------------
        print("phase 13: evaluation (shape scores, self-checks, prior pool, quantile-ABC, compare_conditional, MMD)",
              flush=True)
        evaluated = evaluation_phase(np, torch, hac_fused, tmp)
        print("phase 13: the device prior sweep (prepare_samples(engine='tpu'), both families, KS against native)",
              flush=True)
        pools = device_pool_phase(np, torch, tmp, evaluated["secs"]["prior pool"])
        print(json.dumps({"device_sweep": pools}), flush=True)

        # -- 14. the campaign ------------------------------------------------------------------
        print("phase 14: the campaign (data, train, replay, pool, compare, shapes, grid, uci, report) "
              "with impl=fused, depth cut", flush=True)
        campaigned = campaign_phase(np, torch, hac_fused, tmp)

        # -- 15. data parallel ------------------------------------------------------------------
        print(f"phase 15: data parallel ({DP_RANKS}-rank gloo world on the one card, then a 1-rank NCCL world)",
              flush=True)
        dp = data_parallel_phase(np, torch, hac_fused, tmp, x, card)

    # -- 16. the port's entry points ----------------------------------------------------------
    print(f"phase 16: the port's entry points (entry under both impls, the bench of {len(BENCH_RUNS)} "
          f"combinations through its supervisor, dryrun_multichip(1))", flush=True)
    entered = entry_phase(np, torch, hac_fused, card)

    # -- 17. result lines -----------------------------------------------------------------
    source = "hint_tpu_torch/ops/csrc/hac_block.cu"

    def kernel_entry(name, replaces, launches, kind, more):
        v = variants[kind]["float32_forward"]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": errs[kind]["float32"][0], "max_err": errs[kind]["float32"][1],
            "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None, "batch": BUCKET,
            "max_abs_err_bf16": errs[kind]["bfloat16"][0], "max_err_bf16": errs[kind]["bfloat16"][1],
            "variants": variants[kind], "kernel_route": {dt: route_name(hac_fused, dt) for dt in TOL},
            "route_errors": checked[kind][1],
            "route_profile": {dt: profiles.get(f"{kind}_{dt}") for dt in TOL}, **more,
        }

    gf, gt = grads["flagship"], grads["flagship"]["times"]

    # launches of the UCI path (phase 12: training, evaluation, the sweep)
    # per kernel, of the evaluation path (phase 13) and of the campaign
    # (phase 14: its hint models' blocks all take the unconditional kernel)
    uci_counts = uci_run["counts"]
    uci_fwd, uci_grad, uci_bwd, uci_w = (sum(c[k] for c in uci_counts.values()) for k in range(4))
    camp_fwd, camp_grad, camp_bwd, camp_w = campaigned["launches"]
    # launches of the data-parallel path (phase 15), summed over the ranks of
    # both worlds: steps, evaluation and sampling; the conditional kernel's
    # in RCINN's sampling
    dp_counts = [r["step_counts"] for r in dp["ranks"]] + [dp["nccl"]["step_counts"]]
    dp_counts += [r["eval_counts"] for r in dp["ranks"]]
    dp_counts += [r["sample_counts"][n] for r in dp["ranks"] for n in (FLAGSHIP, CHINT)]
    dp_fwd, dp_grad, dp_bwd, dp_w = (sum(c[k] for c in dp_counts) for k in range(4))
    dp_cond = sum(r["sample_counts"][RCINN][0] for r in dp["ranks"])
    # launches of the entry points (phase 16): the fused entry's two calls,
    # the fused bench's timed steps (f32 and bf16, each in its own process)
    entry_fwd = sum(v["launches"] for v in entered["entry"].values())
    bench_fwd, bench_grad, bench_bwd, bench_w, bench_wg, bench_tiled = entered["bench_launches"]
    uci_kinds = list(UCI_BATCHES)

    def backward_entry(name, part, launches, max_abs_err, library_ms=None, more=None):
        """One backward kernel at batch 10,000 (flagship block), timed alone
        on buffers the kernel before it filled; the data and weight kernels'
        errors are those of the whole backward (phase 5). The UCI blocks'
        times at their configs' training batches beside."""
        ct = grads["conditional"]["times"]
        uci_blocks, campaign_blocks = ({kind: {k: grads[kind]["times"][f"{part}_{k}"]
                                               for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                                        | {"batch": grads[kind]["times"]["batch"], "max_err": grads[kind]["f32_leaf"],
                                           "max_err_bf16": grads[kind]["bf16_leaf"]} for kind in kinds}
                                       for kinds in (uci_kinds, CAMPAIGN_BLOCKS))
        return {
            "name": name, "route": "cuda", "source": "hint_tpu_torch/ops/csrc/hac_block_bwd.cu",
            "replaces": "hint_tpu/ops/pallas_block.py:357", "launches": launches,
            "max_abs_err": max_abs_err, "max_err": gf["f32_leaf"], "max_err_bf16": gf["bf16_leaf"],
            "ms": gt[f"{part}_ms"], "plain_ms": gt[f"{part}_plain_ms"], "bound_ms": gt[f"{part}_bound_ms"],
            "bound_by": gt[f"{part}_bound_by"], "library_ms": library_ms, "batch": TRAIN_BATCH,
            "backward_ms": gt["bwd_ms"], "backward_plain_ms": gt["bwd_plain_ms"],
            "conditional_ms": ct[f"{part}_ms"], "conditional_plain_ms": ct[f"{part}_plain_ms"],
            "conditional_bound_ms": ct[f"{part}_bound_ms"], "uci_blocks": uci_blocks,
            "campaign_blocks": campaign_blocks, **(more or {}),
        }

    def wgmma_entry(launches):
        """The bf16 route of the forward kernel (``hac_block_wg_kernel``,
        wgmma) on the flagship block: serving at 4096 (phase 4), serving and
        saving at 10,000 (phase 5), beside its bounds on the bf16 tensor
        cores; its launches are the fused bf16 bench's saving forwards
        (phase 16). The other blocks' times beside."""
        v4, v10 = (variants["flagship"][k]["routes"]["wgmma"] for k in ("bfloat16_forward", "bfloat16_forward_b10000"))
        f10 = gt["bf16_forward"]
        return {
            "name": "hac_block_wgmma", "route": "cuda", "source": source,
            "replaces": "hint_tpu/ops/pallas_block.py:250", "launches": launches,
            "max_abs_err": checked["flagship"][1]["bfloat16"]["wgmma"][0],
            "max_err": checked["flagship"][1]["bfloat16"]["wgmma"][1],
            "ms": v4["ms"], "plain_ms": variants["flagship"]["bfloat16_forward"]["plain_ms"],
            "bound_ms": v4["bound_ms"], "bound_by": v4["bound_by"], "library_ms": None, "batch": BUCKET,
            "kernel_route": {"serving": route_name(hac_fused, "bfloat16"),
                             "saving": route_name(hac_fused, "bfloat16", saving=True)},
            "ms_b10000": v10["ms"], "bound_ms_b10000": v10["bound_ms"],
            "saving_ms_b10000": min(f10["wgmma"]["save"]), "saving_bound_ms_b10000": f10["wgmma"]["save_bound_ms"],
            "saving_bound_by_b10000": f10["wgmma"]["save_bound_by"], "forward_times_b10000": f10,
            "blocks": {kind: {"variants": {k: v for k, v in variants[kind].items() if k.startswith("bfloat16")},
                              "route_errors": checked[kind][1]["bfloat16"],
                              "forward_times": grads[kind]["times"]["bf16_forward"] if kind in grads else None}
                       for kind in BLOCKS},
        }

    uncond = [FLAGSHIP, CHINT]
    print(json.dumps({"kernels": [
        kernel_entry(
            "hac_block", "hint_tpu/ops/pallas_block.py:250",
            sum(served[n]["launches"] + trained[n][0] for n in uncond) + uci_fwd + evaluated["sample_launches"]
            + camp_fwd + dp_fwd + entry_fwd + bench_fwd, "flagship", {
                "serve_launches": {n: served[n]["launches"] for n in uncond},
                "train_launches": {n: trained[n][0] for n in uncond},
                "uci_launches": {n: c[0] for n, c in uci_counts.items()},
                "evaluation_launches": evaluated["sample_launches"],
                "uci_blocks": {kind: {"max_abs_err": errs[kind]["float32"][0], "max_err": errs[kind]["float32"][1],
                                      "max_abs_err_bf16": errs[kind]["bfloat16"][0],
                                      "max_err_bf16": errs[kind]["bfloat16"][1], "route_errors": checked[kind][1],
                                      "variants": variants[kind]} for kind in uci_kinds},
                "uci_path": uci_run, "evaluation_path": evaluated,
                "x_lane_max_abs_err": errs["x_lane"]["float32"][0], "x_lane_max_err": errs["x_lane"]["float32"][1],
                "x_lane_route_errors": checked["x_lane"][1],
                "x_lane_variants": variants["x_lane"],
                "sample_rps": {n: served[n] for n in uncond},
                "campaign_launches": {k: c[0] for k, c in campaigned["counts"].items()},
                "campaign_path": campaigned, "data_parallel_launches": dp_fwd, "data_parallel_path": dp,
                "entry_launches": entry_fwd, "bench_launches": bench_fwd, "entry_points_path": entered,
                "campaign_blocks": {kind: {"max_abs_err": errs[kind]["float32"][0], "max_err": errs[kind]["float32"][1],
                                           "max_abs_err_bf16": errs[kind]["bfloat16"][0],
                                           "max_err_bf16": errs[kind]["bfloat16"][1],
                                           "route_errors": checked[kind][1], "variants": variants[kind]}
                                    for kind in CAMPAIGN_BLOCKS},
            }),
        kernel_entry(
            "hac_block_conditional", "hint_tpu/ops/pallas_block.py:209",
            served[RCINN]["launches"] + trained[RCINN][0] + evaluated["compare_launches"] + dp_cond, "conditional", {
                "serve_launches": served[RCINN]["launches"], "train_launches": trained[RCINN][0],
                "evaluation_launches": evaluated["compare_launches"], "data_parallel_launches": dp_cond,
                "sample_rps": served[RCINN],
            }),
        wgmma_entry(bench_wg),
        {
            "name": "hac_block_gradient", "route": "cuda", "source": "hint_tpu_torch/ops/hac_fused.py",
            "replaces": "hint_tpu/ops/pallas_block.py:357",
            "launches": sum(t[1] for t in trained.values()) + uci_grad + camp_grad + dp_grad + bench_grad,
            "data_parallel_launches": dp_grad, "bench_launches": bench_grad,
            "uci_launches": {n: c[1] for n, c in uci_counts.items()},
            "uci_blocks": {kind: grads[kind] for kind in uci_kinds},
            "campaign_launches": {k: c[1] for k, c in campaigned["counts"].items()},
            "campaign_blocks": {kind: grads[kind] for kind in CAMPAIGN_BLOCKS},
            "max_abs_err": gf["f32_abs"], "max_err": gf["f32_leaf"], "max_err_per_entry": gf["f32_entry"],
            "plain_max_err": gf["plain_leaf"], "plain_max_err_per_entry": gf["plain_entry"],
            "max_err_bf16": gf["bf16_leaf"], "max_abs_err_bf16": gf["bf16_abs"],
            "flipped_rows": gf["flipped_rows"], "all_rows_max_err": gf["all_rows_leaf"],
            "ms": gt["fwd_bwd_ms"], "plain_ms": gt["fwd_bwd_plain_ms"], "bound_ms": gt["fwd_bwd_bound_ms"],
            "bound_by": "operations", "library_ms": None, "batch": TRAIN_BATCH,
            "conditional": {k: v for k, v in grads["conditional"].items()},
            "train_launches_under_autograd": {n: t[1] for n, t in trained.items()},
            "train_step_ms": step_ms, "train_step_split_ms": splits, "train_step_bound_ms": step_bound,
            "train_step_extra_mib": step_mib,
            "train_idle_share_profiled": idle_share, "train_device_busy_ms": busy_ms,
            "two_lane_forward_backward_ms": whole_ms, "two_lane_plain_steps_ms": plain_ms,
            "saved_vs_plain": gf["saved_vs_plain"], "reshuffle_levelwise": reshuffled,
            "forward_ms": gt["forward_ms"], "forward_save_ms": gt["forward_save_ms"],
            "forward_save_bound_ms": gt["forward_save_bound_ms"], "forward_save_turns": gt["forward_save_turns"],
            "repack": gt["repack"], "conditional_forward_save_ms": grads["conditional"]["times"]["forward_save_ms"],
            "forward_save_route": route_name(hac_fused, "float32", saving=True), "bench_tiled_launches": bench_tiled,
            "forward_save_loop_ms": {kind: g["times"].get("forward_save_loop_ms") for kind, g in grads.items()},
            "forward_save_tiled_ms": {kind: g["times"]["forward_save_ms"] for kind, g in grads.items()},
            "forward_save_bounds_ms": {kind: g["times"]["forward_save_bound_ms"] for kind, g in grads.items()},
        },
        backward_entry("hac_block_backward", "data",
                       sum(t[2] - t[3] for t in trained.values()) + uci_bwd - uci_w + camp_bwd - camp_w
                       + dp_bwd - dp_w + bench_bwd - bench_w,
                       gf["f32_abs"],
                       more={"profile": data_profiles,
                             "uci_launches": {n: c[2] - c[3] for n, c in uci_counts.items()},
                             "campaign_launches": camp_bwd - camp_w, "data_parallel_launches": dp_bwd - dp_w,
                             "bench_launches": bench_bwd - bench_w}),
        backward_entry("hac_block_backward_weights", "weights",
                       sum(t[3] for t in trained.values()) + uci_w + camp_w + dp_w + bench_w,
                       gf["f32_abs"], more={
                           "holds": "the sum over the row chunks, by each tile's last chunk in chunk order (the "
                                    "former hac_block_backward_reduce)",
                           "chunks": gt["chunks"], "blocks": gt["weight_blocks"],
                           "reduction_library_ms": gt["reduction_library_ms"],
                           "conditional_reduction_library_ms": grads["conditional"]["times"]["reduction_library_ms"],
                           "bmm_yardstick_ms": gt["bmm_ms"],
                           "conditional_bmm_yardstick_ms": grads["conditional"]["times"]["bmm_ms"],
                           "uci_launches": {n: c[3] for n, c in uci_counts.items()},
                           "campaign_launches": camp_w, "data_parallel_launches": dp_w, "bench_launches": bench_w}),
    ]}))
    print(f"whole script: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
