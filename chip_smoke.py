#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``hint_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and a checkout of the repository; imports nothing of
JAX or ``hint_tpu``. Three configs are driven at full width: the flagship
``plus_shape.unconditional_hint_4_full``, the condition-fed
``plus_shape.conditional_recursive_cinn_4`` (4 launches of the conditional
kernel per pass) and the two-lane ``plus_shape.conditional_hint_8_full``
(8 launches of the unconditional kernel per two-lane pass, 16 per
``/sample``). Phases:

1. the card's name and power limit; build the hac_block kernel from
   ``hint_tpu_torch/ops/csrc`` (nvcc, sm_90a) and print the build seconds;
2. the kernel against its plain version (the levelwise engine) on the HAC
   block of each config (``model.init`` weights, noise in every padded entry,
   the rows ``[split, in_max)`` before a condition-fed block's condition rows
   included), forward and inverse, f32 and bf16, batch 37 (ragged), 64, 4096
   and 10,000;
3. serving the flagship with ``impl="fused"`` through
   ``InferenceService.from_checkpoint`` and the HTTP server: /health,
   /sample n=4096, /sample n=5000 (paged), /log_prob; the kernel's launch
   count over those requests, finite outputs, forward(inverse(z)) = z, the
   fused log_prob against the plain one, and /sample requests/s;
4. times with CUDA events (median of 5 rounds after warm-up): kernel and
   plain version per block-pass of each block at batch 4096 (serving) and
   10,000 (training), beside the bound;
5. the kernel under autograd (``hac_fused._FusedBlock``) on the flagship
   block and on the condition-fed block, batch 37 and 4096, forward and
   inverse, f32: outputs against the plain version, and the gradients of
   sum(y*r) + sum(logdet*q) for x, the condition and every level parameter
   against autograd through the plain version; its time per block at batch
   10,000;
6. training the flagship through ``hint_tpu_torch.cli.main(["train", ...])``
   with ``--impl fused``: 2 epochs of 2 steps at the config's batch of 10,000
   on 20,000 generated plus-shape rows (kept, with their ``y``, for the later
   phases), 2 evaluations; the kernel's launch count (4 per train step, 4 per
   evaluation batch), finite losses, the same run with ``--impl levelwise``
   step by step, ``--resume`` of the state after epoch 1, and the saved file
   sampled through the CLI and served with ``impl="fused"`` over HTTP;
7. flagship training times at batch 10,000 (synchronised CUDA events, median
   of 5 after warm-up): steps/s for fused and levelwise, f32 and bf16; the
   split of a fused f32 step into re-pack, forward, backward and optimizer;
   a ``torch.profiler`` table of the device operations and the idle gaps
   that take most of a step;
8. serving the two conditional configs as in phase 3, with the default
   ``vis_y_target`` and an explicit ``y_target`` (same seed, other samples),
   ``y`` beside ``x`` for /log_prob, forward(inverse(z, y), y) = z;
9. training them as in phase 6 on the same rows with their ``y`` (4 resp. 8
   launches per train step and per evaluation batch), ``sample --y-target``
   from the saved file;
10. their training times as in phase 7 (f32), and the share of the plain
    couplings and permutations in a two-lane step;
11. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

Any failed check exits non-zero before the last line is printed.
"""

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
# the HAC block of each config at d=100: (c_internal, cond_dim)
BLOCKS = {
    "flagship": ((263, 131, 65, 32, 32), 0),
    "conditional": ((267, 133, 66), 4),  # RCINN: the condition-fed kernel
    "x_lane": ((152, 76, 38), 0),  # CHINT: the unconditional kernel on its x lane
}
DIM = 100
BUCKET = 4096
# kernel vs plain version. f32: the kernel sums each product in another
# order than the plain version's matmuls, through 7 levels of exp-scaled
# couplings. bf16: both round the same activations to bf16, but one that
# sits on a rounding boundary can land one bf16 ulp (2**-8) apart.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a served flow: round trip and fused-vs-plain log_prob (f32)
ROUND_TRIP_TOL = 1e-3
LOG_PROB_TOL = (1e-3, 1e-4)  # (abs, rel)
# the kernel under autograd: the backward of hac_fused._FusedBlock and autograd
# through the plain version run the same code from the same x; what is left
# is the order of the atomic adds in the scatter/gather backward kernels
GRAD_TOL = 1e-5
# fused vs levelwise training, per-step loss (f32): the kernel's forward sums
# in another order (phase 2), the backward is the same code
TRAIN_LOSS_TOL = 1e-4
# a resumed epoch against the uninterrupted one: same code, same draws;
# only the atomics' order differs
RESUME_TOL = 1e-5
TRAIN_BATCH = 10_000
STEPS_PER_EPOCH = 2
TRAIN_ARGS = ["--n-train", str(STEPS_PER_EPOCH * TRAIN_BATCH), "--n-test", str(TRAIN_BATCH),
              "--max-batches", str(STEPS_PER_EPOCH)]
# published H100 SXM peaks (NVIDIA data sheet): f32 CUDA cores, bf16
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


class CheckFailed(AssertionError):
    pass


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


def make_block(torch, kind, compute_dtype, requires_grad=False):
    """One HAC block of ``BLOCKS``, model.init weights, noise in the padding
    (for a condition-fed block that includes the rows [split, in_max) of w0
    that lie before its condition rows)."""
    from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling

    c_internal, cond_dim = BLOCKS[kind]
    hac = HierarchicalAffineCoupling(
        dim=DIM, c_internal=c_internal, cond_dim=cond_dim, compute_dtype=compute_dtype, impl="fused"
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


def block_work(hac, batch, compute_dtype):
    """(FLOPs, bytes, bound ms, what bounds it) of one block-pass: the
    logical subnet products (the condition's layer-1 terms included), x and
    the condition read and y/logdet written once, the weights read once."""
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
    by_ops, by_bytes = flops / PEAK_FLOPS[compute_dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
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


def kernel_vs_plain(torch, hac_fused, kind, blocks):
    """The kernel against its plain version on one block of ``BLOCKS``.
    Returns {dtype: [max abs, max |d|/(1+|ref|)]}."""
    cond_dim = BLOCKS[kind][1]
    errs = {dt: [0.0, 0.0] for dt in TOL}
    g = torch.Generator(device="cuda").manual_seed(2)
    for dt, hac in blocks.items():
        for batch in (37, 64, BUCKET, TRAIN_BATCH):
            x = randn(torch, g, batch, DIM)
            c = randn(torch, g, batch, cond_dim) if cond_dim else None
            for rev in (False, True):
                with torch.no_grad():
                    yk, ldk = hac_fused.fused_block(hac, x, c, rev)
                    yp, ldp = hac_fused.plain_block(hac, x, c, rev)
                torch.cuda.synchronize()
                d_abs = max(float((yk - yp).abs().max()), float((ldk - ldp).abs().max()))
                d_rel = max(rel_err(yk, yp), rel_err(ldk, ldp))
                errs[dt] = [max(errs[dt][0], d_abs), max(errs[dt][1], d_rel)]
                finite = bool(torch.isfinite(yk).all() and torch.isfinite(ldk).all())
                check(
                    finite and d_rel <= TOL[dt],
                    f"{kind} {dt} {'inverse' if rev else 'forward'} B={batch}: max_abs={d_abs:.3e} "
                    f"max_rel={d_rel:.3e} (tol {TOL[dt]:g}: |d| <= tol*(1+|ref|))",
                )
    return errs


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
        hac_fused.launches = 0
        health = http(port, "/health")
        x = np.asarray(http(port, "/sample", {"n": BUCKET, "seed": 0})["x"], np.float32)
        if dy:
            other = {"n": BUCKET, "seed": 0, "y_target": [0.5] * dy}
            x_other = np.asarray(http(port, "/sample", other)["x"], np.float32)
        x_paged = np.asarray(http(port, "/sample", {"n": 5000, "seed": 1})["x"], np.float32)
        lp = np.asarray(http(port, "/log_prob", {"x": x.tolist(), **with_y})["log_prob"], np.float32)
        launches = hac_fused.launches
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
    training batch. Returns {variant: {ms, plain_ms, bound_ms, ...}}."""
    cond_dim = BLOCKS[kind][1]
    g = torch.Generator(device="cuda").manual_seed(4)
    variants = {}
    with torch.no_grad():
        for batch in (BUCKET, TRAIN_BATCH):
            xb = randn(torch, g, batch, DIM)
            cb = randn(torch, g, batch, cond_dim) if cond_dim else None
            for dt, hac in blocks.items():
                for rev in (False, True):
                    name = f"{dt}_{'inverse' if rev else 'forward'}" + ("" if batch == BUCKET else f"_b{batch}")
                    k_ms = time_ms(torch, lambda: hac_fused.fused_block(hac, xb, cb, rev), reps=20)
                    p_ms = time_ms(torch, lambda: hac_fused.plain_block(hac, xb, cb, rev), reps=5)
                    flops, nbytes, bound, bound_by = block_work(hac, batch, dt)
                    variants[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
                                      "tflops": flops / k_ms / 1e9}
                    print(f"  hac_block {kind} {name} B={batch}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                          f"bound {bound:.4f} ms by {bound_by} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
                          f"{flops / k_ms / 1e9:.2f} TFLOP/s", flush=True)
    return variants


# -- phase 5 -------------------------------------------------------------------------------


def gradient_phase(torch, hac_fused, kind):
    """_FusedBlock against the plain version under autograd on one block of
    ``BLOCKS``: gradients for x, the condition (where the block takes one)
    and every level parameter. Returns (worst abs error, worst relative
    error, {ms, plain_ms, bound_ms} of forward + backward at batch 10,000)."""
    cond_dim = BLOCKS[kind][1]
    hac = make_block(torch, kind, "float32", requires_grad=True)
    names = [k for k, _ in hac.named_parameters()]
    inputs = ["x", "cond"] if cond_dim else ["x"]
    g = torch.Generator(device="cuda").manual_seed(5)
    worst_abs = worst = 0.0
    for batch in (37, BUCKET):
        x, r, q = randn(torch, g, batch, DIM), randn(torch, g, batch, DIM), randn(torch, g, batch)
        c = randn(torch, g, batch, cond_dim) if cond_dim else None
        for rev in (False, True):
            outs, grads = {}, {}
            for which, fn in (("fused", hac_fused.fused_block), ("plain", hac_fused.plain_block)):
                xg = x.clone().requires_grad_()
                cg = c.clone().requires_grad_() if cond_dim else None
                before = hac_fused.launches
                y, ld = fn(hac, xg, cg, rev)
                if which == "fused":
                    through = hac_fused.launches == before + 1 and type(y.grad_fn).__name__ == "_FusedBlockBackward"
                outs[which] = (y.detach(), ld.detach())
                wrt = [xg, cg] if cond_dim else [xg]
                grads[which] = torch.autograd.grad((y * r).sum() + (ld * q).sum(), [*wrt, *hac.parameters()])
            torch.cuda.synchronize()
            d_out = max(rel_err(a, b) for a, b in zip(outs["fused"], outs["plain"]))
            per_leaf = {k: rel_err(a, b) for k, a, b in zip([*inputs, *names], grads["fused"], grads["plain"])}
            finite = all(bool(torch.isfinite(t).all()) for t in grads["fused"])
            moved = all(bool(t.abs().max() > 0) for t in grads["fused"])
            d_grad = max(per_leaf.values())
            worst = max(worst, d_grad)
            worst_abs = max(worst_abs, max(float((a - b).abs().max()) for a, b in zip(grads["fused"], grads["plain"])))
            tag = f"{kind} {'inverse' if rev else 'forward'} B={batch}"
            check(through and d_out <= TOL["float32"],
                  f"{tag}: one launch through _FusedBlock, outputs vs plain max_rel={d_out:.3e} (tol {TOL['float32']:g})")
            check(
                finite and moved and d_grad <= GRAD_TOL,
                f"{tag}: gradients of {' and '.join(inputs)} and {len(names)} level parameters vs plain, worst "
                f"{max(per_leaf, key=per_leaf.get)} max_rel={d_grad:.3e} (tol {GRAD_TOL:g}), all finite and non-zero",
            )
    x = randn(torch, g, TRAIN_BATCH, DIM).requires_grad_()
    c = randn(torch, g, TRAIN_BATCH, cond_dim).requires_grad_() if cond_dim else None
    wrt = [x, c, *hac.parameters()] if cond_dim else [x, *hac.parameters()]

    def both_ways(fn):
        y, ld = fn(hac, x, c, False)
        torch.autograd.grad(y.sum() + ld.sum(), wrt)

    k_ms = time_ms(torch, lambda: both_ways(hac_fused.fused_block), reps=3, warmup=2)
    p_ms = time_ms(torch, lambda: both_ways(hac_fused.plain_block), reps=3, warmup=2)
    # forward, the backward's recomputed forward, and a backward of twice the forward
    bound = 4 * block_work(hac, TRAIN_BATCH, "float32")[2]
    print(f"  {kind} block forward + backward at B={TRAIN_BATCH}: _FusedBlock {k_ms:.3f} ms, "
          f"plain under autograd {p_ms:.3f} ms, bound {bound:.4f} ms", flush=True)
    return worst_abs, worst, {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound}


# -- phases 6 and 9 --------------------------------------------------------------------------


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
    and serve the saved file. Returns (kernel launches, those under
    autograd) of the fused run."""
    from hint_tpu_torch import cli
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.serve import InferenceService, make_server

    cfg = get_config(name)
    cache = ["--cache-dir", os.path.join(tmp, "data")]
    final_ckpt, half_ckpt = os.path.join(tmp, f"{name}.trained.npz"), os.path.join(tmp, f"{name}.epoch1.npz")
    t0 = time.perf_counter()
    hac_fused.launches = hac_fused.grad_launches = 0
    final, losses = train_cli(torch, name, ["--impl", "fused", "--epochs", "2", *TRAIN_ARGS, *cache, "--save", final_ckpt])
    launches, grad_launches = hac_fused.launches, hac_fused.grad_launches
    print(f"  train --impl fused: {time.perf_counter() - t0:.1f} s including any data generation", flush=True)
    steps, evals, blocks = 2 * STEPS_PER_EPOCH, 2, cfg.n_blocks
    check(losses.shape == (steps, 2), f"{steps} training steps at batch {TRAIN_BATCH}")
    check(
        launches == blocks * (steps + evals) and grad_launches == blocks * steps,
        f"kernel launches over the training run: {launches} (= {blocks} blocks x ({steps} steps + {evals} "
        f"evaluation batches)), {grad_launches} of them under autograd",
    )
    check(bool(np.isfinite(losses).all() and np.isfinite(final)),
          f"losses finite: first step {losses[0].sum():.4f}, last step {losses[-1].sum():.4f}, test {final:.4f}")

    hac_fused.launches = 0
    final_lw, losses_lw = train_cli(torch, name, ["--impl", "levelwise", "--epochs", "2", *TRAIN_ARGS, *cache])
    check(hac_fused.launches == 0, "the levelwise run launches no kernel")
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
    return launches, grad_launches


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
    return times, split, trainer, steps["fused_float32"]


def print_step_times(name, times, split, bound, flops):
    for variant, ms in times.items():
        print(f"  {name} train step {variant}: {ms:.3f} ms, {1e3 / ms:.2f} steps/s")
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


def main():
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
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 2. kernel vs plain version ------------------------------------------------
    print("phase 2: hac_block kernel vs plain version (the HAC block of each config)", flush=True)
    blocks = {kind: {dt: make_block(torch, kind, dt) for dt in TOL} for kind in BLOCKS}
    errs = {kind: kernel_vs_plain(torch, hac_fused, kind, blocks[kind]) for kind in BLOCKS}

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        # -- 3. serving the flagship through the kernel ------------------------------------
        print(f"phase 3: serve {FLAGSHIP} impl=fused over HTTP", flush=True)
        served = {FLAGSHIP: serve_phase(np, torch, hac_fused, FLAGSHIP, tmp)}

        # -- 4. timings ----------------------------------------------------------------
        print(f"phase 4: block-pass times at batch {BUCKET} and {TRAIN_BATCH}, CUDA events ({card})", flush=True)
        variants = {kind: block_times(torch, hac_fused, kind, blocks[kind]) for kind in BLOCKS}

        # -- 5. the kernel under autograd ---------------------------------------------------
        print("phase 5: hac_block under autograd (_FusedBlock) vs plain version (f32)", flush=True)
        grads = {kind: gradient_phase(torch, hac_fused, kind) for kind in ("flagship", "conditional")}
        del blocks

        # -- 6. training through the CLI ----------------------------------------------------
        print(f"phase 6: train {FLAGSHIP} --impl fused through the CLI, batch {TRAIN_BATCH}", flush=True)
        trained = {FLAGSHIP: training_phase(np, torch, hac_fused, tmp, FLAGSHIP)}
        data = os.path.join(tmp, "data")
        x = torch.from_numpy(np.load(os.path.join(data, "plus-shape_x_train.npy"))[:TRAIN_BATCH].astype(np.float32)).cuda()
        y = torch.from_numpy(np.load(os.path.join(data, "plus-shape_y_train.npy"))[:TRAIN_BATCH].astype(np.float32)).cuda()

        # -- 7. training times ----------------------------------------------------------------
        print(f"phase 7: {FLAGSHIP} train-step times at batch {TRAIN_BATCH}, CUDA events ({card})", flush=True)
        step_ms, splits, step_bound = {}, {}, {}

        def time_steps(name, y_in, dtypes):
            times, split, trainer, fused_step = step_times(torch, hac_fused, name, x, y_in, dtypes)
            # forward, backward (twice the forward) and the backward's recomputed forward
            hac = next(m for m in trainer.model.modules() if type(m).__name__ == "HierarchicalAffineCoupling")
            flops = 4 * get_config(name).n_blocks * block_work(hac, TRAIN_BATCH, "float32")[0]
            step_ms[name], splits[name] = times, split
            step_bound[name] = flops / PEAK_FLOPS["float32"] * 1e3
            print_step_times(name, times, split, step_bound[name], flops)
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

    # -- 11. result lines -----------------------------------------------------------------
    source = "hint_tpu_torch/ops/csrc/hac_block.cu"

    def kernel_entry(name, replaces, launches, kind, more):
        v = variants[kind]["float32_forward"]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": errs[kind]["float32"][0], "max_err": errs[kind]["float32"][1],
            "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None, "batch": BUCKET,
            "max_abs_err_bf16": errs[kind]["bfloat16"][0], "max_err_bf16": errs[kind]["bfloat16"][1],
            "variants": variants[kind], **more,
        }

    g_abs, g_rel, g_time = grads["flagship"]
    uncond = [FLAGSHIP, CHINT]
    print(json.dumps({"kernels": [
        kernel_entry(
            "hac_block", "hint_tpu/ops/pallas_block.py:250",
            sum(served[n]["launches"] + trained[n][0] for n in uncond), "flagship", {
                "serve_launches": {n: served[n]["launches"] for n in uncond},
                "train_launches": {n: trained[n][0] for n in uncond},
                "x_lane_max_abs_err": errs["x_lane"]["float32"][0], "x_lane_max_err": errs["x_lane"]["float32"][1],
                "x_lane_variants": variants["x_lane"],
                "sample_rps": {n: served[n] for n in uncond},
            }),
        kernel_entry(
            "hac_block_conditional", "hint_tpu/ops/pallas_block.py:209",
            served[RCINN]["launches"] + trained[RCINN][0], "conditional", {
                "serve_launches": served[RCINN]["launches"], "train_launches": trained[RCINN][0],
                "sample_rps": served[RCINN],
            }),
        {
            "name": "hac_block_gradient", "route": "cuda", "source": "hint_tpu_torch/ops/hac_fused.py",
            "replaces": "hint_tpu/ops/pallas_block.py:357",
            "launches": sum(t[1] for t in trained.values()),
            "max_abs_err": g_abs, "max_err": g_rel, **g_time, "bound_by": "operations", "library_ms": None,
            "batch": TRAIN_BATCH,
            "conditional": dict(zip(("max_abs_err", "max_err", "times"), grads["conditional"])),
            "train_launches_under_autograd": {n: t[1] for n, t in trained.items()},
            "train_step_ms": step_ms, "train_step_split_ms": splits, "train_step_bound_ms": step_bound,
            "train_idle_share_profiled": idle_share, "train_device_busy_ms": busy_ms,
            "two_lane_forward_backward_ms": whole_ms, "two_lane_plain_steps_ms": plain_ms,
        },
    ]}))
    print(f"whole script: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
