#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``hint_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and a checkout of the repository; imports nothing of
JAX or ``hint_tpu``. Phases:

1. the card's name and power limit; build the hac_block kernel from
   ``hint_tpu_torch/ops/csrc`` (nvcc, sm_90a) and print the build seconds;
2. the kernel against its plain version (the levelwise engine) on the
   flagship HAC block (``model.init`` weights, noise in every padded entry),
   forward and inverse, f32 and bf16, batch 37 (ragged), 64 and 4096;
3. serving the flagship ``plus_shape.unconditional_hint_4_full`` with
   ``impl="fused"`` through ``InferenceService.from_checkpoint`` and the HTTP
   server: /health, /sample n=4096, /sample n=5000 (paged), /log_prob; the
   kernel's launch count over those requests, finite outputs,
   forward(inverse(z)) = z and the fused log_prob against the plain one;
4. times with CUDA events (median of repeats after warm-up): kernel and
   plain version per block-pass at batch 4096, and /sample n=4096 requests/s;
5. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

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
BUCKET = 4096
# kernel vs plain version. f32: the kernel sums each product in another
# order than the plain version's matmuls, through 7 levels of exp-scaled
# couplings. bf16: both round the same activations to bf16, but one that
# sits on a rounding boundary can land one bf16 ulp (2**-8) apart.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the served 4-block flow: round trip and fused-vs-plain log_prob (f32)
ROUND_TRIP_TOL = 1e-3
LOG_PROB_TOL = (1e-3, 1e-4)  # (abs, rel)
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


def flagship_block(torch, compute_dtype):
    """One flagship HAC block, model.init weights, noise in the padding."""
    from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling

    hac = HierarchicalAffineCoupling(
        dim=100, c_internal=(263, 131, 65, 32, 32), compute_dtype=compute_dtype, impl="fused"
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
    return hac.cuda().requires_grad_(False)


def block_work(hac, batch, compute_dtype):
    """(FLOPs, bytes, bound ms) of one block-pass: the logical subnet
    products, x read and y/logdet written once, the weights read once."""
    flops = 2 * batch * sum(
        2 * (nd.split * nd.hidden + nd.hidden * nd.hidden + nd.hidden * (nd.dim - nd.split))
        for lv in hac.levels for nd in lv.nodes
    )
    n_bias = sum(
        2 * (2 * nd.hidden + nd.dim - nd.split) for lv in hac.levels for nd in lv.nodes
    )
    wbytes = 2 if compute_dtype == "bfloat16" else 4
    nbytes = 4 * (2 * batch * hac.dim + batch) + wbytes * (hac.n_params - n_bias) + 4 * n_bias
    bound = max(flops / PEAK_FLOPS[compute_dtype], nbytes / PEAK_BYTES) * 1e3
    return flops, nbytes, bound


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


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.ops import hac_fused
    from hint_tpu_torch.ops.base import exact_f32_matmul
    from hint_tpu_torch.serve import InferenceService, make_server
    from hint_tpu_torch.train.checkpoint import save_params_npz

    exact_f32_matmul()
    card = card_line()
    print(f"card: {card}", flush=True)

    # -- 1. build ---------------------------------------------------------------
    print("phase 1: build", flush=True)
    lib, build_s, log = hac_fused.build()
    print(f"  built {os.path.relpath(lib)} in {build_s:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 2. kernel vs plain version ------------------------------------------------
    print("phase 2: hac_block kernel vs plain version (flagship block)", flush=True)
    blocks = {dt: flagship_block(torch, dt) for dt in TOL}
    errs = {dt: [0.0, 0.0] for dt in TOL}  # max abs, max |d|/(1+|ref|)
    g = torch.Generator(device="cuda").manual_seed(2)
    for dt, hac in blocks.items():
        for batch in (37, 64, BUCKET):
            x = torch.randn((batch, 100), generator=g, device="cuda")
            for rev in (False, True):
                with torch.no_grad():
                    yk, ldk = hac_fused.fused_block(hac, x, None, rev)
                    yp, ldp = hac_fused.plain_block(hac, x, None, rev)
                torch.cuda.synchronize()
                d_abs = max(float((yk - yp).abs().max()), float((ldk - ldp).abs().max()))
                d_rel = max(
                    float(((yk - yp).abs() / (1 + yp.abs())).max()),
                    float(((ldk - ldp).abs() / (1 + ldp.abs())).max()),
                )
                errs[dt] = [max(errs[dt][0], d_abs), max(errs[dt][1], d_rel)]
                tol = TOL[dt]
                finite = bool(torch.isfinite(yk).all() and torch.isfinite(ldk).all())
                check(
                    finite and d_rel <= tol,
                    f"{dt} {'inverse' if rev else 'forward'} B={batch}: max_abs={d_abs:.3e} "
                    f"max_rel={d_rel:.3e} (tol {tol:g}: |d| <= tol*(1+|ref|))",
                )

    # -- 3. serving the flagship through the kernel ------------------------------------
    print(f"phase 3: serve {FLAGSHIP} impl=fused over HTTP", flush=True)
    cfg = get_config(FLAGSHIP)
    model = cfg.build_model(impl="fused")
    model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)  # at full init scale the random 4-block inverse overflows f32
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        ckpt = os.path.join(tmp, "flagship.npz")
        save_params_npz(ckpt, model)
        del model
        svc = InferenceService.from_checkpoint(FLAGSHIP, ckpt, impl="fused")
        plain = InferenceService.from_checkpoint(FLAGSHIP, ckpt, impl="levelwise")
    t0 = time.perf_counter()
    svc.warmup()
    print(f"  warmup (every bucket, sample + log_prob): {time.perf_counter() - t0:.2f} s")
    n_hac = sum(type(b).__name__ == "HierarchicalAffineCoupling" for b in svc.model.bijectors)
    httpd = make_server(svc, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        port = httpd.server_port
        hac_fused.launches = 0
        health = http(port, "/health")
        x = np.asarray(http(port, "/sample", {"n": BUCKET, "seed": 0})["x"], np.float32)
        x_paged = np.asarray(http(port, "/sample", {"n": 5000, "seed": 1})["x"], np.float32)
        lp = np.asarray(http(port, "/log_prob", {"x": x.tolist()})["log_prob"], np.float32)
        launches = hac_fused.launches
        passes = 1 + 2 + 1  # sample 4096, sample 5000 (two 4096 pages), log_prob 4096
        check(health == {"status": "ok", "config": FLAGSHIP}, f"/health {health}")
        check(
            launches == n_hac * passes,
            f"kernel launches over the requests: {launches} (= {n_hac} blocks x {passes} passes)",
        )
        check(x.shape == (BUCKET, 100) and np.isfinite(x).all(), f"/sample n={BUCKET}: {x.shape}, finite")
        check(x_paged.shape == (5000, 100) and np.isfinite(x_paged).all(), f"/sample n=5000: {x_paged.shape}, finite")
        check(lp.shape == (BUCKET,) and np.isfinite(lp).all(), f"/log_prob: {lp.shape}, finite")
        z = torch.randn((BUCKET, 100), generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
        with torch.no_grad():
            z_back, _ = svc.model(torch.from_numpy(x).cuda())
        rt = float(((z_back - z).abs() / (1 + z.abs())).max())
        check(rt <= ROUND_TRIP_TOL, f"forward(inverse(z)) = z: max |d|/(1+|z|) = {rt:.3e} (tol {ROUND_TRIP_TOL:g})")
        lp_plain = plain.log_prob(x)
        lp_err = float(np.abs(lp - lp_plain).max())
        lp_ok = bool(np.all(np.abs(lp - lp_plain) <= LOG_PROB_TOL[0] + LOG_PROB_TOL[1] * np.abs(lp_plain)))
        check(lp_ok, f"fused log_prob vs plain: max_abs={lp_err:.3e} (tol {LOG_PROB_TOL[0]:g} + {LOG_PROB_TOL[1]:g}|lp|), "
              f"mean log_prob {float(lp.mean()):.3f}")

        # -- 4. timings ----------------------------------------------------------------
        print(f"phase 4: timings at batch {BUCKET}, CUDA events ({card})", flush=True)
        variants = {}
        xb = torch.randn((BUCKET, 100), generator=g, device="cuda")
        with torch.no_grad():
            for dt, hac in blocks.items():
                for rev in (False, True):
                    name = f"{dt}_{'inverse' if rev else 'forward'}"
                    k_ms = time_ms(torch, lambda: hac_fused.fused_block(hac, xb, None, rev), reps=50)
                    p_ms = time_ms(torch, lambda: hac_fused.plain_block(hac, xb, None, rev), reps=10)
                    flops, nbytes, bound = block_work(hac, BUCKET, dt)
                    variants[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                                      "tflops": flops / k_ms / 1e9}
                    print(f"  hac_block {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                          f"bound {bound:.4f} ms ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
                          f"{flops / k_ms / 1e9:.2f} TFLOP/s", flush=True)
        reqs = 20
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

    # -- 5. result lines -----------------------------------------------------------------
    main_v = variants["float32_forward"]
    print(json.dumps({"kernels": [{
        "name": "hac_block",
        "route": "cuda",
        "source": "hint_tpu_torch/ops/csrc/hac_block.cu",
        "replaces": "hint_tpu/ops/pallas_block.py:250",
        "launches": launches,
        "max_abs_err": errs["float32"][0],
        "max_err": errs["float32"][1],
        "ms": main_v["ms"],
        "plain_ms": main_v["plain_ms"],
        "bound_ms": main_v["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
        "batch": BUCKET,
        "max_abs_err_bf16": errs["bfloat16"][0],
        "max_err_bf16": errs["bfloat16"][1],
        "variants": variants,
        "sample_http_rps": http_rps,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
