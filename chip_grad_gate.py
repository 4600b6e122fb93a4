#!/usr/bin/env python3
"""How often the HAC block's kernels pass the gates of ``chip_smoke.py``
over random draws.

    python3 chip_grad_gate.py [--draws 8] [--dtype {float32,bfloat16}]

float32 (the default): phase 5's float64 gradient gate, per leaf |d| / (1 +
max |ref|) of the kernels' gradients against the plain version run in
float64 at most twice the f32 plain version's own (rows whose ReLU masks
differ from float64's set aside, as phase 5 does). For each block of
``chip_smoke.BLOCKS`` in ``KINDS`` (model.init weights with noise in the
padding), batches 37 and 300 (and two draws at 4,096 for the blocks that
are not UCI's), ``--draws`` draws of rows and cotangents each, forward and
inverse, a saving forward fills the saved buffer (``hac_fused._run_block(...,
saved=)``) and the backward kernels read it, once by each f32 route that
saves (``F32_SAVE_ROUTES``: the tiled route, which training takes, and the
loop, whose chains it keeps); it prints per route the draws over the gate,
the median and the largest ratio, and whether the routes fail the same
draws (the tiled route's saves are the loop's bit for bit, so they must).

bfloat16: for each route of the forward kernel in bf16 (``ROUTES``: the
wgmma route and the CUDA-core loop), the draws
that fail phase 2's bf16 bound (``chip_smoke.TOL``: y and the log-det
within 2e-2 of 1 + |ref| of the bf16 plain version, at phase 2's batches of
each of its blocks, two draws at 10,000) and phase 5's bf16 gradient bound
(``GRAD_TOL_BF16``: per leaf within 2e-2 of 1 + max |ref| of the bf16
plain version, over the rows whose saved ReLU masks agree with the plain
version's, and at most 1 % of the rows set aside; the blocks of ``KINDS``
at phase 5's batches, two draws at 4,096 and 10,000), with the route making
the saving forward that the backward kernels read; per pass (forward,
inverse), with the largest error of each. The same draws for every route.
Needs one CUDA card; imports nothing of JAX or ``hint_tpu``.
"""

import argparse
import copy
import statistics
import sys

import chip_smoke as cs  # blocks, plain activations, masks, bounds

KINDS = ("uci_miniboone", "uci_power", "uci_gas", "flagship", "conditional", "campaign_x_lane", "grid_4_1")


def leaf_err(got, ref):
    return max(float((a.double() - b.double()).abs().max() / (1 + b.double().abs().max()))
               for a, b in zip(got, ref) if a is not None and b is not None)


def draw(torch, dev, seed, batch, dim, cd):
    g = torch.Generator(device=dev).manual_seed(seed)
    x, r, q = (torch.randn(s, generator=g, device=dev) for s in ((batch, dim), (batch, dim), (batch,)))
    return x, r, q, torch.randn((batch, cd), generator=g, device=dev) if cd else None


def f32_save_routes(hac_fused):
    """The f32 routes that save, by name: training's (``_SAVE_ROUTE``) first."""
    return {hac_fused.ROUTE_TILED: "tiled", hac_fused.ROUTE_LOOP: "cuda_core_loop"}


def f32_gate(torch, hac_fused, dev, draws):
    names = f32_save_routes(hac_fused)
    assert next(iter(names)) == hac_fused._SAVE_ROUTE["float32"]
    over = {r: [] for r in names}  # the draws over the gate, by route
    n_draws = 0
    for kind in KINDS:
        hac = cs.make_block(torch, kind, "float32", requires_grad=True)
        h64 = copy.deepcopy(hac).double()
        dim, _, cd = cs.BLOCKS[kind]
        L = len(hac.levels)
        needs = (True, cd > 0, *(True,) * len(list(hac.parameters())))
        ratios = {r: [] for r in names}
        for batch in (37, 300) + (() if kind.startswith("uci") else (4096,)):
            for seed in range(draws if batch < 4096 else 2):
                x, r, q, c = draw(torch, dev, 200 + seed, batch, dim, cd)
                c64 = None if c is None else c.double()
                for rev in (False, True):
                    n_draws += 1
                    ref_m = cs.relu_masks(cs.plain_activations(torch, hac_fused, h64, x.double(), c64, rev), L)
                    flips = cs.flipped_per_row(cs.relu_masks(cs.plain_activations(torch, hac_fused, hac, x, c, rev), L),
                                               ref_m) > 0
                    last = None  # (keep, ref, plain ratio) of the route before, reused where the masks agree
                    for route in names:
                        saved = hac_fused.saved_buffer(hac, x)
                        with torch.no_grad():
                            hac_fused._run_block(hac, x, c, rev, route, saved)
                        km = cs.relu_masks(cs.saved_activations(hac_fused, hac, saved, batch), L)
                        keep = (~(flips | (cs.flipped_per_row(km, ref_m) > 0))).float()
                        rk, qk = r * keep[:, None], q * keep
                        if last is None or not torch.equal(last[0], keep):
                            ref = hac_fused.plain_block_grad(h64, x.double(), c64, rev, rk.double(), qk.double(),
                                                             needs)
                            last = (keep, ref, leaf_err(hac_fused.plain_block_grad(hac, x, c, rev, rk, qk, needs),
                                                        ref))
                        k = leaf_err(hac_fused._run_block_grad(hac, saved, c, rev, rk, qk, needs), last[1])
                        ratios[route].append(k / last[2])
                        if k / last[2] > 2:
                            over[route].append((kind, batch, seed, rev))
                        del saved
        for route, name in names.items():
            v = ratios[route]
            print(f"{kind} {name}: {sum(t > 2 for t in v)} of {len(v)} draws over the gate; ratio median "
                  f"{statistics.median(v):.2f}, max {max(v):.2f}", flush=True)
    for route, name in names.items():
        print(f"total {name}: {len(over[route])} of {n_draws} draws over the gate: {over[route]}", flush=True)
    same = len({tuple(v) for v in over.values()}) == 1
    print(f"the routes fail the same draws: {same}", flush=True)


def route_names(hac_fused):
    """The bf16 routes by name."""
    return {hac_fused.ROUTE_WG: "wgmma", hac_fused.ROUTE_LOOP: "cuda_core_loop"}


GATES = ("phase 2", "phase 5")
PASSES = ("forward", "inverse")


def bf16_gate(torch, hac_fused, dev, draws):
    names = route_names(hac_fused)

    def counts():  # {route: {(gate, pass): [fails, draws, worst]}}
        return {r: {(gt, p): [0, 0, 0.0] for gt in GATES for p in PASSES} for r in names}

    def line(m, r):
        return "; ".join(f"{gt} {p} {v[0]} of {v[1]} (max {v[2]:.3e})"
                         for (gt, p), v in m[r].items() if v[1])

    total = counts()
    for kind in cs.BLOCKS:  # phase 2 holds every block; phase 5 those of KINDS
        hac = cs.make_block(torch, kind, "bfloat16", requires_grad=True)
        dim, _, cd = cs.BLOCKS[kind]
        L = len(hac.levels)
        needs = (True, cd > 0, *(True,) * len(list(hac.parameters())))
        mine = counts()

        def count(route, gate, rev, err, ok):
            for acc in (mine[route][(gate, PASSES[rev])], total[route][(gate, PASSES[rev])]):
                acc[0] += not ok
                acc[1] += 1
                acc[2] = max(acc[2], err)

        # phase 2: outputs against the bf16 plain version
        for batch in cs.block_batches(kind)[0]:
            for seed in range(draws if batch < 10_000 else 2):
                x, _, _, c = draw(torch, dev, 300 + seed, batch, dim, cd)
                for rev in (False, True):
                    with torch.no_grad():
                        yp, ldp = hac_fused.plain_block(hac, x, c, rev)
                        for route in names:
                            yk, ldk = hac_fused._run_block(hac, x, c, rev, route)
                            e = max(cs.rel_err(yk, yp), cs.rel_err(ldk, ldp))
                            finite = bool(torch.isfinite(yk).all() and torch.isfinite(ldk).all())
                            count(route, GATES[0], rev, e, finite and e <= cs.TOL["bfloat16"])
        # phase 5: gradients over the saving forward of each route
        for batch in cs.block_batches(kind)[2] if kind in KINDS else ():
            for seed in range(draws if batch < 4096 else 2):
                x, r, q, c = draw(torch, dev, 400 + seed, batch, dim, cd)
                for rev in (False, True):
                    plain_m = cs.relu_masks(cs.plain_activations(torch, hac_fused, hac, x, c, rev), L)
                    for route in names:
                        saved = hac_fused.saved_buffer(hac, x)
                        with torch.no_grad():
                            hac_fused._run_block(hac, x, c, rev, route, saved)
                        km = cs.relu_masks(cs.saved_activations(hac_fused, hac, saved, batch), L)
                        flipped = cs.flipped_per_row(km, plain_m) > 0
                        keep = (~flipped).float()
                        rk, qk = r * keep[:, None], q * keep
                        ref = hac_fused.plain_block_grad(hac, x, c, rev, rk, qk, needs)
                        got = hac_fused._run_block_grad(hac, saved, c, rev, rk, qk, needs)
                        e = leaf_err(got, ref)
                        finite = all(bool(torch.isfinite(t).all()) for t in got if t is not None)
                        ok = finite and e <= cs.GRAD_TOL_BF16 and int(flipped.sum()) <= max(1, batch // 100)
                        count(route, GATES[1], rev, e, ok)
                        del saved
        for r in names:
            print(f"{kind} {names[r]}: {line(mine, r)}", flush=True)
    for r in names:
        print(f"total {names[r]}, failed draws: {line(total, r)}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_grad_gate: no CUDA card visible", file=sys.stderr)
        return 2
    from hint_tpu_torch.ops import hac_fused
    from hint_tpu_torch.ops.base import exact_f32_matmul

    exact_f32_matmul()
    (f32_gate if args.dtype == "float32" else bf16_gate)(torch, hac_fused, torch.device("cuda"), args.draws)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
