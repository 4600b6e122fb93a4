#!/usr/bin/env python3
"""How often the HAC block's backward passes the float64 gradient gate of
``chip_smoke.py`` phase 5 over random draws.

    python3 chip_grad_gate.py [--draws 8]

The gate: per leaf |d| / (1 + max |ref|) of the kernels' gradients against
the plain version run in float64 at most twice the f32 plain version's own
(rows whose ReLU masks differ from float64's set aside, as phase 5 does).
For each block of ``chip_smoke.BLOCKS`` in ``KINDS`` (f32, model.init
weights with noise in the padding), batches 37 and 300 (and two draws at
4,096 for the blocks that are not UCI's), ``--draws`` draws of rows and
cotangents each, forward and inverse, a saving forward fills the saved
buffer (``hac_fused._run_block(..., saved=)``) and the backward kernels
read it; it prints the draws over the gate, the median and the largest
ratio. Needs one CUDA card; imports nothing of JAX or ``hint_tpu``.
"""

import argparse
import copy
import statistics
import sys

import chip_smoke as cs  # blocks, plain activations, masks

KINDS = ("uci_miniboone", "uci_power", "uci_gas", "flagship", "conditional", "campaign_x_lane", "grid_4_1")


def leaf_err(got, ref):
    return max(float((a.double() - b.double()).abs().max() / (1 + b.double().abs().max()))
               for a, b in zip(got, ref) if a is not None and b is not None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_grad_gate: no CUDA card visible", file=sys.stderr)
        return 2
    from hint_tpu_torch.ops import hac_fused
    from hint_tpu_torch.ops.base import exact_f32_matmul

    exact_f32_matmul()
    dev = torch.device("cuda")
    for kind in KINDS:
        hac = cs.make_block(torch, kind, "float32", requires_grad=True)
        h64 = copy.deepcopy(hac).double()
        dim, _, cd = cs.BLOCKS[kind]
        L = len(hac.levels)
        needs = (True, cd > 0, *(True,) * len(list(hac.parameters())))
        ratios = []
        for batch in (37, 300) + (() if kind.startswith("uci") else (4096,)):
            for seed in range(args.draws if batch < 4096 else 2):
                g = torch.Generator(device=dev).manual_seed(200 + seed)
                x, r, q = (torch.randn(s, generator=g, device=dev) for s in ((batch, dim), (batch, dim), (batch,)))
                c = torch.randn((batch, cd), generator=g, device=dev) if cd else None
                c64 = None if c is None else c.double()
                for rev in (False, True):
                    ref_m = cs.relu_masks(cs.plain_activations(torch, hac_fused, h64, x.double(), c64, rev), L)
                    flips = cs.flipped_per_row(cs.relu_masks(cs.plain_activations(torch, hac_fused, hac, x, c, rev), L),
                                               ref_m) > 0
                    saved = hac_fused.saved_buffer(hac, x)
                    with torch.no_grad():
                        hac_fused._run_block(hac, x, c, rev, saved=saved)
                    km = cs.relu_masks(cs.saved_activations(hac_fused, hac, saved, batch), L)
                    keep = (~(flips | (cs.flipped_per_row(km, ref_m) > 0))).float()
                    rk, qk = r * keep[:, None], q * keep
                    ref = hac_fused.plain_block_grad(h64, x.double(), c64, rev, rk.double(), qk.double(), needs)
                    p = leaf_err(hac_fused.plain_block_grad(hac, x, c, rev, rk, qk, needs), ref)
                    k = leaf_err(hac_fused._run_block_grad(hac, saved, c, rev, rk, qk, needs), ref)
                    ratios.append(k / p)
        print(f"{kind}: {sum(v > 2 for v in ratios)} of {len(ratios)} draws over the gate; ratio median "
              f"{statistics.median(ratios):.2f}, max {max(ratios):.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
