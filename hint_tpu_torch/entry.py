"""Entry points of the port (counterpart of ``__graft_entry__.py``).

* ``entry()`` — the flagship's NLL forward (``plus_shape.unconditional_hint_4_full``)
  as a function of its parameters and rows, with parameters from seed 0
  and 1,024 rows, on one card;
* ``dryrun_multichip(n)`` — ``parallel.dryrun`` (a data-parallel training
  step, evaluation, sampling, quantile-ABC, MMD and shape scores) in a
  world of ``n`` spawned ranks, one card a rank.

    python -m hint_tpu_torch.entry [--device cpu]

prints the entry loss, then runs ``dryrun_multichip`` over every card (one
rank on the CPU with ``--device cpu``). Both run on CUDA unless the caller
names the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from hint_tpu_torch.configs import get_config
from hint_tpu_torch.parallel.dryrun import dryrun, spawn
from hint_tpu_torch.train.trainer import nll_terms

FLAGSHIP = "plus_shape.unconditional_hint_4_full"
ENTRY_ROWS = 1024


def entry(device=None, impl: str = "levelwise"):
    """Returns ``(fn, (params, x))``: ``fn(params, x)`` is the flagship's
    NLL (``t1 + t2`` of ``nll_terms``) of the rows ``x`` under the
    parameters ``params``, a dict of the model's ``state_dict`` keys (the
    JAX parameter tree's key paths joined by dots). ``fn`` evaluates the
    model through ``torch.func.functional_call``, so it reads nothing but
    its arguments, as the JAX function does. ``params`` are
    ``init_state(0)``'s, ``x`` 1,024 rows from a CPU generator seeded 1
    (the same on every device). ``impl`` is the HAC engine of
    ``make_trainer``; ``"fused"`` runs the block kernel on a card."""
    cfg = get_config(FLAGSHIP)
    trainer = cfg.make_trainer(impl=impl, device=device)
    trainer.init_state(0)
    model = trainer.model
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    x = torch.randn((ENTRY_ROWS, cfg.ndim_x), generator=torch.Generator().manual_seed(1)).to(trainer.device)

    def fn(params, x):
        z, logdet = torch.func.functional_call(model, params, (x,))
        t1, t2 = nll_terms(z, logdet)
        return t1 + t2

    return fn, (params, x)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """``parallel.dryrun`` in a world of ``n_devices`` spawned ranks: NCCL
    with one card a rank, or gloo with every rank on ``device`` where one
    is named (``"cpu"``). Rank 0 prints what each path gave."""
    spawn(dryrun, n_devices, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The flagship's entry loss, then parallel.dryrun over every card")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    fn, (params, x) = entry(args.device)
    with torch.no_grad():
        print("entry loss:", float(fn(params, x)), flush=True)
    on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
    dryrun_multichip(1 if on_cpu else torch.cuda.device_count(), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
