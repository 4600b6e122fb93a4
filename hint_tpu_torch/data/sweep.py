"""The dispatch loop shared by the device prior sweeps (``lens_tpu``,
``plus_tpu``): seeding, grouping into host transfers, and the overlap of
one dispatch's host fix-ups with the next dispatch's device work.

* Sub-batch ``q`` of a sweep draws from its own ``torch.Generator``, seeded
  from ``(seed, q)`` alone, so a pool of n rows is the first n rows of a
  larger pool with the same ``seed`` and ``sub_batch``, whatever ``n`` and
  ``group``.
* A dispatch runs ``group`` sub-batches into one packed device tensor and
  starts one ``non_blocking`` copy of it into pinned host memory, followed
  by a CUDA event. Dispatch i+1 is enqueued before the host waits on
  dispatch i's event and finishes its rows, so the host's work on i runs
  while the card computes i+1.
* On the CPU (``device="cpu"``, as the tests run it) the packed tensor is
  the host copy and there is nothing to overlap.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from hint_tpu_torch.ops.base import resolve_device


def sub_batch_generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    """The generator of sub-batch ``index`` of a sweep seeded with ``seed``:
    a function of the pair alone (numpy's ``SeedSequence`` mixes it)."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state))
    return g


def run_sweep(
    n: int,
    seed: int,
    sub_batch: int,
    group: int,
    device,
    body: Callable[[torch.Generator, int, torch.device], Tuple[torch.Tensor, Sequence[torch.Tensor]]],
    finish: Callable[[np.ndarray, Callable[[], List[np.ndarray]]], Tuple[np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw ``n`` rows: ``body(generator, sub_batch, device)`` computes one
    sub-batch on the device and returns its packed rows and the draws a host
    regeneration would need; ``finish(packed, extras)`` turns the host copy
    of one dispatch into ``(x, y)``, calling ``extras()`` (a device-to-host
    copy of the draws) only when a row needs them."""
    if n < 1 or sub_batch < 1 or group < 1:
        raise ValueError(f"need n, sub_batch and group >= 1, got {n}, {sub_batch}, {group}")
    dev = resolve_device(device)
    n_sub = -(-n // sub_batch)
    n_disp = -(-n_sub // group)

    def dispatch(i):
        q0, q1 = i * group, min((i + 1) * group, n_sub)
        packs, draws = [], []
        for q in range(q0, q1):
            packed, extra = body(sub_batch_generator(seed, q, dev), sub_batch, dev)
            packs.append(packed)
            draws.append(extra)
        packed = packs[0] if len(packs) == 1 else torch.cat(packs)
        event = None
        if dev.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = packed
        return host, draws, event

    def fetch(draws):
        return lambda: [torch.cat(parts).cpu().numpy() for parts in zip(*draws)]

    xs, ys = [], []
    pending = dispatch(0)
    for i in range(n_disp):
        nxt = dispatch(i + 1) if i + 1 < n_disp else None
        host, draws, event = pending
        if event is not None:
            event.synchronize()
        x, y = finish(host.numpy(), fetch(draws))
        take = min(len(x), n - i * group * sub_batch)
        xs.append(x[:take])
        ys.append(y[:take])
        pending = nxt
    return np.concatenate(xs), np.concatenate(ys)
