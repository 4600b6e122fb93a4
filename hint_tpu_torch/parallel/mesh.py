"""Data parallelism over ``torch.distributed``, one process per rank (port
of ``hint_tpu/parallel/mesh.py``).

The reference is single-GPU; the one meaningful distribution axis here is
the batch. Models are at most a few million parameters, so every rank holds
all of them; each rank computes on its contiguous block of the batch, and
gradients and results are combined with collectives. Where ``hint_tpu``
describes a 1-D device mesh and lets XLA insert the collectives, the port's
``Mesh`` is a process group, this process's rank in it and its device:

    init_world(rank, world_size, backend, store)  # or torchrun's env://
    mesh = make_mesh(device="cpu")                # CUDA:LOCAL_RANK unless named
    xs = shard_batch(pad_rows(x, mesh.size)[0], mesh)
    out = all_gather_rows(f(xs), mesh)

NCCL serves CUDA tensors with one card a rank; gloo serves CPU tensors and,
when asked for by name, CUDA tensors too (the one-card world of
``chip_smoke.py``). Both collectives are built on ``all_reduce`` alone, the
one reduction both backends offer for CUDA tensors, so the same code runs on
either. A backend is never switched silently: asking for NCCL with more
ranks than cards, or without a card, raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hint_tpu_torch.ops.base import resolve_device

BACKENDS = ("gloo", "nccl")
# how long a collective waits for the other ranks before it raises
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: the process group, this process's rank and
    the number of ranks in it, the axis names and this rank's device."""

    group: object
    rank: int
    size: int
    axis_names: tuple
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        """Ranks along each axis, as ``jax.sharding.Mesh.shape``."""
        return {name: (self.size if i == 0 else 1) for i, name in enumerate(self.axis_names)}


def check_backend(backend: str, n_local: int) -> None:
    """Raise where ``backend`` cannot serve ``n_local`` ranks on this host:
    NCCL needs a card for each of them."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs a CUDA card; pass backend='gloo' to run on the CPU")
        if n_local > torch.cuda.device_count():
            raise RuntimeError(
                f"backend='nccl' needs one card a rank: {n_local} ranks on this host, "
                f"{torch.cuda.device_count()} cards; pass backend='gloo' to share a card"
            )


def init_world(
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    backend: str = "gloo",
    store=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Start this process's default process group. Without a ``store`` the
    rendezvous reads torchrun's environment (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)."""
    kwargs = {"store": store, "rank": rank, "world_size": world_size} if store is not None else {
        "init_method": "env://"}
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    backend: Optional[str] = None,
    device=None,
) -> Optional[Mesh]:
    """The 1-D data-parallel mesh over the first ``n_devices`` ranks of the
    world that torchrun or ``init_world`` started (default: all of them).
    Its device is ``cuda:LOCAL_RANK`` unless ``device`` names another.
    ``backend``, where given, must be the world's. A leading subgroup is a
    collective of the whole world: every rank calls ``make_mesh``, and the
    ranks outside the subgroup get None."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: run under torchrun or parallel.spawn, or call init_world first")
    world_backend = dist.get_backend()
    if backend is not None and backend != world_backend:
        raise ValueError(f"the world runs backend={world_backend!r}, not {backend!r}")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} must lie in [1, {world}], the world's size")
    check_backend(world_backend, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    dev = resolve_device(device if device is not None else f"cuda:{os.environ.get('LOCAL_RANK', rank)}")
    if world_backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend='nccl' serves CUDA tensors, not {dev}")
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} does not exist: {torch.cuda.device_count()} cards")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(group=group, rank=rank, size=n, axis_names=tuple(axis_names), device=dev, backend=world_backend)


def mesh_size(mesh: Mesh, axis: str = "data") -> int:
    return mesh.shape[axis]


def pad_rows(arr, multiple: int, value: float = 0.0):
    """Pad axis 0 of a tensor or array up to a multiple of ``multiple``
    with ``value``. Returns (padded, original_n)."""
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr.new_full((pad, *arr.shape[1:]), value)]), n
    return np.concatenate([arr, np.full((pad, *arr.shape[1:]), value, arr.dtype)]), n


def shard_batch(arr, mesh: Mesh, axis: str = "data"):
    """This rank's contiguous block of the rows, rank r taking the r-th of
    ``mesh_size`` equal blocks (the row count must divide, as for the
    batch sharding in ``hint_tpu``; ``pad_rows`` first where it need not)."""
    size = mesh_size(mesh, axis)
    n = arr.shape[0]
    if n % size:
        raise ValueError(f"{n} rows do not divide over {size} ranks; pad_rows first")
    block = n // size
    return arr[mesh.rank * block : (mesh.rank + 1) * block]


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the mesh's ranks in place; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns it."""
    dist.broadcast(t, src=src, group=mesh.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``t``, concatenated in rank order, bit for bit;
    the ranks' row counts may differ. Each rank writes its rows into a zero
    buffer of all the rows, and one sum over the ranks of the buffer's
    bytes fills it: every byte is written by one rank and zero on the
    others, so the integer sum carries nothing and returns each rank's
    bytes as they were (-0.0, ±Inf and NaN payloads included, which a sum
    of the values would not keep: -0.0 + 0.0 is +0.0). Bytes, because
    NCCL sums no 16-bit integers and every row width is whole bytes."""
    counts = torch.zeros(mesh.size, dtype=torch.int64, device=t.device)
    counts[mesh.rank] = t.shape[0]
    counts = all_reduce_sum(counts, mesh).tolist()
    start = sum(counts[: mesh.rank])
    out = t.new_zeros((sum(counts), *t.shape[1:]))
    out[start : start + t.shape[0]] = t
    all_reduce_sum(out.view(torch.uint8), mesh)
    return out


def map_rows(fn, mesh: Optional[Mesh], *rows: torch.Tensor):
    """``fn(*rows)`` for a function that computes row by row, returning a
    tensor or a tuple of tensors with a row for each input row. Under a
    mesh, ``fn`` of this rank's block of the rows (padded with zeros to a
    multiple of the ranks), every rank's outputs gathered and trimmed: all
    the rows' results on every rank."""
    if mesh is None:
        return fn(*rows)
    n = rows[0].shape[0]
    out = fn(*(shard_batch(pad_rows(r, mesh.size)[0], mesh) for r in rows))
    if isinstance(out, torch.Tensor):
        return all_gather_rows(out, mesh)[:n]
    return tuple(all_gather_rows(t, mesh)[:n] for t in out)
