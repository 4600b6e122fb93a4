"""Data parallelism over ``torch.distributed`` (port of ``hint_tpu/parallel``):
the mesh, the row helpers and the two collectives; ``dryrun`` runs every
sharded path once and starts worlds of processes."""

from hint_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    init_world,
    make_mesh,
    map_rows,
    mesh_size,
    pad_rows,
    shard_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "init_world",
    "mesh_size",
    "pad_rows",
    "shard_batch",
    "all_reduce_sum",
    "all_gather_rows",
    "map_rows",
]
