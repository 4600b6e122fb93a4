"""Whole-HAC-block CUDA kernel: wrapper, build/loader, launch count and the
plain version (the counterpart of ``hint_tpu/ops/pallas_block.py``).

Kernel: ``csrc/hac_block.cu``. It replaces the Pallas kernel built by
``hint_tpu/ops/pallas_block.py:_fused_call`` (body ``_kernel_factory.kernel``,
atan ``_atan``): one launch runs an entire HAC block, every level's s/t
subnets, couplings and the log-det, over the whole batch, forward
(levels bottom-up) or inverse (top-down), in f32 or with bf16 weights,
with or without a condition fed to every subnet (``cond_dim > 0``, the
``c_ref`` variant of the Pallas kernel).

What bounds it on the card: a flagship block (d=100,
c_internal=(263,131,65,32,32)) is ~0.97 MFLOP per row against ~800 bytes of
row input and output, so at a serving batch the work is far above the card's
balance point; the ~2 MB of f32 weights are read by every thread block from
the 50 MB L2.

What the design does about it (the kernel's header says more): one thread
block owns a tile of rows and keeps the tile, its S buffer and
hidden-activation buffers in shared memory for the whole block, so no
activation touches device memory. Per level it runs the level's s/t units in
chunks that fill the hidden buffers. Four routes share the entry point,
chosen per compute dtype by ``_FWD_ROUTE`` to serve and by ``_SAVE_ROUTE``
to save (``ROUTES``; the kernel's ``ROUTE_F32``/``ROUTE_BF16`` and
``SAVE_ROUTE_F32``/``SAVE_ROUTE_BF16``): in f32 the 3xTF32 tensor-core
route (``ROUTE_TC``: 32-row tiles, ``mma.sync``) serves and the tiled route
(``ROUTE_TILED``: the first port's loop's f32 FMA chains, bit for bit, in
4 x 4 register tiles, 16- or 8-row tiles by ``_tl_launch``, its weights
streamed through shared memory by the copy engine in the chunks of
``_tl_plan``) saves; in bf16 the wgmma route (``ROUTE_WG``: 64-row tiles,
three consumer warpgroups on ``wgmma``, the weights streamed through shared
memory by the copy engine) saves and the loop (16-row tiles, f32 FMAs on
the CUDA cores) serves, as the bf16 gates decided (PERF.md). Each route
but the loop reads a layout of the weights of its own (``_tc_layout``:
3xTF32 fragments; ``_wg_layout``: each warpgroup's stream of weight slices;
``_tl_plan``: each unit's matrices with their rows padded to 4 floats),
gathered from the flat weights in one launch on the route's first launch
for a parameter version (``_tc_packed``, ``_tl_packed``), so an f32
training step builds the tiled route's and never the 3xTF32 one.
``_run_block(..., route=)`` launches a route by name
(``hac_block_launch_route``); ``build(profile=True)`` builds the
tensor-core routes' and the tiled route's cycle profiles in
(``profile_read``; ``TL_PROFILE_PHASES``). Only the real
``split`` input rows of ``w0`` and the real ``out_i`` columns of ``w2``/``b2``
reach a result: padding holds arbitrary values once a trainer has
overwritten every leaf, and the padded copies hold zeros there. A
condition-fed block keeps the tile's condition rows in shared memory and adds
``cond_dim`` terms to layer 1, from the rows of ``w0`` that start at the
level's ``in_max``. The TPU kernel's dense level maps (up to 2048-wide
scatter matrices, forced by Mosaic's 2-D-only dots) are not carried over.

On a CPU tensor ``fused_block`` runs the plain version (the levelwise
engine); on a CUDA tensor it launches the kernel or raises. Under autograd
the kernel is the forward of ``_FusedBlock`` as a saving forward: it also
writes every level's input and S, every unit's a1 and a2 and the block's
output into a saved buffer (``saved_buffer``; by ``_SAVE_ROUTE``, from the
registers the activations are made in), which it keeps for the
backward; serving, sampling and evaluation under ``no_grad`` allocate
none. The backward is a second hand-written kernel,
``csrc/hac_block_bwd.cu``: the reverse chain over the saved buffer and the
split-row weight sums, both on the tensor cores (3xTF32 or bf16; see its
header), with ``plain_block_grad`` (autograd through the levelwise engine,
as the JAX package's ``custom_vjp`` at ``pallas_block.py:357-382``
differentiates its levelwise engine) as its plain version. The block does
not recompute its forward in the backward: ``Flow(remat=True)`` checkpoints
it like every other bijector, and the recompute is a saving forward.

A block with per-node reshuffle is no kernel's: ``fused_block`` runs it
through the levelwise engine on every device, under autograd where a
gradient is asked for, as ``hint_tpu``'s ``fused_block`` does
(``pallas_block.py:361-362``); the counter ``hac.reshuffle_levelwise``
counts it.

Launches, packs and builds are counted in ``utils.instrument``'s registry
(``hac.launches``, ``hac.launches.wgmma`` by the bf16 wgmma route,
``hac.launches.tiled`` by the f32 tiled route, ``hac.launches.under_grad``
as the forward of ``_FusedBlock``,
``hac.bwd_launches``, ``hac.bwd_weight_launches`` of the weight kernel,
``hac.packs`` a parameter version, ``hac.builds`` and ``hac.build_s``); a
repack runs under the span ``hac.pack``, the library's load or build under
``hac.build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from hint_tpu_torch.ops.clamp import ATAN_SCALE
from hint_tpu_torch.utils.instrument import count, get, span

_CSRC = Path(__file__).parent / "csrc"
SOURCES = (_CSRC / "hac_block.cu", _CSRC / "hac_block_bwd.cu")
HEADERS = (_CSRC / "hac_common.cuh",)
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# layout of the int32 metadata table; must match csrc/hac_common.cuh
_HDR, _LREC, _NREC, _TLREC = 4, 12, 4, 8
# rows per thread block of the forward loop and the target width (floats) of
# one of its hidden buffers
_TILE_ROWS = 16
_CHUNK_FLOATS = 576
# the forward kernel's routes (csrc/hac_block.cu): the first port's loop in
# both dtypes, the tensor cores by mma.sync 3xTF32 in f32 (ROUTE_TC), by
# wgmma in bf16 (ROUTE_WG), and the loop's FMA chains fed from shared memory
# in f32 (ROUTE_TILED). hac_block_launch takes per compute dtype _FWD_ROUTE
# to serve and _SAVE_ROUTE to save (training). A tensor-core route takes a
# direction where it holds chip_smoke.py's gates at their seeds and fails
# them on no more random draws than the loop (chip_grad_gate.py; PERF.md):
# the f32 saving forward keeps the loop's exact f32 FMA chains, which hold
# the float64 gradient gate that 3xTF32 activations fail more often, by the
# tiled route (the loop's bits, faster); the wgmma route holds the bf16
# gates in the forward direction, which training takes, but fails phase 2's
# bound on an inverse at its seeds, so bf16 serving stays on the loop
ROUTE_LOOP, ROUTE_TC, ROUTE_WG, ROUTE_TILED = 0, 1, 2, 3
ROUTES = {"float32": (ROUTE_TC, ROUTE_TILED, ROUTE_LOOP), "bfloat16": (ROUTE_WG, ROUTE_LOOP)}
_FWD_ROUTE = {"float32": ROUTE_TC, "bfloat16": ROUTE_LOOP}
_SAVE_ROUTE = {"float32": ROUTE_TILED, "bfloat16": ROUTE_WG}
# the 3xTF32 route: rows per thread block; per compute dtype the k of one
# mma, the elements of one (k-step, n8 tile) weight fragment as stored (f32:
# each value as its TF32 high and low parts; bf16: the backward data
# kernel's fragments); the pad of a hidden-buffer row and the least width
# (floats) of a hidden buffer: two of the flagship's level-0 units, as wide
# as one block per SM has room for
_TC_ROWS = 32
_TC_KS = {"float32": 8, "bfloat16": 16}
_TC_FRAG = {"float32": 128, "bfloat16": 128}
_TC_PAD = 4
_TC_MIN_WIDTH = 544
# the wgmma route: rows per thread block, n8 tiles of one item, the k of one
# wgmma, consumer warpgroups, the most weight slices in flight for each of
# them, bytes of its mbarriers, its table's record
_WG_ROWS, _WG_TILES, _WG_KS, _WG_GROUPS, _WG_MAX_STAGES, _WG_BARS, _WLREC = 64, 4, 16, 3, 3, 256, 8
_SMEM_MAX = 232_448  # bytes of dynamic shared memory a Hopper block may use
# the tiled route: rows a consumer thread holds in layers 1-2 and in layer 3,
# weight rows a ring stage holds of the widest chunk's layer, most stages,
# most threads of a block (the consumers and a producer warp), bytes of its
# mbarriers, its table's header and level record; the SMs of an H100, which
# its tile rule fills
_TL_ROWS, _TL_ROWS3, _TL_KS, _TL_MAX_STAGES, _TL_THREADS, _TL_BARS, _TL_HDR, _TL_LREC = 4, 2, 16, 3, 576, 64, 4, 4
_SMS = 132
# the backward's workspace table (csrc/hac_common.cuh), the data kernel's
# tensor-core records and hidden-buffer row pad, and the weight-gradient tiles
# (records, rows, columns; csrc/hac_block_bwd.cu)
_WHDR, _WREC = 3, 8
_BREC, _BPAD = 9, 4
_TREC, _GRAD_ROWS, _GRAD_COLS = 5, 128, 264
# thread blocks the weight kernel aims for (8 waves of one per SM of an
# H100) and the fewest batch rows one of them sums
_GRAD_BLOCKS, _GRAD_MIN_ROWS = 1056, 512


def plain_block(hac, x: torch.Tensor, cond: Optional[torch.Tensor], rev: bool):
    """The kernel's plain PyTorch version: the levelwise engine."""
    return hac._inverse_levelwise(x, cond) if rev else hac._forward_levelwise(x, cond)


def plain_block_grad(hac, x, cond, rev: bool, g_y, g_ld, needs):
    """The backward kernel's plain version: autograd through the levelwise
    engine from the saved input. ``needs`` flags x, cond and every level
    parameter (``_level_leaves`` order); returns their gradients, None where
    not needed."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(needs[0])
        cond = cond.detach().requires_grad_(needs[1]) if cond is not None else None
        wanted = [t for t, need in zip((x, cond, *_level_leaves(hac)), needs) if need]
        y, logdet = plain_block(hac, x, cond, rev)
        grads = iter(torch.autograd.grad((y, logdet), wanted, (g_y, g_ld), allow_unused=True))
    return tuple(next(grads) if need else None for need in needs)


# -- build and load ------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc", path=f"{home}/bin") or shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the hac_block kernel cannot be built")
    return found


def build(profile: bool = False) -> Tuple[Path, float, str]:
    """Compile ``SOURCES`` for sm_90a into one library in ``_build/`` unless
    a library of the same sources, headers and flags is there already: one
    nvcc per source, all started together, then one link. Returns the
    library path, the seconds spent compiling (0 when cached) and the
    compiler's output (register and shared-memory use per kernel).
    ``profile`` builds the forward kernel's cycle profile in
    (``HAC_BLOCK_PROFILE``, read by ``profile_read``), as a library of its
    own."""
    flags = (*NVCC_FLAGS, "-DHAC_BLOCK_PROFILE") if profile else NVCC_FLAGS
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in (*SOURCES, *HEADERS)) + " ".join(flags).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"hac_block_{digest}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in SOURCES]
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = [
        subprocess.Popen([nvcc, *flags, "-c", "-o", str(o), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, o in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    try:
        failed = [(p.returncode, log) for p, log in zip(procs, logs) if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *flags, "-shared", "-o", str(tmp), *map(str, objs)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            if link.returncode != 0:
                failed.append((link.returncode, link.stdout))
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"({rc}) {log}" for rc, log in failed))
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib)
    secs = time.perf_counter() - t0
    count("hac.builds")
    count("hac.build_s", secs)
    return lib, secs, "".join(logs)


#: the forward kernel's profile phases (csrc/hac_block.cu, PROF_*), in order, of the 3xTF32 route
PROFILE_PHASES = ("load", "group_start", "products", "group_store", "layer_wait", "couple", "couple_wait",
                  "store")
#: what the tiled route counts in the same counters: its warps' waits for
#: a slab, their products, the epilogues, the layers' barriers, the
#: coupling and its barrier, the output (the first counter stays 0)
TL_PROFILE_PHASES = ("unused", "slab_wait", "products", "epilogue", "layer_barrier", "couple", "couple_barrier",
                     "store")
#: what the wgmma route counts in the same counters: an item's biases, the
#: wait for its weight slice, its products, its epilogue, the consumers'
#: barriers, a chunk's layer-1 inputs, the saved S, the output
WG_PROFILE_PHASES = ("item_setup", "slice_wait", "products", "epilogue", "barriers", "inputs", "save", "store")


#: the backward data kernel's profile phases (csrc/hac_block_bwd.cu, BPROF_*), in order
BWD_PROFILE_PHASES = ("load", "stage", "prologue", "dpre2", "dpre1", "dx", "cond", "store")


def profile_read(lib, backward: bool = False) -> dict:
    """The cycles every warp of the forward's tensor-core route (or, with
    ``backward``, of the backward data kernel) spent in each phase since the
    last read, summed over warps and blocks, from a library built with
    ``build(profile=True)``; clears them."""
    phases, read = ((BWD_PROFILE_PHASES, lib.hac_block_bwd_profile_read) if backward
                    else (PROFILE_PHASES, lib.hac_block_profile_read))
    out = (ctypes.c_ulonglong * len(phases))()
    if read(out) != len(phases):
        raise RuntimeError("profile read failed (not a profile build?)")
    return dict(zip(phases, (int(v) for v in out)))


def _load(path: Path):
    """The library at ``path`` with its entry points' argument types."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hac_block_launch.argtypes = [p, p, p, p, i, i, i, p, i, p, p, i, i, ctypes.c_float, i, p, p, i, i, p]
    lib.hac_block_launch_route.argtypes = [*lib.hac_block_launch.argtypes, i]
    lib.hac_block_bwd_data_launch.argtypes = [
        p, p, p, p, p, p, i, i, i, p, i, p, i, p, i, i, i, ctypes.c_float, i, p,
    ]
    lib.hac_block_bwd_weights_launch.argtypes = [p, p, p, i, i, i, p, p, p, i, i, i, i, i, p, p, p, p]
    lib.hac_block_profile_read.argtypes = [p]
    lib.hac_block_bwd_profile_read.argtypes = [p]
    for f in ("launch", "launch_route", "bwd_data_launch", "bwd_weights_launch", "profile_read",
              "bwd_profile_read"):
        getattr(lib, f"hac_block_{f}").restype = i
    lib.hac_block_error_string.argtypes = [i]
    lib.hac_block_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            with span("hac.build"):
                _lib = _load(build()[0])
        return _lib


# -- packed weights and metadata (built once per parameter version) ---------------------


class _Bwd(NamedTuple):
    """The backward kernels' view of a block's structure (``_pack_bwd``)."""

    wmeta: np.ndarray  # int32 workspace table, then the data kernel's tensor-core records
    saved_floats: int  # floats per batch row of the saved buffer (the saving forward's)
    grad_floats: int  # floats per batch row of the gradient buffer (the data kernel's)
    width: int  # floats per row of one hidden buffer of the data kernel
    npc_max: int  # most nodes in one chunk
    index: np.ndarray  # int64: source of every element of the backward weight layout in [flat weights, 0]
    tiles: np.ndarray  # int32 (n_tiles, _TREC) weight-gradient tiles
    leaves: Tuple[Tuple[int, Tuple[int, ...]], ...]  # (offset, shape) of each level leaf's gradient


class _TcLayout(NamedTuple):
    """The view of a block's structure of the tensor-core route of its
    compute dtype (``_tc_layout`` in f32, ``_wg_layout`` in bf16)."""

    table: np.ndarray  # int32 (levels, _TLREC or _WLREC) records
    index: np.ndarray  # int64: source of every element of the route's weights in [flat weights, 0]
    width: int  # elements per row of one hidden buffer (before the row pad)


class _Packed(NamedTuple):
    meta: torch.Tensor  # int32 level/node table, then the tensor-core table
    weights: torch.Tensor  # w0, w1, w2 of every level, flat, in the compute dtype
    biases: torch.Tensor  # b0, b1, b2 of every level, flat, f32
    width: int  # floats per row of one hidden-activation buffer of the loop route
    bwd: _Bwd
    wmeta: torch.Tensor  # bwd.wmeta on the device
    tiles: torch.Tensor  # bwd.tiles on the device
    arrivals: torch.Tensor  # the weight kernel's arrival counter of each tile (``_Structure.arrivals``)


class _TcPacked(NamedTuple):
    """The tensor-core route's weights for one parameter version (``_tc_packed``)."""

    weights: torch.Tensor  # the route's layout: TF32 high and low parts in f32, bf16 slices in bf16
    width: int  # elements per row of one hidden buffer of the route


def _pad4(v: int) -> int:
    return (v + 3) // 4 * 4


def _smem_bytes(dim: int, width: int, cond_dim: int, meta_len: int) -> int:
    """Dynamic shared memory of one tile: the rows, S and T (``dim`` padded
    to 4 floats), two hidden buffers, the log-det accumulators, the
    condition rows (padded to 4 floats) and the int32 table; the same sum as
    ``smem_floats`` in csrc/hac_block.cu."""
    floats = _TILE_ROWS * (3 * _pad4(dim) + 2 * width + 1 + _pad4(cond_dim))
    return 4 * floats + 4 * meta_len


def _tc_smem_bytes(dim: int, width: int, cond_dim: int, meta_len: int) -> int:
    """Dynamic shared memory of one tile of the 3xTF32 route: the rows, S,
    T, the log-det accumulators, the condition rows and two hidden buffers
    of ``width`` + pad floats a row, then the int32 table; the same sum as
    ``tc_smem_bytes`` in csrc/hac_block.cu."""
    floats = _TC_ROWS * (3 * _pad4(dim) + 1 + _pad4(cond_dim) + 2 * (width + _TC_PAD))
    return 4 * floats + 4 * meta_len


def _wg_smem_bytes(dim: int, width: int, cond_dim: int, meta_len: int, stages: int) -> int:
    """Dynamic shared memory of one tile of the wgmma route with ``stages``
    weight slices in flight for each of its ``_WG_GROUPS`` consumer
    warpgroups: the mbarriers, the slices (``_WG_TILES`` n8 tiles by up to
    ``width`` bf16), xs and S (``dim`` padded to 4 floats), the condition
    rows, the warpgroups' log-det partials, a chunk's biases of its three
    layers (3 ``width`` floats), two activation buffers (``width`` bf16 a
    row), then the int32 table; the same sum as ``wg_smem_bytes`` in
    csrc/hac_block.cu."""
    slices = _WG_GROUPS * stages * 2 * 8 * _WG_TILES * width
    f32 = _WG_ROWS * (2 * _pad4(dim) + _pad4(cond_dim) + _WG_GROUPS) + 3 * width
    return _WG_BARS + slices + 4 * f32 + 2 * 2 * _WG_ROWS * width + 4 * meta_len


def _wg_stages(dim: int, width: int, cond_dim: int, meta_len: int) -> int:
    """Weight slices in flight for each consumer warpgroup of the wgmma
    route: as many as shared memory holds, at most ``_WG_MAX_STAGES``; 0
    where not even one fits (the launch refuses it)."""
    fits = [k for k in range(1, _WG_MAX_STAGES + 1)
            if _wg_smem_bytes(dim, width, cond_dim, meta_len, k) <= _SMEM_MAX]
    return max(fits, default=0)


def _bwd_smem_bytes(dim: int, width: int, cond_dim: int, npc_max: int, table_len: int) -> int:
    """Dynamic shared memory of one tile of the backward data kernel: the
    gradient, dS and dT (``dim`` padded to 4 floats), two hidden buffers of
    ``width`` + pad floats a row, g_logdet, the condition's gradient and a
    chunk's per-node condition gradients (padded to 4 floats), then the int32
    tables; the same sum as ``bwd_smem_floats`` in csrc/hac_block_bwd.cu."""
    cp = _pad4(cond_dim)
    floats = _TC_ROWS * (3 * _pad4(dim) + 2 * (width + _BPAD) + 1 + (1 + npc_max) * cp)
    return 4 * floats + 4 * table_len


def _tl_astride(wa: int) -> int:
    """The tiled route's a1/a2 row stride: ``wa`` floats, padded so that the
    stride over 4 floats is odd (``tl_astride``)."""
    return wa if (wa // 4) % 2 else wa + 4


def _tl_slab(rows: int, ncols: int, nu: int, stage: int) -> Tuple[int, int]:
    """(floats of a unit's region, weight rows of a slab) of a chunk's layer
    of ``nu`` units of ``rows`` x ``ncols`` matrices in a ring stage of
    ``stage`` floats (``tl_slab``): as many rows (a multiple of 4, at most
    ``rows``) as a region holds."""
    region = stage // nu & ~3
    return region, min(rows, region // ncols & ~3)


def _tl_smem_bytes(dim: int, cond_dim: int, rows: int, wa: int, stage: int, stages: int, meta_len: int) -> int:
    """Dynamic shared memory of one tile of the tiled route: the mbarriers, a
    ring of ``stages`` stages of ``stage`` floats, xs, S and T (``dim``
    padded to 4 floats), a1 and a2 (``_tl_astride(wa)`` floats a row), the
    level's input and the condition rows transposed, the log-det
    accumulators, then the int32 table; the same sum as ``tl_smem_bytes``
    in csrc/hac_block.cu."""
    floats = stages * stage + rows * (4 * _pad4(dim) + 2 * _tl_astride(wa) + _pad4(cond_dim) + 1)
    return _TL_BARS + 4 * floats + 4 * meta_len


class _TlPlan(NamedTuple):
    """The tiled route's view of a block's structure (``_tl_plan``)."""

    table: np.ndarray  # int32: quad slots, a1/a2 width, stage floats, 0; per level units a chunk, w0, w1, w2
    index: np.ndarray  # int64: source of every element of the route's padded weights in the flat ones, -1 a pad
    slots: int  # quads of columns the consumers of one row group hold in layers 1 and 2
    width: int  # floats of a chunk's a1 (a2) row: its units' h columns, each padded to a quad
    stage: int  # floats of one ring stage: a slab of every unit of the widest chunk's layer


def _tl_plan(hac, meta_len: int = 0) -> _TlPlan:
    """Quad slots and chunks of the tiled route, from the block's widths. A
    chunk's units, their h columns each padded to a quad (4 columns), run
    layers 1 and 2 in one pass of the consumers: a thread a quad of a row
    group. So a level of 2 n units of q quads takes ceil(2 n / (slots // q))
    passes, each as long as its chain (the level's layer-1 rows and h) and
    as wide as the slots. The slots are the count, from the widest unit's q
    up to the most a block has threads for, that makes the sum of the
    passes' lengths times the slots smallest
    (the threads' time, idle slots included), the most of those on a tie
    (fewer passes, more warps an SM), among the counts whose 16-row tile
    fits with two slabs in flight beside a table of ``meta_len`` ints.
    The table holds per level the units a chunk and where the level's w0,
    w1 and w2 start in the route's padded weights: every unit's matrix of
    every layer in the packed order, each row padded to a quad, so
    that the kernel reads a quad of a row as one 16-byte load and copies
    whole slabs 16-byte aligned (``index``; ``_tl_packed``)."""
    cd, levels = hac.cond_dim, hac.levels
    quads = [_pad4(lv.hidden) // 4 for lv in levels]

    def plan(slots):
        upc = [min(2 * len(lv.nodes), slots // q) for lv, q in zip(levels, quads)]
        width = max(u * 4 * q for u, q in zip(upc, quads))
        stage = max(u * _TL_KS * _pad4(max(lv.hidden, lv.out_max)) for u, lv in zip(upc, levels))
        cost = slots * sum(-(-2 * len(lv.nodes) // u) * (lv.in_max + cd + lv.hidden) for lv, u in zip(levels, upc))
        return (slots, width, stage, upc), cost

    n_table = _TL_HDR + _TL_LREC * len(levels)
    plans = [plan(slots) for slots in range(max(quads), (_TL_THREADS - 32) // 4 + 1)]
    fit = [(pl, c) for pl, c in plans
           if _tl_smem_bytes(hac.dim, cd, 4 * _TL_ROWS, pl[1], pl[2], 2, meta_len + n_table) <= _SMEM_MAX]
    if not fit:
        fit = plans[:1]  # the fewest slots: 8-row tiles (checked by _structure)
    if not fit:
        raise ValueError(f"HAC block too wide for the tiled route ({4 * max(quads)} columns)")
    slots, width, stage, upc = min(fit, key=lambda pc: (pc[1], -pc[0][0]))[0]
    # the padded weights: every unit's matrix of every layer, K x ncols with its
    # columns padded to a quad, in the packed layout's order
    table, parts, at, woff = [slots, width, stage, 0], [], 0, 0
    for lv, u in zip(levels, upc):
        n, h, o = 2 * len(lv.nodes), lv.hidden, lv.out_max
        table.append(u)
        for k, nc in ((lv.in_max + cd, h), (h, h), (h, o)):
            table.append(at)
            r, c = np.meshgrid(np.arange(k), np.arange(_pad4(nc)), indexing="ij")
            for unit in range(n):
                parts.append(np.where(c < nc, woff + unit * k * nc + r * nc + c, -1).reshape(-1))
                at += parts[-1].size
            woff += n * k * nc
    if at >= 2**31:
        raise ValueError("HAC block too large for the tiled route's int32 offsets")
    return _TlPlan(np.asarray(table, np.int32), np.concatenate(parts), slots, width, stage)


def _tl_launch(batch: int, dim: int, cond_dim: int, meta_len: int, plan: _TlPlan,
               sms: int = _SMS) -> Optional[Tuple[int, int, int, int]]:
    """(rows, stages, threads, shared-memory bytes) of the tiled route's
    launch, the kernel's rule (``tl_launch``): 16-row tiles (four row groups
    of consumers) where they still give each of ``sms`` SMs one and fit with
    two slabs in flight, else 8 rows (two); as many stages as fit, at most
    ``_TL_MAX_STAGES``; the consumers in whole warps, and a producer warp.
    None where no tile fits."""
    def threads(groups):
        return 32 * -(-plan.slots * groups // 32) + 32

    def fits(groups, stages):
        return (_tl_smem_bytes(dim, cond_dim, _TL_ROWS * groups, plan.width, plan.stage, stages, meta_len)
                <= _SMEM_MAX and threads(groups) <= _TL_THREADS)

    groups = 4 if -(-batch // (4 * _TL_ROWS)) >= sms and fits(4, 2) else 2
    stages = max((k for k in range(1, _TL_MAX_STAGES + 1) if fits(groups, k)), default=0)
    if stages == 0:
        return None
    rows = _TL_ROWS * groups
    return rows, stages, threads(groups), _tl_smem_bytes(dim, cond_dim, rows, plan.width, plan.stage, stages,
                                                         meta_len)


def _weight_rows(batch: int, n_tiles: int) -> int:
    """Batch rows summed by one thread block of the weight kernel: enough
    row chunks that tiles x chunks fill the card, none under
    ``_GRAD_MIN_ROWS`` rows. The chunks are ``ceil(batch / rows)``."""
    splits = max(1, min(-(-batch // _GRAD_MIN_ROWS), -(-_GRAD_BLOCKS // max(1, n_tiles))))
    return -(-batch // splits)


def _pack_bwd(hac) -> _Bwd:
    """Workspace table, chunking, the data kernel's weight layout and the
    weight-gradient tiles of the backward.

    Two buffers of f32 rows. The saved buffer holds per level the input x
    and S (width ``dim``) and a1, a2 (width ``2 n h``), and the block's
    output last: the saving forward writes it, the backward reads it. The
    gradient buffer holds per level dS, dT (width ``dim``) and dpre1, dpre2
    (width ``2 n h``): the data kernel writes it, the weight kernel reads
    it. Each region starts at a multiple of 4 floats per row.

    The data kernel's tensor-core records, per level: k-steps k3 of w2^T
    (``out_max``) and kh of the hidden width, n8 tiles nh of the hidden
    width, nx of the x rows and ncd of the condition rows of w0, nodes per
    chunk (a node's s- and t-unit share a chunk: ``2 hs`` columns each in
    a hidden buffer of ``width``), and the offsets of the level's w2^T, w1^T
    and w0^T in the backward layout. Every unit's w2^T (``out_max`` x h) and
    w1^T (h x h), and every node's w0^T of both units stacked along K (2 hs
    x the node's x rows and condition rows), are padded to k-steps and n8
    tiles in mma-fragment order (``_frag_order``); rows of w2^T past the
    node's ``out`` and columns of w0^T past its ``split`` are zeros.
    ``index`` gives each element's place in the flat packed weights, or -1
    for a zero (``_bwd_weights`` gathers it).

    Weight-gradient tiles of up to ``_GRAD_ROWS`` x ``_GRAD_COLS`` cover
    every unit's w0 (``in_max + cond_dim`` x h), w1 (h x h) and w2 (h x
    out_max); the row tiles of one unit's layer are neighbours in the table,
    so that they read its dpre rows from L2."""
    levels, cd, cdt = hac.levels, hac.cond_dim, hac.compute_dtype
    ks = _TC_KS[cdt]
    L = len(levels)
    wmeta = np.zeros(_WHDR + (_WREC + _BREC) * L, np.int64)
    rows = {"saved": 0, "grad": 0}
    tiles, leaves, parts = [], [], []
    woff = boff = at = 0
    n_w = sum(p.numel() for li in range(L) for k, p in hac.level_params(li).items() if k[0] == "w")
    kh = [-(-lv.hidden // ks) for lv in levels]
    width = max(_TC_MIN_WIDTH, max(2 * k * ks for k in kh))
    npc_max = 0
    stored = 2 if cdt == "float32" else 1  # stored elements per weight (f32: TF32 high, low)

    def region(buf, floats):
        rows[buf] += _pad4(floats)
        return rows[buf] - _pad4(floats)

    for li, lv in enumerate(levels):
        n, h, o = len(lv.nodes), lv.hidden, lv.out_max
        m_rows = lv.in_max + cd
        rec = [region("saved", hac.dim), region("saved", hac.dim), region("grad", hac.dim), region("grad", hac.dim),
               region("saved", 2 * n * h), region("saved", 2 * n * h), region("grad", 2 * n * h),
               region("grad", 2 * n * h)]
        wmeta[_WHDR + _WREC * li : _WHDR + _WREC * (li + 1)] = rec
        shapes = [(m_rows, h), (h, h), (h, o)]
        for layer, (m, k) in enumerate(shapes):
            for u in range(2 * n):
                for n0 in range(0, k, _GRAD_COLS):
                    for m0 in range(0, m, _GRAD_ROWS):
                        tiles.append((li, u, layer, m0, n0))
        # gradient offsets in _level_leaves order
        wo = [woff, woff + 2 * n * shapes[0][0] * h, woff + 2 * n * (shapes[0][0] * h + h * h)]
        bo = [boff, boff + 2 * n * h, boff + 4 * n * h]
        lk = {}
        for layer, (m, k) in enumerate(shapes):
            lk[f"w{layer}"], lk[f"b{layer}"] = (wo[layer], (2 * n, m, k)), (n_w + bo[layer], (2 * n, k))
        leaves += [lk[k] for k in hac.level_params(li)]
        # the data kernel's tensor-core layout: B[k][c] of each product is w[c][k] of the forward's
        hs = kh[li] * ks
        k3, nh, nx, ncd = -(-o // ks), hs // 8, -(-lv.in_max // 8), -(-cd // 8)
        npc = max(1, min(n, width // (2 * hs)))
        npc_max = max(npc, npc_max)
        offs = []
        r, c = _frag_order(k3, nh, cdt)  # w2^T of each unit: row m of K, column j of N
        offs.append(at * stored)
        for u in range(2 * n):
            nd = lv.nodes[u % n]
            parts.append(np.where((r < nd.dim - nd.split) & (c < h), wo[2] + u * h * o + c * o + r, -1))
            at += r.size
        r, c = _frag_order(kh[li], nh, cdt)  # w1^T of each unit
        offs.append(at * stored)
        for u in range(2 * n):
            parts.append(np.where((r < h) & (c < h), wo[1] + u * h * h + c * h + r, -1))
            at += r.size
        r, c = _frag_order(2 * kh[li], nx + ncd, cdt)  # w0^T of each node: s-unit's K rows, then t-unit's
        offs.append(at * stored)
        for i, nd in enumerate(lv.nodes):
            u, j = np.where(r < hs, i, n + i), r % hs
            src = np.where(c < 8 * nx, np.where(c < nd.split, c, -1),
                           np.where(c - 8 * nx < cd, lv.in_max + c - 8 * nx, -1))
            parts.append(np.where((j < h) & (src >= 0), wo[0] + u * m_rows * h + src * h + j, -1))
            at += r.size
        wmeta[_WHDR + _WREC * L + _BREC * li : _WHDR + _WREC * L + _BREC * (li + 1)] = (
            k3, kh[li], nh, nx, ncd, npc, *offs)
        woff, boff = wo[2] + 2 * n * h * o, bo[2] + 2 * n * o
    wmeta[0] = region("saved", hac.dim)
    wmeta[1], wmeta[2] = rows["saved"], rows["grad"]
    if at * stored >= 2**31:
        raise ValueError("HAC block too large for the backward layout's int32 offsets")
    return _Bwd(wmeta.astype(np.int32), rows["saved"], rows["grad"], width, npc_max, np.concatenate(parts),
                np.asarray(tiles, np.int32).reshape(-1, _TREC), tuple(leaves))


def _pack_meta(hac) -> Tuple[np.ndarray, int]:
    """Level records (n, h, in_rows = in_max + cond_dim, out_max, first node,
    units per chunk, w0/w1/w2/b0/b1/b2 offsets) and node records (offset,
    split, out)."""
    levels = hac.levels
    n_nodes = sum(len(lv.nodes) for lv in levels)
    meta = np.zeros(_HDR + _LREC * len(levels) + _NREC * n_nodes, np.int64)
    meta[0], meta[1] = len(levels), n_nodes
    woff = boff = node0 = width = 0
    for li, lv in enumerate(levels):
        n, h, o = len(lv.nodes), lv.hidden, lv.out_max
        rows = lv.in_max + hac.cond_dim
        hp = _pad4(h)
        upc = max(1, min(2 * n, _CHUNK_FLOATS // hp))
        width = max(width, upc * hp)
        w0, w1, w2 = woff, woff + 2 * n * rows * h, woff + 2 * n * (rows * h + h * h)
        woff = w2 + 2 * n * h * o
        b0, b1, b2 = boff, boff + 2 * n * h, boff + 4 * n * h
        boff = b2 + 2 * n * o
        meta[_HDR + _LREC * li : _HDR + _LREC * (li + 1)] = (
            n, h, rows, o, node0, upc, w0, w1, w2, b0, b1, b2,
        )
        for i, nd in enumerate(lv.nodes):
            k = _HDR + _LREC * len(levels) + _NREC * (node0 + i)
            meta[k : k + 3] = (nd.offset, nd.split, nd.dim - nd.split)
        node0 += n
    if woff >= 2**31:
        raise ValueError("HAC block too large for the kernel's int32 offsets")
    return meta.astype(np.int32), width


def _frag_order(k_steps: int, n_tiles: int, compute_dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """(row, column) of a (k_steps * ks) x (n_tiles * 8) matrix for every
    element of its mma.sync B fragments, in the order the 3xTF32 route and
    the backward data kernel read them: fragment (k-step, n8 tile) after
    fragment, k-step major; in a fragment lane after lane (lane = 4 g + t);
    in a lane TF32's b0, b1 = rows t, t + 4 of column g, or bf16's rows 2t,
    2t + 1, 2t + 8, 2t + 9."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    if compute_dtype == "bfloat16":
        k_in = (2 * t[:, None] + np.array([0, 1, 8, 9])[None, :]).reshape(-1)  # (lane, register, half)
    else:
        k_in = (t[:, None] + np.array([0, 4])[None, :]).reshape(-1)  # (lane, register)
    per = k_in.size // 32
    n_in = np.repeat(g, per)
    ks = _TC_KS[compute_dtype]
    kt, nt = np.meshgrid(np.arange(k_steps), np.arange(n_tiles), indexing="ij")
    rows = (kt[..., None] * ks + k_in).reshape(-1)
    cols = (nt[..., None] * 8 + n_in).reshape(-1)
    return rows, cols


def _tf32_parts(frags: torch.Tensor) -> torch.Tensor:
    """f32 weight fragments in lane order (two values a lane) as the f32
    route reads them: a lane's two values rounded to TF32 (10 mantissa bits,
    half away from zero: one add and one mask on the bits), then the TF32 of
    their remainders. hi + lo carries the value to ~2^-22, as the kernels'
    split of the activations (cvt.rn) does."""
    v = frags.view(-1, 32, 2)
    hi = ((v.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    lo = (((v - hi).view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    return torch.cat([hi, lo], dim=-1).reshape(-1)


def _tc_layout(hac) -> _TcLayout:
    """The 3xTF32 route's table and padded weight layout (f32 blocks). Per
    level: k-steps kh = ceil(h / 8) of the hidden width and k1 = ceil(in_max
    / 8) + ceil(cond_dim / 8) of layer 1, n8 tiles nh = kh of layers 1-2 and
    n3 of layer 3's ``out_max`` columns, units per chunk, and the offsets of
    the level's w0, w1, w2 in the padded layout. Every unit's matrix is K x N
    padded to k-steps and n8 tiles, in mma-fragment order (``_frag_order``):
    layer 1's rows are the node's ``split`` rows of w0, zeros to the end of
    its last k-step, then its condition rows (from ``in_max``), then zeros
    (the kernel reads x from the node's offset and the condition straight
    from their rows, the columns past the node's split and past ``cond_dim``
    as zeros); layer 3's columns past the node's ``out`` are zeros.
    ``index`` gives each element's place in the flat packed weights, or -1
    for a zero; ``_tc_packed`` then stores every lane's two values as their
    TF32 high parts, then their low parts (``_tf32_parts``)."""
    ks, cd = _TC_KS["float32"], hac.cond_dim
    levels = hac.levels
    kh = [-(-lv.hidden // ks) for lv in levels]
    width = max(_TC_MIN_WIDTH, max(k * ks for k in kh))
    table = np.zeros((len(levels), _TLREC), np.int64)
    parts, at, woff = [], 0, 0
    for li, lv in enumerate(levels):
        n, h, o = len(lv.nodes), lv.hidden, lv.out_max
        rows = lv.in_max + cd
        kc = -(-cd // ks)  # layer 1's k-steps of the condition, after each node's k-steps of x
        k1, nh, n3 = -(-lv.in_max // ks) + kc, kh[li] * ks // 8, -(-o // 8)
        hs = kh[li] * ks
        w0, w1, w2 = woff, woff + 2 * n * rows * h, woff + 2 * n * (rows * h + h * h)
        woff = w2 + 2 * n * h * o
        offs = []
        for layer, (kk, nn) in enumerate(((k1, nh), (kh[li], nh), (kh[li], n3))):
            offs.append(2 * at)  # TF32 high and low parts
            r, c = _frag_order(kk, nn, "float32")
            for u in range(2 * n):
                nd = lv.nodes[u % n]
                if layer == 0:  # the node's split rows, zeros to its k-step, then the condition rows at in_max
                    kx = -(-nd.split // ks) * ks
                    src_r = np.where(r < nd.split, r, np.where((r >= kx) & (r < kx + cd), lv.in_max + r - kx, -1))
                    idx = np.where((src_r >= 0) & (c < h), w0 + u * rows * h + src_r * h + c, -1)
                elif layer == 1:
                    idx = np.where((r < h) & (c < h), w1 + u * h * h + r * h + c, -1)
                else:
                    idx = np.where((r < h) & (c < nd.dim - nd.split), w2 + u * h * o + r * o + c, -1)
                parts.append(idx)
                at += idx.size
        table[li] = (kh[li], k1, nh, n3, max(1, min(2 * n, width // hs)), *offs)
    if 2 * at >= 2**31:
        raise ValueError("HAC block too large for the tensor-core route's int32 offsets")
    return _TcLayout(table.astype(np.int32), np.concatenate(parts), width)


def _wg_items(layer: int, u0: int, nu: int, n: int, kh: int, n3: int, w: int):
    """(unit in chunk, group, n8 tiles) of each item of a chunk's layer that
    consumer warpgroup ``w`` of the wgmma route takes, in its order (the
    kernel's ``wg_items``): layers 1 and 2 deal the units' groups of
    ``_WG_TILES`` tiles out in turn; layer 3 gives group ``grp`` of a unit of
    node ``i`` to warpgroup ``(i + grp) % _WG_GROUPS``, so that a node's s-
    and t-unit columns are the same threads'."""
    t, k = _WG_TILES, _WG_GROUPS
    if layer < 2:
        ng = -(-2 * kh // t)
        return [(i // ng, i % ng, min(t, 2 * kh - t * (i % ng))) for i in range(w, nu * ng, k)]
    ng = -(-n3 // t)
    return [(ul, grp, min(t, n3 - t * grp)) for ul in range(nu) for grp in range((w - (u0 + ul) % n) % k, ng, k)]


def _core_order(m: np.ndarray) -> np.ndarray:
    """An (8 T) x K matrix in the order of a wgmma K-major operand without
    swizzle: 8-row by 8-column core matrices, along K within each 8 rows."""
    t8, k = m.shape
    return m.reshape(t8 // 8, 8, k // 8, 8).transpose(0, 2, 1, 3).reshape(-1)


def _wg_layout(hac) -> _TcLayout:
    """The wgmma route's table and weight slices (bf16 blocks). Per level:
    kh = ceil(h / 16) k-steps of the hidden width (hs = 16 kh columns of a
    unit in a1/a2), k1x = ceil(in_max / 16) of x and k1c = ceil(cond_dim /
    16) of the condition in layer 1, n3 = ceil(out_max / 8) n8 tiles of
    layer 3, units per chunk, and where each of the ``_WG_GROUPS`` consumer
    warpgroups' streams of slices starts. Each unit's layer is an N x K
    matrix (N = hs, hs, 8 n3; K = 16 (k1x + k1c), hs, hs) cut into items of
    ``_WG_TILES`` n8 tiles of N by the whole K (``_wg_items``); the slices
    of a level follow each
    other in the order the warpgroup takes them (chunk, layer, item), each in
    core-matrix order (``_core_order``), so that its producer copies them
    with one bulk copy each. Layer 1's K is the node's split rows of w0,
    zeros to 16 k1x, then its condition rows (from ``in_max``), then zeros;
    every pad is zero. ``index`` gives each element's place in the flat
    packed weights, or -1 for a zero. ``width`` (elements) is the widest K
    (and at least ``out_max``) and the activation buffers' width: a chunk is
    as many units as their a1, a2, layer-1 inputs and layer-3 biases fit
    in it."""
    cd, levels = hac.cond_dim, hac.levels
    kc = -(-cd // _WG_KS)
    kh = [-(-lv.hidden // _WG_KS) for lv in levels]
    k1x = [-(-lv.in_max // _WG_KS) for lv in levels]
    width = _WG_KS * max(max(kh), max(k1x) + kc, max(-(-lv.out_max // _WG_KS) for lv in levels))
    table = np.zeros((len(levels), _WLREC), np.int64)
    parts, at, woff = [], 0, 0
    for li, lv in enumerate(levels):
        n, h, o = len(lv.nodes), lv.hidden, lv.out_max
        rows = lv.in_max + cd
        hs, n3 = _WG_KS * kh[li], -(-o // 8)
        kx = _WG_KS * k1x[li]
        upc = max(1, min(2 * n, width // hs, width // (kx + _WG_KS * kc), width // o))
        w0, w1, w2 = woff, woff + 2 * n * rows * h, woff + 2 * n * (rows * h + h * h)
        woff = w2 + 2 * n * h * o
        cache = {}

        def matrix(u, layer):
            if (u, layer) not in cache:
                nd = lv.nodes[u % n]
                c, k = np.meshgrid(np.arange(8 * n3 if layer == 2 else hs),
                                   np.arange(kx + _WG_KS * kc if layer == 0 else hs), indexing="ij")
                if layer == 0:  # the node's split rows, zeros to kx, then the condition rows at in_max
                    src = np.where(k < nd.split, k, np.where((k >= kx) & (k < kx + cd), lv.in_max + k - kx, -1))
                    idx = np.where((src >= 0) & (c < h), w0 + u * rows * h + src * h + c, -1)
                elif layer == 1:
                    idx = np.where((k < h) & (c < h), w1 + u * h * h + k * h + c, -1)
                else:
                    idx = np.where((k < h) & (c < nd.dim - nd.split), w2 + u * h * o + k * o + c, -1)
                cache[(u, layer)] = idx
            return cache[(u, layer)]

        offs = []
        for w in range(_WG_GROUPS):
            offs.append(at)
            for u0 in range(0, 2 * n, upc):
                for layer in range(3):
                    for ul, grp, tiles in _wg_items(layer, u0, min(upc, 2 * n - u0), n, kh[li], n3, w):
                        col = 8 * _WG_TILES * grp
                        parts.append(_core_order(matrix(u0 + ul, layer)[col : col + 8 * tiles]))
                        at += parts[-1].size
        table[li, : 5 + _WG_GROUPS] = (kh[li], k1x[li], kc, n3, upc, *offs)
    if at >= 2**31:
        raise ValueError("HAC block too large for the wgmma route's int32 offsets")
    return _TcLayout(table.astype(np.int32), np.concatenate(parts), width)


class _Structure(NamedTuple):
    """What a block's kernels need beyond its parameters' values, on one
    device for one compute dtype: built once, reused by every re-pack."""

    meta: torch.Tensor  # int32 level/node table, then the tensor-core route's table, then the tiled route's
    width: int  # floats per row of one hidden buffer of the loop route
    tc: _TcLayout  # the dtype's tensor-core route: 3xTF32 in f32, wgmma in bf16
    tl: Optional[_TlPlan]  # the tiled route's plan (f32 blocks)
    # made on a route's first launch (``_tc_packed``, ``_tl_packed``):
    # ROUTE_TC, ROUTE_WG or ROUTE_TILED -> the int64 gather of its layout
    # from [flat weights, 0] on the device
    index: dict
    bwd: _Bwd
    wmeta: torch.Tensor  # bwd.wmeta on the device
    tiles: torch.Tensor  # bwd.tiles on the device
    # int32 per tile, zeroed once: the weight kernel counts a tile's row
    # chunks in as they finish, and the last sets it back to 0 (so one
    # structure's backward runs on one stream at a time)
    arrivals: torch.Tensor


def _check_smem(smem: int) -> None:
    if smem > _SMEM_MAX:
        raise ValueError(f"HAC block needs {smem} B of shared memory per tile (max {_SMEM_MAX})")


def _check_tc_smem(hac, tc: _TcLayout, meta_len: int) -> None:
    """A tile of the dtype's tensor-core route fits in shared memory (the
    wgmma route with one weight slice in flight a warpgroup), or raise."""
    if hac.compute_dtype == "float32":
        _check_smem(_tc_smem_bytes(hac.dim, tc.width, hac.cond_dim, meta_len))
    else:
        _check_smem(_wg_smem_bytes(hac.dim, tc.width, hac.cond_dim, meta_len, 1))


def _tc_index(layout, n_w: int, device: torch.device) -> torch.Tensor:
    """A layout's gather index (``_TcLayout``'s or ``_Bwd``'s) into [flat weights, 0] on ``device``."""
    return torch.from_numpy(np.where(layout.index < 0, n_w, layout.index)).to(device)


def _structure(hac, device: torch.device) -> _Structure:
    """The tables, built once per device and compute dtype: the level/node
    table, then the table of the dtype's tensor-core route (from meta[2]
    on), then in f32 the tiled route's (from meta[3] on). A tile of each
    route the dtype takes by default must fit in shared memory (the tiled
    route's of 8 rows with one slab in flight); the tensor-core route's tile
    of a dtype that takes only the loop is checked where it is asked for by
    name (``_tc_packed``)."""
    cached = hac.__dict__.get("_kernel_struct")
    if cached is not None and cached[0] == (device, hac.compute_dtype):
        return cached[1]
    cdt = hac.compute_dtype
    meta, width = _pack_meta(hac)
    tc = _tc_layout(hac) if cdt == "float32" else _wg_layout(hac)
    meta[2] = meta.size
    meta = np.concatenate([meta, tc.table.reshape(-1)])
    tl = _tl_plan(hac, meta.size) if cdt == "float32" else None
    if tl is not None:
        meta[3] = meta.size
        meta = np.concatenate([meta, tl.table])
    bwd = _pack_bwd(hac)
    _check_smem(_smem_bytes(hac.dim, width, hac.cond_dim, meta.size))
    if {_FWD_ROUTE[cdt], _SAVE_ROUTE[cdt]} & {ROUTE_TC, ROUTE_WG}:
        _check_tc_smem(hac, tc, meta.size)
    if tl is not None:
        _check_smem(_tl_smem_bytes(hac.dim, hac.cond_dim, 2 * _TL_ROWS, tl.width, tl.stage, 1, meta.size))
    st = _Structure(torch.from_numpy(meta).to(device), width, tc, tl, {}, bwd,
                    torch.from_numpy(bwd.wmeta).to(device), torch.from_numpy(bwd.tiles).to(device),
                    torch.zeros(len(bwd.tiles), dtype=torch.int32, device=device))
    hac._kernel_struct = ((device, cdt), st)
    return st


def _packed(hac, device: torch.device) -> _Packed:
    """The kernel's view of the block's parameters: the flat packed weights
    in the compute dtype (pre-cast to bf16 for compute_dtype="bfloat16"),
    which the loop reads and from which the other routes' layouts are
    gathered on each one's first launch (``_tc_packed``, ``_tl_packed``),
    and one f32 bias buffer. Rebuilt only when a parameter is replaced or updated in
    place; the tables (``_structure``) once. A parameter counts as the same
    only while it is the same tensor object (held by weak reference) at the
    same address and version: a new tensor can sit at a freed one's
    address at version 0 (a second parameter dict under
    ``torch.func.functional_call``, two tensors over one buffer)."""
    lps = [hac.level_params(li) for li in range(len(hac.levels))]
    leaves = [p for lp in lps for p in lp.values()]
    key = (device, hac.compute_dtype, tuple((p.data_ptr(), p._version) for p in leaves))
    cached = hac.__dict__.get("_kernel_pack")
    if cached is not None and cached[0] == key and all(r() is p for r, p in zip(cached[1], leaves)):
        return cached[2]
    count("hac.packs")
    with span("hac.pack"):
        st = _structure(hac, device)
        wdtype = torch.bfloat16 if hac.compute_dtype == "bfloat16" else torch.float32
        with torch.no_grad():
            ws = [lp[k] for lp in lps for k in ("w0", "w1", "w2")]
            flat = torch.cat([w.reshape(-1) for w in ws]).to(device=device, dtype=wdtype)
            biases = torch.cat([lp[k].reshape(-1) for lp in lps for k in ("b0", "b1", "b2")])
            biases = biases.to(device=device, dtype=torch.float32).contiguous()
    pk = _Packed(st.meta, flat, biases, st.width, st.bwd, st.wmeta, st.tiles, st.arrivals)
    hac._kernel_pack = (key, [weakref.ref(p) for p in leaves], pk)
    return pk


def _tc_packed(hac, pk: _Packed) -> _TcPacked:
    """The weights of the dtype's tensor-core route for the parameter
    version of ``pk``: its layout (``_tc_layout``, ``_wg_layout``) gathered
    from the flat weights in one launch, in f32 split into TF32 parts.
    Built on the route's first launch for a parameter version and cached
    beside it, so that a step whose kernels all take the loop or the tiled
    route never builds it."""
    cached = hac.__dict__.get("_kernel_pack_tc")
    if cached is not None and cached[0] is pk:
        return cached[1]
    cdt = hac.compute_dtype
    route = ROUTE_TC if cdt == "float32" else ROUTE_WG
    st = _structure(hac, pk.meta.device)
    _check_tc_smem(hac, st.tc, pk.meta.numel())
    with span("hac.pack"):
        if route not in st.index:  # the gather's index, once per structure
            st.index[route] = _tc_index(st.tc, pk.weights.numel(), pk.meta.device)
        with torch.no_grad():
            w = torch.cat([pk.weights, pk.weights.new_zeros(1)])[st.index[route]]
            if cdt == "float32":
                w = _tf32_parts(w)
    tp = _TcPacked(w, st.tc.width)
    hac._kernel_pack_tc = (pk, tp)
    return tp


def _tl_packed(hac, pk: _Packed) -> torch.Tensor:
    """The tiled route's padded weights for the parameter version of ``pk``
    (``_tl_plan``'s ``index``), gathered from the flat weights in one launch
    on the route's first launch for a parameter version and cached beside
    it. A pad takes the first weight's value: the kernel reads a pad only
    into an output it never stores."""
    cached = hac.__dict__.get("_kernel_pack_tl")
    if cached is not None and cached[0] is pk:
        return cached[1]
    st = _structure(hac, pk.meta.device)
    with span("hac.pack"):
        if ROUTE_TILED not in st.index:  # the gather's index, once per structure
            st.index[ROUTE_TILED] = torch.from_numpy(np.maximum(st.tl.index, 0)).to(pk.meta.device)
        with torch.no_grad():
            w = pk.weights[st.index[ROUTE_TILED]]
    hac._kernel_pack_tl = (pk, w)
    return w


def _bwd_weights(hac, pk: _Packed) -> torch.Tensor:
    """The data kernel's weight layout (``_pack_bwd``'s ``index``) gathered
    from ``pk.weights`` in one launch, in f32 split into TF32 parts as the
    forward's tensor-core layout is (``_tf32_parts``). Built on the first
    backward of a parameter version, so serving and evaluation never build
    it."""
    cached = hac.__dict__.get("_kernel_pack_bwd")
    if cached is not None and cached[0] is pk:
        return cached[1]
    n_w, dev = pk.weights.numel(), pk.weights.device
    with span("hac.pack"):
        index = hac.__dict__.get("_kernel_bwd_index")
        if index is None or index[0] != (dev, hac.compute_dtype):  # the gather's index, once per device and dtype
            index = hac._kernel_bwd_index = ((dev, hac.compute_dtype), _tc_index(pk.bwd, n_w, dev))
        with torch.no_grad():
            flat = torch.cat([pk.weights, pk.weights.new_zeros(1)])
            wb = flat[index[1]]
            if hac.compute_dtype == "float32":
                wb = _tf32_parts(wb)
    hac._kernel_pack_bwd = (pk, wb)
    return wb


# -- the wrapper -----------------------------------------------------------------------


def _check_launch(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} ({lib.hac_block_error_string(err).decode()})"
        )


def _check_cond(hac, cond) -> None:
    if (cond is None) != (hac.cond_dim == 0):
        raise ValueError(
            f"HAC block has cond_dim={hac.cond_dim} but the condition is "
            f"{'missing' if cond is None else 'given'}"
        )


def saved_buffer(hac, x: torch.Tensor) -> torch.Tensor:
    """An empty saved buffer for a saving forward of ``x``'s rows: f32, the
    saved floats a row of the block's workspace table (``_pack_bwd``)."""
    return torch.empty(x.shape[0] * _packed(hac, x.device).bwd.saved_floats, device=x.device,
                       dtype=torch.float32)


def _run_block(hac, x: torch.Tensor, cond: Optional[torch.Tensor], rev: bool, route: Optional[int] = None,
               saved: Optional[torch.Tensor] = None):
    """(y, logdet) without autograd of a block without reshuffle: a CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises. ``route`` names the kernel's route (one of ``ROUTES`` of the
    compute dtype); None takes the dtype's through ``hac_block_launch``:
    ``_FWD_ROUTE`` to serve, ``_SAVE_ROUTE`` to save. ``saved`` (CUDA only;
    ``saved_buffer``) makes the pass a saving forward: it also writes every
    level's input and S, every unit's a1 and a2 and the block's output
    there, for the backward. The loop, the tiled and the wgmma routes save;
    the 3xTF32 route serves only (its activations fail the float64 gradient
    gate on more random draws than the loop's: 20 of 240 against 7; PERF.md).
    A saving forward's y and log-det are its route's without saving, bit for
    bit; the tiled route's y, log-det and saves are the loop's."""
    _check_cond(hac, cond)
    if x.device.type == "cpu":
        if saved is not None:
            raise ValueError("a saving forward runs on the card only")
        return plain_block(hac, x, cond, rev)
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != hac.dim:
        raise ValueError(f"hac_block kernel takes float32 (B, {hac.dim}); got {x.dtype} {tuple(x.shape)}")
    B = x.shape[0]
    if cond is not None and (
        cond.device != x.device or cond.dtype != torch.float32 or tuple(cond.shape) != (B, hac.cond_dim)
    ):
        raise ValueError(
            f"hac_block kernel takes a float32 condition ({B}, {hac.cond_dim}) on {x.device}; "
            f"got {cond.dtype} {tuple(cond.shape)} on {cond.device}"
        )
    if x.device.type != "cuda":
        raise ValueError(f"hac_block kernel: unsupported device {x.device}")
    cdt = hac.compute_dtype
    if route is not None and route not in ROUTES[cdt]:
        raise ValueError(f"hac_block kernel: no route {route!r} in {cdt}")
    if saved is not None and route == ROUTE_TC:
        raise ValueError("hac_block kernel: a saving forward takes the loop, tiled or wgmma route, not 3xTF32")
    take = (_FWD_ROUTE[cdt] if saved is None else _SAVE_ROUTE[cdt]) if route is None else route
    if saved is not None and (saved.device != x.device or saved.dtype != torch.float32 or not saved.is_contiguous()
                              or saved.numel() != x.shape[0] * _packed(hac, x.device).bwd.saved_floats):
        raise ValueError("hac_block kernel: the saved buffer is not the block's (saved_buffer)")
    x = x.contiguous()
    cond = None if cond is None else cond.contiguous()
    y = torch.empty_like(x)
    ld = torch.empty(B, device=x.device, dtype=torch.float32)
    if B == 0:
        return y, ld
    pk = _packed(hac, x.device)
    lib = _library()
    tl = _structure(hac, x.device).tl
    if take == ROUTE_LOOP:
        weights, width = pk.weights, pk.width
    elif take == ROUTE_TILED:
        weights, width = _tl_packed(hac, pk), tl.width
    else:
        weights, width = _tc_packed(hac, pk)
    args = (
        x.data_ptr(), None if cond is None else cond.data_ptr(), y.data_ptr(), ld.data_ptr(),
        B, hac.dim, hac.cond_dim, pk.meta.data_ptr(), pk.meta.numel(),
        weights.data_ptr(), pk.biases.data_ptr(), width, int(rev), float(hac.clamp * ATAN_SCALE),
        int(cdt == "bfloat16"), None if saved is None else saved.data_ptr(),
        None if saved is None else pk.wmeta.data_ptr(), 0 if tl is None else tl.slots, 0 if tl is None else tl.stage,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    with torch.cuda.device(x.device):
        err = lib.hac_block_launch(*args) if route is None else lib.hac_block_launch_route(*args, route)
    _check_launch(lib, err, "hac_block kernel")
    count("hac.launches")
    count("hac.launches.wgmma", int(take == ROUTE_WG))
    count("hac.launches.tiled", int(take == ROUTE_TILED))
    return y, ld


def _level_leaves(hac):
    """Every level parameter of the block, in level order."""
    return [p for li in range(len(hac.levels)) for p in hac.level_params(li).values()]


class BackwardLaunch:
    """One block backward on the card: its buffers, and its two kernels
    (``csrc/hac_block_bwd.cu``), each launched by its own method and counted
    there. ``saved`` is the saved buffer a saving forward of the same rows
    filled (``_run_block(..., saved=)``). ``_run_block_grad`` calls ``data``,
    then, where a level leaf needs a gradient, ``weights``. ``rows``: batch
    rows per thread block of the weight kernel (default ``_weight_rows``)."""

    def __init__(self, hac, saved, cond, rev: bool, g_y, g_ld, want_w: bool, rows: Optional[int] = None):
        B, dev = g_y.shape[0], g_y.device
        if B == 0:
            raise ValueError("BackwardLaunch needs at least one row")
        self.hac, self.rev, self.B = hac, rev, B
        self.pk = pk = _packed(hac, dev)
        bwd = pk.bwd
        if saved.dtype != torch.float32 or saved.numel() != B * bwd.saved_floats or not saved.is_contiguous():
            raise ValueError("BackwardLaunch: the saved buffer is not the block's (saved_buffer)")
        self.wt = _bwd_weights(hac, pk)
        _check_smem(_bwd_smem_bytes(hac.dim, bwd.width, hac.cond_dim, bwd.npc_max, pk.meta.numel() + bwd.wmeta.size))
        f32 = dict(device=dev, dtype=torch.float32)
        self.sv, self.g_y, self.g_ld = saved, g_y.to(**f32).contiguous(), g_ld.to(**f32).contiguous()
        self.cond = None if cond is None else cond.contiguous()
        self.dx = torch.empty(B, hac.dim, **f32)
        self.dcond = None if cond is None else torch.empty_like(self.cond)
        self.gw = torch.empty(B * bwd.grad_floats, **f32)
        self.n_w, self.n_tot = pk.weights.numel(), pk.weights.numel() + pk.biases.numel()
        self.rows = _weight_rows(B, len(bwd.tiles)) if rows is None else rows
        chunks = -(-B // self.rows)
        # the row chunks' partial sums, which the last chunk of each tile to finish adds up
        self.part = torch.empty(chunks * self.n_tot, **f32) if want_w and chunks > 1 else None
        self.grad = torch.empty(self.n_tot, **f32) if want_w else None
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.lib = _library()

    def data(self):
        """The data kernel: dx, dcond and the gradient buffer."""
        hac, pk, bwd = self.hac, self.pk, self.pk.bwd
        err = self.lib.hac_block_bwd_data_launch(
            self.sv.data_ptr(), self.gw.data_ptr(), self.g_y.data_ptr(), self.g_ld.data_ptr(), self.dx.data_ptr(),
            None if self.dcond is None else self.dcond.data_ptr(), self.B, hac.dim, hac.cond_dim,
            pk.meta.data_ptr(), pk.meta.numel(), pk.wmeta.data_ptr(), pk.wmeta.numel(), self.wt.data_ptr(), bwd.width,
            bwd.npc_max, int(self.rev), float(hac.clamp * ATAN_SCALE), int(hac.compute_dtype == "bfloat16"),
            self.stream,
        )
        _check_launch(self.lib, err, "hac_block backward data kernel")
        count("hac.bwd_launches")

    def weights(self):
        """The weight kernel: every level leaf's gradient into ``grad``, the
        row chunks' sums added in chunk order by each tile's last chunk."""
        hac, pk = self.hac, self.pk
        part = None if self.part is None else self.part.data_ptr()
        err = self.lib.hac_block_bwd_weights_launch(
            self.sv.data_ptr(), self.gw.data_ptr(), None if self.cond is None else self.cond.data_ptr(), self.B,
            hac.dim, hac.cond_dim, pk.meta.data_ptr(), pk.wmeta.data_ptr(), pk.tiles.data_ptr(), len(pk.bwd.tiles),
            self.rows, self.n_w, self.n_tot, int(hac.compute_dtype == "bfloat16"), part,
            None if part is None else pk.arrivals.data_ptr(), self.grad.data_ptr(), self.stream,
        )
        _check_launch(self.lib, err, "hac_block backward weight kernel")
        count("hac.bwd_launches")
        count("hac.bwd_weight_launches")

    def region(self, li: Optional[int], k: int = 0) -> torch.Tensor:
        """Workspace region ``k`` of level ``li`` (0-3: x, S from the saved
        buffer, dS, dT from the gradient buffer, each (B, d); 4-7: a1, a2
        saved, dpre1, dpre2, each (B, 2 n, h)), or the block's output (B, d)
        for ``li=None``."""
        return workspace_region(self.hac, self.pk.bwd, self.B, self.sv if li is None or k in (0, 1, 4, 5) else self.gw,
                                li, k)


def workspace_region(hac, bwd: _Bwd, B: int, buf: torch.Tensor, li: Optional[int], k: int = 0) -> torch.Tensor:
    """Region ``k`` of level ``li`` of the workspace table (``BackwardLaunch.region``)
    as a view of ``buf``, the saved or the gradient buffer that holds it."""
    if li is None:
        off, shape = int(bwd.wmeta[0]), (hac.dim,)
    else:
        lv = hac.levels[li]
        off = int(bwd.wmeta[_WHDR + _WREC * li + k])
        shape = (hac.dim,) if k < 4 else (2 * len(lv.nodes), lv.hidden)
    return buf[B * off : B * (off + int(np.prod(shape)))].view(B, *shape)


def _run_block_grad(hac, inp, cond, rev: bool, g_y, g_ld, needs):
    """Gradients of x, cond and every level leaf (``plain_block_grad``'s
    contract) of a block without reshuffle, from what its forward saved:
    on the CPU the block's input ``inp``, from which the plain version
    recomputes; on the card ``inp`` is the saved buffer of a saving forward,
    which the backward kernels read (or they raise). The weight kernel runs
    only where a level leaf needs its gradient; the leaves' gradients are
    views of one buffer in the packed order."""
    if inp.device.type == "cpu":
        return plain_block_grad(hac, inp, cond, rev, g_y, g_ld, needs)
    if inp.device.type != "cuda":
        raise ValueError(f"hac_block backward kernel: unsupported device {inp.device}")
    want_w = any(needs[2:])
    pk = _packed(hac, inp.device)
    if g_y.shape[0] == 0:
        dx = torch.zeros_like(g_y)
        dcond = None if cond is None else torch.zeros_like(cond)
        grad = torch.zeros(pk.weights.numel() + pk.biases.numel(), device=inp.device) if want_w else None
    else:
        with torch.cuda.device(inp.device):
            run = BackwardLaunch(hac, inp, cond, rev, g_y, g_ld, want_w)
            run.data()
            if want_w:
                run.weights()
        dx, dcond, grad = run.dx, run.dcond, run.grad
    leaves = [grad[o : o + int(np.prod(shape))].view(shape) if want_w else None for o, shape in pk.bwd.leaves]
    return tuple(g if need else None for g, need in zip((dx, dcond, *leaves), needs))


class _FusedBlock(torch.autograd.Function):
    """The block under autograd (the counterpart of ``fused_block``'s
    ``custom_vjp`` in ``hint_tpu/ops/pallas_block.py``). On the card the
    forward is the kernel as a saving forward by ``_SAVE_ROUTE`` (the tiled
    route in f32, the wgmma route in bf16): besides y and the log-det it writes
    every level's input and S, every unit's a1 and a2 and the block's
    output into a saved buffer
    (about half the backward's workspace: 0.51 GB for the flagship block at
    batch 10,000), which it stores with ``save_for_backward``; the backward
    kernels read it, so they differentiate the pass that made the loss (its
    products and ReLU masks) and recompute nothing. Under
    ``Flow(remat=True)`` a non-reentrant checkpoint drops that buffer and
    re-runs the saving forward before the backward, as it does for every
    other bijector. On the CPU the forward saves its input and the backward
    is the plain version (autograd through the levelwise engine, as the JAX
    package's VJP). The level parameters are arguments so that autograd
    asks for their gradients; the kernels read the same tensors from
    ``hac``."""

    @staticmethod
    def forward(ctx, hac, rev, x, cond, *level_params):
        ctx.hac, ctx.rev = hac, rev
        saved = saved_buffer(hac, x) if x.device.type == "cuda" and x.shape[0] else None
        before = get("hac.launches")
        out = _run_block(hac, x, cond, rev, saved=saved)
        count("hac.launches.under_grad", get("hac.launches") - before)
        ctx.save_for_backward(x if saved is None else saved, cond)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_y, g_logdet):
        inp, cond = ctx.saved_tensors
        grads = _run_block_grad(ctx.hac, inp, cond, ctx.rev, g_y, g_logdet, ctx.needs_input_grad[2:])
        return (None, None, *grads)


def fused_block(hac, x: torch.Tensor, cond: Optional[torch.Tensor] = None, rev: bool = False):
    """(y, logdet) of one whole HAC block. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises. Where a gradient
    is asked for (of ``x``, ``cond`` or a level parameter) the call goes
    through ``_FusedBlock``; serving and evaluation under ``no_grad`` call
    the kernel directly. A reshuffle block runs the levelwise engine on
    every device (autograd differentiates it), as ``hint_tpu``'s
    ``fused_block`` does: the kernel takes no per-node permutations."""
    if hac.reshuffle:
        _check_cond(hac, cond)
        count("hac.reshuffle_levelwise")
        return plain_block(hac, x, cond, rev)
    if torch.is_grad_enabled():
        params = _level_leaves(hac)
        if any(t is not None and t.requires_grad for t in (x, cond, *params)):
            return _FusedBlock.apply(hac, rev, x, cond, *params)
    return _run_block(hac, x, cond, rev)
