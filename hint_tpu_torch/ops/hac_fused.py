"""Whole-HAC-block CUDA kernel: wrapper, build/loader, launch count and the
plain version (the counterpart of ``hint_tpu/ops/pallas_block.py``).

Kernel: ``csrc/hac_block.cu``. It replaces the Pallas kernel built by
``hint_tpu/ops/pallas_block.py:_fused_call`` (body ``_kernel_factory.kernel``,
atan ``_atan``): one launch runs an entire HAC block, every level's s/t
subnets, couplings and the log-det, over the whole batch, forward
(levels bottom-up) or inverse (top-down), in f32 or with bf16 weights,
with or without a condition fed to every subnet (``cond_dim > 0``, the
``c_ref`` variant of the Pallas kernel).

What bounds it on the card: f32 operations on the CUDA cores. A flagship
block (d=100, c_internal=(263,131,65,32,32)) is ~0.97 MFLOP per row against
~800 bytes of row input and output, so at a serving batch the work is far
above the H100's ~20 FLOP/byte f32 balance point; the ~2 MB of weights are
read by every thread block but stay resident in the 50 MB L2.

What the design does about it: one thread block owns a tile of 16 rows and
keeps the tile, its S/T buffers and two hidden-activation buffers in shared
memory for the whole block, so no activation touches device memory. Per
level it runs the level's s/t units in chunks that fill the hidden buffer;
each thread accumulates 8 rows x 1 output column in registers, reading
weights straight from global memory (L1/L2) and activations as 16-byte
broadcast loads from shared memory. Only the real ``split`` input rows of
``w0`` and the real ``out_i`` columns of ``w2``/``b2`` are read: padding
holds arbitrary values once a trainer has overwritten every leaf. A
condition-fed block keeps the tile's condition rows in shared memory beside
the tile and adds ``cond_dim`` terms to each layer-1 sum, read from the
rows of ``w0`` that start at the level's ``in_max``. The TPU
kernel's dense level maps (up to 2048-wide scatter matrices, forced by
Mosaic's 2-D-only dots) are not carried over; the kernel does the logical
FLOPs only. Tensor cores are not used yet.

On a CPU tensor ``fused_block`` runs the plain version (the levelwise
engine); on a CUDA tensor it launches the kernel or raises. Under autograd
the kernel is the forward of ``_FusedBlock``, whose backward recomputes the
block with the plain version (the gradient of the TPU kernel is the
levelwise engine's too, ``pallas_block.py:357-382``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from hint_tpu_torch.ops.clamp import ATAN_SCALE

#: kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0
#: those of them made as the forward of ``_FusedBlock`` (the kernel under autograd)
grad_launches = 0

SOURCE = Path(__file__).parent / "csrc" / "hac_block.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# layout of the int32 metadata table; must match csrc/hac_block.cu
_HDR, _LREC, _NREC = 4, 12, 4
# rows per thread block and the target width (floats) of one hidden buffer
_TILE_ROWS = 16
_CHUNK_FLOATS = 576
_SMEM_MAX = 232_448  # bytes of dynamic shared memory a Hopper block may use


def plain_block(hac, x: torch.Tensor, cond: Optional[torch.Tensor], rev: bool):
    """The kernel's plain PyTorch version: the levelwise engine."""
    return hac._inverse_levelwise(x, cond) if rev else hac._forward_levelwise(x, cond)


# -- build and load ------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc", path=f"{home}/bin") or shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the hac_block kernel cannot be built")
    return found


def build() -> Tuple[Path, float, str]:
    """Compile ``csrc/hac_block.cu`` for sm_90a into ``_build/`` unless a
    library of the same source and flags is there already. Returns the
    library path, the seconds spent compiling (0 when cached) and the
    compiler's output (register and shared-memory use per kernel)."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"hac_block_{digest}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds, proc.stdout + proc.stderr


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.hac_block_launch.argtypes = [
                p, p, p, p, i, i, i, p, i, p, p, i, i, ctypes.c_float, i, p,
            ]
            lib.hac_block_launch.restype = i
            lib.hac_block_error_string.argtypes = [i]
            lib.hac_block_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# -- packed weights and metadata (built once per parameter version) ---------------------


class _Packed(NamedTuple):
    meta: torch.Tensor  # int32 level/node table
    weights: torch.Tensor  # w0, w1, w2 of every level, flat, in the compute dtype
    biases: torch.Tensor  # b0, b1, b2 of every level, flat, f32
    width: int  # floats per row of one hidden-activation buffer


def _pad4(v: int) -> int:
    return (v + 3) // 4 * 4


def _smem_bytes(dim: int, width: int, cond_dim: int, meta_len: int) -> int:
    """Dynamic shared memory of one tile: the rows, S and T (``dim`` padded
    to 4 floats), two hidden buffers, the log-det accumulators, the
    condition rows (padded to 4 floats) and the int32 table; the same sum as
    ``smem_floats`` in csrc/hac_block.cu."""
    floats = _TILE_ROWS * (3 * _pad4(dim) + 2 * width + 1 + _pad4(cond_dim))
    return 4 * floats + 4 * meta_len


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


def _packed(hac, device: torch.device) -> _Packed:
    """The kernel's view of the block's parameters: one flat weight buffer
    (pre-cast to bf16 for compute_dtype="bfloat16") and one f32 bias buffer,
    rebuilt only when a parameter is replaced or updated in place."""
    lps = [hac.level_params(li) for li in range(len(hac.levels))]
    key = (
        device, hac.compute_dtype,
        tuple((p.data_ptr(), p._version) for lp in lps for p in lp.values()),
    )
    cached = hac.__dict__.get("_kernel_pack")
    if cached is not None and cached[0] == key:
        return cached[1]
    meta, width = _pack_meta(hac)
    wdtype = torch.bfloat16 if hac.compute_dtype == "bfloat16" else torch.float32
    with torch.no_grad():
        weights = torch.cat([lp[k].reshape(-1) for lp in lps for k in ("w0", "w1", "w2")])
        biases = torch.cat([lp[k].reshape(-1) for lp in lps for k in ("b0", "b1", "b2")])
        weights = weights.to(device=device, dtype=wdtype).contiguous()
        biases = biases.to(device=device, dtype=torch.float32).contiguous()
    smem = _smem_bytes(hac.dim, width, hac.cond_dim, meta.size)
    if smem > _SMEM_MAX:
        raise ValueError(f"HAC block needs {smem} B of shared memory per tile (max {_SMEM_MAX})")
    pk = _Packed(torch.from_numpy(meta).to(device), weights, biases, width)
    hac._kernel_pack = (key, pk)
    return pk


# -- the wrapper -----------------------------------------------------------------------


def _run_block(hac, x: torch.Tensor, cond: Optional[torch.Tensor], rev: bool):
    """(y, logdet) without autograd: a CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    global launches
    if (cond is None) != (hac.cond_dim == 0):
        raise ValueError(
            f"HAC block has cond_dim={hac.cond_dim} but the condition is "
            f"{'missing' if cond is None else 'given'}"
        )
    if x.device.type == "cpu":
        return plain_block(hac, x, cond, rev)
    if hac.reshuffle:
        raise NotImplementedError("HAC kernel with per-node reshuffle is not ported yet (ROADMAP §2)")
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
    x = x.contiguous()
    cond = None if cond is None else cond.contiguous()
    y = torch.empty_like(x)
    ld = torch.empty(B, device=x.device, dtype=torch.float32)
    if B == 0:
        return y, ld
    pk = _packed(hac, x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.hac_block_launch(
            x.data_ptr(), None if cond is None else cond.data_ptr(), y.data_ptr(), ld.data_ptr(),
            B, hac.dim, hac.cond_dim, pk.meta.data_ptr(), pk.meta.numel(),
            pk.weights.data_ptr(), pk.biases.data_ptr(), pk.width, int(rev), float(hac.clamp * ATAN_SCALE),
            int(hac.compute_dtype == "bfloat16"), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"hac_block kernel launch failed: CUDA error {err} "
            f"({lib.hac_block_error_string(err).decode()})"
        )
    launches += 1
    return y, ld


def _level_leaves(hac):
    """Every level parameter of the block, in level order."""
    return [p for li in range(len(hac.levels)) for p in hac.level_params(li).values()]


class _FusedBlock(torch.autograd.Function):
    """The block under autograd (the counterpart of ``fused_block``'s
    ``custom_vjp`` in ``hint_tpu/ops/pallas_block.py``): the forward is the
    kernel and saves only its input; the backward rematerialises through
    the plain version, as the JAX package's does through its levelwise
    engine. The level parameters are arguments so that autograd asks for
    their gradients; the plain version reads the same tensors from ``hac``."""

    @staticmethod
    def forward(ctx, hac, rev, x, cond, *level_params):
        global grad_launches
        ctx.hac, ctx.rev = hac, rev
        ctx.save_for_backward(x, *(() if cond is None else (cond,)))
        before = launches
        out = _run_block(hac, x, cond, rev)
        grad_launches += launches - before
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_y, g_logdet):
        x, *cond = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            x = x.detach().requires_grad_(needs[0])
            cond = cond[0].detach().requires_grad_(needs[1]) if cond else None
            wanted = [t for t, need in zip((x, cond, *_level_leaves(ctx.hac)), needs) if need]
            y, logdet = plain_block(ctx.hac, x, cond, ctx.rev)
            grads = iter(torch.autograd.grad((y, logdet), wanted, (g_y, g_logdet), allow_unused=True))
        return (None, None, *(next(grads) if need else None for need in needs))


def fused_block(hac, x: torch.Tensor, cond: Optional[torch.Tensor] = None, rev: bool = False):
    """(y, logdet) of one whole HAC block. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises. Where a gradient
    is asked for (of ``x``, ``cond`` or a level parameter) the call goes
    through ``_FusedBlock``; serving and evaluation under ``no_grad`` call
    the kernel directly."""
    if torch.is_grad_enabled():
        params = _level_leaves(hac)
        if any(t is not None and t.requires_grad for t in (x, cond, *params)):
            return _FusedBlock.apply(hac, rev, x, cond, *params)
    return _run_block(hac, x, cond, rev)
