"""Whole-HAC-block CUDA kernel: wrapper, build/loader, launch count and the
plain version (the counterpart of ``hint_tpu/ops/pallas_block.py``).

Kernel: ``csrc/hac_block.cu``. It replaces the Pallas kernel built by
``hint_tpu/ops/pallas_block.py:_fused_call`` (body ``_kernel_factory.kernel``,
atan ``_atan``): one launch runs an entire HAC block, every level's s/t
subnets, couplings and the log-det, over the whole batch, forward
(levels bottom-up) or inverse (top-down), in f32 or with bf16 weights.

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
holds arbitrary values once a trainer has overwritten every leaf. The TPU
kernel's dense level maps (up to 2048-wide scatter matrices, forced by
Mosaic's 2-D-only dots) are not carried over; the kernel does the logical
FLOPs only. Tensor cores are not used yet.

On a CPU tensor ``fused_block`` runs the plain version (the levelwise
engine); on a CUDA tensor it launches the kernel or raises.
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

from hint_tpu_torch.ops.clamp import ATAN_SCALE

#: kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0

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
                p, p, p, i, i, p, i, p, p, i, i, ctypes.c_float, i, p,
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


def _pack_meta(hac) -> Tuple[np.ndarray, int]:
    """Level records (n, h, in_rows, out_max, first node, units per chunk,
    w0/w1/w2/b0/b1/b2 offsets) and node records (offset, split, out)."""
    levels = hac.levels
    n_nodes = sum(len(lv.nodes) for lv in levels)
    meta = np.zeros(_HDR + _LREC * len(levels) + _NREC * n_nodes, np.int64)
    meta[0], meta[1] = len(levels), n_nodes
    woff = boff = node0 = width = 0
    for li, lv in enumerate(levels):
        n, h, o = len(lv.nodes), lv.hidden, lv.out_max
        rows = lv.in_max + hac.cond_dim
        hp = (h + 3) // 4 * 4
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
    dp = (hac.dim + 3) // 4 * 4
    smem = 4 * (3 * _TILE_ROWS * dp + 2 * _TILE_ROWS * width + _TILE_ROWS) + 4 * meta.size
    if smem > _SMEM_MAX:
        raise ValueError(f"HAC block needs {smem} B of shared memory per tile (max {_SMEM_MAX})")
    pk = _Packed(torch.from_numpy(meta).to(device), weights, biases, width)
    hac._kernel_pack = (key, pk)
    return pk


# -- the wrapper -----------------------------------------------------------------------


def fused_block(hac, x: torch.Tensor, cond: Optional[torch.Tensor] = None, rev: bool = False):
    """(y, logdet) of one whole HAC block. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    global launches
    if x.device.type == "cpu":
        return plain_block(hac, x, cond, rev)
    if cond is not None or hac.cond_dim:
        raise NotImplementedError("conditional HAC kernel is not ported yet (ROADMAP §2, K1 conditional)")
    if hac.reshuffle:
        raise NotImplementedError("HAC kernel with per-node reshuffle is not ported yet (ROADMAP §2)")
    if torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in hac.parameters())
    ):
        raise NotImplementedError(
            "hac_block kernel has no backward yet (ROADMAP §2, K5): run under "
            "torch.no_grad()/inference_mode() or use impl='levelwise'"
        )
    if x.device.type != "cuda":
        raise ValueError(f"hac_block kernel: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != hac.dim:
        raise ValueError(f"hac_block kernel takes float32 (B, {hac.dim}); got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    B = x.shape[0]
    y = torch.empty_like(x)
    ld = torch.empty(B, device=x.device, dtype=torch.float32)
    if B == 0:
        return y, ld
    pk = _packed(hac, x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.hac_block_launch(
            x.data_ptr(), y.data_ptr(), ld.data_ptr(), B, hac.dim,
            pk.meta.data_ptr(), pk.meta.numel(), pk.weights.data_ptr(), pk.biases.data_ptr(),
            pk.width, int(rev), float(hac.clamp * ATAN_SCALE),
            int(hac.compute_dtype == "bfloat16"), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"hac_block kernel launch failed: CUDA error {err} "
            f"({lib.hac_block_error_string(err).decode()})"
        )
    launches += 1
    return y, ld
