// Layout shared by the HAC-block kernels (hac_block.cu, hac_block_bwd.cu)
// and their wrapper, hint_tpu_torch/ops/hac_fused.py.
#pragma once

#include <cuda_bf16.h>

namespace {

// int32 metadata table, written by hac_fused.py:_pack_meta
constexpr int HDR = 4;    // n_levels, n_nodes, 0, 0
constexpr int LREC = 12;  // n, h, in_rows (= in_max + cond_dim), out_max, node0, upc,
                          // w0, w1, w2, b0, b1, b2
constexpr int NREC = 4;   // offset, split, out, 0

__host__ __device__ constexpr int pad4(int v) { return (v + 3) & ~3; }

// Weight loads and the rounding of layer inputs: f32, or bf16 weights with
// every matmul operand rounded to bf16 and f32 accumulation.
template <bool BF16> struct Wt;

template <> struct Wt<false> {
  using T = float;
  __device__ __forceinline__ static float load(const float* p) { return __ldg(p); }
  __device__ __forceinline__ static float round(float v) { return v; }
};

template <> struct Wt<true> {
  using T = unsigned short;  // bf16 bits
  __device__ __forceinline__ static float load(const unsigned short* p) {
    return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

}  // namespace
