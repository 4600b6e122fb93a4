// Layout shared by the HAC-block kernels (hac_block.cu, hac_block_bwd.cu)
// and their wrapper, hint_tpu_torch/ops/hac_fused.py.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// int32 metadata table, written by hac_fused.py:_pack_meta
constexpr int HDR = 4;    // n_levels, n_nodes, start of the tensor-core table (ints into
                          // the table), start of the tensor-core weights (elements into wbuf)
constexpr int LREC = 12;  // n, h, in_rows (= in_max + cond_dim), out_max, node0, upc,
                          // w0, w1, w2, b0, b1, b2
constexpr int NREC = 4;   // offset, split, out, 0
constexpr int TLREC = 8;  // tensor-core table, per level: k-steps of the hidden width,
                          // of layer 1; n8 tiles of layers 1-2, of layer 3; units per
                          // chunk; w0, w1, w2 (elements from the tensor-core weights)

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

// -- tensor-core fragments (mma.sync), shared by the forward kernel's tensor-core
// route and the backward weight kernel ------------------------------------------
// Operand routes: 3xTF32 (f32 mode); bf16 x bf16; bf16 with the B side split
// in three (the weight kernel's a2^T . dS/dT).
enum { M_TF32X3 = 0, M_BF16 = 1, M_BF16_B3 = 2 };

// f32 -> TF32 (10 mantissa bits), round to nearest even, low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rne(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ float bf16_rne(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b from zero (the first product of a k-step)
__device__ __forceinline__ void mma_tf32_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of two m16 halves (32 rows) from raw f32 values a[half][reg][elem]:
// TF32 takes elem 0 of each reg (k8), bf16 both (k16, low k in the low half).
template <int MODE> struct FragA;

template <> struct FragA<M_TF32X3> {
  uint32_t hi[2][4], lo[2][4];
  __device__ __forceinline__ void set(const float (&a)[2][4][2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi[h][r] = tf32_rne(a[h][r][0]);
        lo[h][r] = tf32_rne(a[h][r][0] - __uint_as_float(hi[h][r]));
      }
  }
};

template <> struct FragA<M_BF16> {
  uint32_t v[2][4];
  __device__ __forceinline__ void set(const float (&a)[2][4][2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) v[h][r] = bf16_pair(a[h][r][0], a[h][r][1]);
  }
};

template <> struct FragA<M_BF16_B3> : FragA<M_BF16> {};

// acc[half] += A[half] . B for one n8 tile and k-step; b[reg][elem] raw f32
// values. The tensor cores sum a k-step's products (all passes of a split,
// the small ones first) from zero with truncating f32 adds; that partial
// joins the running sum by an ordinary f32 add (round to nearest), so the
// truncation stays within one k-step instead of running along all of K.
template <int MODE>
__device__ __forceinline__ void mma_tile(float (&acc)[2][4], const FragA<MODE>& A, const float (&b)[2][2]) {
  if constexpr (MODE == M_TF32X3) {
    const uint32_t bh0 = tf32_rne(b[0][0]), bh1 = tf32_rne(b[1][0]);
    const uint32_t bl0 = tf32_rne(b[0][0] - __uint_as_float(bh0));
    const uint32_t bl1 = tf32_rne(b[1][0] - __uint_as_float(bh1));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t[4];
      mma_tf32_z(t, A.lo[h], bh0, bh1);
      mma_tf32(t, A.hi[h], bl0, bl1);
      mma_tf32(t, A.hi[h], bh0, bh1);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][j] += t[j];
    }
  } else if constexpr (MODE == M_BF16_B3) {
    uint32_t bp[3][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p[3][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = b[r][e];
        p[0][e] = bf16_rne(x);
        const float r1 = x - p[0][e];
        p[1][e] = bf16_rne(r1);
        p[2][e] = bf16_rne(r1 - p[1][e]);
      }
#pragma unroll
      for (int s = 0; s < 3; ++s) bp[s][r] = bf16_pair(p[s][0], p[s][1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t[4];
      mma_bf16_z(t, A.v[h], bp[2][0], bp[2][1]);
      mma_bf16(t, A.v[h], bp[1][0], bp[1][1]);
      mma_bf16(t, A.v[h], bp[0][0], bp[0][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][j] += t[j];
    }
  } else {
    const uint32_t b0 = bf16_pair(b[0][0], b[0][1]), b1 = bf16_pair(b[1][0], b[1][1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t[4];
      mma_bf16_z(t, A.v[h], b0, b1);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][j] += t[j];
    }
  }
}

// k offset of fragment register r, element e (A: r >> 1; B: r) for lane tig
template <bool BF>
__device__ __forceinline__ int frag_k(int r, int e, int tig) {
  return BF ? r * 8 + 2 * tig + e : r * 4 + tig;
}

// -- cp.async -------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
