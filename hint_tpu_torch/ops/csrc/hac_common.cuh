// Layout shared by the HAC-block kernels (hac_block.cu, hac_block_bwd.cu)
// and their wrapper, hint_tpu_torch/ops/hac_fused.py.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// int32 metadata table, written by hac_fused.py:_pack_meta
constexpr int HDR = 4;    // n_levels, n_nodes, start of the tensor-core table (ints into
                          // the table), 0
constexpr int LREC = 12;  // n, h, in_rows (= in_max + cond_dim), out_max, node0, upc,
                          // w0, w1, w2, b0, b1, b2
constexpr int NREC = 4;   // offset, split, out, 0
constexpr int TLREC = 8;  // tensor-core table, per level: k-steps of the hidden width,
                          // of layer 1; n8 tiles of layers 1-2, of layer 3; units per
                          // chunk; w0, w1, w2 (elements into the tensor-core layout)

__host__ __device__ constexpr int pad4(int v) { return (v + 3) & ~3; }

// int32 workspace table of the backward, written by hac_fused.py:_pack_bwd.
// Two buffers of f32 rows: the saved buffer, which the forward kernel fills
// where it saves its activations and the backward kernels read, and the
// gradient buffer, which the data kernel fills and the weight kernel reads.
// Every entry is an offset in floats per batch row: region r of row width w
// starts at buf + B * r, row b at + b * w.
constexpr int WHDR = 3;  // y (block output, width d; saved), floats per row of the saved and of the gradient buffer
constexpr int WREC = 8;  // per level: x, s (saved, width d); ds, dt (gradient, width d); a1, a2 (saved,
                         // width 2 n h); p1, p2 (gradient, width 2 n h)

// Rows [0, nrows) of `units` units of h columns each from shared memory
// (row stride ss, unit u's column j at u * us + j) to device memory (row
// stride ds, the units next to each other): one warp a row, neighbouring
// lanes on neighbouring columns.
__device__ __forceinline__ void save_rows(float* __restrict__ dst, int ds, const float* src, int ss, int us, int h,
                                          int units, int nrows, int warp, int nw, int lane) {
  for (int r = warp; r < nrows; r += nw)
    for (int u = 0; u < units; ++u)
      for (int j = lane; j < h; j += 32) dst[(size_t)r * ds + u * h + j] = src[r * ss + u * us + j];
}

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
// in three (the weight kernel's a2^T . dS/dT); bf16 with the A side split in
// three (the data kernel's dS/dT . w2^T in bf16 mode).
enum { M_TF32X3 = 0, M_BF16 = 1, M_BF16_B3 = 2, M_BF16_A3 = 3 };

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

// an f32 A side as hi + mid + lo, each bf16, exactly: v[part][half][reg]
template <> struct FragA<M_BF16_A3> {
  uint32_t v[3][2][4];
};

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

// -- the tensor-core product loop of the forward kernel's tensor-core route and
// of the backward data kernel ---------------------------------------------------
constexpr int TTB = 32;        // batch rows per thread block: two m16 halves
constexpr int TNTW = 4;        // n8 tiles of one warp group

// Per compute dtype: the k of one mma, the elements of one (k-step, n8 tile)
// weight fragment as stored, a lane's part of it, the warps of a block.
template <bool BF16> struct Tc;
template <> struct Tc<false> {
  using BV = float4;                // a lane's part of one weight fragment: b0, b1 high, b0, b1 low
  static constexpr int KS = 8;      // k of one mma.sync (m16n8k8, TF32)
  static constexpr int FRAG = 128;  // elements of one (k-step, n8 tile): 32 lanes x 2 x (high, low)
  static constexpr int NW = 12;     // warps per block (the forward: 164 registers a thread)
};
template <> struct Tc<true> {
  using BV = uint2;
  static constexpr int KS = 16;     // m16n8k16, bf16
  static constexpr int FRAG = 128;  // 32 lanes x 2 registers x 2 bf16
  static constexpr int NW = 16;     // warps per block (128 registers a thread)
};

// Calls f(unit in chunk, first n8 tile, tiles) for warp w's share of the
// nu x nt tiles of a chunk's layer: an even split over the NW warps, taken
// in groups of at most TNTW tiles of one unit, as even as the share allows.
template <int NW, class F>
__device__ __forceinline__ void warp_groups(int nu, int nt, int w, F&& f) {
  const int tot = nu * nt;
  int t = w * tot / NW;
  const int t1 = (w + 1) * tot / NW;
  while (t < t1) {
    const int ul = t / nt, tt = t - ul * nt;
    const int rem = min(t1 - t, nt - tt);
    const int ng = (rem + TNTW - 1) / TNTW;
    const int nb = (rem + ng - 1) / ng;
    f(ul, tt, nb);
    t += nb;
  }
}

// acc[i][h] = A . W for the tile's two m16 halves h and n8 tiles i < NB
// over `ks` k-steps, by the operand route MODE: M_TF32X3 (W stored as TF32
// high and low parts, k8), M_BF16 and M_BF16_A3 (W bf16, k16). W fragment
// (k-step kt, tile i) starts at wf + kt * kstride + i * 128 elements; a
// lane's part is 4 elements at lane * 4 (Tc's BV). The next k-step's
// fragments are loaded into the other of two register sets while this one
// is multiplied (an L1 prefetch further ahead, and loading the next group's
// first fragments during this group, measured slower in the forward). NB is
// a template argument so that the 2 NB product chains of a k-step are
// independent straight-line code. fill(k0, A) sets both halves' A fragments
// of the k-step starting at column k0. Each k-step's products are summed
// from zero on the tensor cores (the small parts first), then added to the
// running sum by one rounding f32 add.
template <int MODE, int NB, class WT, class Fill>
__device__ __forceinline__ void tc_group(float (&acc)[TNTW][2][4], const WT* __restrict__ wf, int kstride, int ks,
                                         int lane, Fill&& fill) {
  using C = Tc<MODE != M_TF32X3>;
  using BV = typename C::BV;
#pragma unroll
  for (int i = 0; i < TNTW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][h][j] = 0.f;
  const BV* wl = reinterpret_cast<const BV*>(wf) + lane;  // this lane's part of fragment (0, 0)
  const int kstep = kstride / (C::FRAG / 32);             // in BV units
  auto load = [&](BV(&b)[NB], int kt) {
#pragma unroll
    for (int i = 0; i < NB; ++i) b[i] = __ldg(wl + kt * kstep + i * 32);
  };
  auto step = [&](const BV(&b)[NB], int kt) {
    FragA<MODE> A;  // both m16 halves' A fragments
    fill(kt * C::KS, A);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float t[4];
        if constexpr (MODE == M_TF32X3) {
          const uint32_t bh0 = __float_as_uint(b[i].x), bh1 = __float_as_uint(b[i].y);
          const uint32_t bl0 = __float_as_uint(b[i].z), bl1 = __float_as_uint(b[i].w);
          mma_tf32_z(t, A.lo[h], bh0, bh1);
          mma_tf32(t, A.hi[h], bl0, bl1);
          mma_tf32(t, A.hi[h], bh0, bh1);
        } else if constexpr (MODE == M_BF16_A3) {
          mma_bf16_z(t, A.v[2][h], b[i].x, b[i].y);
          mma_bf16(t, A.v[1][h], b[i].x, b[i].y);
          mma_bf16(t, A.v[0][h], b[i].x, b[i].y);
        } else {
          mma_bf16_z(t, A.v[h], b[i].x, b[i].y);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][h][j] += t[j];
      }
    }
  };
  BV b0[NB], b1[NB];
  load(b0, 0);
  int kt = 0;
#pragma unroll 1
  for (; kt + 2 <= ks; kt += 2) {
    load(b1, kt + 1);
    step(b0, kt);
    if (kt + 2 < ks) load(b0, kt + 2);
    step(b1, kt + 1);
  }
  if (kt < ks) step(b0, kt);
}

// tc_group with the tile count as a template argument
template <int MODE, class WT, class Fill>
__device__ __forceinline__ void tc_group_nb(float (&acc)[TNTW][2][4], const WT* __restrict__ wf, int kstride, int ks,
                                            int nb, int lane, Fill&& fill) {
  switch (nb) {
    case 1: tc_group<MODE, 1>(acc, wf, kstride, ks, lane, fill); break;
    case 2: tc_group<MODE, 2>(acc, wf, kstride, ks, lane, fill); break;
    case 3: tc_group<MODE, 3>(acc, wf, kstride, ks, lane, fill); break;
    default: tc_group<MODE, 4>(acc, wf, kstride, ks, lane, fill); break;
  }
}

// A's value v at fragment register r of half h into the TF32 high and low parts
__device__ __forceinline__ void tf32_split(FragA<M_TF32X3>& A, int h, int r, float v) {
  A.hi[h][r] = tf32_rne(v);
  A.lo[h][r] = tf32_rne(v - __uint_as_float(A.hi[h][r]));
}

// A's f32 values v0, v1 (the pair of register r of half h) as three exact bf16 parts each
__device__ __forceinline__ void bf16_split3(FragA<M_BF16_A3>& A, int h, int r, float v0, float v1) {
  float p0[3], p1[3];
  p0[0] = bf16_rne(v0);
  p1[0] = bf16_rne(v1);
  const float r0 = v0 - p0[0], r1 = v1 - p1[0];
  p0[1] = bf16_rne(r0);
  p1[1] = bf16_rne(r1);
  p0[2] = bf16_rne(r0 - p0[1]);
  p1[2] = bf16_rne(r1 - p1[1]);
#pragma unroll
  for (int s = 0; s < 3; ++s) A.v[s][h][r] = bf16_pair(p0[s], p1[s]);
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
