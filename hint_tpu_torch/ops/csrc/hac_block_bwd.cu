// Backward of a whole hierarchical-affine-coupling (HAC) block, for Hopper
// (sm_90a): the gradients of x, the condition and every level parameter.
//
// Replaces the gradient of the Pallas kernel of hint_tpu/ops/pallas_block.py
// (fused_block's custom_vjp, _fwd/_bwd), which rematerialises through XLA's
// levelwise engine. Plain version and wrapper: hint_tpu_torch/ops/hac_fused.py
// (plain_block_grad, _run_block_grad).
//
// What it reads: the saved buffer of a saving forward. The forward kernel
// under autograd (hac_fused._FusedBlock) writes, besides y and the log-det,
// each level's input x_l and scale pre-activation S, every unit's a1 and a2
// and the block's output (csrc/hac_block.cu, `sv`); these kernels read them
// and recompute nothing, so they differentiate the pass that made the loss,
// its ReLU masks included. What they write goes to a second buffer, the
// gradient buffer (the workspace table in hac_common.cuh says where).
//
// Two kernels, each with its own entry point, both on the caller's stream:
//
// 1. hac_block_bwd_data: the reverse chain. One thread block per tile of
//    TTB = 32 rows walks the levels in reverse pass order. Per level, with
//    le = cs*atan(S), forward pass y = e^le x + T:
//      dx = g e^le, dT = g, dle = g e^le x + g_ld;
//    inverse pass y = (x - T) e^-le:
//      dx = g / e^le, dT = -g / e^le, dle = -g y - g_ld;
//    dS = dle cs / (1 + S^2) (the prologue). Then per chunk of nodes (a
//    node's s- and t-unit always share a chunk):
//      dpre3 = (dS | dT)[off+split : off+split+out]
//      dpre2 = round(dpre3 . w2^T) * [a2 > 0]
//      dpre1 = round(dpre2 . w1^T) * [a1 > 0]
//      d[x_upper | cond] = round([dpre1_s | dpre1_t] . [w0_s^T ; w0_t^T])
//    where round is the identity in f32 and rounds to bf16 in bf16 mode
//    (the backward of the plain version's operand rounding). The x part is
//    added to dx on the node's upper segment (no two nodes of a level share
//    one); the condition part is summed over the chunk's nodes in node order,
//    chunk after chunk, level after level. No atomics: every sum has a fixed
//    order, so two calls give the same bits. dS, dT, dpre1 and dpre2 go to
//    the gradient buffer for the weight kernel.
//    Every product runs on mma.sync by the forward kernel's tensor-core
//    product loop (tc_group, hac_common.cuh): 3xTF32 in f32 mode (each
//    k-step's products summed from zero, then added to the running sum by a
//    rounding f32 add); in bf16 mode dpre2 and dpre1 are bf16 values, and
//    dS/dT (f32) are split exactly into three bf16 parts. The weights come
//    from a padded layout of every unit's w2^T, w1^T and every node's w0^T
//    of both units stacked along K, in fragment order, that the wrapper
//    builds once per parameter version (hac_fused._bwd_weights), so that
//    d[x_upper | cond] is one product of K = 2 hs. The warps split each
//    product's n8 tiles evenly (warp_groups). A chunk's a1 and a2 are
//    staged from the saved buffer into the two hidden buffers by cp.async
//    (a1 while dpre2 runs); the epilogues read the masks from there and
//    write dpre2 and dpre1 in place, and each goes to the gradient buffer
//    row by row while the next product runs.
//    Tried and measured slower on the card: the first port's CUDA-core
//    loops over the same buffer (1.7x); f32 products with both sides split
//    exactly into three bf16 parts (six products); staging the next chunk's
//    a2 while dx runs; splitting dx's K over the warps.
// 2. hac_block_bwd_weights: dw = sum_b act^T dpre for every unit and layer
//    (act = [x_upper | 0 | cond], a1, a2; dpre = dpre1, dpre2, dpre3) and
//    db = sum_b dpre, over output tiles of GTM = 128 rows by up to GTN = 264
//    columns (a unit's whole N up to 264; a table of tiles from the
//    wrapper), each split over row chunks of `rows_per_split`. The last of
//    a tile's chunks to finish adds the chunks' sums in chunk order (below),
//    rounds them to bf16 for weights in bf16 mode (the plain version rounds
//    each weight gradient once, after the whole-batch sum; biases are not
//    rounded) and writes them in the packed weights | biases order. Padding
//    gets exact zeros: act is 0 on the rows [split, in_max) of w0, dpre3 on
//    the columns [out, out_max) of w2/b2.
//
// Bound on the card: both the data and the weight kernel by the bytes of
// the two buffers (~51 KB a row each for the flagship block: the data
// kernel reads the saved one and writes the gradient one, the weight kernel
// reads both), as each takes the forward's products once on the tensor
// cores.
//
// The weight kernel's design: every product on mma.sync. f32 mode takes
// 3xTF32: each f32 operand is split into a TF32 high part and a TF32
// remainder (both rounded to nearest even), and hi.hi + hi.lo + lo.hi is
// summed in f32, ~2^-21 relative error per product. The tensor cores add in
// f32 with truncation: along K = 10,000 batch rows that one-sided error grows
// like K^1.5, so each k-step's products are summed from zero on the tensor
// cores and added to the running sum by a rounding f32 add. bf16 mode
// multiplies the values the plain version rounds to bf16 as they are
// (m16n8k16, f32 sums); a2 against dS/dT splits the f32 side exactly into
// three bf16 parts and takes three products. A tile spans a unit's whole N,
// so each act float is read once per 264 columns and each dpre float once
// per 128 rows (at most 3 times for h <= 384). act and dpre rows go through
// a ring of three cp.async stages, as many rows a stage as the tile's real
// widths leave room for; a narrow tile spreads each slab's rows over the
// warps its columns leave idle and adds their sums in a fixed order, and
// every thread of a row-0 tile takes part in the bias sums. The grid runs a
// tile's row chunks next to each other, so the widest tiles, first in the
// table, all start in the first wave.
//
// The sum over the row chunks replaces a third kernel, which read every
// chunk's partials back from device memory after the weight kernel ended (a
// launch of its own, on a grid that ramps up and drains). Each block writes
// its tile's sums to [chunks][n_weights + n_biases] partials, makes them
// visible (__threadfence) and counts itself in the tile's arrival counter;
// the block that arrives last adds the tile's partials in chunk order, from
// 0, reading them from L2, writes the gradient and sets the counter back to
// 0 for the next launch. One chunk writes its sums as they are. The counter
// is the only atomic, and no value goes through one: every sum has a fixed
// order, so two calls give the same bits, and a tile's f32 gradient is the
// split-order sum of the chunks' own partials bit for bit. No block waits
// for another.
// Tried and measured slower on the card: the chunks of a tile as one
// thread-block cluster, adding the ranks' sums over distributed shared
// memory in rank order. With 156 KB of shared memory a block, the card
// holds 39 clusters of 3 blocks (117 SMs) and 15 of 8, and the flagship
// block's weight kernel took 1.80 ms against 1.48 + 0.01 for the weight
// kernel and the reduction (PERF.md). Also slower on that block, against
// 1.50-1.52 ms for this design: the last block keeping its own sums in
// shared memory (1.58), also waiting for the others' partials behind a
// second counter (1.60); a tile's partials contiguous, read 16 bytes at a
// time (1.56); 8 elements a thread in the last block's sum (1.57).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hac_common.cuh"

namespace {

// -- data kernel: the reverse chain on the tensor cores (TTB = 32 rows a tile, hac_common.cuh) --
constexpr int BREC = 9;         // backward tensor-core table, per level (after the WREC records): k-steps
                                // of w2^T, of the hidden width; n8 tiles of the hidden width, of the
                                // x rows and of the condition rows of w0; nodes per chunk; w2^T, w1^T,
                                // w0^T (elements from the start of the backward layout)
constexpr int BPAD = 4;         // hidden-buffer row stride = width + pad: (width + 4) / 4 odd

// -- weight kernel --
constexpr int GTM = 128;        // output rows (act columns) of one tile
constexpr int GTN = 264;        // output columns (dpre columns) of one tile
constexpr int GBR = 32;         // batch rows per staged slab of the widest tiles
constexpr int GNT = 512;        // 16 warps: 4 of 32 rows x 4 of 9 n8 tiles
constexpr int GNTW = 9;         // n8 tiles per warp
constexpr int GSTG = 3;         // ring stages
constexpr int GSA = GTM + 8;    // act slab row stride of the widest tiles, in floats (8 mod 32)
constexpr int GSB = GTN + 16;   // dpre slab row stride of the widest tiles, in floats (24 mod 32)
constexpr int TREC = 5;         // per tile: level, unit, layer (0, 1, 2), m0, n0
constexpr int GRV = 4;          // elements a thread of a tile's last chunk adds at once

// Floats of the data kernel's dynamic shared memory before the int tables;
// the same sum as hac_fused.py:_bwd_smem_bytes.
__host__ __device__ constexpr size_t bwd_smem_floats(int d, int width, int cond_dim, int npc_max) {
  return (size_t)TTB * (3 * pad4(d) + 2 * (width + BPAD) + 1 + (1 + npc_max) * pad4(cond_dim));
}

constexpr size_t weight_smem_bytes = sizeof(float) * GSTG * GBR * (GSA + GSB);
// the epilogue's k-group sums of a whole tile (at most 16 warps' 32 rows x
// GNTW n8 tiles) and the bias partials (GNT floats at the ring's end) share
// the ring without overlap
static_assert(GNT / 32 * 32 * GNTW * 8 <= GSTG * GBR * (GSA + GSB) - GNT, "epilogue sums overlap the bias partials");

// Optional cycle profile of the data kernel (hac_fused.build(profile=True)
// compiles with HAC_BLOCK_PROFILE): every warp adds the clock64 cycles it
// spends in each phase (BPROF_* below; a phase ends at the barrier after it,
// so it holds the wait for the block's slowest warp) to hac_block_bwd_prof,
// read and cleared by hac_block_bwd_profile_read.
enum { BPROF_LOAD, BPROF_STAGE, BPROF_PROLOGUE, BPROF_DPRE2, BPROF_DPRE1, BPROF_DX, BPROF_COND, BPROF_STORE, BPROF_N };
#ifdef HAC_BLOCK_PROFILE
__device__ unsigned long long hac_block_bwd_prof[BPROF_N];
#define BPROF_START long long prof_t = clock64(); long long prof_acc[BPROF_N] = {};
#define BPROF(slot)                        \
  {                                        \
    const long long prof_now = clock64();  \
    prof_acc[slot] += prof_now - prof_t;   \
    prof_t = prof_now;                     \
  }
#define BPROF_FLUSH                                                                 \
  if ((threadIdx.x & 31) == 0)                                                      \
    for (int i = 0; i < BPROF_N; ++i) atomicAdd(&hac_block_bwd_prof[i], (unsigned long long)prof_acc[i]);
#else
#define BPROF_START
#define BPROF(slot)
#define BPROF_FLUSH
#endif

// The level's dS, dT (into S, T) and the gradient past the coupling (into
// xs, which holds the gradient of the level's output), from the saved S and
// the level's input (forward pass) or output (inverse pass); dS and dT go to
// the gradient buffer too. Rows past nrows get zeros.
__device__ __forceinline__ void coupling_grad(float* xs, float* S, float* T, const float* gl, int rows, int nrows,
                                              int dp, int d, int row0, bool rev, float cs, const float* Sg,
                                              const float* Xg, const float* Yg, float* DSg, float* DTg, int tid,
                                              int nt) {
  for (int i = tid; i < rows * dp; i += nt) {
    const int r = i / dp, c = i - r * dp;
    if (r >= nrows || c >= d) {
      S[i] = 0.f;
      T[i] = 0.f;
      continue;
    }
    const size_t e = (size_t)(row0 + r) * d + c;
    const float s = Sg[e], g = xs[i];
    const float ex = expf(cs * atanf(s));
    float dle;
    if (rev) {
      const float gx = g / ex;
      xs[i] = gx;
      T[i] = -gx;
      dle = -g * Yg[e] - gl[r];
    } else {
      xs[i] = g * ex;
      T[i] = g;
      dle = g * ex * Xg[e] + gl[r];
    }
    S[i] = dle * cs / (1.f + s * s);
    DSg[e] = S[i];
    DTg[e] = T[i];
  }
}

template <bool BF16>
__global__ void __launch_bounds__(32 * Tc<BF16>::NW, 1)
hac_block_bwd_data(const float* __restrict__ sv, float* __restrict__ gw, const float* __restrict__ gy,
                   const float* __restrict__ gld, float* __restrict__ dx, float* __restrict__ dcond, int B, int d,
                   int cond_dim, const int* __restrict__ meta_g, int meta_len, const int* __restrict__ wmeta_g,
                   int wmeta_len, const typename Wt<BF16>::T* __restrict__ wt, int width, int npc_max, int rev,
                   float cs) {
  using C = Tc<BF16>;
  using W = Wt<BF16>;
  // dS/dT (f32) . w2^T; dpre2 . w1^T and dpre1 . w0^T (bf16 values in bf16 mode)
  constexpr int M23 = BF16 ? M_BF16_A3 : M_TF32X3, M01 = BF16 ? M_BF16 : M_TF32X3;
  constexpr int KS = C::KS, FRAG = C::FRAG, NW = C::NW, NT = 32 * NW;
  extern __shared__ __align__(16) float smem[];
  const int dp = pad4(d), cp = pad4(cond_dim), as = width + BPAD, pp = npc_max * cp;
  float* xs = smem;               // [TTB][dp] the gradient g of the current level's output
  float* S = xs + TTB * dp;       // [TTB][dp] dS
  float* T = S + TTB * dp;        // [TTB][dp] dT
  float* h1 = T + TTB * dp;       // [TTB][as] a chunk's a1 (staged), then dpre1 in place
  float* h2 = h1 + TTB * as;      // [TTB][as] a chunk's a2 (staged), then dpre2 in place
  float* gl = h2 + TTB * as;      // [TTB] g_logdet
  float* dca = gl + TTB;          // [TTB][cp] condition gradient
  float* cpart = dca + TTB * cp;  // [TTB][npc_max][cp] a chunk's per-node condition gradients
  int* meta = reinterpret_cast<int*>(smem + bwd_smem_floats(d, width, cond_dim, npc_max));
  int* wmeta = meta + meta_len;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * TTB;
  const int nrows = min(TTB, B - row0);
  const size_t Bz = (size_t)B;

  BPROF_START
  for (int i = tid; i < meta_len; i += NT) meta[i] = meta_g[i];
  for (int i = tid; i < wmeta_len; i += NT) wmeta[i] = wmeta_g[i];
  for (int i = tid; i < TTB * dp; i += NT) {
    const int r = i / dp, c = i - r * dp;
    xs[i] = (r < nrows && c < d) ? gy[(size_t)(row0 + r) * d + c] : 0.f;
  }
  for (int i = tid; i < TTB * cp; i += NT) dca[i] = 0.f;
  if (tid < TTB) gl[tid] = tid < nrows ? gld[row0 + tid] : 0.f;
  __syncthreads();
  BPROF(BPROF_LOAD)

  const int L = meta[0];
  const int* nodes = meta + HDR + L * LREC;

  // both halves' A fragments of a k-step from rows of f32 values (row stride
  // `stride`, `p` at the k-step's first column of row 0): in f32 each value
  // as its TF32 high and low parts, in bf16 as one bf16 (dpre: bf16 values)
  // or as three exact bf16 parts (dS/dT); columns from `lim` on read as
  // zeros (dS/dT past a node's out: another node's values on zero weights,
  // where an Inf would make a NaN)
  auto fill = [&](const float* p, int stride, int lim, auto& A) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* q = p + (hh * 16 + (r & 1) * 8 + g) * stride;
        if constexpr (BF16) {
          const int k = (r >> 1) * 8 + 2 * tig;
          const float v0 = k < lim ? q[k] : 0.f, v1 = k + 1 < lim ? q[k + 1] : 0.f;
          if constexpr (std::is_same_v<std::decay_t<decltype(A)>, FragA<M_BF16_A3>>) bf16_split3(A, hh, r, v0, v1);
          else A.v[hh][r] = bf16_pair(v0, v1);
        } else {
          const int k = (r >> 1) * 4 + tig;
          tf32_split(A, hh, r, k < lim ? q[k] : 0.f);
        }
      }
  };

  // Stages a chunk's a1 or a2 (the saved region `src` of a level with n
  // nodes of h columns, nc nodes from i0) into `dst` with cp.async: node
  // il's s-unit at columns 2 il hs, its t-unit at (2 il + 1) hs; rows past
  // nrows as zeros. One commit group.
  auto stage = [&](float* dst, const float* src, int n, int h, int hs, int i0, int nc) {
    for (int r = warp; r < TTB; r += NW) {
      const bool ok = r < nrows;
      const float* row = src + (size_t)(row0 + (ok ? r : 0)) * (2 * n * h) + i0 * h;
      for (int u = 0; u < 2 * nc; ++u) {
        const float* from = row + ((u & 1) * n + (u >> 1)) * h;
        for (int j = lane; j < h; j += 32) cp_async4(dst + r * as + u * hs + j, from + j, ok);
      }
    }
    cp_async_commit();
  };
  for (int step = 0; step < L; ++step) {
    const int li = rev ? L - 1 - step : step;
    const int* lv = meta + HDR + li * LREC;
    const int* wl = wmeta + WHDR + li * WREC;
    const int* bt = wmeta + WHDR + L * WREC + li * BREC;
    const int n = lv[0], h = lv[1];
    const int* nd = nodes + lv[4] * NREC;
    const int k3 = bt[0], kh = bt[1], nh = bt[2], nx = bt[3], ncd = bt[4], npc = bt[5];
    const typename W::T* w2t = wt + bt[6];
    const typename W::T* w1t = wt + bt[7];
    const typename W::T* w0t = wt + bt[8];
    const int hs = nh * 8, uw = 2 * n * h, n0t = nx + ncd;
    const float* A1g = sv + Bz * wl[4];
    const float* A2g = sv + Bz * wl[5];
    float* P1g = gw + Bz * wl[6];
    float* P2g = gw + Bz * wl[7];
    // the level's output, read by the inverse pass: the next level's input or the block's output
    const float* Yg = sv + Bz * (li + 1 < L ? wmeta[WHDR + (li + 1) * WREC] : wmeta[0]);
    coupling_grad(xs, S, T, gl, TTB, nrows, dp, d, row0, rev, cs, sv + Bz * wl[1], sv + Bz * wl[0], Yg,
                  gw + Bz * wl[2], gw + Bz * wl[3], tid, NT);
    __syncthreads();
    BPROF(BPROF_PROLOGUE)

    for (int i0 = 0; i0 < n; i0 += npc) {
      const int nc = min(npc, n - i0);
      // the chunk's a2 into h2, then its a1 into h1 (needed only after dpre2)
      stage(h2, A2g, n, h, hs, i0, nc);
      stage(h1, A1g, n, h, hs, i0, nc);
      cp_async_wait<1>();
      __syncthreads();
      BPROF(BPROF_STAGE)

      // dpre2 = round(dpre3 . w2^T) * [a2 > 0], dpre3 the node's dS or dT columns
      warp_groups<NW>(2 * nc, nh, warp, [&](int ul, int tt, int nb) {
        const int il = ul >> 1, is_t = ul & 1, ni = i0 + il, u = is_t ? n + ni : ni;
        const int* node = nd + ni * NREC;
        const int out = node[2];
        const float* src = (is_t ? T : S) + node[0] + node[1];
        float acc[TNTW][2][4];
        tc_group_nb<M23>(acc, w2t + ((size_t)u * k3 * nh + tt) * FRAG, nh * FRAG, (out + KS - 1) / KS, nb, lane,
                         [&](int k0, auto& A) { fill(src + k0, dp, out - k0, A); });
#pragma unroll
        for (int i = 0; i < TNTW; ++i) {
          if (i >= nb) continue;
          const int c = (tt + i) * 8 + 2 * tig;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* q = h2 + ((j >> 1) * 8 + g) * as + ul * hs + c + (j & 1);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float* e = q + hh * 16 * as;
              *e = (c + (j & 1) < h && *e > 0.f) ? W::round(acc[i][hh][j]) : 0.f;
            }
          }
        }
      });
      cp_async_wait<0>();
      __syncthreads();
      BPROF(BPROF_DPRE2)

      // dpre2 to the gradient buffer; dpre1 = round(dpre2 . w1^T) * [a1 > 0]
      for (int half = 0; half < 2; ++half)
        save_rows(P2g + (size_t)row0 * uw + (half * n + i0) * h, uw, h2 + half * hs, as, 2 * hs, h, nc, nrows, warp,
                  NW, lane);
      warp_groups<NW>(2 * nc, nh, warp, [&](int ul, int tt, int nb) {
        const int il = ul >> 1, u = (ul & 1) ? n + i0 + il : i0 + il;
        const float* src = h2 + ul * hs;
        float acc[TNTW][2][4];
        tc_group_nb<M01>(acc, w1t + ((size_t)u * kh * nh + tt) * FRAG, nh * FRAG, kh, nb, lane,
                         [&](int k0, auto& A) { fill(src + k0, as, hs, A); });
#pragma unroll
        for (int i = 0; i < TNTW; ++i) {
          if (i >= nb) continue;
          const int c = (tt + i) * 8 + 2 * tig;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* q = h1 + ((j >> 1) * 8 + g) * as + ul * hs + c + (j & 1);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float* e = q + hh * 16 * as;
              *e = (c + (j & 1) < h && *e > 0.f) ? W::round(acc[i][hh][j]) : 0.f;
            }
          }
        }
      });
      __syncthreads();
      BPROF(BPROF_DPRE1)

      // dpre1 to the gradient buffer; d[x_upper | cond] of each node as one
      // product of K = 2 hs: its s-unit's dpre1 and w0^T stacked above its t-unit's
      for (int half = 0; half < 2; ++half)
        save_rows(P1g + (size_t)row0 * uw + (half * n + i0) * h, uw, h1 + half * hs, as, 2 * hs, h, nc, nrows, warp,
                  NW, lane);
      warp_groups<NW>(nc, n0t, warp, [&](int il, int tt, int nb) {
        const int ni = i0 + il;
        const int* node = nd + ni * NREC;
        const int off = node[0], split = node[1];
        if (tt >= (split + 7) / 8 && tt + nb <= nx) return;  // x columns past the node's split only
        const float* src = h1 + 2 * il * hs;
        float acc[TNTW][2][4];
        tc_group_nb<M01>(acc, w0t + ((size_t)ni * 2 * kh * n0t + tt) * FRAG, n0t * FRAG, 2 * kh, nb, lane,
                         [&](int k0, auto& A) { fill(src + k0, as, 2 * hs, A); });
#pragma unroll
        for (int i = 0; i < TNTW; ++i) {
          if (i >= nb) continue;
          const int t = tt + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = (t < nx ? t : t - nx) * 8 + 2 * tig + (j & 1);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = hh * 16 + (j >> 1) * 8 + g;
              if (t < nx) {
                if (c < split) xs[r * dp + off + c] += W::round(acc[i][hh][j]);
              } else if (c < cond_dim) {
                cpart[r * pp + il * cp + c] = W::round(acc[i][hh][j]);
              }
            }
          }
        }
      });
      __syncthreads();
      BPROF(BPROF_DX)

      if (cond_dim > 0) {  // the chunk's condition gradients, in node order
        for (int i = tid; i < TTB * cond_dim; i += NT) {
          const int r = i / cond_dim, k = i - r * cond_dim;
          float s = dca[r * cp + k];
          for (int il = 0; il < nc; ++il) s += cpart[r * pp + il * cp + k];
          dca[r * cp + k] = s;
        }
        __syncthreads();
        BPROF(BPROF_COND)
      }
    }
  }

  for (int i = tid; i < nrows * d; i += NT) {
    const int r = i / d, c = i - r * d;
    dx[(size_t)(row0 + r) * d + c] = xs[r * dp + c];
  }
  for (int i = tid; i < nrows * cond_dim; i += NT) {
    const int r = i / cond_dim, c = i - r * cond_dim;
    dcond[(size_t)(row0 + r) * cond_dim + c] = dca[r * cp + c];
  }
  BPROF(BPROF_STORE)
  BPROF_FLUSH
}

// -- the weight kernel --------------------------------------------------------------
// Columns [c0, c1) of a weight tile's act or dpre slab, from a row-major
// (B, stride) array.
struct Seg {
  const float* src;    // element of tile column c0 in batch row 0
  int stride, c0, c1;
  bool dpre;           // a dpre segment (else act)
};

// One tile: rows [m0, m0 + 128) x columns [n0, n0 + 264) of one unit's
// layer gradient, summed over the batch rows [r0, r1).
template <bool BF, int MODE>
__device__ __forceinline__ void weight_tile(float* gsm, const float* __restrict__ cond, int d, int cond_dim,
                                            int layer, int u,
                                            int off, int split, int out, int h, int in_rows, int M, int N, int uw,
                                            const float* act, const float* dpre, int m0, int n0, int r0, int r1,
                                            float* __restrict__ part, int n_tot, unsigned* __restrict__ arrivals,
                                            float* __restrict__ grad, int wofs, int bofs) {
  constexpr int KS = BF ? 16 : 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
  const int in_max = in_rows - cond_dim;
  const int mt = min(GTM, M - m0), ntc = min(GTN, N - n0);
  // warps as WM (32 rows each) x WN (11 n8 tiles each) x WK: a narrow tile
  // leaves warps over, which take every WK-th k-step of each slab; their
  // partial sums are added in wk order at the end (warps past WM WN WK
  // only stage)
  const int WM = mt > 64 ? 4 : (mt > 32 ? 2 : 1), WN = ntc > 216 ? 4 : (ntc > 144 ? 3 : (ntc > 72 ? 2 : 1));
  const int WK = GNT / 32 / (WM * WN);
  const int wk = warp / (WM * WN), wm = warp % (WM * WN) / WN, wn = warp % WN;
  const bool active = wk < WK;
  constexpr size_t swords = (size_t)GBR * (GSA + GSB);
  // a slab holds as many batch rows as the tile's real widths leave room
  // for in one stage (32 for the widest tiles, up to 256 for narrow ones),
  // at row strides 8 and 24 mod 32 (fragment loads without bank conflicts)
  const int sa = (mt + 23) / 32 * 32 + 8, sb = (ntc + 7) / 32 * 32 + 24;
  const int gbr = min(256, static_cast<int>(swords) / (sa + sb) / 16 * 16);
  const int nsl = (r1 - r0 + gbr - 1) / gbr;
  float acc[GNTW][2][4];
#pragma unroll
  for (int i = 0; i < GNTW; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][hh][j] = 0.f;
  // bias sums (row 0 tiles): thread t sums column t % ntc over the slab
  // rows congruent to t / ntc modulo bp; the bp partials are added in order
  const int bp = GNT / ntc, bc = tid % ntc, bq = tid / ntc;
  const bool bsum = m0 == 0 && bq < bp;
  float bacc = 0.f;

  // The real columns of the tile, as segments of row-major (B, width)
  // arrays: act is [x_upper | 0 | cond] (layer 0) or a unit's a1/a2
  // columns; dpre a unit's dpre1/dpre2 columns or its node's dS/dT
  // columns. Padding columns ([split, in_max) of act, [out, out_max) of
  // dpre) are never copied and stay at the zeros written below; batch rows
  // past the chunk are zero-filled by the copies. The table is indexed at
  // run time, so it lives in shared memory rather than in local memory.
  __shared__ Seg segs[3];
  __shared__ int nseg;
  if (tid == 0) {
    int k = 0;
    auto add = [&](bool is_b, const float* base, int stride, int lo, int hi) {
      const int t0 = is_b ? n0 : m0, t1 = t0 + (is_b ? ntc : mt);
      const int c0 = max(lo, t0), c1 = min(hi, t1);
      if (c0 < c1) segs[k++] = {base + (c0 - lo), stride, c0 - t0, c1 - t0, is_b};
    };
    if (layer == 0) {
      add(false, act + off, d, 0, split);
      if (cond_dim > 0) add(false, cond, cond_dim, in_max, in_rows);
    } else {
      add(false, act + u * h, uw, 0, h);
    }
    if (layer == 2) add(true, dpre + off + split, d, 0, out);
    else add(true, dpre + u * h, uw, 0, h);
    nseg = k;
  }

  for (int i = tid; i < GSTG * (int)swords; i += GNT) gsm[i] = 0.f;
  __syncthreads();

  auto issue = [&](int s, float* st) {
    const int bb = r0 + s * gbr;
    for (int kb = warp; kb < gbr; kb += GNT / 32) {
      const int b = bb + kb;
      const bool rowok = b < r1;
      for (int k = 0; k < nseg; ++k) {
        const Seg sg = segs[k];
        float* dst = sg.dpre ? st + gbr * sa + kb * sb : st + kb * sa;
        const float* src = sg.src + (size_t)(rowok ? b : 0) * sg.stride;
        for (int c = sg.c0 + lane; c < sg.c1; c += 32) cp_async4(dst + c, src + (c - sg.c0), rowok);
      }
    }
  };

  auto compute = [&](const float* st) {
    const float* As = st;
    const float* Bs = st + gbr * sa;
    if (active) {
#pragma unroll 1
      for (int ks = wk * KS; ks < gbr; ks += WK * KS) {
        float a[2][4][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              a[hh][r][e] = (BF || e == 0)
                                ? As[(ks + frag_k<BF>(r >> 1, e, tig)) * sa + wm * 32 + hh * 16 + (r & 1) * 8 + g]
                                : 0.f;
        FragA<MODE> A;
        A.set(a);
#pragma unroll
        for (int i = 0; i < GNTW; ++i) {
          const int nb = (wn * GNTW + i) * 8;
          if (nb < ntc) {
            float b[2][2];
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                b[r][e] = (BF || e == 0) ? Bs[(ks + frag_k<BF>(r, e, tig)) * sb + nb + g] : 0.f;
            mma_tile<MODE>(acc[i], A, b);
          }
        }
      }
    }
    if (bsum)
      for (int kb = bq; kb < gbr; kb += bp) bacc += Bs[kb * sb + bc];
  };

#pragma unroll
  for (int s = 0; s < GSTG - 1; ++s) {
    if (s < nsl) issue(s, gsm + s * swords);
    cp_async_commit();
  }
  for (int s = 0; s < nsl; ++s) {
    if (s + GSTG - 1 < nsl) issue(s + GSTG - 1, gsm + ((s + GSTG - 1) % GSTG) * swords);
    cp_async_commit();
    cp_async_wait<GSTG - 1>();
    __syncthreads();
    compute(gsm + (s % GSTG) * swords);
    __syncthreads();
  }

  // the k groups' partial sums through shared memory, added in group order
  const int RM = WM * 32, RN = WN * GNTW * 8;
  float* red = gsm;  // [WK][RM][RN] <= GNT / 32 * 32 * GNTW * 8 floats, within the ring
#pragma unroll
  for (int i = 0; i < GNTW; ++i) {
    const int nb = (wn * GNTW + i) * 8;
    if (!active || nb >= ntc) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[(wk * RM + wm * 32 + hh * 16 + (j >> 1) * 8 + g) * RN + nb + 2 * tig + (j & 1)] = acc[i][hh][j];
  }
  float* bred = gsm + GSTG * swords - GNT;  // [bp][ntc], past the k groups' sums
  if (bsum) bred[bq * ntc + bc] = bacc;
  __syncthreads();
  // the tile's sums: with one chunk the gradient, else this chunk's partials
  const int S = gridDim.x, nw = mt * ntc, nb = m0 == 0 ? ntc : 0;  // the tile's weights and biases (row-0 tiles)
  float* mine = S == 1 ? grad : part + (size_t)blockIdx.x * n_tot;
  for (int e = tid; e < nw; e += GNT) {
    const int m = e / ntc, c = e - m * ntc;
    float v = red[m * RN + c];
    for (int k = 1; k < WK; ++k) v += red[(k * RM + m) * RN + c];
    mine[wofs + (size_t)(m0 + m) * N + n0 + c] = S == 1 ? Wt<BF>::round(v) : v;
  }
  if (tid < nb) {
    float v = bred[tid];
    for (int q = 1; q < bp; ++q) v += bred[q * ntc + tid];
    mine[bofs + n0 + tid] = v;
  }
  if (S == 1) return;

  // the last chunk of the tile to arrive adds the chunks' partials in chunk order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(arrivals + blockIdx.y, 1u) == static_cast<unsigned>(S - 1);
    if (last) arrivals[blockIdx.y] = 0u;  // every chunk has arrived: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // GRV elements a thread at once, the chunks' loads of 4 chunks in flight
  // together (the block reads chunks x the tile from L2 here)
  for (int e0 = tid; e0 < nw + nb; e0 += GRV * GNT) {
    size_t at[GRV];
    float v[GRV];
#pragma unroll
    for (int j = 0; j < GRV; ++j) {
      const int e = min(e0 + j * GNT, nw + nb - 1), m = e / ntc, c = e - m * ntc;
      at[j] = e < nw ? wofs + (size_t)(m0 + m) * N + n0 + c : (size_t)bofs + n0 + (e - nw);
      v[j] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < S; ++k) {
      const float* pk = part + (size_t)k * n_tot;
      float t[GRV];
#pragma unroll
      for (int j = 0; j < GRV; ++j) t[j] = __ldcg(pk + at[j]);
#pragma unroll
      for (int j = 0; j < GRV; ++j) v[j] += t[j];
    }
#pragma unroll
    for (int j = 0; j < GRV; ++j) {
      const int e = e0 + j * GNT;
      if (e < nw + nb) grad[at[j]] = e < nw ? Wt<BF>::round(v[j]) : v[j];
    }
  }
}

template <bool BF>
__global__ void __launch_bounds__(GNT, 1)
hac_block_bwd_weights(const float* __restrict__ sv, const float* __restrict__ gw, const float* __restrict__ cond,
                      int B, int d, int cond_dim,
                      const int* __restrict__ meta, const int* __restrict__ wmeta, const int* __restrict__ tiles,
                      int rows_per_split, int n_w, int n_tot, float* __restrict__ part,
                      unsigned* __restrict__ arrivals, float* __restrict__ grad) {
  extern __shared__ __align__(16) float gsm[];
  const int* tile = tiles + blockIdx.y * TREC;
  const int li = tile[0], u = tile[1], layer = tile[2], m0 = tile[3], n0 = tile[4];
  const int L = __ldg(meta);
  const int* lv = meta + HDR + li * LREC;
  const int* wl = wmeta + WHDR + li * WREC;
  const int n = __ldg(lv), h = __ldg(lv + 1), in_rows = __ldg(lv + 2), out_max = __ldg(lv + 3);
  const int ni = u < n ? u : u - n;
  const int* node = meta + HDR + L * LREC + (__ldg(lv + 4) + ni) * NREC;
  const int off = __ldg(node), split = __ldg(node + 1), out = __ldg(node + 2);
  const int uw = 2 * n * h;
  const size_t Bz = (size_t)B;
  const int M = layer == 0 ? in_rows : h;
  const int N = layer == 2 ? out_max : h;
  // act: layer 0 the level input (and the condition), 1 a1, 2 a2; dpre: dpre1, dpre2, dS/dT
  const float* act = sv + Bz * __ldg(wl + (layer == 0 ? 0 : layer + 3));
  const float* dpre = gw + Bz * __ldg(wl + (layer == 2 ? (u < n ? 2 : 3) : 6 + layer));
  const int r0 = blockIdx.x * rows_per_split, r1 = min(B, r0 + rows_per_split);

  const int wofs = __ldg(lv + 6 + layer) + u * M * N, bofs = n_w + __ldg(lv + 9 + layer) + u * N;
  if (BF && layer == 2)  // a2 (bf16) against dS/dT (f32): the f32 side in three bf16 parts
    weight_tile<BF, M_BF16_B3>(gsm, cond, d, cond_dim, layer, u, off, split, out, h, in_rows, M, N, uw, act,
                               dpre, m0, n0, r0, r1, part, n_tot, arrivals, grad, wofs, bofs);
  else
    weight_tile<BF, BF ? M_BF16 : M_TF32X3>(gsm, cond, d, cond_dim, layer, u, off, split, out, h, in_rows, M,
                                             N, uw, act, dpre, m0, n0, r0, r1, part, n_tot, arrivals, grad, wofs,
                                             bofs);
}

template <bool BF16>
cudaError_t launch_data(const float* sv, float* gw, const float* gy, const float* gld, float* dx, float* dcond,
                        int B, int d, int cond_dim, const int* meta, int meta_len, const int* wmeta, int wmeta_len,
                        const void* wt, int width, int npc_max, int rev, float cs, cudaStream_t stream) {
  using WT = typename Wt<BF16>::T;
  const WT* w = static_cast<const WT*>(wt);
  const size_t tables = sizeof(int) * (meta_len + wmeta_len);

  const size_t smem = sizeof(float) * bwd_smem_floats(d, width, cond_dim, npc_max) + tables;
  cudaError_t e = cudaFuncSetAttribute(hac_block_bwd_data<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  hac_block_bwd_data<BF16><<<(B + TTB - 1) / TTB, 32 * Tc<BF16>::NW, smem, stream>>>(
      sv, gw, gy, gld, dx, dcond, B, d, cond_dim, meta, meta_len, wmeta, wmeta_len, w, width, npc_max, rev, cs);
  return cudaGetLastError();
}

template <bool BF>
cudaError_t launch_weights(const float* sv, const float* gw, const float* cond, int B, int d, int cond_dim, const int* meta,
                           const int* wmeta, const int* tiles, int n_tiles, int rows_per_split, int n_w, int n_tot,
                           float* part, unsigned* arrivals, float* grad, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(hac_block_bwd_weights<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)weight_smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + rows_per_split - 1) / rows_per_split, n_tiles);
  hac_block_bwd_weights<BF><<<grid, GNT, weight_smem_bytes, stream>>>(
      sv, gw, cond, B, d, cond_dim, meta, wmeta, tiles, rows_per_split, n_w, n_tot, part, arrivals, grad);
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns the CUDA error
// code (0 = launched); the wrapper counts a launch where it gets 0.
extern "C" {

// The data kernel. sv: the saved buffer the forward kernel filled (B * the
// saved floats a row of the table wmeta, f32); gw: the gradient buffer it
// fills (B * the gradient floats a row); gy, dx: (B, d) f32; dcond:
// (B, cond_dim) f32, null when cond_dim == 0; gld: (B,) f32; wt: the
// backward weight layout (hac_fused._bwd_layout), f32 or bf16 (bf16 != 0);
// width: floats per row of one hidden buffer.
int hac_block_bwd_data_launch(const float* sv, float* gw, const float* gy, const float* gld, float* dx,
                              float* dcond, int B, int d, int cond_dim, const int* meta, int meta_len,
                              const int* wmeta, int wmeta_len, const void* wt, int width, int npc_max, int rev,
                              float cs, int bf16, void* stream) {
  if (B <= 0 || cond_dim < 0 || (cond_dim > 0 && dcond == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_data<true>(sv, gw, gy, gld, dx, dcond, B, d, cond_dim, meta, meta_len, wmeta, wmeta_len, wt,
                               width, npc_max, rev, cs, s)
           : launch_data<false>(sv, gw, gy, gld, dx, dcond, B, d, cond_dim, meta, meta_len, wmeta, wmeta_len, wt,
                                width, npc_max, rev, cs, s));
}

// The weight kernel over the saved buffer (the activations) and the
// gradient buffer the data kernel filled (the dpre): n_tiles tiles x
// ceil(B / rows_per_split) row chunks; grad: n_tot = n_w weights, then
// biases, f32 (weights rounded to bf16 where bf16 != 0). With more than one
// chunk, part: chunks * n_tot f32 of scratch and arrivals: n_tiles
// counters, 0 before the launch and 0 after it (null with one chunk).
int hac_block_bwd_weights_launch(const float* sv, const float* gw, const float* cond, int B, int d, int cond_dim, const int* meta,
                                 const int* wmeta, const int* tiles, int n_tiles, int rows_per_split, int n_w,
                                 int n_tot, int bf16, float* part, unsigned* arrivals, float* grad, void* stream) {
  if (B <= 0 || n_tiles <= 0 || rows_per_split <= 0 || (cond_dim > 0 && cond == nullptr)
      || (B > rows_per_split && (part == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_weights<true>(sv, gw, cond, B, d, cond_dim, meta, wmeta, tiles, n_tiles,
                                                      rows_per_split, n_w, n_tot, part, arrivals, grad, s)
                               : launch_weights<false>(sv, gw, cond, B, d, cond_dim, meta, wmeta, tiles, n_tiles,
                                                       rows_per_split, n_w, n_tot, part, arrivals, grad, s));
}

// Copies the profile build's data-kernel cycle counters (BPROF_N of them)
// to `out` on the host and clears them; returns BPROF_N, or -1 in the
// default build.
int hac_block_bwd_profile_read(unsigned long long* out) {
#ifdef HAC_BLOCK_PROFILE
  if (cudaMemcpyFromSymbol(out, hac_block_bwd_prof, sizeof(hac_block_bwd_prof)) != cudaSuccess) return -1;
  const unsigned long long zero[BPROF_N] = {};
  if (cudaMemcpyToSymbol(hac_block_bwd_prof, zero, sizeof(zero)) != cudaSuccess) return -1;
  return BPROF_N;
#else
  (void)out;
  return -1;
#endif
}

}  // extern "C"
