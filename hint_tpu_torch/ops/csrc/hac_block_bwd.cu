// Backward of a whole hierarchical-affine-coupling (HAC) block, for Hopper
// (sm_90a): the gradients of x, the condition and every level parameter.
//
// Replaces the gradient of the Pallas kernel of hint_tpu/ops/pallas_block.py
// (fused_block's custom_vjp, _fwd/_bwd), which rematerialises through XLA's
// levelwise engine. Plain version and wrapper: hint_tpu_torch/ops/hac_fused.py
// (plain_block_grad, _run_block_grad).
//
// Three kernels, each with its own entry point, all on the caller's stream:
//
// 1. hac_block_bwd_data: one thread block per tile of BTB rows, as the
//    forward kernel.
//    Sweep 1 runs the block forward in pass order (the rematerialisation)
//    and writes each level's input x_l and scale pre-activation S, every
//    unit's a1 and a2, and the block's output to a workspace in device
//    memory.
//    Sweep 2 walks the levels in reverse pass order. Per level, with
//    le = cs*atan(S), forward pass y = e^le x + T:
//      dx = g e^le, dT = g, dle = g e^le x + g_ld;
//    inverse pass y = (x - T) e^-le:
//      dx = g / e^le, dT = -g / e^le, dle = -g y - g_ld;
//    dS = dle cs / (1 + S^2). Then per chunk of nodes (a node's s- and
//    t-unit always share a chunk):
//      dpre3 = (dS | dT)[off+split : off+split+out]
//      dpre2 = round(dpre3 . w2^T) * [a2 > 0]
//      dpre1 = round(dpre2 . w1^T) * [a1 > 0]
//      d[x_upper | cond] = round(dpre1_s . w0_s^T + dpre1_t . w0_t^T)
//    where round is the identity in f32 and rounds to bf16 in bf16 mode
//    (the backward of the plain version's operand rounding). The x part is
//    added to dx on the node's upper segment (no two nodes of a level share
//    one); the condition part is summed over the chunk's nodes in node order,
//    chunk after chunk, level after level. No atomics: every sum has a fixed
//    order, so two calls give the same bits. dS, dT, dpre1 and dpre2 go to
//    the workspace. The transposed weights (packed by the wrapper) make the
//    products w^T coalesced like the forward's.
// 2. hac_block_bwd_weights: dw = sum_b act^T dpre for every unit and layer
//    (act = [x_upper | 0 | cond], a1, a2; dpre = dpre1, dpre2, dpre3) and
//    db = sum_b dpre, over output tiles of GTM = 128 rows by up to GTN = 264
//    columns (a unit's whole N up to 264; a table of tiles from the
//    wrapper), each split over row chunks of `rows_per_split`. Partials go
//    to [splits][n_weights + n_biases]. Padding gets exact zeros: act is 0
//    on the rows [split, in_max) of w0, dpre3 on the columns [out, out_max)
//    of w2/b2.
// 3. hac_block_bwd_reduce: the sum over the splits in split order, rounded
//    to bf16 for weights in bf16 mode (the plain version rounds each weight
//    gradient once, after the whole-batch sum; biases are not rounded),
//    written in the packed weights | biases order.
//
// Bound on the card: the data kernel by f32 operations on the CUDA cores
// (the forward's products twice: sweep 1 repeats the forward, the reverse
// chain takes each once more); the weight kernel by the bytes of the
// workspace (~100 KB per row for the flagship block) that the data kernel
// writes and it reads, once its products, a third copy of the forward's,
// run on the tensor cores.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hac_common.cuh"

namespace {

constexpr int BTB = 16;        // batch rows per data thread block
constexpr int BRT = 8;         // rows per thread work item
constexpr int BRG = BTB / BRT; // row groups per tile
constexpr int BNT = 256;       // threads per data block

// int32 workspace table, written by hac_fused.py:_pack_bwd. Every entry but
// npc is an offset in floats per batch row: region r of row width w starts
// at ws + B * r, row b at + b * w.
constexpr int WHDR = 2;  // y (block output, width d), floats per row in all
constexpr int WREC = 9;  // per level: x, s, ds, dt (width d); a1, a2, p1, p2
                         // (width 2 n h); npc (nodes per chunk)

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

// Floats of the data kernel's dynamic shared memory before the int tables;
// the same sum as hac_fused.py:_bwd_smem_bytes.
__host__ __device__ constexpr size_t bwd_smem_floats(int d, int bwidth, int cond_dim, int npc_max) {
  return (size_t)BTB * (3 * pad4(d) + 2 * bwidth + 1 + (2 + npc_max) * pad4(cond_dim));
}

constexpr size_t weight_smem_bytes = sizeof(float) * GSTG * GBR * (GSA + GSB);

template <bool BF16>
__global__ void __launch_bounds__(BNT, 2)
hac_block_bwd_data(const float* __restrict__ x, const float* __restrict__ cond,
                   const float* __restrict__ gy, const float* __restrict__ gld,
                   float* __restrict__ dx, float* __restrict__ dcond, int B, int d, int cond_dim,
                   const int* __restrict__ meta_g, int meta_len, const int* __restrict__ wmeta_g,
                   int wmeta_len, const typename Wt<BF16>::T* __restrict__ wbuf,
                   const typename Wt<BF16>::T* __restrict__ wtbuf, const float* __restrict__ bbuf,
                   int bwidth, int npc_max, int rev, float cs, float* ws) {
  using W = Wt<BF16>;
  using WT = typename W::T;
  extern __shared__ __align__(16) float smem[];
  const int dp = pad4(d), cp = pad4(cond_dim), bw = bwidth, pp = npc_max * cp;
  float* xs = smem;              // [BTB][dp] sweep 1: rows; sweep 2: the gradient g
  float* S = xs + BTB * dp;      // [BTB][dp] sweep 1: S; sweep 2: dS
  float* T = S + BTB * dp;       // [BTB][dp] sweep 1: T; sweep 2: dT
  float* h1 = T + BTB * dp;      // [BTB][bw] sweep 1: a1; sweep 2: dpre1
  float* h2 = h1 + BTB * bw;     // [BTB][bw] sweep 1: a2; sweep 2: dpre2
  float* gl = h2 + BTB * bw;     // [BTB] g_logdet
  float* cnd = gl + BTB;         // [BTB][cp] condition rows
  float* dca = cnd + BTB * cp;   // [BTB][cp] condition gradient
  float* cpart = dca + BTB * cp; // [BTB][npc_max][cp] a chunk's per-node condition gradients
  int* meta = reinterpret_cast<int*>(smem + bwd_smem_floats(d, bw, cond_dim, npc_max));
  int* wmeta = meta + meta_len;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BTB;
  const int nrows = min(BTB, B - row0);
  const size_t Bz = (size_t)B;

  for (int i = tid; i < meta_len; i += BNT) meta[i] = meta_g[i];
  for (int i = tid; i < wmeta_len; i += BNT) wmeta[i] = wmeta_g[i];
  for (int i = tid; i < BTB * dp; i += BNT) {
    const int r = i / dp, c = i - r * dp;
    xs[i] = (r < nrows && c < d) ? x[(size_t)(row0 + r) * d + c] : 0.f;
  }
  for (int i = tid; i < BTB * cp; i += BNT) {
    const int r = i / cp, c = i - r * cp;
    cnd[i] = (r < nrows && c < cond_dim) ? cond[(size_t)(row0 + r) * cond_dim + c] : 0.f;
    dca[i] = 0.f;
  }
  if (tid < BTB) gl[tid] = tid < nrows ? gld[row0 + tid] : 0.f;
  __syncthreads();

  const int L = meta[0];
  const int* nodes = meta + HDR + L * LREC;

  // -- sweep 1: the block forward in pass order, saving what sweep 2 reads --
  for (int step = 0; step < L; ++step) {
    const int li = rev ? step : L - 1 - step;
    const int* lv = meta + HDR + li * LREC;
    const int* wl = wmeta + WHDR + li * WREC;
    const int n = lv[0], h = lv[1], in_rows = lv[2], out_max = lv[3];
    const int* nd = nodes + lv[4] * NREC;
    const WT* w0 = wbuf + lv[6];
    const WT* w1 = wbuf + lv[7];
    const WT* w2 = wbuf + lv[8];
    const float* b0 = bbuf + lv[9];
    const float* b1 = bbuf + lv[10];
    const float* b2 = bbuf + lv[11];
    const int hp = pad4(h), in_max = in_rows - cond_dim, npc = wl[8], uw = 2 * n * h;
    float* Xg = ws + Bz * wl[0];
    float* A1g = ws + Bz * wl[4];
    float* A2g = ws + Bz * wl[5];

    for (int i = tid; i < nrows * d; i += BNT) {
      const int r = i / d, c = i - r * d;
      Xg[(size_t)(row0 + r) * d + c] = xs[r * dp + c];
    }
    for (int i = tid; i < BTB * dp; i += BNT) {
      S[i] = 0.f;
      T[i] = 0.f;
    }

    for (int i0 = 0; i0 < n; i0 += npc) {
      const int nc = min(npc, n - i0);
      const int cols = 2 * nc * h;

      // layer 1 (the forward kernel's loop)
      for (int it = tid; it < BRG * cols; it += BNT) {
        const int g = it / cols, c = it - g * cols;
        const int ul = c / h, j = c - ul * h;
        const int ni = i0 + (ul < nc ? ul : ul - nc), u = ul < nc ? ni : n + ni;
        const int* node = nd + ni * NREC;
        const int off = node[0], split = node[1];
        float acc[BRT];
        const float bias = b0[u * h + j];
#pragma unroll
        for (int r = 0; r < BRT; ++r) acc[r] = bias;
        const WT* w = w0 + (size_t)u * in_rows * h + j;
        const float* xr = xs + g * BRT * dp + off;
        for (int k = 0; k < split; ++k) {
          const float wk = W::load(w + (size_t)k * h);
#pragma unroll
          for (int r = 0; r < BRT; ++r) acc[r] = fmaf(W::round(xr[r * dp + k]), wk, acc[r]);
        }
        const float* cr = cnd + g * BRT * cp;
        for (int k = 0; k < cond_dim; ++k) {
          const float wk = W::load(w + (size_t)(in_max + k) * h);
#pragma unroll
          for (int r = 0; r < BRT; ++r) acc[r] = fmaf(W::round(cr[r * cp + k]), wk, acc[r]);
        }
        float* out = h1 + g * BRT * bw + ul * hp + j;
#pragma unroll
        for (int r = 0; r < BRT; ++r) {
          const float v = W::round(fmaxf(acc[r], 0.f));
          out[r * bw] = v;
          const int rr = g * BRT + r;
          if (rr < nrows) A1g[(size_t)(row0 + rr) * uw + u * h + j] = v;
        }
      }
      __syncthreads();

      // layer 2
      for (int it = tid; it < BRG * cols; it += BNT) {
        const int g = it / cols, c = it - g * cols;
        const int ul = c / h, j = c - ul * h;
        const int ni = i0 + (ul < nc ? ul : ul - nc), u = ul < nc ? ni : n + ni;
        float acc[BRT];
        const float bias = b1[u * h + j];
#pragma unroll
        for (int r = 0; r < BRT; ++r) acc[r] = bias;
        const WT* w = w1 + (size_t)u * h * h + j;
        const float* ar = h1 + g * BRT * bw + ul * hp;
        int k = 0;
        for (; k + 4 <= h; k += 4) {
          const float wa = W::load(w + (size_t)k * h);
          const float wb = W::load(w + (size_t)(k + 1) * h);
          const float wc = W::load(w + (size_t)(k + 2) * h);
          const float wd = W::load(w + (size_t)(k + 3) * h);
#pragma unroll
          for (int r = 0; r < BRT; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(ar + r * bw + k);
            acc[r] = fmaf(a.x, wa, acc[r]);
            acc[r] = fmaf(a.y, wb, acc[r]);
            acc[r] = fmaf(a.z, wc, acc[r]);
            acc[r] = fmaf(a.w, wd, acc[r]);
          }
        }
        for (; k < h; ++k) {
          const float wk = W::load(w + (size_t)k * h);
#pragma unroll
          for (int r = 0; r < BRT; ++r) acc[r] = fmaf(ar[r * bw + k], wk, acc[r]);
        }
        float* out = h2 + g * BRT * bw + ul * hp + j;
#pragma unroll
        for (int r = 0; r < BRT; ++r) {
          const float v = W::round(fmaxf(acc[r], 0.f));
          out[r * bw] = v;
          const int rr = g * BRT + r;
          if (rr < nrows) A2g[(size_t)(row0 + rr) * uw + u * h + j] = v;
        }
      }
      __syncthreads();

      // layer 3: only the node's `out_i` real columns of w2/b2
      const int cols3 = 2 * nc * out_max;
      for (int it = tid; it < BRG * cols3; it += BNT) {
        const int g = it / cols3, c = it - g * cols3;
        const int ul = c / out_max, m = c - ul * out_max;
        const bool is_t = ul >= nc;
        const int ni = i0 + (is_t ? ul - nc : ul), u = is_t ? n + ni : ni;
        const int* node = nd + ni * NREC;
        if (m >= node[2]) continue;
        float acc[BRT];
        const float bias = b2[u * out_max + m];
#pragma unroll
        for (int r = 0; r < BRT; ++r) acc[r] = bias;
        const WT* w = w2 + (size_t)u * h * out_max + m;
        const float* ar = h2 + g * BRT * bw + ul * hp;
        int k = 0;
        for (; k + 4 <= h; k += 4) {
          const float wa = W::load(w + (size_t)k * out_max);
          const float wb = W::load(w + (size_t)(k + 1) * out_max);
          const float wc = W::load(w + (size_t)(k + 2) * out_max);
          const float wd = W::load(w + (size_t)(k + 3) * out_max);
#pragma unroll
          for (int r = 0; r < BRT; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(ar + r * bw + k);
            acc[r] = fmaf(a.x, wa, acc[r]);
            acc[r] = fmaf(a.y, wb, acc[r]);
            acc[r] = fmaf(a.z, wc, acc[r]);
            acc[r] = fmaf(a.w, wd, acc[r]);
          }
        }
        for (; k < h; ++k) {
          const float wk = W::load(w + (size_t)k * out_max);
#pragma unroll
          for (int r = 0; r < BRT; ++r) acc[r] = fmaf(ar[r * bw + k], wk, acc[r]);
        }
        float* dst = (is_t ? T : S) + g * BRT * dp + node[0] + node[1] + m;
#pragma unroll
        for (int r = 0; r < BRT; ++r) dst[r * dp] = acc[r];
      }
      __syncthreads();
    }

    // save S, then couple every row in place
    float* Sg = ws + Bz * wl[1];
    for (int i = tid; i < BTB * dp; i += BNT) {
      const int r = i / dp, c = i - r * dp;
      if (r >= nrows || c >= d) continue;
      Sg[(size_t)(row0 + r) * d + c] = S[i];
      const float le = cs * atanf(S[i]);
      xs[i] = rev ? (xs[i] - T[i]) / expf(le) : expf(le) * xs[i] + T[i];
    }
    __syncthreads();
  }
  {
    float* Yg = ws + Bz * wmeta[0];
    for (int i = tid; i < nrows * d; i += BNT) {
      const int r = i / d, c = i - r * d;
      Yg[(size_t)(row0 + r) * d + c] = xs[r * dp + c];
    }
  }
  for (int i = tid; i < BTB * dp; i += BNT) {
    const int r = i / dp, c = i - r * dp;
    xs[i] = (r < nrows && c < d) ? gy[(size_t)(row0 + r) * d + c] : 0.f;
  }
  __syncthreads();

  // -- sweep 2: the levels in reverse pass order ---------------------------
  for (int step = 0; step < L; ++step) {
    const int li = rev ? L - 1 - step : step;
    const int* lv = meta + HDR + li * LREC;
    const int* wl = wmeta + WHDR + li * WREC;
    const int n = lv[0], h = lv[1], in_rows = lv[2], out_max = lv[3];
    const int* nd = nodes + lv[4] * NREC;
    const WT* wt0 = wtbuf + lv[6];
    const WT* wt1 = wtbuf + lv[7];
    const WT* wt2 = wtbuf + lv[8];
    const int hp = pad4(h), in_max = in_rows - cond_dim, npc = wl[8], uw = 2 * n * h;
    const float* Xg = ws + Bz * wl[0];
    const float* Sg = ws + Bz * wl[1];
    float* DSg = ws + Bz * wl[2];
    float* DTg = ws + Bz * wl[3];
    const float* A1g = ws + Bz * wl[4];
    const float* A2g = ws + Bz * wl[5];
    float* P1g = ws + Bz * wl[6];
    float* P2g = ws + Bz * wl[7];
    // the level's output, read by the inverse pass: the next level's input or the block's output
    const float* Yg = ws + Bz * (li + 1 < L ? wmeta[WHDR + (li + 1) * WREC] : wmeta[0]);

    for (int i = tid; i < BTB * dp; i += BNT) {
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
    __syncthreads();

    for (int i0 = 0; i0 < n; i0 += npc) {
      const int nc = min(npc, n - i0);
      const int cols = 2 * nc * h;

      // dpre2 = round(dpre3 . w2^T) * [a2 > 0]
      for (int it = tid; it < BRG * cols; it += BNT) {
        const int g = it / cols, c = it - g * cols;
        const int ul = c / h, k = c - ul * h;
        const bool is_t = ul >= nc;
        const int ni = i0 + (is_t ? ul - nc : ul), u = is_t ? n + ni : ni;
        const int* node = nd + ni * NREC;
        const int out = node[2];
        float acc[BRT];
#pragma unroll
        for (int r = 0; r < BRT; ++r) acc[r] = 0.f;
        const WT* w = wt2 + (size_t)u * out_max * h + k;
        const float* dr = (is_t ? T : S) + g * BRT * dp + node[0] + node[1];
        for (int m = 0; m < out; ++m) {
          const float wk = W::load(w + (size_t)m * h);
#pragma unroll
          for (int r = 0; r < BRT; ++r) acc[r] = fmaf(dr[r * dp + m], wk, acc[r]);
        }
        float* o = h2 + g * BRT * bw + ul * hp + k;
#pragma unroll
        for (int r = 0; r < BRT; ++r) {
          const int rr = g * BRT + r;
          float v = 0.f;
          if (rr < nrows) {
            const size_t e = (size_t)(row0 + rr) * uw + u * h + k;
            v = A2g[e] > 0.f ? W::round(acc[r]) : 0.f;
            P2g[e] = v;
          }
          o[r * bw] = v;
        }
      }
      __syncthreads();

      // dpre1 = round(dpre2 . w1^T) * [a1 > 0]
      for (int it = tid; it < BRG * cols; it += BNT) {
        const int g = it / cols, c = it - g * cols;
        const int ul = c / h, k = c - ul * h;
        const int u = ul < nc ? i0 + ul : n + i0 + ul - nc;
        float acc[BRT];
#pragma unroll
        for (int r = 0; r < BRT; ++r) acc[r] = 0.f;
        const WT* w = wt1 + (size_t)u * h * h + k;
        const float* pr = h2 + g * BRT * bw + ul * hp;
        int j = 0;
        for (; j + 4 <= h; j += 4) {
          const float wa = W::load(w + (size_t)j * h);
          const float wb = W::load(w + (size_t)(j + 1) * h);
          const float wc = W::load(w + (size_t)(j + 2) * h);
          const float wd = W::load(w + (size_t)(j + 3) * h);
#pragma unroll
          for (int r = 0; r < BRT; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(pr + r * bw + j);
            acc[r] = fmaf(a.x, wa, acc[r]);
            acc[r] = fmaf(a.y, wb, acc[r]);
            acc[r] = fmaf(a.z, wc, acc[r]);
            acc[r] = fmaf(a.w, wd, acc[r]);
          }
        }
        for (; j < h; ++j) {
          const float wk = W::load(w + (size_t)j * h);
#pragma unroll
          for (int r = 0; r < BRT; ++r) acc[r] = fmaf(pr[r * bw + j], wk, acc[r]);
        }
        float* o = h1 + g * BRT * bw + ul * hp + k;
#pragma unroll
        for (int r = 0; r < BRT; ++r) {
          const int rr = g * BRT + r;
          float v = 0.f;
          if (rr < nrows) {
            const size_t e = (size_t)(row0 + rr) * uw + u * h + k;
            v = A1g[e] > 0.f ? W::round(acc[r]) : 0.f;
            P1g[e] = v;
          }
          o[r * bw] = v;
        }
      }
      __syncthreads();

      // d[x_upper | cond] of each node: its s-unit's sum, then its t-unit's
      for (int it = tid; it < BRG * nc * in_rows; it += BNT) {
        const int g = it / (nc * in_rows), c = it - g * (nc * in_rows);
        const int il = c / in_rows, kk = c - il * in_rows;
        const int ni = i0 + il;
        const int* node = nd + ni * NREC;
        if (kk >= node[1] && kk < in_max) continue;  // padding rows of w0
        float acc[BRT];
#pragma unroll
        for (int r = 0; r < BRT; ++r) acc[r] = 0.f;
        for (int which = 0; which < 2; ++which) {
          const int u = which ? n + ni : ni, ul = which ? nc + il : il;
          const WT* w = wt0 + (size_t)u * h * in_rows + kk;
          const float* pr = h1 + g * BRT * bw + ul * hp;
          int j = 0;
          for (; j + 4 <= h; j += 4) {
            const float wa = W::load(w + (size_t)j * in_rows);
            const float wb = W::load(w + (size_t)(j + 1) * in_rows);
            const float wc = W::load(w + (size_t)(j + 2) * in_rows);
            const float wd = W::load(w + (size_t)(j + 3) * in_rows);
#pragma unroll
            for (int r = 0; r < BRT; ++r) {
              const float4 a = *reinterpret_cast<const float4*>(pr + r * bw + j);
              acc[r] = fmaf(a.x, wa, acc[r]);
              acc[r] = fmaf(a.y, wb, acc[r]);
              acc[r] = fmaf(a.z, wc, acc[r]);
              acc[r] = fmaf(a.w, wd, acc[r]);
            }
          }
          for (; j < h; ++j) {
            const float wk = W::load(w + (size_t)j * in_rows);
#pragma unroll
            for (int r = 0; r < BRT; ++r) acc[r] = fmaf(pr[r * bw + j], wk, acc[r]);
          }
        }
        if (kk < in_max) {
          float* o = xs + g * BRT * dp + node[0] + kk;
#pragma unroll
          for (int r = 0; r < BRT; ++r) o[r * dp] += W::round(acc[r]);
        } else {
          float* o = cpart + g * BRT * pp + il * cp + (kk - in_max);
#pragma unroll
          for (int r = 0; r < BRT; ++r) o[r * pp] = W::round(acc[r]);
        }
      }
      __syncthreads();

      if (cond_dim > 0) {
        for (int i = tid; i < BTB * cond_dim; i += BNT) {
          const int r = i / cond_dim, k = i - r * cond_dim;
          float s = dca[r * cp + k];
          for (int il = 0; il < nc; ++il) s += cpart[r * pp + il * cp + k];
          dca[r * cp + k] = s;
        }
        __syncthreads();
      }
    }
  }

  for (int i = tid; i < nrows * d; i += BNT) {
    const int r = i / d, c = i - r * d;
    dx[(size_t)(row0 + r) * d + c] = xs[r * dp + c];
  }
  for (int i = tid; i < nrows * cond_dim; i += BNT) {
    const int r = i / cond_dim, c = i - r * cond_dim;
    dcond[(size_t)(row0 + r) * cond_dim + c] = dca[r * cp + c];
  }
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
                                            float* __restrict__ dst, int wofs, int bofs) {
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
  float* red = gsm;  // [WK][RM][RN] <= GNT / 32 * 32 * 88 floats, within the ring
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
  for (int e = tid; e < mt * ntc; e += GNT) {
    const int m = e / ntc, c = e - m * ntc;
    float v = red[m * RN + c];
    for (int k = 1; k < WK; ++k) v += red[(k * RM + m) * RN + c];
    dst[wofs + (size_t)(m0 + m) * N + n0 + c] = v;
  }
  if (m0 == 0 && tid < ntc) {
    float v = bred[tid];
    for (int q = 1; q < bp; ++q) v += bred[q * ntc + tid];
    dst[bofs + n0 + tid] = v;
  }
}

template <bool BF>
__global__ void __launch_bounds__(GNT, 1)
hac_block_bwd_weights(const float* __restrict__ ws, const float* __restrict__ cond, int B, int d, int cond_dim,
                      const int* __restrict__ meta, const int* __restrict__ wmeta, const int* __restrict__ tiles,
                      int rows_per_split, int n_w, int n_tot, float* __restrict__ part) {
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
  const float* act = ws + Bz * __ldg(wl + (layer == 0 ? 0 : layer + 3));
  const float* dpre = ws + Bz * __ldg(wl + (layer == 2 ? (u < n ? 2 : 3) : 6 + layer));
  const int r0 = blockIdx.x * rows_per_split, r1 = min(B, r0 + rows_per_split);

  float* dst = part + (size_t)blockIdx.x * n_tot;
  const int wofs = __ldg(lv + 6 + layer) + u * M * N, bofs = n_w + __ldg(lv + 9 + layer) + u * N;
  if (BF && layer == 2)  // a2 (bf16) against dS/dT (f32): the f32 side in three bf16 parts
    weight_tile<BF, M_BF16_B3>(gsm, cond, d, cond_dim, layer, u, off, split, out, h, in_rows, M, N, uw, act,
                               dpre, m0, n0, r0, r1, dst, wofs, bofs);
  else
    weight_tile<BF, BF ? M_BF16 : M_TF32X3>(gsm, cond, d, cond_dim, layer, u, off, split, out, h, in_rows, M,
                                             N, uw, act, dpre, m0, n0, r0, r1, dst, wofs, bofs);
}

template <bool BF16>
__global__ void hac_block_bwd_reduce(const float* __restrict__ part, int splits, int n_w, int n_tot,
                                     float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tot) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n_tot + i];
  grad[i] = (BF16 && i < n_w) ? Wt<true>::round(s) : s;
}

template <bool BF16>
cudaError_t launch_data(const float* x, const float* cond, const float* gy, const float* gld,
                        float* dx, float* dcond, int B, int d, int cond_dim, const int* meta,
                        int meta_len, const int* wmeta, int wmeta_len, const void* wbuf,
                        const void* wtbuf, const float* bbuf, int bwidth, int npc_max, int rev,
                        float cs, float* ws, cudaStream_t stream) {
  using WT = typename Wt<BF16>::T;
  const size_t smem = sizeof(float) * bwd_smem_floats(d, bwidth, cond_dim, npc_max) +
                      sizeof(int) * (meta_len + wmeta_len);
  cudaError_t e = cudaFuncSetAttribute(hac_block_bwd_data<BF16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  hac_block_bwd_data<BF16><<<(B + BTB - 1) / BTB, BNT, smem, stream>>>(
      x, cond, gy, gld, dx, dcond, B, d, cond_dim, meta, meta_len, wmeta, wmeta_len,
      static_cast<const WT*>(wbuf), static_cast<const WT*>(wtbuf), bbuf, bwidth, npc_max, rev, cs,
      ws);
  return cudaGetLastError();
}

template <bool BF>
cudaError_t launch_weights(const float* ws, const float* cond, int B, int d, int cond_dim, const int* meta,
                           const int* wmeta, const int* tiles, int n_tiles, int rows_per_split, int n_w, int n_tot,
                           float* part, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(hac_block_bwd_weights<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)weight_smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + rows_per_split - 1) / rows_per_split, n_tiles);
  hac_block_bwd_weights<BF><<<grid, GNT, weight_smem_bytes, stream>>>(ws, cond, B, d, cond_dim, meta, wmeta, tiles,
                                                                      rows_per_split, n_w, n_tot, part);
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns the CUDA error
// code (0 = launched); the wrapper counts a launch where it gets 0.
extern "C" {

// The data kernel. x, gy, dx: (B, d) f32; cond, dcond: (B, cond_dim) f32,
// null when cond_dim == 0; gld: (B,) f32; wbuf/wtbuf: the packed weights and
// their per-unit transposes, f32 or bf16 (bf16 != 0); bbuf: f32 biases; ws:
// B * (floats per row of the workspace table) f32.
int hac_block_bwd_data_launch(const float* x, const float* cond, const float* gy,
                              const float* gld, float* dx, float* dcond, int B, int d,
                              int cond_dim, const int* meta, int meta_len, const int* wmeta,
                              int wmeta_len, const void* wbuf, const void* wtbuf,
                              const float* bbuf, int bwidth, int npc_max, int rev, float cs,
                              int bf16, float* ws, void* stream) {
  if (B <= 0 || cond_dim < 0 || (cond_dim > 0 && (cond == nullptr || dcond == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_data<true>(x, cond, gy, gld, dx, dcond, B, d, cond_dim, meta, meta_len, wmeta,
                               wmeta_len, wbuf, wtbuf, bbuf, bwidth, npc_max, rev, cs, ws, s)
           : launch_data<false>(x, cond, gy, gld, dx, dcond, B, d, cond_dim, meta, meta_len,
                                wmeta, wmeta_len, wbuf, wtbuf, bbuf, bwidth, npc_max, rev, cs,
                                ws, s));
}

// The weight kernel over a workspace the data kernel filled: n_tiles tiles
// x ceil(B / rows_per_split) row chunks; part: chunks * n_tot f32.
int hac_block_bwd_weights_launch(const float* ws, const float* cond, int B, int d, int cond_dim, const int* meta,
                                 const int* wmeta, const int* tiles, int n_tiles, int rows_per_split, int n_w,
                                 int n_tot, int bf16, float* part, void* stream) {
  if (B <= 0 || n_tiles <= 0 || rows_per_split <= 0 || (cond_dim > 0 && cond == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_weights<true>(ws, cond, B, d, cond_dim, meta, wmeta, tiles, n_tiles,
                                                      rows_per_split, n_w, n_tot, part, s)
                               : launch_weights<false>(ws, cond, B, d, cond_dim, meta, wmeta, tiles, n_tiles,
                                                       rows_per_split, n_w, n_tot, part, s));
}

// The sum of `splits` partials in split order into grad: n_tot f32
// (weights, then biases; weights rounded to bf16 where bf16 != 0).
int hac_block_bwd_reduce_launch(const float* part, int splits, int n_w, int n_tot, int bf16,
                                float* grad, void* stream) {
  if (splits <= 0 || n_tot <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n_tot + 255) / 256;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    hac_block_bwd_reduce<true><<<blocks, 256, 0, s>>>(part, splits, n_w, n_tot, grad);
  else
    hac_block_bwd_reduce<false><<<blocks, 256, 0, s>>>(part, splits, n_w, n_tot, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
