// Whole hierarchical-affine-coupling (HAC) block in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of hint_tpu/ops/pallas_block.py:_fused_call
// (body _kernel_factory.kernel). Plain version and wrapper:
// hint_tpu_torch/ops/hac_fused.py.
//
// What both routes compute. One thread block owns a tile of rows of the
// batch. The rows, the level's S/T buffers and two hidden-activation buffers
// live in shared memory for the whole block; nothing but x, y, logdet and the
// weights touches device memory. Per tree level (bottom-up forward, top-down
// inverse) the level's 2n subnet units (s-subnets 0..n-1, then t-subnets
// n..2n-1) run in chunks of `upc` units:
//   layer 1  a1 = relu(x[off : off+split] . w0[u][:split]
//                      + cond . w0[u][in_max : in_max+cond_dim] + b0[u])
//   layer 2  a2 = relu(a1 . w1[u] + b1[u])
//   layer 3  S/T[off+split+m] = a2 . w2[u][:, m] + b2[u][m],  m < out_i
// then every row is coupled in place: log_e = clamp*0.636*atan(S),
// forward x = exp(log_e)*x + T, inverse x = (x - T)/exp(log_e), and
// logdet += / -= sum(log_e). S and T are zero outside the level's lower
// segments, where atan(0) = 0 leaves x exactly unchanged. Padded rows
// [split, in_max) of w0 and padded columns [out, out_max) of w2/b2 hold
// arbitrary values after a trainer's update and never reach a result.
//
// Condition-fed blocks (cond_dim > 0, the c_ref variant of the Pallas kernel):
// every subnet's input is its node's upper segment followed by the condition.
// The tile's condition rows sit in shared memory for the whole block; the
// Pallas kernel's extra dense dot c @ W1[d:] per level becomes cond_dim more
// terms of layer 1. The condition rows of w0[u] start at in_max, the level's
// widest split, not at the node's own split.
//
// bf16 mode: weights arrive pre-cast to bf16; every layer input is rounded
// to bf16 and products accumulate in f32 (JAX's preferred_element_type=f32).
// Biases and the coupling stay f32.
//
// Saving forward (training): given the saved buffer `sv` and the workspace
// table `wm` (hac_common.cuh), the loop route also writes what the backward
// kernels read: each level's input x_l and S, each unit's a1 and a2 and the
// block's output. A SAVE template parameter keeps every trace of it out of
// the serving kernels (sv == nullptr). A saving forward takes the loop in
// both modes (SAVE_ROUTE below, hac_fused._SAVE_ROUTE): its exact f32 FMA
// chains keep the backward's gradients within twice the f32 plain version's
// error against float64 (chip_smoke.py phase 5's gate) on more random draws
// than tensor-core activations do, whether by 3xTF32 or with both f32
// operands split exactly into bf16 parts: the tensor cores' truncating sums
// within a k-step, not their products, set that error (PERF.md). The
// tensor-core route serves only, and refuses a saved buffer.
//   What bounds a saving forward: the bytes it saves, ~51 KB a row for the
//   flagship block (0.52 GB at batch 10,000, 0.156 ms at 3.35 TB/s), against
//   a pass that moves ~800 bytes a row otherwise, and the loop's f32 FMAs.
//   A save that stopped the warps after each layer to copy the rows out of
//   shared memory cost ~0.4 ms more than the pass without it. So the loop
//   stores a1 and a2 from the registers they are made in, as each thread
//   finishes its 8 rows: neighbouring threads hold neighbouring columns of a
//   row, so a warp's store is 32 neighbouring floats, with no barrier and no
//   second pass over shared memory, and the stores overlap other warps'
//   FMAs. x_l and S go out in the coupling loop as it reads them, the output
//   with y. Every store is streamed (st.global.cs): the saved rows are read
//   back only by the backward, and would otherwise push the weights out of
//   L2.
//
// Two routes behind one entry point; hac_block_launch takes ROUTE_F32 (the
// tensor cores) or ROUTE_BF16 (the loop) to serve and SAVE_ROUTE (the loop)
// to save; hac_block_launch_route names one:
//
// ROUTE_TC, hac_block_kernel: every product on the tensor cores (mma.sync).
//   Bound: the operations on the route (3 TF32 products per f32 product at
//   495 TFLOP/s; bf16 at 989) and the weights each 32-row tile reads from L2
//   (~4.5 MB of padded f32 high/low parts, ~1.3 MB of bf16, per flagship
//   block). Measured, it is bound by neither: by the instructions around the
//   products (fragment loads and splits, per-k-step adds, each group's and
//   chunk's set-up), a cycle profile says (build(profile=True)).
//   - f32 takes 3xTF32: each operand is split into a TF32 high part and a
//     TF32 remainder (cvt.rn), and lo.hi + hi.lo + hi.hi is summed from zero
//     for each k-step, then added to the running sum by a rounding f32 add:
//     the tensor cores add with truncation, and with one accumulator along
//     K (up to 34 k-steps) the error against the plain version grew ~4x.
//     The weights arrive split (the wrapper does it once per parameter
//     version); the activations are split as they are read.
//   - bf16 multiplies the bf16 layer inputs and the bf16 weights as they are
//     (m16n8k16), each k-step's products from zero, then a rounding add as
//     in f32: the truncation's one-sided bias, though ~1e-6 relative, tips
//     bf16 roundings of the next layer's inputs one way, and one
//     accumulator along K doubled the worst error against the plain version
//     (x-lane block, inverse). a1/a2 are kept as bf16 in shared memory (they
//     are bf16 values), which halves their room.
//   - Weights come from a padded layout of their own that the wrapper builds
//     once per parameter version, on the route's first launch
//     (hac_fused._tc_layout, _tc_packed): per unit and layer, K padded to the
//     k-step and N to n8 with zeros in every pad, and stored fragment by
//     fragment, so that a warp reads one (k-step, n8 tile) operand as one
//     coalesced 16-byte (f32) or 8-byte (bf16) load a lane. Layer 1's rows
//     are the node's split rows of w0, zeros to its k-step, then its
//     condition rows: layer 1 reads its A fragments straight from the rows of
//     x (at the node's offset) and of the condition, with the columns past
//     the node's split and past cond_dim read as zeros. `wbuf` is that
//     layout; the table at meta[meta[2]] describes it per level (TLREC). A
//     training step, whose forward is the loop's, never builds it.
//   - A tile is 32 rows (two m16 halves), one block per SM (12 warps in f32,
//     164 registers a thread; 16 in bf16). Each layer of a chunk splits the
//     chunk's n8 tiles evenly over the warps; a warp takes its tiles in
//     groups of up to 4 of one unit and keeps 2 x 4 accumulator tiles in
//     registers, so each B fragment feeds 32 rows and each A fragment (from
//     shared memory) feeds up to 4 tiles. The next k-step's B fragments load
//     while the current ones are multiplied. Rows of a1/a2 are `width` + pad
//     elements apart, so that fragment loads hit 32 distinct banks. One call
//     site of the product loop for all three layers keeps the code small.
//   - Tried and measured slower on the card: 8 warps at two blocks per SM;
//     L1 prefetches of the fragments a few k-steps ahead; loading each
//     group's first fragments during the group before it; every group 4
//     tiles wide.
// ROUTE_LOOP, hac_block_loop_kernel: the first port's loop on the CUDA cores.
//   16-row tiles, each thread keeps 8 rows x 1 output column in registers,
//   weights from L1/L2, activations as 16-byte shared-memory broadcasts.
//   Bound: f32 FMAs (~0.97 MFLOP per row per flagship block). It is the
//   saving route of both modes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hac_common.cuh"

namespace {

// the route hac_block_launch takes per compute dtype (hac_fused._FWD_ROUTE)
// without a saved buffer, and with one (hac_fused._SAVE_ROUTE). bf16 serves
// by the loop: the tensor-core route is 3.5x faster in bf16 but failed
// chip_smoke.py's 2e-2 bf16 bound once (x-lane block, inverse, batch 4096:
// 2.11e-2 on the log-det), where the loop passes; on other draws the loop
// exceeds that bound too (PERF.md).
constexpr int ROUTE_LOOP = 0;
constexpr int ROUTE_TC = 1;
constexpr int ROUTE_F32 = 1;
constexpr int ROUTE_BF16 = 0;
constexpr int SAVE_ROUTE = 0;

// -- ROUTE_LOOP --
constexpr int TB = 16;          // batch rows per thread block
constexpr int RT = 8;           // rows per thread work item
constexpr int RG = TB / RT;     // row groups per tile
constexpr int NT = 256;         // threads per block
constexpr int NWARP = NT / 32;

// Floats of dynamic shared memory before the metadata table; the same sum
// as hac_fused.py:_smem_bytes. Every part is a multiple of 4 floats, so the
// 16-byte loads of a1/a2 stay aligned.
__host__ __device__ constexpr size_t smem_floats(int d, int width, int cond_dim) {
  return (size_t)TB * (3 * pad4(d) + 2 * width + 1 + pad4(cond_dim));
}

template <bool BF16, bool SAVE>
__global__ void __launch_bounds__(NT, 2)
hac_block_loop_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                 float* __restrict__ y, float* __restrict__ ld, int B, int d, int cond_dim,
                 const int* __restrict__ meta_g, int meta_len,
                 const typename Wt<BF16>::T* __restrict__ wbuf,
                 const float* __restrict__ bbuf, int width, int rev, float cs,
                 float* __restrict__ sv, const int* __restrict__ wm) {
  using W = Wt<BF16>;
  using WT = typename W::T;
  extern __shared__ __align__(16) float smem[];
  const int dp = pad4(d), cp = pad4(cond_dim);
  float* xs = smem;              // [TB][dp] rows being transformed
  float* S = xs + TB * dp;       // [TB][dp] scale pre-activations of this level
  float* T = S + TB * dp;        // [TB][dp] shifts of this level
  float* a1 = T + TB * dp;       // [TB][width] layer-1 activations of a chunk
  float* a2 = a1 + TB * width;   // [TB][width] layer-2 activations of a chunk
  float* lds = a2 + TB * width;  // [TB] logdet accumulators
  float* cnd = lds + TB;         // [TB][cp] condition rows, the same for every level
  int* meta = reinterpret_cast<int*>(smem + smem_floats(d, width, cond_dim));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * TB;
  const int nrows = min(TB, B - row0);
  const size_t Bz = B;

  for (int i = tid; i < meta_len; i += NT) meta[i] = meta_g[i];
  for (int i = tid; i < TB * dp; i += NT) {
    const int r = i / dp, c = i - r * dp;
    xs[i] = (r < nrows && c < d) ? x[(size_t)(row0 + r) * d + c] : 0.f;
  }
  for (int i = tid; i < TB * cp; i += NT) {
    const int r = i / cp, c = i - r * cp;
    cnd[i] = (r < nrows && c < cond_dim) ? cond[(size_t)(row0 + r) * cond_dim + c] : 0.f;
  }
  if (tid < TB) lds[tid] = 0.f;
  __syncthreads();

  const int L = meta[0];
  const int* nodes = meta + HDR + L * LREC;
  for (int step = 0; step < L; ++step) {
    const int li = rev ? step : L - 1 - step;
    const int* lv = meta + HDR + li * LREC;
    const int n = lv[0], h = lv[1], in_rows = lv[2], out_max = lv[3];
    const int* nd = nodes + lv[4] * NREC;
    const int upc = lv[5];
    const WT* w0 = wbuf + lv[6];
    const WT* w1 = wbuf + lv[7];
    const WT* w2 = wbuf + lv[8];
    const float* b0 = bbuf + lv[9];
    const float* b1 = bbuf + lv[10];
    const float* b2 = bbuf + lv[11];
    const int hp = pad4(h), in_max = in_rows - cond_dim, uw = 2 * n * h;
    const int* wl = wm + WHDR + li * WREC;  // where SAVE: this level's regions of the saved buffer
    // where SAVE, layers 1 and 2 store a1 and a2 from the registers they are
    // made in: neighbouring threads hold neighbouring columns of a row, and
    // the level's a1 (a2) rows hold the units' columns next to each other,
    // so a warp's store is 32 neighbouring floats of one row
    float* sv1 = nullptr;
    float* sv2 = nullptr;
    if constexpr (SAVE) {
      sv1 = sv + Bz * __ldg(wl + 4) + (size_t)row0 * uw;
      sv2 = sv + Bz * __ldg(wl + 5) + (size_t)row0 * uw;
    }
    for (int i = tid; i < TB * dp; i += NT) {
      S[i] = 0.f;
      T[i] = 0.f;
    }

    for (int u0 = 0; u0 < 2 * n; u0 += upc) {
      const int nu = min(upc, 2 * n - u0);
      const int cols = nu * h;

      // layer 1: only the node's `split` real input rows of w0, then the
      // condition rows, which start at in_max
      for (int it = tid; it < RG * cols; it += NT) {
        const int g = it / cols, c = it - g * cols;
        const int ul = c / h, j = c - ul * h;
        const int u = u0 + ul;
        const int* node = nd + (u < n ? u : u - n) * NREC;
        const int off = node[0], split = node[1];
        float acc[RT];
        const float bias = b0[u * h + j];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = bias;
        const WT* w = w0 + (size_t)u * in_rows * h + j;
        const float* xr = xs + g * RT * dp + off;
        for (int k = 0; k < split; ++k) {
          const float wk = W::load(w + (size_t)k * h);
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(W::round(xr[r * dp + k]), wk, acc[r]);
        }
        const float* cr = cnd + g * RT * cp;
        for (int k = 0; k < cond_dim; ++k) {
          const float wk = W::load(w + (size_t)(in_max + k) * h);
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(W::round(cr[r * cp + k]), wk, acc[r]);
        }
        float* out = a1 + g * RT * width + ul * hp + j;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float v = W::round(fmaxf(acc[r], 0.f));
          out[r * width] = v;
          if constexpr (SAVE)
            if (g * RT + r < nrows) __stcs(sv1 + (size_t)(g * RT + r) * uw + u0 * h + c, v);
        }
      }
      __syncthreads();

      // layer 2: h x h
      for (int it = tid; it < RG * cols; it += NT) {
        const int g = it / cols, c = it - g * cols;
        const int ul = c / h, j = c - ul * h;
        const int u = u0 + ul;
        float acc[RT];
        const float bias = b1[u * h + j];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = bias;
        const WT* w = w1 + (size_t)u * h * h + j;
        const float* ar = a1 + g * RT * width + ul * hp;
        int k = 0;
        for (; k + 4 <= h; k += 4) {
          const float wa = W::load(w + (size_t)k * h);
          const float wb = W::load(w + (size_t)(k + 1) * h);
          const float wc = W::load(w + (size_t)(k + 2) * h);
          const float wd = W::load(w + (size_t)(k + 3) * h);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(ar + r * width + k);
            acc[r] = fmaf(a.x, wa, acc[r]);
            acc[r] = fmaf(a.y, wb, acc[r]);
            acc[r] = fmaf(a.z, wc, acc[r]);
            acc[r] = fmaf(a.w, wd, acc[r]);
          }
        }
        for (; k < h; ++k) {
          const float wk = W::load(w + (size_t)k * h);
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(ar[r * width + k], wk, acc[r]);
        }
        float* out = a2 + g * RT * width + ul * hp + j;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float v = W::round(fmaxf(acc[r], 0.f));
          out[r * width] = v;
          if constexpr (SAVE)
            if (g * RT + r < nrows) __stcs(sv2 + (size_t)(g * RT + r) * uw + u0 * h + c, v);
        }
      }
      __syncthreads();

      // layer 3: only the node's `out_i` real columns of w2/b2
      const int cols3 = nu * out_max;
      for (int it = tid; it < RG * cols3; it += NT) {
        const int g = it / cols3, c = it - g * cols3;
        const int ul = c / out_max, m = c - ul * out_max;
        const int u = u0 + ul;
        const bool is_t = u >= n;
        const int* node = nd + (is_t ? u - n : u) * NREC;
        if (m >= node[2]) continue;
        float acc[RT];
        const float bias = b2[u * out_max + m];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = bias;
        const WT* w = w2 + (size_t)u * h * out_max + m;
        const float* ar = a2 + g * RT * width + ul * hp;
        int k = 0;
        for (; k + 4 <= h; k += 4) {
          const float wa = W::load(w + (size_t)k * out_max);
          const float wb = W::load(w + (size_t)(k + 1) * out_max);
          const float wc = W::load(w + (size_t)(k + 2) * out_max);
          const float wd = W::load(w + (size_t)(k + 3) * out_max);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(ar + r * width + k);
            acc[r] = fmaf(a.x, wa, acc[r]);
            acc[r] = fmaf(a.y, wb, acc[r]);
            acc[r] = fmaf(a.z, wc, acc[r]);
            acc[r] = fmaf(a.w, wd, acc[r]);
          }
        }
        for (; k < h; ++k) {
          const float wk = W::load(w + (size_t)k * out_max);
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(ar[r * width + k], wk, acc[r]);
        }
        float* dst = (is_t ? T : S) + g * RT * dp + node[0] + node[1] + m;
#pragma unroll
        for (int r = 0; r < RT; ++r) dst[r * dp] = acc[r];
      }
      __syncthreads();
    }

    // coupling of the level's lower segments, one warp per row (where SAVE,
    // the level's input and S go to the saved buffer as they are read)
    float* svx = nullptr;
    float* svs = nullptr;
    if constexpr (SAVE) {
      svx = sv + Bz * __ldg(wl) + (size_t)row0 * d;
      svs = sv + Bz * __ldg(wl + 1) + (size_t)row0 * d;
    }
    for (int r = warp; r < TB; r += NWARP) {
      float sum = 0.f;
      for (int c = lane; c < d; c += 32) {
        const int i = r * dp + c;
        if constexpr (SAVE) {
          if (r < nrows) {
            __stcs(svx + r * d + c, xs[i]);
            __stcs(svs + r * d + c, S[i]);
          }
        }
        const float le = cs * atanf(S[i]);
        sum += le;
        xs[i] = rev ? (xs[i] - T[i]) / expf(le) : expf(le) * xs[i] + T[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) lds[r] += rev ? -sum : sum;
    }
    __syncthreads();
  }

  for (int i = tid; i < nrows * d; i += NT) {
    const int r = i / d, c = i - r * d;
    y[(size_t)(row0 + r) * d + c] = xs[r * dp + c];
    if constexpr (SAVE) __stcs(sv + Bz * __ldg(wm) + (size_t)(row0 + r) * d + c, xs[r * dp + c]);
  }
  if (tid < nrows) ld[row0 + tid] = lds[tid];
}

// -- ROUTE_TC ---------------------------------------------------------------------
// (TTB, TNTW, Tc, warp_groups and the product loop tc_group: hac_common.cuh)
constexpr int TPAD_F32 = 4;    // a1/a2 row stride = width + pad: (width + 4) / 4 odd (f32),
constexpr int TPAD_BF16 = 8;   // (width + 8) / 8 odd (bf16 pairs): conflict-free fragments

// Optional cycle profile of the tensor-core route (hac_fused.build(profile=True)
// compiles with HAC_BLOCK_PROFILE): every warp adds the clock64 cycles it
// spends in each phase (PROF_* below) to hac_block_prof, read and cleared by
// hac_block_profile_read. The counters are the only atomics, and only in that
// build; the default build has no trace of them.
enum { PROF_LOAD, PROF_GSTART, PROF_GROUP, PROF_EPI, PROF_WAIT, PROF_COUPLE, PROF_COUPLE_WAIT, PROF_STORE, PROF_N };
#ifdef HAC_BLOCK_PROFILE
__device__ unsigned long long hac_block_prof[PROF_N];
#define PROF_START long long prof_t = clock64(); long long prof_acc[PROF_N] = {};
#define PROF(slot)                         \
  {                                        \
    const long long prof_now = clock64();  \
    prof_acc[slot] += prof_now - prof_t;   \
    prof_t = prof_now;                     \
  }
#define PROF_FLUSH                                                                \
  if (lane == 0)                                                                  \
    for (int i = 0; i < PROF_N; ++i) atomicAdd(&hac_block_prof[i], (unsigned long long)prof_acc[i]);
#else
#define PROF_START
#define PROF(slot)
#define PROF_FLUSH
#endif

// Dynamic shared memory of one tile before the metadata table; the same sum
// as hac_fused.py:_tc_smem_bytes. xs, S, T, lds, cnd are f32 (each a multiple
// of 4 floats a row); a1 and a2 hold `width` + pad elements a row.
__host__ __device__ constexpr size_t tc_smem_bytes(int d, int width, int cond_dim, bool bf16) {
  return sizeof(float) * TTB * (3 * pad4(d) + 1 + pad4(cond_dim)) +
         (size_t)(bf16 ? 2 : 4) * TTB * 2 * (width + (bf16 ? TPAD_BF16 : TPAD_F32));
}

template <bool BF16>
__global__ void __launch_bounds__(32 * Tc<BF16>::NW, 1)
hac_block_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                 float* __restrict__ y, float* __restrict__ ld, int B, int d, int cond_dim,
                 const int* __restrict__ meta_g, int meta_len,
                 const typename Wt<BF16>::T* __restrict__ wbuf,
                 const float* __restrict__ bbuf, int width, int rev, float cs) {
  using C = Tc<BF16>;
  using AT = std::conditional_t<BF16, unsigned short, float>;  // a1/a2 in shared memory (bf16 bits in bf16)
  using WT = typename Wt<BF16>::T;
  constexpr int KS = C::KS, FRAG = C::FRAG, TNW = C::NW, TNT = 32 * TNW;
  extern __shared__ __align__(16) float smem[];
  const int dp = pad4(d), cp = pad4(cond_dim), as = width + (BF16 ? TPAD_BF16 : TPAD_F32);
  float* xs = smem;              // [TTB][dp] rows being transformed
  float* S = xs + TTB * dp;      // [TTB][dp] scale pre-activations of this level
  float* T = S + TTB * dp;       // [TTB][dp] shifts of this level
  float* lds = T + TTB * dp;     // [TTB] logdet accumulators
  float* cnd = lds + TTB;        // [TTB][cp] condition rows
  AT* a1 = reinterpret_cast<AT*>(cnd + TTB * cp);  // [TTB][as] layer-1 activations of a chunk
  AT* a2 = a1 + TTB * as;                          // [TTB][as] layer-2 activations of a chunk
  int* meta = reinterpret_cast<int*>(a2 + TTB * as);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * TTB;
  const int nrows = min(TTB, B - row0);

  for (int i = tid; i < meta_len; i += TNT) meta[i] = meta_g[i];
  for (int i = tid; i < TTB * dp; i += TNT) {
    const int r = i / dp, c = i - r * dp;
    xs[i] = (r < nrows && c < d) ? x[(size_t)(row0 + r) * d + c] : 0.f;
  }
  for (int i = tid; i < TTB * cp; i += TNT) {
    const int r = i / cp, c = i - r * cp;
    cnd[i] = (r < nrows && c < cond_dim) ? cond[(size_t)(row0 + r) * cond_dim + c] : 0.f;
  }
  PROF_START
  if (tid < TTB) lds[tid] = 0.f;
  __syncthreads();
  PROF(PROF_LOAD)

  const int L = meta[0];
  const int* nodes = meta + HDR + L * LREC;
  const int* tct = meta + meta[2];
  const WT* wtc = wbuf;  // the route's padded layout

  // both halves' A fragments of a k-step from rows of f32 values (x and the
  // condition; a1/a2 in f32 mode), `p` at the k-step's first column of row
  // 0. Where `masked`, the columns from `lim` on are read as zeros: layer 1's
  // last k-step of x runs past the node's split (onto its lower columns, the
  // next node's, the next row's), and of the condition past cond_dim (onto
  // the next row's); their weights are zero, but an Inf there would make a
  // NaN in another node or row. (Staging layer 1's input in a2 instead
  // measured slower.)
  auto fill_f32 = [&](auto masked, const float* p, int stride, int lim, auto& A) {
    auto at = [&](const float* q, int k) {
      if constexpr (decltype(masked)::value) return k < lim ? q[k] : 0.f;
      else return q[k];
    };
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* q = p + (hh * 16 + (r & 1) * 8 + g) * stride;
        if constexpr (BF16) {
          const int k = (r >> 1) * 8 + 2 * tig;
          A.v[hh][r] = bf16_pair(at(q, k), at(q, k + 1));
        } else {
          tf32_split(A, hh, r, at(q, (r >> 1) * 4 + tig));
        }
      }
  };

  for (int step = 0; step < L; ++step) {
    const int li = rev ? step : L - 1 - step;
    const int* lv = meta + HDR + li * LREC;
    const int* tl = tct + li * TLREC;
    const int n = lv[0], h = lv[1], out_max = lv[3];
    const int* nd = nodes + lv[4] * NREC;
    const int kh = tl[0], k1 = tl[1], nh = tl[2], n3 = tl[3], upc = tl[4];
    const int hs = nh * 8;                     // columns of one unit in a1/a2 (= kh * KS)
    const int ksc = (cond_dim + KS - 1) / KS;  // layer 1's k-steps of the condition

    for (int i = tid; i < TTB * dp; i += TNT) {
      S[i] = 0.f;
      T[i] = 0.f;
    }

    for (int u0 = 0; u0 < 2 * n; u0 += upc) {
      const int nu = min(upc, 2 * n - u0);
      // the chunk's three layers, one barrier after each; one call site of
      // the product loop keeps the kernel's code small
      for (int layer = 0; layer < 3; ++layer) {
        const int nt = layer == 2 ? n3 : nh;
        warp_groups<TNW>(nu, nt, warp, [&](int ul, int tt, int nb) {
          const int u = u0 + ul;
          const int* node = nd + (u < n ? u : u - n) * NREC;
          const int off = node[0], split = node[1], out = node[2];
          // the group's biases (loaded before its products), weights, k-steps
          const int lim = layer == 2 ? out : h;
          const float* bsrc = bbuf + lv[9 + layer] + u * (layer == 2 ? out_max : h);
          float bias[TNTW][2];
#pragma unroll
          for (int i = 0; i < TNTW; ++i) {
            const int c = (tt + i) * 8 + 2 * tig;
            bias[i][0] = i < nb && c < lim ? __ldg(bsrc + c) : 0.f;
            bias[i][1] = i < nb && c + 1 < lim ? __ldg(bsrc + c + 1) : 0.f;
          }
          const WT* wf = wtc + tl[5 + layer] + ((size_t)u * (layer == 0 ? k1 : kh) * nt + tt) * FRAG;
          const int ksx = (split + KS - 1) / KS;
          const AT* act = (layer == 1 ? a1 : a2) + ul * hs;
          PROF(PROF_GSTART)
          // layer 1 reads the node's split columns of x (k-steps [0, ksx)),
          // then the condition, zeros past split and cond_dim. Layers 2 and 3
          // read a1, a2, whose columns up to hs the layer before wrote.
          float acc[TNTW][2][4];
          tc_group_nb<BF16 ? M_BF16 : M_TF32X3>(acc, wf, nt * FRAG, layer == 0 ? ksx + ksc : kh, nb, lane, [&](int k0, auto& A) {
            if (layer == 0) {
              const int kc = k0 - ksx * KS;
              const bool in_x = kc < 0;
              fill_f32(std::true_type{}, in_x ? xs + off + k0 : cnd + kc, in_x ? dp : cp,
                       in_x ? split - k0 : cond_dim - kc, A);
            } else if constexpr (BF16) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  A.v[hh][r] = *reinterpret_cast<const uint32_t*>(act + (hh * 16 + (r & 1) * 8 + g) * as + k0 +
                                                                  (r >> 1) * 8 + 2 * tig);
            } else {
              fill_f32(std::false_type{}, act + k0, as, 0, A);
            }
          });
          PROF(PROF_GROUP)
#pragma unroll
          for (int i = 0; i < TNTW; ++i) {
            if (i >= nb) continue;
            const int c = (tt + i) * 8 + 2 * tig;
            if (layer < 2) {
              // relu(acc + bias) on the real columns, 0 on the padding up to
              // the unit's hs columns, rounded to bf16 in bf16 mode
              AT* dst = (layer == 0 ? a1 : a2) + ul * hs + c;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const float v0 = c < h ? fmaxf(acc[i][hh][2 * half] + bias[i][0], 0.f) : 0.f;
                  const float v1 = c + 1 < h ? fmaxf(acc[i][hh][2 * half + 1] + bias[i][1], 0.f) : 0.f;
                  AT* q = dst + (hh * 16 + half * 8 + g) * as;
                  if constexpr (BF16) *reinterpret_cast<uint32_t*>(q) = bf16_pair(v0, v1);
                  else *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
                }
            } else {
              // S/T: only the node's out_i real columns
              float* dst = (u >= n ? T : S) + off + split;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int m = c + (j & 1);
                if (m >= out) continue;
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) dst[(hh * 16 + (j >> 1) * 8 + g) * dp + m] = acc[i][hh][j] + bias[i][j & 1];
              }
            }
          }
          PROF(PROF_EPI)
        });
        __syncthreads();
        PROF(PROF_WAIT)
      }
    }

    // coupling of the level's lower segments, one warp per row; four
    // columns of a lane at a time, their sums added in column order (outside
    // the lower segments S = T = 0, where the coupling leaves x as it is)
    for (int r = warp; r < TTB; r += TNW) {
      float sum = 0.f;
      for (int c0 = lane; c0 < d; c0 += 128) {
        float le[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = r * dp + c0 + 32 * j;
          le[j] = 0.f;
          if (c0 + 32 * j < d) {
            const float tv = T[i];
            le[j] = cs * atanf(S[i]);
            xs[i] = rev ? (xs[i] - tv) / expf(le[j]) : expf(le[j]) * xs[i] + tv;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += le[j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) lds[r] += rev ? -sum : sum;
    }
    PROF(PROF_COUPLE)
    __syncthreads();
    PROF(PROF_COUPLE_WAIT)
  }

  for (int i = tid; i < nrows * d; i += TNT) {
    const int r = i / d, c = i - r * d;
    y[(size_t)(row0 + r) * d + c] = xs[r * dp + c];
  }
  if (tid < nrows) ld[row0 + tid] = lds[tid];
  PROF(PROF_STORE)
  PROF_FLUSH
}

template <bool BF16, bool SAVE>
cudaError_t launch_loop(const float* x, const float* cond, float* y, float* ld, int B, int d,
                        int cond_dim, const int* meta, int meta_len, const typename Wt<BF16>::T* w,
                        const float* bbuf, int width, int rev, float cs, float* sv, const int* wm,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(d, width, cond_dim) + sizeof(int) * meta_len;
  cudaError_t e = cudaFuncSetAttribute(hac_block_loop_kernel<BF16, SAVE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  hac_block_loop_kernel<BF16, SAVE><<<(B + TB - 1) / TB, NT, smem, stream>>>(
      x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, rev, cs, sv, wm);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch(const float* x, const float* cond, float* y, float* ld, int B, int d,
                   int cond_dim, const int* meta, int meta_len, const void* wbuf,
                   const float* bbuf, int width, int rev, float cs, float* sv, const int* wm, int route,
                   cudaStream_t stream) {
  using WT = typename Wt<BF16>::T;
  const WT* w = static_cast<const WT*>(wbuf);
  if (route == ROUTE_TC) {
    if (sv != nullptr) return cudaErrorInvalidValue;  // a saving forward takes the loop
    const size_t smem = tc_smem_bytes(d, width, cond_dim, BF16) + sizeof(int) * meta_len;
    cudaError_t e = cudaFuncSetAttribute(hac_block_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    hac_block_kernel<BF16><<<(B + TTB - 1) / TTB, 32 * Tc<BF16>::NW, smem, stream>>>(
        x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, rev, cs);
    return cudaGetLastError();
  }
  if (route != ROUTE_LOOP) return cudaErrorInvalidValue;
  return sv ? launch_loop<BF16, true>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, rev, cs, sv,
                                      wm, stream)
            : launch_loop<BF16, false>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, rev, cs,
                                       sv, wm, stream);
}

}  // namespace

extern "C" {

// Launches one whole-block pass on `stream` by the route `route` (ROUTE_TC or
// ROUTE_LOOP); returns the CUDA error code (0 = launched). x, y: (B, d) f32;
// cond: (B, cond_dim) f32, null when cond_dim == 0; ld: (B,) f32; wbuf: the
// route's weights, f32 or bf16 (bf16 != 0): for ROUTE_LOOP the packed
// layout, for ROUTE_TC its padded layout (TF32 parts in f32); bbuf: f32
// biases; width: elements per row of one hidden buffer of the route (before
// ROUTE_TC's pad); cs = clamp * 0.636. sv: null, or (ROUTE_LOOP only) the
// saved buffer of the backward (B * the saved floats a row of the workspace
// table wm, f32), into which the pass also writes every level's input and
// S, every unit's a1 and a2 and the block's output; wm: that table on the
// device (read only where sv is given).
int hac_block_launch_route(const float* x, const float* cond, float* y, float* ld, int B, int d,
                           int cond_dim, const int* meta, int meta_len, const void* wbuf,
                           const float* bbuf, int width, int rev, float cs, int bf16, float* sv,
                           const int* wm, void* stream, int route) {
  if (B <= 0) return 0;
  if (cond_dim < 0 || (cond_dim > 0 && cond == nullptr) || (sv != nullptr && wm == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch<true>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, wbuf, bbuf, width, rev,
                          cs, sv, wm, route, s)
           : launch<false>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, wbuf, bbuf, width,
                           rev, cs, sv, wm, route, s));
}

// The same by the route of the compute dtype: ROUTE_F32 or ROUTE_BF16, or
// SAVE_ROUTE where sv is given.
int hac_block_launch(const float* x, const float* cond, float* y, float* ld, int B, int d,
                     int cond_dim, const int* meta, int meta_len, const void* wbuf,
                     const float* bbuf, int width, int rev, float cs, int bf16, float* sv,
                     const int* wm, void* stream) {
  return hac_block_launch_route(x, cond, y, ld, B, d, cond_dim, meta, meta_len, wbuf, bbuf, width,
                                rev, cs, bf16, sv, wm, stream,
                                sv ? SAVE_ROUTE : (bf16 ? ROUTE_BF16 : ROUTE_F32));
}

// Copies the profile build's cycle counters (PROF_N of them) to `out` on the
// host and clears them; returns PROF_N, or -1 in the default build.
int hac_block_profile_read(unsigned long long* out) {
#ifdef HAC_BLOCK_PROFILE
  if (cudaMemcpyFromSymbol(out, hac_block_prof, sizeof(hac_block_prof)) != cudaSuccess) return -1;
  const unsigned long long zero[PROF_N] = {};
  if (cudaMemcpyToSymbol(hac_block_prof, zero, sizeof(zero)) != cudaSuccess) return -1;
  return PROF_N;
#else
  (void)out;
  return -1;
#endif
}

const char* hac_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
