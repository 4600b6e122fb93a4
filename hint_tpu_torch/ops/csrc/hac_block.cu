// Whole hierarchical-affine-coupling (HAC) block in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of hint_tpu/ops/pallas_block.py:_fused_call
// (body _kernel_factory.kernel). Plain version and wrapper:
// hint_tpu_torch/ops/hac_fused.py.
//
// What every route computes. One thread block owns a tile of rows of the
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
// table `wm` (hac_common.cuh), the loop, the tiled and the wgmma routes also
// write what the backward kernels read: each level's input x_l and S, each
// unit's a1 and a2 and the block's output. A SAVE template parameter keeps
// every trace of it out of the serving kernels (sv == nullptr). f32 saves by
// the tiled route (SAVE_ROUTE_F32, hac_fused._SAVE_ROUTE), whose FMA chains
// are the loop's, bit for bit: exact f32 chains keep the backward's gradients
// within twice the f32 plain version's error against float64 (chip_smoke.py
// phase 5's gate) on more random draws than tensor-core activations do,
// whether by 3xTF32 or with both f32 operands split exactly into bf16 parts:
// the tensor cores' truncating sums within a k-step, not their products, set
// that error (PERF.md). The 3xTF32 route serves only, and refuses a saved
// buffer. bf16 saves by the wgmma route,
// which fails the bf16 gates on no more random draws than the loop
// (chip_grad_gate.py --dtype bfloat16); it serves by the loop, as the wgmma
// route fails chip_smoke.py phase 2's bf16 bound on an inverse pass at its
// seeds (x-lane block, batch 4096, 2.114e-2 against 2e-2; PERF.md).
//   What bounds a saving forward: the bytes it saves, ~51 KB a row for the
//   flagship block (0.52 GB at batch 10,000, 0.156 ms at 3.35 TB/s), against
//   a pass that moves ~800 bytes a row otherwise; in f32 on the CUDA cores
//   the FMAs bound it first (0.144 ms for the flagship block, 0.293 ms for the
//   condition-fed one at 67 TFLOP/s). Every route stores a1 and a2
//   from the registers they are made in (a save that stopped the warps after
//   each layer to copy the rows out of shared memory cost more than the
//   bytes' own time, in the loop as in the wgmma route), streamed
//   (st.global.cs): the saved rows are read back only by the backward, and
//   would otherwise push the weights out of L2. x_l and S go out where the
//   route reads them, the output with y.
//
// Four routes behind one entry point; hac_block_launch takes per dtype
// ROUTE_F32 / ROUTE_BF16 to serve and SAVE_ROUTE_F32 / SAVE_ROUTE_BF16 to
// save; hac_block_launch_route names one:
//
// ROUTE_TC, hac_block_kernel (f32): every product on the tensor cores
//   (mma.sync, 3xTF32).
//   Bound: the operations on the route (3 TF32 products per f32 product at
//   495 TFLOP/s) and the weights each 32-row tile reads from L2 (~4.5 MB of
//   padded f32 high/low parts per flagship block). Measured, it is bound by
//   neither: by the instructions around the products (fragment loads and
//   splits, per-k-step adds, each group's and chunk's set-up), a cycle
//   profile says (build(profile=True)).
//   - Each operand is split into a TF32 high part and a TF32 remainder
//     (cvt.rn), and lo.hi + hi.lo + hi.hi is summed from zero for each
//     k-step, then added to the running sum by a rounding f32 add: the tensor
//     cores add with truncation, and with one accumulator along K (up to 34
//     k-steps) the error against the plain version grew ~4x. The weights
//     arrive split (the wrapper does it once per parameter version); the
//     activations are split as they are read.
//   - Weights come from a padded layout of their own that the wrapper builds
//     once per parameter version, on the route's first launch
//     (hac_fused._tc_layout, _tc_packed): per unit and layer, K padded to the
//     k-step and N to n8 with zeros in every pad, and stored fragment by
//     fragment, so that a warp reads one (k-step, n8 tile) operand as one
//     coalesced 16-byte load a lane. Layer 1's rows are the node's split rows
//     of w0, zeros to its k-step, then its condition rows: layer 1 reads its
//     A fragments straight from the rows of x (at the node's offset) and of
//     the condition, with the columns past the node's split and past
//     cond_dim read as zeros. `wbuf` is that layout; the table at
//     meta[meta[2]] describes it per level (TLREC). A training step, whose
//     forward is the loop's, never builds it.
//   - A tile is 32 rows (two m16 halves), one block per SM (12 warps, 164
//     registers a thread). Each layer of a chunk splits the chunk's n8 tiles
//     evenly over the warps; a warp takes its tiles in groups of up to 4 of
//     one unit and keeps 2 x 4 accumulator tiles in registers, so each B
//     fragment feeds 32 rows and each A fragment (from shared memory) feeds
//     up to 4 tiles. The next k-step's B fragments load while the current
//     ones are multiplied. Rows of a1/a2 are `width` + pad floats apart, so
//     that fragment loads hit 32 distinct banks. One call site of the
//     product loop for all three layers keeps the code small.
//   - Tried and measured slower on the card: 8 warps at two blocks per SM;
//     L1 prefetches of the fragments a few k-steps ahead; loading each
//     group's first fragments during the group before it; every group 4
//     tiles wide.
// ROUTE_WG, hac_block_wg_kernel (bf16): every product on the warpgroup
//   tensor cores (wgmma m64nNk16, bf16 operands from shared memory, f32
//   sums), the layer inputs rounded to bf16 as the Pallas kernel's dot
//   rounds them (pallas_block.py:198-203).
//   Bound: the saved bytes where it saves; else the operations (0.0098 ms
//   at batch 10,000 for the flagship block at 989 TFLOP/s). Measured, it is
//   bound by neither: by the instructions of each item (its biases, its
//   slice's mbarrier, its descriptors, the epilogue) at two consumer
//   warpgroups an SM, a cycle profile says (build(profile=True); PERF.md).
//   - A block holds 64 rows (one m64 tile) and runs two consumer
//     warpgroups that split each layer's columns in items of up to 32
//     (m64n32k16), and a producer warp for each of them. The tile's rows (x,
//     S; f32) stay in shared memory; a chunk's layer-1 inputs, a1 and a2 are
//     bf16 there, in the core-matrix layout that wgmma reads without
//     swizzle, the epilogues writing each value where the next layer's
//     descriptor reads it.
//   - Weights stream through shared memory: a level's flagship weights
//     (~380 KB of bf16 at level 0) do not fit in 227 KB. The wrapper lays
//     them out once per parameter version (hac_fused._wg_layout, on the
//     route's first launch) as each warpgroup's stream of slices, in the
//     order it takes them, each an item's columns by its whole K in core
//     matrices; a producer warp copies them with the copy engine
//     (cp.async.bulk, one copy an item) into a ring of up to three stages a
//     warpgroup, against mbarriers: full (the bytes landed) and empty (the
//     consumers released it). Items small enough share a stage.
//   - Layer 3's items of a node go to the same warpgroup and threads for
//     its s- and its t-unit: the s-unit's epilogue writes S, the t-unit's
//     reads it back and couples the node's lower segment in place, with the
//     log-det summed in registers. No T buffer and no coupling pass.
//   - Accumulation: each k-step's products summed from zero on the tensor
//     cores, then added to the item's f32 sum by a rounding add; with one
//     accumulator along K more random draws failed the bf16 gates, and it
//     was ~3 % faster (PERF.md).
//   - The biases of a chunk are staged in shared memory with its layer-1
//     inputs: loaded per item from L2 they cost ~7 % of a serving pass.
// ROUTE_LOOP, hac_block_loop_kernel: the first port's loop on the CUDA cores.
//   16-row tiles, each thread keeps 8 rows x 1 output column in registers,
//   weights from L1/L2, activations as 16-byte shared-memory broadcasts.
//   Bound: f32 FMAs (~0.97 MFLOP per row per flagship block). It serves bf16
//   and is the reference the tiled route is held to bit for bit.
// ROUTE_TILED, hac_block_save_kernel (f32): the saving forward of f32
//   training, in place of the loop there. It ports the same Pallas kernel
//   (pallas_block.py:_fused_call, as the forward of the custom_vjp).
//   Bound: f32 FMAs on the CUDA cores (0.144 ms for the flagship block at
//   batch 10,000, 0.293 ms for the condition-fed one, at 67 TFLOP/s). The
//   loop fed each weight, read from L1/L2 by every 16-row tile, to 8 FMAs; a
//   16-row tile here reads each weight from L2 once, into shared memory,
//   and feeds it to 16 rows from there.
//   - Every output is the loop's chain: its bias, then fmaf over k = 0, 1,
//     ... (layer 1: the node's split rows of x, then the condition rows from
//     in_max), relu where the loop has it; no split of K, no reordering, and
//     the coupling is the loop's code (couple_rows). y, the log-det and every
//     saved value are the loop's, bit for bit.
//   - Weights: a layout of the route's own, each unit's matrix with its rows
//     padded to a quad (hac_fused._tl_plan, gathered once per
//     parameter version by _tl_packed), so that a thread reads its 4 columns
//     of a row as one 16-byte load. A producer warp copies each chunk's
//     layer in slabs, one bulk copy (cp.async.bulk) a unit and slab, into a
//     ring of up to TL_MAX_STAGES stages against mbarriers (full: the bytes
//     landed; empty: every consumer warp released it), as the wgmma route
//     does; a narrow layer comes in fewer, taller slabs (tl_slab).
//   - Register tiles: in layers 1 and 2 a consumer thread holds 4 rows x 4
//     neighbouring columns (a quad) of one unit; four row groups of a
//     16-row tile (17 consumer warps for 136 quads). A chunk is as many units
//     as the block's quad slots hold (hac_fused._tl_plan, from the widths),
//     so each of its layers 1 and 2 is one pass of the consumers. Layer 1
//     reads the level's input and the condition from transposed copies (a
//     thread's 4 rows one 16-byte load), layer 2 a1 as 16-byte loads along
//     k; a quad's biases are read as the chunk starts, and a1/a2 go back to
//     shared memory a quad a 16-byte store. Layer 3 (out_i columns) holds 2
//     rows x a quad a thread, in rounds where its items outnumber threads.
//   - Tiles of 16 rows where that still gives every SM one, else 8 (two row
//     groups): at batch 10,000, 625 tiles in 4.7 waves of one tile an SM
//     (tl_launch; hac_fused._tl_launch).
//   - Tried and measured on the card (the condition-fed block, saving, at
//     10,000; the loop 2.06-2.09 ms; PERF.md): 8 rows x 4 columns a thread
//     in two row groups (9 consumer warps), reading the flat weights as 4
//     scalars a k from 16-row slabs: 2.32 ms, its warps 28 % of their cycles
//     waiting for slabs and 17 % in epilogues; with the padded weights 2.24;
//     with the biases read early and 16-byte a1/a2 stores 1.76; that without
//     the ring (weights through the read-only cache, a k-quad ahead in
//     registers) 1.75, and 2.05 with 4-row threads; one stage in flight 2.86,
//     two as fast as three; 8-row tiles 2.99; 32-row tiles of 68 quads
//     2.38-2.53; 8-row slabs in six stages 1.72.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hac_common.cuh"

namespace {

// The routes. hac_block_launch takes per compute dtype (hac_fused._FWD_ROUTE)
// ROUTE_F32 or ROUTE_BF16 without a saved buffer, and with one
// (hac_fused._SAVE_ROUTE) SAVE_ROUTE_F32 or SAVE_ROUTE_BF16 (PERF.md says
// which random draws of chip_smoke.py's gates decided them).
constexpr int ROUTE_LOOP = 0;
constexpr int ROUTE_TC = 1;
constexpr int ROUTE_WG = 2;
constexpr int ROUTE_TILED = 3;
constexpr int ROUTE_F32 = 1;
constexpr int ROUTE_BF16 = 0;
constexpr int SAVE_ROUTE_F32 = 3;
constexpr int SAVE_ROUTE_BF16 = 2;

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

// The coupling of a level's lower segments on rows [0, rows) of a tile, one
// warp a row, shared by the loop and the tiled route so that both compile the
// same expressions: log_e = cs * atan(S), the rows updated in place, the
// log-det summed over a row's columns lane by lane and then across the warp.
// Where SAVE, the level's input and S go to the saved buffer as they are read
// (wl: the level's record of the workspace table).
template <bool SAVE>
__device__ __forceinline__ void couple_rows(float* xs, const float* S, const float* T, float* lds, int rows, int nrows,
                                            int d, int rev, float cs, float* __restrict__ sv, const int* wl, size_t Bz,
                                            int row0, int warp, int nwarps, int lane) {
  const int dp = pad4(d);
  float* svx = nullptr;
  float* svs = nullptr;
  if constexpr (SAVE) {
    svx = sv + Bz * __ldg(wl) + (size_t)row0 * d;
    svs = sv + Bz * __ldg(wl + 1) + (size_t)row0 * d;
  }
  for (int r = warp; r < rows; r += nwarps) {
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
}

// A tile's output rows and log-dets (where SAVE, the output to the saved
// buffer too), by threads [0, nt).
template <bool SAVE>
__device__ __forceinline__ void store_rows(const float* xs, const float* lds, float* __restrict__ y,
                                           float* __restrict__ ld, int nrows, int d, float* __restrict__ sv,
                                           const int* __restrict__ wm, size_t Bz, int row0, int tid, int nt) {
  const int dp = pad4(d);
  for (int i = tid; i < nrows * d; i += nt) {
    const int r = i / d, c = i - r * d;
    y[(size_t)(row0 + r) * d + c] = xs[r * dp + c];
    if constexpr (SAVE) __stcs(sv + Bz * __ldg(wm) + (size_t)(row0 + r) * d + c, xs[r * dp + c]);
  }
  if (tid < nrows) ld[row0 + tid] = lds[tid];
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

    couple_rows<SAVE>(xs, S, T, lds, TB, nrows, d, rev, cs, sv, wl, Bz, row0, warp, NWARP, lane);
    __syncthreads();
  }

  store_rows<SAVE>(xs, lds, y, ld, nrows, d, sv, wm, Bz, row0, tid, NT);
}

// -- ROUTE_TC ---------------------------------------------------------------------
// (TTB, TNTW, Tc, warp_groups and the product loop tc_group: hac_common.cuh)
constexpr int TPAD_F32 = 4;    // a1/a2 row stride = width + pad: (width + 4) / 4 odd: conflict-free fragments

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
// as hac_fused.py:_tc_smem_bytes. xs, S, T, lds, cnd, a1, a2 are f32 (each a
// multiple of 4 floats a row); a1 and a2 hold `width` + pad floats a row.
__host__ __device__ constexpr size_t tc_smem_bytes(int d, int width, int cond_dim) {
  return sizeof(float) * TTB * (3 * pad4(d) + 1 + pad4(cond_dim) + 2 * (width + TPAD_F32));
}

__global__ void __launch_bounds__(32 * Tc<false>::NW, 1)
hac_block_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                 float* __restrict__ y, float* __restrict__ ld, int B, int d, int cond_dim,
                 const int* __restrict__ meta_g, int meta_len, const float* __restrict__ wbuf,
                 const float* __restrict__ bbuf, int width, int rev, float cs) {
  using C = Tc<false>;
  constexpr int KS = C::KS, FRAG = C::FRAG, TNW = C::NW, TNT = 32 * TNW;
  extern __shared__ __align__(16) float smem[];
  const int dp = pad4(d), cp = pad4(cond_dim), as = width + TPAD_F32;
  float* xs = smem;              // [TTB][dp] rows being transformed
  float* S = xs + TTB * dp;      // [TTB][dp] scale pre-activations of this level
  float* T = S + TTB * dp;       // [TTB][dp] shifts of this level
  float* lds = T + TTB * dp;     // [TTB] logdet accumulators
  float* cnd = lds + TTB;        // [TTB][cp] condition rows
  float* a1 = cnd + TTB * cp;    // [TTB][as] layer-1 activations of a chunk
  float* a2 = a1 + TTB * as;     // [TTB][as] layer-2 activations of a chunk
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
  const float* wtc = wbuf;  // the route's padded layout

  // both halves' A fragments of a k-step from rows of f32 values (x and the
  // condition, a1/a2), `p` at the k-step's first column of row 0. Where
  // `masked`, the columns from `lim` on are read as zeros: layer 1's last
  // k-step of x runs past the node's split (onto its lower columns, the next
  // node's, the next row's), and of the condition past cond_dim (onto the
  // next row's); their weights are zero, but an Inf there would make a NaN in
  // another node or row. (Staging layer 1's input in a2 instead measured
  // slower.)
  auto fill_f32 = [&](auto masked, const float* p, int stride, int lim, auto& A) {
    auto at = [&](const float* q, int k) {
      if constexpr (decltype(masked)::value) return k < lim ? q[k] : 0.f;
      else return q[k];
    };
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        tf32_split(A, hh, r, at(p + (hh * 16 + (r & 1) * 8 + g) * stride, (r >> 1) * 4 + tig));
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
          const float* wf = wtc + tl[5 + layer] + ((size_t)u * (layer == 0 ? k1 : kh) * nt + tt) * FRAG;
          const int ksx = (split + KS - 1) / KS;
          const float* act = (layer == 1 ? a1 : a2) + ul * hs;
          PROF(PROF_GSTART)
          // layer 1 reads the node's split columns of x (k-steps [0, ksx)),
          // then the condition, zeros past split and cond_dim. Layers 2 and 3
          // read a1, a2, whose columns up to hs the layer before wrote.
          float acc[TNTW][2][4];
          tc_group_nb<M_TF32X3>(acc, wf, nt * FRAG, layer == 0 ? ksx + ksc : kh, nb, lane, [&](int k0, auto& A) {
            if (layer == 0) {
              const int kc = k0 - ksx * KS;
              const bool in_x = kc < 0;
              fill_f32(std::true_type{}, in_x ? xs + off + k0 : cnd + kc, in_x ? dp : cp,
                       in_x ? split - k0 : cond_dim - kc, A);
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
              // the unit's hs columns
              float* dst = (layer == 0 ? a1 : a2) + ul * hs + c;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const float v0 = c < h ? fmaxf(acc[i][hh][2 * half] + bias[i][0], 0.f) : 0.f;
                  const float v1 = c + 1 < h ? fmaxf(acc[i][hh][2 * half + 1] + bias[i][1], 0.f) : 0.f;
                  *reinterpret_cast<float2*>(dst + (hh * 16 + half * 8 + g) * as) = make_float2(v0, v1);
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

// -- ROUTE_WG ---------------------------------------------------------------------
constexpr int WTB = 64;               // batch rows per thread block: one m64 tile
constexpr int WNT = 4;                // n8 tiles of one item (m64n32k16)
constexpr int WGS = 3;                // consumer warpgroups (2: 14 % slower; 4: registers capped at 96, slower)
constexpr int WMAX_STAGES = 3;        // most weight slices in flight for one consumer warpgroup
constexpr int WCONS = 128 * WGS;      // consumer threads
constexpr int WTHREADS = WCONS + 32;  // and a producer warp: lane w fills warpgroup w's slices
constexpr int WBARS = 256;            // bytes of mbarriers: full[WGS][WMAX_STAGES], then empty[WGS][WMAX_STAGES]
constexpr int WLREC = 8;              // per level: kh, k1x, k1c, n3, upc, each warpgroup's stream (hac_fused._wg_layout)
static_assert(2 * WGS * WMAX_STAGES * 8 <= WBARS && 5 + WGS <= WLREC, "room for the mbarriers and the streams");
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a Hopper block may use

// bytes of one weight slice: WNT n8 tiles by K <= width, bf16 (several
// smaller items of a layer share one)
__host__ __device__ constexpr size_t wg_slice_bytes(int width) { return (size_t)2 * 8 * WNT * width; }

// Dynamic shared memory before the metadata table with `stages` slices a
// consumer warpgroup; the same sum as hac_fused.py:_wg_smem_bytes: the
// mbarriers, the slices, xs and S (f32, dim padded to 4), the condition
// rows, the warpgroups' log-det partials, a chunk's biases of the three
// layers (f32), the two bf16 activation buffers.
__host__ __device__ constexpr size_t wg_smem_bytes(int d, int width, int cond_dim, int stages) {
  return WBARS + WGS * stages * wg_slice_bytes(width) +
         sizeof(float) * (WTB * (2 * pad4(d) + pad4(cond_dim)) + WGS * WTB + 3 * width) + (size_t)2 * 2 * WTB * width;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the same for a thread whose warp's lanes wait on different barriers
__device__ __forceinline__ void mbar_wait_lane(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from device memory to shared memory by the
// copy engine, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// the consumers' barrier; what they wrote to shared memory for the tensor
// cores (the async proxy) is made visible to it first
__device__ __forceinline__ void bar_consumers() {
  asm volatile("fence.proxy.async.shared::cta;\nbar.sync 1, %0;\n" ::"n"(WCONS) : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across the wgmma
// instructions that write them asynchronously
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// 8-row by 16-byte core matrices, the next one along K 128 bytes on, the
// next eight rows `sbo` bytes on.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
// byte offset of element (r, c) of a K-major bf16 operand in core matrices
// whose eight-row groups are `sbo` bytes apart
__device__ __forceinline__ int core_at(int r, int c, int sbo) {
  return (r >> 3) * sbo + (c >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

// d (64 x 8 NT, f32; scale_d: d + A.B, else A.B) = A (64 x 16, bf16) . B
// (16 x 8 NT, bf16), both K-major in shared memory (descriptors). Warp q of
// the warpgroup holds d[4 j + e] at row 16q + g + 8 (e >> 1), column 8 j +
// 2 t + (e & 1).
template <int NT>
__device__ __forceinline__ void wg_mma(float* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wg_mma<1>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wg_mma<2>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wg_mma<4>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// NT tiles as one product (4, 2, 1) or two (3 = 2 + 1, the second's B rows
// 16 on: two eight-row groups of `sbo` bytes)
template <int NT>
__device__ __forceinline__ void wg_mma_tiles(float* d, uint64_t da, uint64_t db, int scale_d, uint32_t sbo) {
  if constexpr (NT == 3) {
    wg_mma<2>(d, da, db, scale_d);
    wg_mma<1>(d + 8, da, db + (uint64_t)((2 * sbo) >> 4), scale_d);
  } else {
    wg_mma<NT>(d, da, db, scale_d);
  }
}

// acc (this thread's values of one item: 64 rows by 8 NT columns) = A . B
// over `ks` k-steps, A and B K-major in shared memory from descriptors da0,
// db0 (k-step kk 256 bytes on: 16 in a descriptor; B's eight-row groups
// 256 ks bytes apart). Each k-step's products are summed from zero on the
// tensor cores, then added to acc by a rounding f32 add (the first k-step's
// go to acc as they are); the next k-step is issued before the last one is
// waited for, each into its own registers.
template <int NT>
__device__ __forceinline__ void wg_product(float (&acc)[4 * WNT], uint64_t da0, uint64_t db0, int ks) {
  const uint32_t sbo = 256u * ks;
  fence_regs(acc);
  wgmma_fence();
  wg_mma_tiles<NT>(acc, da0, db0, 0, sbo);  // from zero
  wgmma_commit();
  float t0[4 * NT], t1[4 * NT];
  auto issue = [&](float(&t)[4 * NT], int kk) {
    fence_regs(t);
    wgmma_fence();
    wg_mma_tiles<NT>(t, da0 + 16 * kk, db0 + 16 * kk, 0, sbo);
    wgmma_commit();
  };
  auto add = [&](float(&t)[4 * NT]) {
    fence_regs(acc);
    fence_regs(t);
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] += t[i];
  };
  // k-step kk's products go to t0 (kk odd) or t1 (kk even); each is added
  // once the one after it has been issued
  int kk = 1;
#pragma unroll 1
  for (; kk + 2 <= ks; kk += 2) {
    issue(t0, kk);
    if (kk > 1) {
      wgmma_wait<1>();
      add(t1);
    }
    issue(t1, kk + 1);
    wgmma_wait<1>();
    add(t0);
  }
  if (kk < ks) {
    issue(t0, kk);
    if (kk > 1) {
      wgmma_wait<1>();
      add(t1);
    }
    wgmma_wait<0>();
    add(t0);
  } else if (ks > 1) {
    wgmma_wait<0>();
    add(t1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// Calls f(unit in chunk, group, tiles) for each item of a chunk's layer
// that warpgroup w takes, in order; the producer and the consumers walk the
// same. Layers 1 and 2: the units' groups of WNT n8 tiles (kh * 2 tiles a
// unit), counted across the chunk's units, go to the warpgroups in turn.
// Layer 3: group grp of a unit of node i goes to warpgroup (i + grp) % WGS,
// so that the s-unit's and the t-unit's columns of a node are the same
// threads'.
template <class F>
__device__ __forceinline__ void wg_items(int layer, int u0, int nu, int n, int kh, int n3, int w, F&& f) {
  const int nt = layer < 2 ? 2 * kh : n3, ng = (nt + WNT - 1) / WNT;
  for (int ul = 0; ul < nu; ++ul) {
    const int node = u0 + ul < n ? u0 + ul : u0 + ul - n;
    const int first = (w - (layer < 2 ? ul * ng : node)) % WGS;
    for (int grp = first < 0 ? first + WGS : first; grp < ng; grp += WGS) f(ul, grp, min(WNT, nt - grp * WNT));
  }
}

// The ring of one warpgroup's weight slices. Consecutive items of a chunk's
// layer share a slice while their bytes (16 tiles K each) fit one: the
// producer adds each item's bytes to the slice's mbarrier and copies it,
// then arrives once the slice is whole; the consumers wait for it at its
// first item and release it (one arrival a warp) when the next one starts
// or the layer ends.
struct WgRing {
  uint32_t full, empty;  // mbarriers of the current stage (8 bytes a stage)
  unsigned char* at;     // the current stage, then the open slice's next byte
  int slice, ns;         // bytes of a stage; stages
  int s = 0;             // the current stage
  uint32_t phase = 0;    // the parity of its fill (consumers) or of its release (producer)
  uint32_t used = 0;     // bytes of the open slice
  bool open = false, reuse = false;  // a slice open; every stage filled once already
  // whether an item of `bytes` starts a slice
  __device__ bool starts(uint32_t bytes) const { return !open || used + bytes > (uint32_t)slice; }
  // the open slice closed: to the next stage
  __device__ void next() {
    open = false;
    at += slice - used;
    full += 8;
    empty += 8;
    if (++s == ns) {
      s = 0;
      at -= ns * slice;
      full -= 8 * ns;
      empty -= 8 * ns;
      phase ^= 1;
      reuse = true;
    }
  }
  __device__ void start() {
    open = true;
    used = 0;
  }
  __device__ void take(uint32_t bytes) {
    at += bytes;
    used += bytes;
  }
};

template <bool SAVE>
__global__ void __launch_bounds__(WTHREADS, 1)
hac_block_wg_kernel(const float* __restrict__ x, const float* __restrict__ cond, float* __restrict__ y,
                    float* __restrict__ ld, int B, int d, int cond_dim, const int* __restrict__ meta_g,
                    int meta_len, const unsigned short* __restrict__ wbuf, const float* __restrict__ bbuf,
                    int width, int ns, int rev, float cs, float* __restrict__ sv, const int* __restrict__ wm) {
  extern __shared__ __align__(128) unsigned char wsm[];
  const int dp = pad4(d), cp = pad4(cond_dim), asbo = 16 * width;
  const size_t slice = wg_slice_bytes(width);
  const uint32_t bars = smem_u32(wsm);  // full[WGS][WMAX_STAGES], then empty[WGS][WMAX_STAGES]
  unsigned char* stages = wsm + WBARS;  // [WGS][ns] weight slices
  float* xs = reinterpret_cast<float*>(stages + WGS * ns * slice);  // [WTB][dp] rows being transformed
  float* S = xs + WTB * dp;                                       // [WTB][dp] S of the level's lower segments
  float* cnd = S + WTB * dp;                                      // [WTB][cp] condition rows
  float* ldw = cnd + WTB * cp;                                    // [WGS][WTB] log-det of each warpgroup
  float* cb = ldw + WGS * WTB;  // [3][width] a chunk's b0, b1 (units' h columns after each other), b2 (out_max)
  // [WTB][width] bf16 in core matrices (eight-row groups asbo bytes apart):
  // a chunk's a1; its a2, which first holds the chunk's layer-1 inputs
  unsigned char* act1 = reinterpret_cast<unsigned char*>(cb + 3 * width);
  unsigned char* act2 = act1 + 2 * WTB * width;
  int* meta = reinterpret_cast<int*>(act2 + 2 * WTB * width);

  // warp-uniform values come through a shuffle from lane 0, so that the
  // compiler sees the paths to the wgmma instructions as uniform
  auto uni = [](int v) { return __shfl_sync(0xffffffffu, v, 0); };
  const int tid = threadIdx.x, warp = uni(tid >> 5), lane = tid & 31;
  const int row0 = blockIdx.x * WTB;
  const int nrows = min(WTB, B - row0);
  const size_t Bz = B;

  for (int i = tid; i < meta_len; i += WTHREADS) meta[i] = meta_g[i];
  for (int i = tid; i < WTB * dp; i += WTHREADS) {
    const int r = i / dp, c = i - r * dp;
    xs[i] = (r < nrows && c < d) ? x[(size_t)(row0 + r) * d + c] : 0.f;
  }
  for (int i = tid; i < WTB * cp; i += WTHREADS) {
    const int r = i / cp, c = i - r * cp;
    cnd[i] = (r < nrows && c < cond_dim) ? cond[(size_t)(row0 + r) * cond_dim + c] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < WGS * ns; ++s) {
      const int w = s / ns, k = s - w * ns;
      mbar_init(bars + 8u * (w * WMAX_STAGES + k), 1);          // full: the producer's arrival and the bytes
      mbar_init(bars + 8u * ((WGS + w) * WMAX_STAGES + k), 4);  // empty: one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int L = uni(meta[0]);
  const int* nodes = meta + HDR + L * LREC;
  const int* wtab = meta + meta[2];
  // the warpgroup a consumer warp belongs to, or the producer lane serves
  const int w = warp < WCONS / 32 ? warp >> 2 : lane;
  WgRing ring{bars + 8u * w * WMAX_STAGES, bars + 8u * (WGS + w) * WMAX_STAGES, stages + w * ns * slice, (int)slice,
              ns};

  if (warp >= WCONS / 32) {
    // the producer warp: lane w fills warpgroup w's slices, the level's
    // stream for w in the order its consumers take them
    if (lane >= WGS) return;
    for (int step = 0; step < L; ++step) {
      const int li = rev ? step : L - 1 - step;
      const int* lv = meta + HDR + li * LREC;
      const int* wl = wtab + li * WLREC;
      const int n = lv[0], kh = wl[0], k1 = wl[1] + wl[2], n3 = wl[3], upc = wl[4];
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wbuf + wl[5 + w]);
      for (int u0 = 0; u0 < 2 * n; u0 += upc)
        for (int layer = 0; layer < 3; ++layer) {
          const uint32_t row_bytes = 32u * (layer == 0 ? k1 : kh);  // K bf16
          wg_items(layer, u0, min(upc, 2 * n - u0), n, kh, n3, w, [&](int, int, int tiles) {
            const uint32_t bytes = 8u * tiles * row_bytes;
            if (ring.starts(bytes)) {
              if (ring.open) {
                mbar_arrive(ring.full);
                ring.next();
              }
              if (ring.reuse) mbar_wait_lane(ring.empty, ring.phase ^ 1);
              ring.start();
            }
            mbar_expect(ring.full, bytes);
            bulk_g2s(smem_u32(ring.at), src, bytes, ring.full);
            src += bytes;
            ring.take(bytes);
          });
          if (ring.open) {
            mbar_arrive(ring.full);
            ring.next();
          }
        }
    }
    return;
  }

  // consumers: warpgroup w; its warp q holds rows 16 q + g and 16 q + g + 8
  const int q = warp & 3, g = lane >> 2, tq = lane & 3;
  const int rr = 16 * q + g;
  float lsum[2] = {0.f, 0.f};
  PROF_START
  auto release = [&] {
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty);
    ring.next();
  };
  for (int step = 0; step < L; ++step) {
    const int li = rev ? step : L - 1 - step;
    const int* lv = meta + HDR + li * LREC;
    const int* wl = wtab + li * WLREC;
    const int n = uni(lv[0]), h = lv[1], out_max = lv[3];
    const int* nd = nodes + lv[4] * NREC;
    const int kh = uni(wl[0]), k1x = uni(wl[1]), k1 = k1x + uni(wl[2]), n3 = uni(wl[3]), upc = uni(wl[4]);
    const int hs = 16 * kh, uw = 2 * n * h;
    const int* sl = wm + WHDR + li * WREC;  // where SAVE: this level's regions of the saved buffer
    if constexpr (SAVE) {
      // the level's input, and S zeroed (it stays 0 outside the lower segments)
      float* svx = sv + Bz * __ldg(sl) + (size_t)row0 * d;
      for (int i = tid; i < nrows * d; i += WCONS) {
        const int r = i / d, c = i - r * d;
        __stcs(svx + i, xs[r * dp + c]);
      }
      for (int i = tid; i < WTB * dp; i += WCONS) S[i] = 0.f;
    }
    for (int u0 = 0; u0 < 2 * n; u0 += upc) {
      const int nu = min(upc, 2 * n - u0);
      // the chunk's layer-1 inputs as bf16 into act2, unit after unit: the
      // node's split columns of x, zeros to 16 k1x, the condition, zeros (an
      // Inf in another node's column or row must not reach this one); eight
      // columns of a row at a time, one 16-byte store
      const int blocks = 2 * nu * k1;  // eight-column blocks a row
      for (int i = tid; i < WTB * blocks; i += WCONS) {
        const int r = i / blocks, b = i - r * blocks, ul = b / (2 * k1), k = 8 * (b - ul * 2 * k1);
        const int* node = nd + ((u0 + ul) % n) * NREC;
        const bool in_x = k < 16 * k1x;
        const float* src = in_x ? xs + r * dp + node[0] + k : cnd + r * cp + k - 16 * k1x;
        const int lim = in_x ? node[1] - k : cond_dim - (k - 16 * k1x);
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = e < lim ? src[e] : 0.f;
        *reinterpret_cast<uint4*>(act2 + core_at(r, 8 * b, asbo)) =
            make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
      }
      // and the chunk's biases, which the units' items read
      for (int i = tid; i < nu * h; i += WCONS) {
        cb[i] = __ldg(bbuf + lv[9] + u0 * h + i);
        cb[width + i] = __ldg(bbuf + lv[10] + u0 * h + i);
      }
      for (int i = tid; i < nu * out_max; i += WCONS) cb[2 * width + i] = __ldg(bbuf + lv[11] + u0 * out_max + i);
      PROF(PROF_COUPLE)
      bar_consumers();
      PROF(PROF_WAIT)
      for (int layer = 0; layer < 3; ++layer) {
        const int ks = layer == 0 ? k1 : kh;
        const uint32_t abase = smem_u32(layer == 1 ? act1 : act2);  // layer 1 reads act2's inputs
        unsigned char* dst = layer == 0 ? act1 : act2;
        wg_items(layer, u0, nu, n, kh, n3, w, [&](int ul, int grp, int tiles) {
          const int u = u0 + ul;
          const int c0 = WNT * 8 * grp + 2 * tq;  // this thread's first column in the unit
          // the item's biases, loaded while its slice arrives and its products run
          float bias[WNT][2];
          const float* bsrc = cb + layer * width + ul * (layer < 2 ? h : out_max);
          const int lim = layer < 2 ? h : nd[(u < n ? u : u - n) * NREC + 2];
#pragma unroll
          for (int j = 0; j < WNT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = c0 + 8 * j + e;
              bias[j][e] = j < tiles && c < lim ? bsrc[c] : 0.f;
            }
          PROF(PROF_LOAD)
          const uint32_t bytes = 256u * tiles * ks;  // 8 tiles rows of 16 ks bf16
          if (ring.starts(bytes)) {
            if (ring.open) release();
            mbar_wait(ring.full, ring.phase);
            ring.start();
          }
          PROF(PROF_GSTART)
          const uint64_t da = wg_desc(abase + 256u * ks * ul, asbo);  // the unit's 16 ks columns
          const uint64_t db = wg_desc(smem_u32(ring.at), 256u * ks);
          ring.take(bytes);
          float acc[4 * WNT];
          switch (tiles) {
            case 1: wg_product<1>(acc, da, db, ks); break;
            case 2: wg_product<2>(acc, da, db, ks); break;
            case 3: wg_product<3>(acc, da, db, ks); break;
            default: wg_product<4>(acc, da, db, ks); break;
          }
          PROF(PROF_GROUP)
          if (layer < 2) {
            // relu(acc + bias) rounded to bf16 on the real columns, 0 on the
            // padding up to hs. This thread's pairs: rows rr, rr + 8 (the
            // next eight-row group), columns c0 + 8 j (the next core matrix).
            // Where SAVE, also widened to the saved buffer from these
            // registers, streamed: a pair as one 8-byte store where the
            // unit's columns start on an even float (h even, or u even)
            unsigned char* q0 = dst + core_at(rr, ul * hs + c0, asbo);
            float* svl = nullptr;
            if constexpr (SAVE) svl = sv + Bz * __ldg(sl + 4 + layer) + (size_t)(row0 + rr) * uw + u * h + c0;
            const bool pairs = ((u * h) & 1) == 0;
#pragma unroll
            for (int j = 0; j < WNT; ++j) {
              if (j >= tiles) continue;
              const int c = c0 + 8 * j;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const __nv_bfloat162 pr =
                    __floats2bfloat162_rn(c < h ? fmaxf(acc[4 * j + 2 * half] + bias[j][0], 0.f) : 0.f,
                                          c + 1 < h ? fmaxf(acc[4 * j + 2 * half + 1] + bias[j][1], 0.f) : 0.f);
                const uint32_t bits = *reinterpret_cast<const uint32_t*>(&pr);
                *reinterpret_cast<uint32_t*>(q0 + half * asbo + 128 * j) = bits;
                if constexpr (SAVE) {
                  const float v0 = __uint_as_float(bits << 16), v1 = __uint_as_float(bits & 0xffff0000u);
                  if (rr + 8 * half < nrows && c < h) {
                    float* o = svl + (size_t)(8 * half) * uw + 8 * j;
                    if (pairs && c + 1 < h) {
                      __stcs(reinterpret_cast<float2*>(o), make_float2(v0, v1));
                    } else {
                      __stcs(o, v0);
                      if (c + 1 < h) __stcs(o + 1, v1);
                    }
                  }
                }
              }
            }
          } else {
            // S (s-units) into shared memory; T (t-units, after their node's
            // s-unit, by the same threads) couples the node's lower segment
            const int* node = nd + (u < n ? u : u - n) * NREC;
            const int i0 = rr * dp + node[0] + node[1] + c0, out = node[2];
#pragma unroll
            for (int j = 0; j < WNT; ++j) {
              if (j >= tiles) continue;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (c0 + 8 * j + (e & 1) >= out) continue;
                const int i = i0 + 8 * dp * (e >> 1) + 8 * j + (e & 1);
                const float v = acc[4 * j + e] + bias[j][e & 1];
                if (u < n) {
                  S[i] = v;
                } else {
                  const float le = cs * atanf(S[i]);
                  xs[i] = rev ? (xs[i] - v) / expf(le) : expf(le) * xs[i] + v;
                  lsum[e >> 1] += le;
                }
              }
            }
          }
          PROF(PROF_EPI)
        });
        if (ring.open) release();
        bar_consumers();
        PROF(PROF_WAIT)

      }
    }
    if constexpr (SAVE) {
      float* svs = sv + Bz * __ldg(sl + 1) + (size_t)row0 * d;
      for (int i = tid; i < nrows * d; i += WCONS) {
        const int r = i / d, c = i - r * d;
        __stcs(svs + i, S[r * dp + c]);
      }
      bar_consumers();
      PROF(PROF_COUPLE_WAIT)
    }
  }

  // the log-det: each thread's two rows over its columns, then the four
  // threads of a row, then the two warpgroups
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = lsum[half];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (tq == 0) ldw[w * WTB + rr + 8 * half] = v;
  }
  bar_consumers();
  if (tid < nrows) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < WGS; ++k) v += ldw[k * WTB + tid];
    ld[row0 + tid] = rev ? -v : v;
  }
  for (int i = tid; i < nrows * d; i += WCONS) {
    const int r = i / d, c = i - r * d;
    y[(size_t)row0 * d + i] = xs[r * dp + c];
    if constexpr (SAVE) __stcs(sv + Bz * __ldg(wm) + (size_t)row0 * d + i, xs[r * dp + c]);
  }
  PROF(PROF_STORE)
  PROF_FLUSH
}

template <bool SAVE>
cudaError_t launch_wg(const float* x, const float* cond, float* y, float* ld, int B, int d, int cond_dim,
                      const int* meta, int meta_len, const unsigned short* w, const float* bbuf, int width, int rev,
                      float cs, float* sv, const int* wm, cudaStream_t stream) {
  int ns = WMAX_STAGES;  // as many slices in flight as shared memory holds
  while (ns > 0 && wg_smem_bytes(d, width, cond_dim, ns) + sizeof(int) * meta_len > (size_t)SMEM_MAX) --ns;
  if (ns == 0) return cudaErrorInvalidValue;
  const size_t smem = wg_smem_bytes(d, width, cond_dim, ns) + sizeof(int) * meta_len;
  cudaError_t e = cudaFuncSetAttribute(hac_block_wg_kernel<SAVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  hac_block_wg_kernel<SAVE><<<(B + WTB - 1) / WTB, WTHREADS, smem, stream>>>(
      x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, ns, rev, cs, sv, wm);
  return cudaGetLastError();
}

// -- ROUTE_TILED ------------------------------------------------------------------
constexpr int TL_RT = 4;          // rows a consumer thread holds in layers 1 and 2 (by 4 columns)
constexpr int TL_R3 = 2;          // rows a consumer thread holds in layer 3 (by 4 columns)
constexpr int TL_KS = 16;         // weight rows a ring stage holds of the widest chunk's layer (hac_fused._tl_plan)
constexpr int TL_MAX_STAGES = 3;  // most slabs in flight
constexpr int TL_THREADS = 576;   // most threads of a block: the consumers and one producer warp
constexpr int TL_BARS = 64;       // bytes of mbarriers: full[TL_MAX_STAGES], then empty[TL_MAX_STAGES]
constexpr int TL_HDR = 4;         // the route's table: quad slots, a1/a2 width, stage floats, 0; then per level:
constexpr int TL_LREC = 4;        // units a chunk, w0, w1, w2 (floats into the route's padded weights)
static_assert(2 * TL_MAX_STAGES * 8 <= TL_BARS && TL_BARS % 16 == 0, "room for the mbarriers");

// a1/a2 row stride: `wa` floats, padded so that the stride over 4 floats is
// odd (eight neighbouring rows' 16-byte loads hit distinct banks)
__host__ __device__ constexpr int tl_astride(int wa) { return (wa / 4) % 2 ? wa : wa + 4; }
// Dynamic shared memory before the metadata table with `ns` stages; the
// same sum as hac_fused.py:_tl_smem_bytes: the mbarriers, the ring, xs, S,
// T, a1, a2, the level's input and the condition rows transposed, and the
// log-det accumulators of `rows` rows.
__host__ __device__ constexpr size_t tl_smem_bytes(int d, int cond_dim, int rows, int wa, int stage, int ns) {
  return TL_BARS + sizeof(float) * ((size_t)ns * stage +
                                    (size_t)rows * (4 * pad4(d) + 2 * tl_astride(wa) + pad4(cond_dim) + 1));
}

// The consumers' barrier (the producer warp has left by then).
__device__ __forceinline__ void bar_tl(int nc) { asm volatile("bar.sync 1, %0;\n" ::"r"(nc) : "memory"); }

// The producer and the consumers walk a tile alike: every level, every
// chunk of its `upc` units, the chunk's three layers, each layer's rounds
// (layer 3 may take more than one) and its slabs (tl_slab). A layer's
// matrices, one a unit, K x ncols after each other in the route's padded
// weights from `base` (hac_fused._tl_plan: each row padded to a quad; a
// pad only ever reaches an output that is not stored; layer 1: w0's in_rows
// = in_max + cond_dim rows, its padding rows [split, in_max) included).
struct TlLayer {
  int K, ncols, base;  // weight rows and (padded) columns of each unit's matrix; the first unit's matrix in wbuf
};
__device__ __forceinline__ TlLayer tl_layer(const int* lv, const int* tl, int layer) {
  const int h = lv[1], in_rows = lv[2], out_max = lv[3];
  if (layer == 0) return {in_rows, pad4(h), tl[1]};
  if (layer == 1) return {h, pad4(h), tl[2]};
  return {h, pad4(out_max), tl[3]};
}
// A chunk's layer in a ring stage: each of its `nu` units a region of
// `region` floats, a slab `rows` weight rows (a multiple of 4, at least
// TL_KS, at most K): as many as a region holds, so that a narrow layer comes
// in few slabs (hac_fused._tl_slab)
struct TlSlab {
  int region, rows;
};
__device__ __forceinline__ TlSlab tl_slab(int K, int ncols, int nu, int stage) {
  const int region = (stage / nu) & ~3;
  return {region, min(K, (region / ncols) & ~3)};
}
// rounds of layer 3: items of TL_R3 rows by a quad of one unit's columns
__device__ __forceinline__ int tl_rounds3(int rows, int nu, int out_max, int nc) {
  const int items = rows / TL_R3 * nu * (pad4(out_max) / 4);
  return (items + nc - 1) / nc;
}

// The f32 saving forward (and, by name, the same pass without saving): the
// loop's FMA chains, fed from shared memory. See the header (ROUTE_TILED).
template <int NRG>
__global__ void __launch_bounds__(TL_THREADS, 1)
hac_block_save_kernel(const float* __restrict__ x, const float* __restrict__ cond, float* __restrict__ y,
                      float* __restrict__ ld, int B, int d, int cond_dim, const int* __restrict__ meta_g,
                      int meta_len, const float* __restrict__ wbuf, const float* __restrict__ bbuf, int ns, int rev,
                      float cs, float* __restrict__ sv, const int* __restrict__ wm) {
  constexpr int TR = TL_RT * NRG;  // rows of the tile
  constexpr int QW = 32 / NRG;     // quads of one warp in layers 1 and 2
  extern __shared__ __align__(128) unsigned char tsm[];
  const int dp = pad4(d), cp = pad4(cond_dim);
  const int* rt = meta_g + __ldg(meta_g + 3);  // the route's table
  const int wa = __ldg(rt + 1), stage = __ldg(rt + 2);
  const int as = tl_astride(wa);
  const int nc = blockDim.x - 32;  // consumer threads; the last warp is the producer
  const uint32_t bars = smem_u32(tsm);                      // full[ns] at 8 bytes each, empty at + 8 TL_MAX_STAGES
  float* ring = reinterpret_cast<float*>(tsm + TL_BARS);  // [ns][stage] weight slabs
  float* xs = ring + ns * stage;  // [TR][dp] rows being transformed
  float* S = xs + TR * dp;        // [TR][dp] scale pre-activations of this level
  float* T = S + TR * dp;         // [TR][dp] shifts of this level
  float* a1 = T + TR * dp;        // [TR][as] layer-1 activations of a chunk
  float* a2 = a1 + TR * as;       // [TR][as] layer-2 activations of a chunk
  // the level's input and the condition transposed, [column][TR], row r at
  // (r % NRG) * TL_RT + r / NRG: a thread's rows of layer 1 are 8 neighbours
  float* xt = a2 + TR * as;       // [dp][TR] the level's input
  float* ct = xt + TR * dp;       // [cp][TR] condition rows, the same for every level
  float* lds = ct + TR * cp;      // [TR] logdet accumulators
  int* meta = reinterpret_cast<int*>(lds + TR);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * TR;
  const int nrows = min(TR, B - row0);
  const size_t Bz = B;
  const bool save = sv != nullptr;

  for (int i = tid; i < meta_len; i += blockDim.x) meta[i] = meta_g[i];
  for (int i = tid; i < TR * dp; i += blockDim.x) {
    const int r = i / dp, c = i - r * dp;
    xs[i] = (r < nrows && c < d) ? x[(size_t)(row0 + r) * d + c] : 0.f;
  }
  for (int i = tid; i < TR * cp; i += blockDim.x) {
    const int r = i / cp, c = i - r * cp;
    ct[c * TR + (r % NRG) * TL_RT + r / NRG] =
        (r < nrows && c < cond_dim) ? cond[(size_t)(row0 + r) * cond_dim + c] : 0.f;
  }
  if (tid < TR) lds[tid] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(bars + 8u * s, 1);                                // full: the producer's arrival and the bytes
      mbar_init(bars + 8u * (TL_MAX_STAGES + s), nc / 32);        // empty: one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int L = meta[0];
  const int* nodes = meta + HDR + L * LREC;
  const int* tls = meta + meta[3] + TL_HDR;  // the route's level records
  int s = 0;           // the ring's current stage
  uint32_t phase = 0;  // the parity of its current fill
  auto advance = [&] {
    if (++s == ns) {
      s = 0;
      phase ^= 1;
    }
  };

  if (warp == nc / 32) {
    // the producer: lane 0 copies every slab of every unit of a chunk's
    // layer into the next stage, one bulk copy a unit, once a consumer warp
    // each has released it
    if (lane != 0) return;
    for (int step = 0; step < L; ++step) {
      const int li = rev ? step : L - 1 - step;
      const int* lv = meta + HDR + li * LREC;
      const int* tl = tls + li * TL_LREC;
      const int n = lv[0], upc = tl[0];
      for (int u0 = 0; u0 < 2 * n; u0 += upc) {
        const int nu = min(upc, 2 * n - u0);
        for (int layer = 0; layer < 3; ++layer) {
          const TlLayer ly = tl_layer(lv, tl, layer);
          const int rounds = layer < 2 ? 1 : tl_rounds3(TR, nu, lv[3], nc);
          const TlSlab sl = tl_slab(ly.K, ly.ncols, nu, stage);
          for (int round = 0; round < rounds; ++round)
            for (int k0 = 0; k0 < ly.K; k0 += sl.rows) {
              const int kn = min(sl.rows, ly.K - k0);
              const uint32_t full = bars + 8u * s;
              mbar_wait_lane(bars + 8u * (TL_MAX_STAGES + s), phase ^ 1);
              for (int ul = 0; ul < nu; ++ul) {
                const int gs = ly.base + (u0 + ul) * ly.K * ly.ncols + k0 * ly.ncols;
                mbar_expect(full, 4u * kn * ly.ncols);
                bulk_g2s(smem_u32(ring + s * stage + ul * sl.region), wbuf + gs, 4u * kn * ly.ncols, full);
              }
              mbar_arrive(full);
              advance();
            }
        }
      }
    }
    return;
  }

  // consumers. Layers 1 and 2: thread (warp, lane) holds rows rg + NRG i
  // (i < TL_RT) of quad q of the chunk's columns (each unit's h columns
  // padded to quads)
  const int rg = lane / QW, q = warp * QW + lane % QW;
  PROF_START
  // a slab of the current stage: wait for it, run f on it, release it
  auto slab = [&](auto&& f) {
    mbar_wait(bars + 8u * s, phase);
    PROF(PROF_GSTART)
    f(ring + s * stage);
    __syncwarp();
    PROF(PROF_GROUP)
    if (lane == 0) mbar_arrive(bars + 8u * (TL_MAX_STAGES + s));
    advance();
  };
  for (int step = 0; step < L; ++step) {
    const int li = rev ? step : L - 1 - step;
    const int* lv = meta + HDR + li * LREC;
    const int n = lv[0], h = lv[1], in_rows = lv[2], out_max = lv[3];
    const int* nd = nodes + lv[4] * NREC;
    const int* tl = tls + li * TL_LREC;
    const int upc = tl[0];
    const float* b0 = bbuf + lv[9];
    const float* b1 = bbuf + lv[10];
    const float* b2 = bbuf + lv[11];
    const int hp = pad4(h), in_max = in_rows - cond_dim, uw = 2 * n * h, qu = hp / 4;
    const int* wl = wm + WHDR + li * WREC;  // where saving: this level's regions of the saved buffer
    float* sv1 = nullptr;
    float* sv2 = nullptr;
    if (save) {
      sv1 = sv + Bz * __ldg(wl + 4) + (size_t)row0 * uw;
      sv2 = sv + Bz * __ldg(wl + 5) + (size_t)row0 * uw;
    }
    for (int i = tid; i < TR * dp; i += nc) {
      const int r = i / dp, c = i - r * dp;
      S[i] = 0.f;
      T[i] = 0.f;
      xt[c * TR + (r % NRG) * TL_RT + r / NRG] = xs[i];
    }
    bar_tl(nc);

    for (int u0 = 0; u0 < 2 * n; u0 += upc) {
      const int nu = min(upc, 2 * n - u0);
      const int ul = q / qu, j0 = 4 * (q - ul * qu), u = u0 + ul;
      const bool on = ul < nu;
      float acc[TL_RT][4];
      // the biases of this thread's columns in layers 1 and 2, read as the
      // chunk starts so that their latency is spent before the products
      float bias[2][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool col = on && j0 + c < h;
        bias[0][c] = col ? __ldg(b0 + u * h + j0 + c) : 0.f;
        bias[1][c] = col ? __ldg(b1 + u * h + j0 + c) : 0.f;
      }

      // layers 1 and 2: each of this thread's outputs one fmaf chain from
      // its bias over k = 0, 1, ... (layer 1: the node's split rows of x,
      // then the condition rows, whose weights start at in_max), as the loop
      // runs it
      for (int layer = 0; layer < 2; ++layer) {
        const TlLayer ly = tl_layer(lv, tl, layer);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < TL_RT; ++i) acc[i][c] = bias[layer][c];
        const int* node = nd + (u < n ? u : u - n) * NREC;
        const int off = on ? node[0] : 0, split = on ? node[1] : 0;
        const TlSlab sl = tl_slab(ly.K, hp, nu, stage);
        for (int k0 = 0; k0 < ly.K; k0 += sl.rows) {
          const int kn = min(sl.rows, ly.K - k0);
          slab([&](const float* st) {
            if (!on) return;
            const float* w = st + ul * sl.region + j0;  // w[kk * hp + c]: row k0 + kk, column j0 + c
            if (layer == 0) {
              for (int kk = 0; kk < kn; ++kk) {
                const int k = k0 + kk;
                const float* src;
                if (k < split)
                  src = xt + (off + k) * TR;
                else if (k >= in_max)
                  src = ct + (k - in_max) * TR;
                else
                  continue;  // w0's padding rows [split, in_max)
                const float4 wq = *reinterpret_cast<const float4*>(w + kk * hp);
                const float wk[4] = {wq.x, wq.y, wq.z, wq.w};
                const float4 q4 = *reinterpret_cast<const float4*>(src + rg * TL_RT);
                const float a[TL_RT] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
                for (int i = 0; i < TL_RT; ++i)
#pragma unroll
                  for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], wk[c], acc[i][c]);
              }
            } else {
              const float* ar = a1 + ul * hp + k0;
              int kk = 0;
              for (; kk + 4 <= kn; kk += 4) {
                float wk[4][4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float4 wq = *reinterpret_cast<const float4*>(w + (kk + e) * hp);
                  wk[e][0] = wq.x, wk[e][1] = wq.y, wk[e][2] = wq.z, wk[e][3] = wq.w;
                }
#pragma unroll
                for (int i = 0; i < TL_RT; ++i) {
                  const float4 a = *reinterpret_cast<const float4*>(ar + (rg + NRG * i) * as + kk);
#pragma unroll
                  for (int c = 0; c < 4; ++c) {
                    acc[i][c] = fmaf(a.x, wk[0][c], acc[i][c]);
                    acc[i][c] = fmaf(a.y, wk[1][c], acc[i][c]);
                    acc[i][c] = fmaf(a.z, wk[2][c], acc[i][c]);
                    acc[i][c] = fmaf(a.w, wk[3][c], acc[i][c]);
                  }
                }
              }
              for (; kk < kn; ++kk) {
                const float4 wq = *reinterpret_cast<const float4*>(w + kk * hp);
                const float wk[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
                for (int i = 0; i < TL_RT; ++i) {
                  const float a = ar[(rg + NRG * i) * as + kk];
#pragma unroll
                  for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a, wk[c], acc[i][c]);
                }
              }
            }
          });
        }
        // relu into a1 (a2), a quad a 16-byte store (its columns past h
        // are never read), where saving also to the saved buffer from the
        // registers
        if (on) {
          float* out = (layer == 0 ? a1 : a2) + ul * hp + j0;
          float* svl = layer == 0 ? sv1 : sv2;
#pragma unroll
          for (int i = 0; i < TL_RT; ++i) {
            const int r = rg + NRG * i;
            const float4 v = make_float4(fmaxf(acc[i][0], 0.f), fmaxf(acc[i][1], 0.f), fmaxf(acc[i][2], 0.f),
                                         fmaxf(acc[i][3], 0.f));
            *reinterpret_cast<float4*>(out + r * as) = v;
            if (save && r < nrows) {
              float* o = svl + (size_t)r * uw + u * h + j0;
              __stcs(o, v.x);
              if (j0 + 1 < h) __stcs(o + 1, v.y);
              if (j0 + 2 < h) __stcs(o + 2, v.z);
              if (j0 + 3 < h) __stcs(o + 3, v.w);
            }
          }
        }
        PROF(PROF_EPI)
        bar_tl(nc);
        PROF(PROF_WAIT)
      }

      // layer 3: only the node's `out_i` real columns of w2/b2, into S
      // (s-units) or T (t-units); items of TL_R3 rows (r3 + TR / TL_R3 i) by
      // a quad of one unit's columns
      {
        const TlLayer ly = tl_layer(lv, tl, 2);
        const int nr3 = TR / TL_R3, q3 = pad4(out_max) / 4, items = nr3 * nu * q3;
        const int rounds = tl_rounds3(TR, nu, out_max, nc);
        const int op = pad4(out_max);
        const TlSlab sl = tl_slab(ly.K, op, nu, stage);
        for (int round = 0; round < rounds; ++round) {
          const int it = round * nc + tid;
          const bool on3 = it < items;
          const int r3 = it % nr3, g3 = it / nr3;
          const int vl = on3 ? g3 / q3 : 0, m0 = 4 * (g3 - vl * q3), v = u0 + vl;
          const int* node = nd + (v < n ? v : v - n) * NREC;
          const int out = on3 ? node[2] : 0;
          float acc3[TL_R3][4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float bias = m0 + c < out ? __ldg(b2 + v * out_max + m0 + c) : 0.f;
#pragma unroll
            for (int i = 0; i < TL_R3; ++i) acc3[i][c] = bias;
          }
          for (int k0 = 0; k0 < ly.K; k0 += sl.rows) {
            const int kn = min(sl.rows, ly.K - k0);
            slab([&](const float* st) {
              if (!on3) return;
              const float* w = st + vl * sl.region + m0;  // w[kk * op + c]
              const float* ar = a2 + vl * hp + k0;
              int kk = 0;
              for (; kk + 4 <= kn; kk += 4) {
                float4 a[TL_R3];
#pragma unroll
                for (int i = 0; i < TL_R3; ++i) a[i] = *reinterpret_cast<const float4*>(ar + (r3 + nr3 * i) * as + kk);
                float wk[4][4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float4 wq = *reinterpret_cast<const float4*>(w + (kk + e) * op);
                  wk[e][0] = wq.x, wk[e][1] = wq.y, wk[e][2] = wq.z, wk[e][3] = wq.w;
                }
#pragma unroll
                for (int i = 0; i < TL_R3; ++i)
#pragma unroll
                  for (int c = 0; c < 4; ++c) {
                    acc3[i][c] = fmaf(a[i].x, wk[0][c], acc3[i][c]);
                    acc3[i][c] = fmaf(a[i].y, wk[1][c], acc3[i][c]);
                    acc3[i][c] = fmaf(a[i].z, wk[2][c], acc3[i][c]);
                    acc3[i][c] = fmaf(a[i].w, wk[3][c], acc3[i][c]);
                  }
              }
              for (; kk < kn; ++kk) {
                const float4 wq = *reinterpret_cast<const float4*>(w + kk * op);
                const float wk[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
                for (int i = 0; i < TL_R3; ++i) {
                  const float a = ar[(r3 + nr3 * i) * as + kk];
#pragma unroll
                  for (int c = 0; c < 4; ++c) acc3[i][c] = fmaf(a, wk[c], acc3[i][c]);
                }
              }
            });
          }
          if (on3) {
            float* dst = (v >= n ? T : S) + node[0] + node[1] + m0;
#pragma unroll
            for (int i = 0; i < TL_R3; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (m0 + c < out) dst[(r3 + nr3 * i) * dp + c] = acc3[i][c];
          }
          PROF(PROF_EPI)
        }
      }
    }
    bar_tl(nc);
    PROF(PROF_WAIT)

    // the coupling, as the loop's
    if (save)
      couple_rows<true>(xs, S, T, lds, TR, nrows, d, rev, cs, sv, wl, Bz, row0, warp, nc / 32, lane);
    else
      couple_rows<false>(xs, S, T, lds, TR, nrows, d, rev, cs, sv, wl, Bz, row0, warp, nc / 32, lane);
    PROF(PROF_COUPLE)
    bar_tl(nc);
    PROF(PROF_COUPLE_WAIT)
  }

  if (save)
    store_rows<true>(xs, lds, y, ld, nrows, d, sv, wm, Bz, row0, tid, nc);
  else
    store_rows<false>(xs, lds, y, ld, nrows, d, sv, wm, Bz, row0, tid, nc);
  PROF(PROF_STORE)
  PROF_FLUSH
}

// The tiled route's tile: 8 NRG rows, NRG = 2 where 16-row tiles still give
// every SM one and 16 rows fit in shared memory with two slabs in flight,
// else 1; the stages as many as fit, at most TL_MAX_STAGES; the threads
// NRG rows groups of `slots` quads in whole warps and a producer warp. The
// same rule as hac_fused.py:_tl_launch. Returns false where no tile fits.
struct TlLaunch {
  int nrg, ns, threads;
  size_t smem;
};
inline bool tl_launch(int B, int d, int cond_dim, int meta_len, int slots, int wa, int stage, int sms, TlLaunch* t) {
  auto fits = [&](int nrg, int ns) {
    return tl_smem_bytes(d, cond_dim, TL_RT * nrg, wa, stage, ns) + sizeof(int) * meta_len <= (size_t)SMEM_MAX &&
           32 * ((slots * nrg + 31) / 32) + 32 <= TL_THREADS;
  };
  const int nrg = (B + 4 * TL_RT - 1) / (4 * TL_RT) >= sms && fits(4, 2) ? 4 : 2;
  int ns = TL_MAX_STAGES;
  while (ns > 0 && !fits(nrg, ns)) --ns;
  if (ns == 0) return false;
  *t = {nrg, ns, 32 * ((slots * nrg + 31) / 32) + 32,
        tl_smem_bytes(d, cond_dim, TL_RT * nrg, wa, stage, ns) + sizeof(int) * meta_len};
  return true;
}

template <int NRG>
cudaError_t launch_tiled_nrg(const float* x, const float* cond, float* y, float* ld, int B, int d, int cond_dim,
                             const int* meta, int meta_len, const float* w, const float* bbuf, int rev, float cs,
                             float* sv, const int* wm, const TlLaunch& t, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(hac_block_save_kernel<NRG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)t.smem);
  if (e != cudaSuccess) return e;
  hac_block_save_kernel<NRG><<<(B + TL_RT * NRG - 1) / (TL_RT * NRG), t.threads, t.smem, stream>>>(
      x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, t.ns, rev, cs, sv, wm);
  return cudaGetLastError();
}

cudaError_t launch_tiled(const float* x, const float* cond, float* y, float* ld, int B, int d, int cond_dim,
                         const int* meta, int meta_len, const float* w, const float* bbuf, int wa, int rev, float cs,
                         float* sv, const int* wm, int slots, int stage, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  TlLaunch t;
  if (slots <= 0 || !tl_launch(B, d, cond_dim, meta_len, slots, wa, stage, sms, &t)) return cudaErrorInvalidValue;
  return t.nrg == 4 ? launch_tiled_nrg<4>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, rev, cs, sv, wm, t,
                                          stream)
                    : launch_tiled_nrg<2>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, rev, cs, sv, wm, t,
                                          stream);
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
                   const float* bbuf, int width, int rev, float cs, float* sv, const int* wm, int slots, int stage,
                   int route, cudaStream_t stream) {
  using WT = typename Wt<BF16>::T;
  const WT* w = static_cast<const WT*>(wbuf);
  if constexpr (BF16) {
    if (route == ROUTE_WG)
      return sv ? launch_wg<true>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, rev, cs, sv, wm, stream)
                : launch_wg<false>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, rev, cs, sv, wm,
                                   stream);
  } else {
    if (route == ROUTE_TC) {
      if (sv != nullptr) return cudaErrorInvalidValue;  // a saving forward takes the loop or the tiled route
      const size_t smem = tc_smem_bytes(d, width, cond_dim) + sizeof(int) * meta_len;
      cudaError_t e = cudaFuncSetAttribute(hac_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      hac_block_kernel<<<(B + TTB - 1) / TTB, 32 * Tc<false>::NW, smem, stream>>>(
          x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, rev, cs);
      return cudaGetLastError();
    }
    if (route == ROUTE_TILED)
      return launch_tiled(x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, rev, cs, sv, wm, slots,
                          stage, stream);
  }
  if (route != ROUTE_LOOP) return cudaErrorInvalidValue;
  return sv ? launch_loop<BF16, true>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, rev, cs, sv,
                                      wm, stream)
            : launch_loop<BF16, false>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, w, bbuf, width, rev, cs,
                                       sv, wm, stream);
}

}  // namespace

extern "C" {

// Launches one whole-block pass on `stream` by the route `route` (ROUTE_LOOP
// in both dtypes; ROUTE_TC and ROUTE_TILED in f32, ROUTE_WG in bf16); returns
// the CUDA error code (0 = launched). x, y: (B, d) f32; cond: (B, cond_dim)
// f32, null when cond_dim == 0; ld: (B,) f32; wbuf: the route's weights, f32
// or bf16 (bf16 != 0): for ROUTE_LOOP and ROUTE_TILED the packed layout, for
// ROUTE_TC its padded layout (TF32 parts), for ROUTE_WG its slices; bbuf: f32
// biases; width: elements per row of one hidden buffer of the route (before
// its pad); cs = clamp * 0.636. sv: null, or (ROUTE_LOOP, ROUTE_WG,
// ROUTE_TILED) the saved buffer of the backward (B * the saved floats a row of
// the workspace table wm, f32), into which the pass also writes every level's
// input and S, every unit's a1 and a2 and the block's output; wm: that table on
// the device (read only where sv is given). slots, stage: the tiled route's
// quad slots and ring-stage floats (its table, hac_fused._tl_plan; read by
// that route only).
int hac_block_launch_route(const float* x, const float* cond, float* y, float* ld, int B, int d,
                           int cond_dim, const int* meta, int meta_len, const void* wbuf,
                           const float* bbuf, int width, int rev, float cs, int bf16, float* sv,
                           const int* wm, int slots, int stage, void* stream, int route) {
  if (B <= 0) return 0;
  if (cond_dim < 0 || (cond_dim > 0 && cond == nullptr) || (sv != nullptr && wm == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch<true>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, wbuf, bbuf, width, rev,
                          cs, sv, wm, slots, stage, route, s)
           : launch<false>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, wbuf, bbuf, width,
                           rev, cs, sv, wm, slots, stage, route, s));
}

// The same by the route of the compute dtype: to serve ROUTE_F32 or
// ROUTE_BF16, to save (sv given) SAVE_ROUTE_F32 or SAVE_ROUTE_BF16.
int hac_block_launch(const float* x, const float* cond, float* y, float* ld, int B, int d,
                     int cond_dim, const int* meta, int meta_len, const void* wbuf,
                     const float* bbuf, int width, int rev, float cs, int bf16, float* sv,
                     const int* wm, int slots, int stage, void* stream) {
  return hac_block_launch_route(x, cond, y, ld, B, d, cond_dim, meta, meta_len, wbuf, bbuf, width,
                                rev, cs, bf16, sv, wm, slots, stage, stream,
                                sv ? (bf16 ? SAVE_ROUTE_BF16 : SAVE_ROUTE_F32) : (bf16 ? ROUTE_BF16 : ROUTE_F32));
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
