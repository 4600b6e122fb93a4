// Whole hierarchical-affine-coupling (HAC) block in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of hint_tpu/ops/pallas_block.py:_fused_call
// (body _kernel_factory.kernel). Plain version and wrapper:
// hint_tpu_torch/ops/hac_fused.py.
//
// One thread block owns TB rows of the batch. The rows, the level's S/T
// buffers and two hidden-activation buffers live in shared memory for the
// whole block; nothing but x, y, logdet and the weights touches device memory.
// Per tree level (bottom-up forward, top-down inverse) the level's 2n subnet
// units (s-subnets 0..n-1, then t-subnets n..2n-1) run in chunks of `upc`
// units:
//   layer 1  a1 = relu(x[off : off+split] . w0[u][:split]
//                      + cond . w0[u][in_max : in_max+cond_dim] + b0[u])
//   layer 2  a2 = relu(a1 . w1[u] + b1[u])
//   layer 3  S/T[off+split+m] = a2 . w2[u][:, m] + b2[u][m],  m < out_i
// then every row is coupled in place: log_e = clamp*0.636*atan(S),
// forward x = exp(log_e)*x + T, inverse x = (x - T)/exp(log_e), and
// logdet += / -= sum(log_e). S and T are zero outside the level's lower
// segments, where atan(0) = 0 leaves x exactly unchanged.
// Padded rows of w0 and padded columns of w2/b2 are never read.
//
// Condition-fed blocks (cond_dim > 0, the c_ref variant of the Pallas kernel):
// every subnet's input is its node's upper segment followed by the condition.
// The tile's condition rows sit in shared memory for the whole block (the
// condition is never transformed), and the Pallas kernel's extra dense dot
// c @ W1[d:] per level becomes cond_dim more terms of each thread's layer-1
// sum. The condition rows of w0[u] start at in_max, the level's widest split,
// not at the node's own split; rows [split, in_max) are padding.
//
// bf16 mode: weights arrive pre-cast to bf16; every layer input is rounded
// to bf16 and products accumulate in f32 (JAX's preferred_element_type=f32).
// Biases and the coupling stay f32.
//
// Bound: f32 FMAs on the CUDA cores (~0.97 MFLOP per row per flagship block).
// Each thread keeps RT rows x 1 output column in registers; activations are
// read as 16-byte shared-memory broadcasts, weights from L1/L2.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hac_common.cuh"

namespace {

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

template <bool BF16>
__global__ void __launch_bounds__(NT, 2)
hac_block_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                 float* __restrict__ y, float* __restrict__ ld, int B, int d, int cond_dim,
                 const int* __restrict__ meta_g, int meta_len,
                 const typename Wt<BF16>::T* __restrict__ wbuf,
                 const float* __restrict__ bbuf, int width, int rev, float cs) {
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

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TB;
  const int nrows = min(TB, B - row0);

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
    const int* lv = meta + HDR + (rev ? step : L - 1 - step) * LREC;
    const int n = lv[0], h = lv[1], in_rows = lv[2], out_max = lv[3];
    const int* nd = nodes + lv[4] * NREC;
    const int upc = lv[5];
    const WT* w0 = wbuf + lv[6];
    const WT* w1 = wbuf + lv[7];
    const WT* w2 = wbuf + lv[8];
    const float* b0 = bbuf + lv[9];
    const float* b1 = bbuf + lv[10];
    const float* b2 = bbuf + lv[11];
    const int hp = pad4(h), in_max = in_rows - cond_dim;

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
        for (int r = 0; r < RT; ++r) out[r * width] = W::round(fmaxf(acc[r], 0.f));
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
        for (int r = 0; r < RT; ++r) out[r * width] = W::round(fmaxf(acc[r], 0.f));
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

    // coupling of the level's lower segments, one warp per row
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < TB; r += NWARP) {
      float sum = 0.f;
      for (int c = lane; c < d; c += 32) {
        const int i = r * dp + c;
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
  }
  if (tid < nrows) ld[row0 + tid] = lds[tid];
}

template <bool BF16>
cudaError_t launch(const float* x, const float* cond, float* y, float* ld, int B, int d,
                   int cond_dim, const int* meta, int meta_len, const void* wbuf,
                   const float* bbuf, int width, int rev, float cs, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(d, width, cond_dim) + sizeof(int) * meta_len;
  cudaError_t e = cudaFuncSetAttribute(hac_block_kernel<BF16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + TB - 1) / TB);
  hac_block_kernel<BF16><<<grid, NT, smem, stream>>>(
      x, cond, y, ld, B, d, cond_dim, meta, meta_len,
      static_cast<const typename Wt<BF16>::T*>(wbuf), bbuf, width, rev, cs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one whole-block pass on `stream`; returns the CUDA error code
// (0 = launched). x, y: (B, d) f32; cond: (B, cond_dim) f32, null when
// cond_dim == 0; ld: (B,) f32; wbuf: f32 or bf16 weights (bf16 != 0); bbuf:
// f32 biases; cs = clamp * 0.636.
int hac_block_launch(const float* x, const float* cond, float* y, float* ld, int B, int d,
                     int cond_dim, const int* meta, int meta_len, const void* wbuf,
                     const float* bbuf, int width, int rev, float cs, int bf16, void* stream) {
  if (B <= 0) return 0;
  if (cond_dim < 0 || (cond_dim > 0 && cond == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch<true>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, wbuf, bbuf, width, rev,
                          cs, s)
           : launch<false>(x, cond, y, ld, B, d, cond_dim, meta, meta_len, wbuf, bbuf, width,
                           rev, cs, s));
}

const char* hac_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
