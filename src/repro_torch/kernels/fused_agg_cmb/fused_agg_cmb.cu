// SP-Optimized fused aggregation + combination on Hopper:
//   out[v, :] = (sum_d wts[v, d] * x[idx[v, d], :]) @ w
// with the aggregated row tile kept in shared memory and consumed there by
// the combination product; the V x F intermediate never reaches device
// memory.
//
// Replaces: src/repro/kernels/fused_agg_cmb/kernel.py, function
// fused_agg_cmb_kernel (the Pallas TPU kernel behind
// repro.kernels.fused_agg_cmb.ops.fused_agg_cmb, including its host-side
// lax.scan over block_f feature chunks).
//
// What bounds it on this card: memory.  The aggregation is ~0.25 FLOP per
// gathered byte and the combination adds 2*G FLOP per aggregated element
// with G = 16 or 8 on the main path, so the whole function stays far under
// the float32 balance point.  The least time is x, w, the real (unpadded)
// neighbor lists and out, each moved once, over 3.35 TB/s.
//
// What the design does about it: one CTA owns kRows rows and one tile of
// up to kGTile output columns, and walks F in kFChunk-column chunks inside
// the kernel (the TPU wrapper's host scan over block_f moves in here, and
// the ragged F edge is masked instead of padding x).  For each chunk:
//   1. gather-accumulate the (kRows x kFChunk) tile h in shared memory --
//      a warp reads a contiguous slice of one x row per neighbor slot, and
//      each thread carries kRows / (kThreads / kFChunk) rows at once so
//      several gathers are in flight;
//   2. stage the matching (kFChunk x G-tile) rows of w in shared memory;
//   3. __syncthreads, then multiply h by that w tile into per-thread
//      float32 accumulators for the CTA's (kRows x G-tile) outputs.
// The product is written by hand (no library call); each output is summed
// over F in ascending order, every h element over d = 0..D-1 in order, all
// in float32 with no atomics, so results are deterministic.  band_size and
// block_f of the schedule do not shape the CTA: rows are independent and
// the kernel picks its own tile.  Every one of the D padded-ELL slots is
// walked, as on the TPU; skipping them is later work.  At cora layer 0 that
// padding (93% of the slots) and the few CTAs (176 of 16 rows for 132 SMs,
// each thread walking every F chunk and slot in turn) hold it far above
// its bound; splitting F across CTAs with a fixed-order second pass is the
// next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;     // rows per CTA
constexpr int kFChunk = 64;   // feature columns per chunk (divides kThreads)
constexpr int kGTile = 64;    // most output columns per CTA
constexpr int kGatherRows = kRows / (kThreads / kFChunk);   // rows per thread
constexpr int kOutPerThread = kRows * kGTile / kThreads;    // most outputs per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// gt: output columns per CTA, a power of two <= kGTile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_agg_cmb_kernel(const int* __restrict__ idx, const float* __restrict__ wts,
                     const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int v_pad, int d, int v, int f, int g,
                     int gt) {
  __shared__ float h_s[kRows][kFChunk];
  __shared__ float w_s[kFChunk][kGTile];

  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * kRows;
  const int g0 = blockIdx.y * gt;
  const int g_here = min(gt, g - g0);

  // gather layout: column c of the chunk, rows rg + k * (kThreads / kFChunk)
  const int c = tid % kFChunk;
  const int rg = tid / kFChunk;
  constexpr int kRowStride = kThreads / kFChunk;

  float acc[kOutPerThread];
#pragma unroll
  for (int k = 0; k < kOutPerThread; ++k) acc[k] = 0.f;

  for (int f0 = 0; f0 < f; f0 += kFChunk) {
    const int col = f0 + c;

    // 1. aggregation of this chunk into h_s
    float h[kGatherRows];
#pragma unroll
    for (int k = 0; k < kGatherRows; ++k) h[k] = 0.f;
    if (col < f) {
      // unrolled so the gathers of several slots are in flight at once;
      // each h[k] still sums its slots in order
#pragma unroll 4
      for (int j = 0; j < d; ++j) {
#pragma unroll
        for (int k = 0; k < kGatherRows; ++k) {
          const long r = row0 + rg + k * kRowStride;
          if (r < v_pad) {
            const long e = r * d + j;
            // clamp: never read outside x, whatever the index holds
            const int src = min(max(__ldg(idx + e), 0), v - 1);
            h[k] = fmaf(__ldg(wts + e), to_f32(x[(long)src * f + col]), h[k]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kGatherRows; ++k) h_s[rg + k * kRowStride][c] = h[k];

    // 2. the matching rows of w (zero past the ragged F and G edges)
    for (int e = tid; e < kFChunk * kGTile; e += kThreads) {
      const int cc = e / kGTile, gg = e % kGTile;
      const int fr = f0 + cc;
      w_s[cc][gg] = (fr < f && gg < g_here) ? to_f32(w[(long)fr * g + g0 + gg]) : 0.f;
    }
    __syncthreads();

    // 3. combination: acc[(r, gg)] += sum_cc h_s[r][cc] * w_s[cc][gg]
    const int nc = min(kFChunk, f - f0);
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) {
      const int o = tid + k * kThreads;
      if (o < kRows * gt) {
        const int r = o / gt, gg = o % gt;
        float s = acc[k];
        for (int cc = 0; cc < nc; ++cc) s = fmaf(h_s[r][cc], w_s[cc][gg], s);
        acc[k] = s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kOutPerThread; ++k) {
    const int o = tid + k * kThreads;
    if (o < kRows * gt) {
      const long r = row0 + o / gt;
      const int gg = o % gt;
      if (r < v_pad && gg < g_here) out[r * g + g0 + gg] = from_f32<T>(acc[k]);
    }
  }
}

template <typename T>
cudaError_t launch(const int* idx, const float* wts, const void* x, const void* w,
                   void* out, int v_pad, int d, int v, int f, int g,
                   cudaStream_t stream) {
  int gt = 1;
  while (gt < g && gt < kGTile) gt *= 2;
  const dim3 grid((unsigned)((v_pad + kRows - 1) / kRows), (unsigned)((g + gt - 1) / gt));
  fused_agg_cmb_kernel<T><<<grid, kThreads, 0, stream>>>(
      idx, wts, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), v_pad, d, v, f, g, gt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out).  Returns a cudaError_t.
int fused_agg_cmb_launch(const void* idx, const void* wts, const void* x,
                         const void* w, void* out, int v_pad, int d, int v,
                         int f, int g, int dtype, void* stream) {
  if (v_pad <= 0 || g <= 0) return (int)cudaSuccess;
  const auto* i = static_cast<const int*>(idx);
  const auto* wt = static_cast<const float*>(wts);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(i, wt, x, w, out, v_pad, d, v, f, g, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(i, wt, x, w, out, v_pad, d, v, f, g, s);
  return (int)cudaErrorInvalidValue;
}

const char* fused_agg_cmb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
