// ELL SpMM aggregation on Hopper: out[v, :] = sum_d wts[v, d] * x[idx[v, d], :].
//
// Replaces: src/repro/kernels/spmm/kernel.py, function spmm_ell (the Pallas
// TPU kernel behind repro.kernels.spmm.ops.spmm and spmm_streamed).
//
// What bounds it on this card: memory.  Each output element costs one
// multiply-add per neighbor slot and one gathered x element, so the work
// is ~0.25 FLOP per byte moved, far under the H100's ~20 FLOP/byte float32
// balance point.  The least time is the bytes of the real (unpadded)
// neighbor lists, of x read once and of out written once over 3.35 TB/s.
//
// What the design does about it: a warp covers consecutive feature columns
// of one row, so every neighbor gather is a coalesced read of a contiguous
// slice of one x row (x stays resident in the 50 MB L2 for the graphs of
// the main path), and the (idx, wts) pair of a slot is one broadcast load
// shared by the warp.  Each thread owns kRowsPerThread rows of one column
// and walks the neighbor loop for all of them together, unrolled over
// slots, with no branch around the loads (rows past the end recompute the
// last row and are not stored), so many independent gathers are in flight
// per thread.  What holds it far above its bound on cora is the padding:
// 93% of the slots are padded, and each slot costs three loads (index,
// weight, x) per 32 columns, so the load units and not device memory set
// its time.
//
// Like the TPU kernel it walks every one of the D padded-ELL slots
// (padded slots carry weight 0 and index 0, so they are real gathers);
// skipping them is later work.  The TPU kernel's block_v / block_f are
// schedule knobs, not CTA shapes here: the kernel picks its own rows and
// columns per CTA, and since every output element is reduced over
// d = 0..D-1 in order, in float32, with no atomics and no split across
// CTAs, the result does not depend on that choice -- which keeps
// spmm_streamed bit-identical to spmm.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One CTA: (kThreads / cols) * kRowsPerThread rows x `cols` feature columns.
// `cols` is a power of two <= 64 that divides kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
spmm_ell_kernel(const int* __restrict__ idx, const float* __restrict__ wts,
                const T* __restrict__ x, T* __restrict__ out,
                int v_pad, int d, int v, int f, int cols) {
  const int row_groups = kThreads / cols;
  const int c = threadIdx.x % cols;
  const int rg = threadIdx.x / cols;
  const int col = blockIdx.y * cols + c;
  if (col >= f) return;  // no barrier in this kernel
  const long row0 = (long)blockIdx.x * row_groups * kRowsPerThread + rg;

  // Rows past v_pad recompute the last row and are not stored, so the
  // gathers carry no branch and the compiler can keep many in flight.
  const int* ip[kRowsPerThread];
  const float* wp[kRowsPerThread];
  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    long r = row0 + (long)k * row_groups;
    if (r >= v_pad) r = v_pad - 1;
    ip[k] = idx + r * d;
    wp[k] = wts + r * d;
    acc[k] = 0.f;
  }

  // unrolled so the gathers of several slots are in flight at once; each
  // acc[k] still sums its slots in order
#pragma unroll 4
  for (int j = 0; j < d; ++j) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      // clamp: never read outside x, whatever the index holds
      const int src = min(max(__ldg(ip[k] + j), 0), v - 1);
      acc[k] = fmaf(__ldg(wp[k] + j), to_f32(x[(long)src * f + col]), acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long r = row0 + (long)k * row_groups;
    if (r < v_pad) out[r * f + col] = from_f32<T>(acc[k]);
  }
}

template <typename T>
cudaError_t launch(const int* idx, const float* wts, const void* x, void* out,
                   int v_pad, int d, int v, int f, cudaStream_t stream) {
  int cols = 1;
  while (cols < f && cols < 64) cols *= 2;
  const long rows_per_cta = (long)(kThreads / cols) * kRowsPerThread;
  const dim3 grid((unsigned)((v_pad + rows_per_cta - 1) / rows_per_cta),
                  (unsigned)((f + cols - 1) / cols));
  spmm_ell_kernel<T><<<grid, kThreads, 0, stream>>>(
      idx, wts, static_cast<const T*>(x), static_cast<T*>(out), v_pad, d, v, f, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out).  Returns a cudaError_t.
int spmm_ell_launch(const void* idx, const void* wts, const void* x, void* out,
                    int v_pad, int d, int v, int f, int dtype, void* stream) {
  if (v_pad <= 0 || f <= 0) return (int)cudaSuccess;
  const auto* i = static_cast<const int*>(idx);
  const auto* w = static_cast<const float*>(wts);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(i, w, x, out, v_pad, d, v, f, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(i, w, x, out, v_pad, d, v, f, s);
  return (int)cudaErrorInvalidValue;
}

const char* spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
