// Dataflow-configurable tiled GEMM on Hopper: out = x (V, F) @ w (F, G),
// accumulated in float32 and cast back to the input dtype.
//
// Replaces: src/repro/kernels/gemm_dataflow/kernel.py, function
// gemm_dataflow (the Pallas TPU kernel behind
// repro.kernels.gemm_dataflow.ops.gemm).
//
// The three dataflows of the paper's Table 1 are three loop orders, each
// keeping its named operand tile resident in shared memory across the inner
// loop, as kernel.py:69-88 defines them:
// - output_stationary ({V_s G_s} F_t): a CTA owns one (T_V x T_G) output
//   tile and walks F; the accumulator stays in registers.
// - weight_stationary ({G_s F_s} V_t): a CTA owns one T_G column range and
//   walks F tiles in order; each (T_F x T_G) weight tile stays resident
//   while the CTA walks its V tiles under it.
// - input_stationary ({V_s F_s} G_t): a CTA owns one T_V row range and
//   walks F tiles in order; each (T_V x T_F) input tile stays resident while
//   the CTA walks its G tiles under it.
// The TPU version accumulates weight- and input-stationary by revisiting
// its output block, which is sequential there.  Here CTAs run in parallel,
// so those two write each F tile's partial product into a float32
// workspace in which every element is owned by exactly one CTA, summed over
// the F tiles in order: no atomics, and the result is deterministic.  To
// fill the card, the temporal range of a CTA (V for weight-stationary, G for
// input-stationary) is cut into at most 2 * SMs / (spatial tiles) chunks,
// each of at least kMinWalk tiles where there are that many, so the
// resident tile is still reused across the walk.
//
// What bounds it on this card: at cora's layer-0 combination (2708 x 1433
// @ 1433 x 16, f32) bytes, ~15.8 MB (~4.7 us at 3.35 TB/s); at smollm's
// w_gate (4096 x 576 @ 576 x 1536, bf16) operations, ~7.2 GFLOP (~7.3 us at
// the bf16 tensor-core peak).
//
// What this first design does about it: it is the simple, right version.
// Tiles are staged in shared memory as f32 (x with row stride T_F + 1, so
// reads are free of bank conflicts) and multiplied on CUDA cores: 256
// threads, each owning up to 8 x 8 outputs at rows ty + 16 i, columns
// tx + 16 j.  No tensor cores yet, so it sits far above the bf16 bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kR = 8;          // outputs per thread in each dimension
constexpr int kMinWalk = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Params {
  const void* x;
  const void* w;
  void* out;
  float* ws;  // weight/input-stationary partial sums (may alias out)
  int v, f, g, bv, bg, bf;
  int nv, ng, nf;   // tile counts
  int split;        // chunks of the temporal range (ws / is)
  int ni, nj;       // 16-row / 16-column groups of a tile
};

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) / 16 * 16; }

// x tile: rows [i0, i0 + 16 ni), columns [k0, k0 + bf), zero outside x.
template <typename T>
__device__ void load_x(const Params& p, float* xs, int i0, int k0) {
  const T* x = static_cast<const T*>(p.x);
  const int rows = p.ni * 16, ld = p.bf + 1;
  for (int e = threadIdx.x; e < rows * p.bf; e += kThreads) {
    const int r = e / p.bf, c = e - r * p.bf;
    const int gi = i0 + r, gk = k0 + c;
    xs[r * ld + c] = (r < p.bv && gi < p.v && gk < p.f)
                         ? to_f32(x[(long long)gi * p.f + gk]) : 0.f;
  }
}

// w tile: rows [k0, k0 + bf), columns [j0, j0 + 16 nj), zero outside w.
template <typename T>
__device__ void load_w(const Params& p, float* wsm, int k0, int j0) {
  const T* w = static_cast<const T*>(p.w);
  const int cols = p.nj * 16;
  for (int e = threadIdx.x; e < p.bf * cols; e += kThreads) {
    const int r = e / cols, c = e - r * cols;
    const int gk = k0 + r, gj = j0 + c;
    wsm[r * cols + c] = (c < p.bg && gk < p.f && gj < p.g)
                            ? to_f32(w[(long long)gk * p.g + gj]) : 0.f;
  }
}

// acc += xs @ wsm over the tile's depth.
__device__ __forceinline__ void tile_product(const Params& p, const float* xs,
                                             const float* wsm, float (&acc)[kR][kR]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ld = p.bf + 1, cols = p.nj * 16;
  for (int kk = 0; kk < p.bf; ++kk) {
    float a[kR], b[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) a[i] = i < p.ni ? xs[(ty + 16 * i) * ld + kk] : 0.f;
#pragma unroll
    for (int j = 0; j < kR; ++j) b[j] = j < p.nj ? wsm[kk * cols + tx + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (i >= p.ni) break;
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kR][kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;
}

// Each thread's outputs of the (i0, j0) tile: fn(global index, value).
template <typename Fn>
__device__ __forceinline__ void for_outputs(const Params& p, int i0, int j0,
                                            const float (&acc)[kR][kR], Fn fn) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty + 16 * i, gi = i0 + r;
    if (i >= p.ni || r >= p.bv || gi >= p.v) continue;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int c = tx + 16 * j, gj = j0 + c;
      if (j < p.nj && c < p.bg && gj < p.g) fn((long long)gi * p.g + gj, acc[i][j]);
    }
  }
}

// Partial product of F tile kt into the workspace (first tile stores, the
// last one writes the output in its dtype).
template <typename T>
__device__ __forceinline__ void accumulate(const Params& p, int i0, int j0, int kt,
                                           const float (&part)[kR][kR]) {
  T* out = static_cast<T*>(p.out);
  const bool first = kt == 0, last = kt == p.nf - 1;
  for_outputs(p, i0, j0, part, [&](long long idx, float val) {
    const float sum = first ? val : p.ws[idx] + val;
    if (last) out[idx] = from_f32<T>(sum);
    else p.ws[idx] = sum;
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gemm_os_kernel(const Params p) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* wsm = xs + p.ni * 16 * (p.bf + 1);
  const int i0 = blockIdx.y * p.bv, j0 = blockIdx.x * p.bg;
  float acc[kR][kR];
  zero(acc);
  for (int kt = 0; kt < p.nf; ++kt) {
    __syncthreads();
    load_x<T>(p, xs, i0, kt * p.bf);
    load_w<T>(p, wsm, kt * p.bf, j0);
    __syncthreads();
    tile_product(p, xs, wsm, acc);
  }
  T* out = static_cast<T*>(p.out);
  for_outputs(p, i0, j0, acc, [&](long long idx, float val) { out[idx] = from_f32<T>(val); });
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gemm_ws_kernel(const Params p) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* wsm = xs + p.ni * 16 * (p.bf + 1);
  const int j0 = blockIdx.x * p.bg;
  const int per = (p.nv + p.split - 1) / p.split;
  const int t_lo = blockIdx.y * per, t_hi = min(p.nv, t_lo + per);
  for (int kt = 0; kt < p.nf; ++kt) {
    __syncthreads();
    load_w<T>(p, wsm, kt * p.bf, j0);  // resident across the V walk
    for (int it = t_lo; it < t_hi; ++it) {
      __syncthreads();
      load_x<T>(p, xs, it * p.bv, kt * p.bf);
      __syncthreads();
      float part[kR][kR];
      zero(part);
      tile_product(p, xs, wsm, part);
      accumulate<T>(p, it * p.bv, j0, kt, part);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gemm_is_kernel(const Params p) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* wsm = xs + p.ni * 16 * (p.bf + 1);
  const int i0 = blockIdx.x * p.bv;
  const int per = (p.ng + p.split - 1) / p.split;
  const int t_lo = blockIdx.y * per, t_hi = min(p.ng, t_lo + per);
  for (int kt = 0; kt < p.nf; ++kt) {
    __syncthreads();
    load_x<T>(p, xs, i0, kt * p.bf);  // resident across the G walk
    for (int jt = t_lo; jt < t_hi; ++jt) {
      __syncthreads();
      load_w<T>(p, wsm, kt * p.bf, jt * p.bg);
      __syncthreads();
      float part[kR][kR];
      zero(part);
      tile_product(p, xs, wsm, part);
      accumulate<T>(p, i0, jt * p.bg, kt, part);
    }
  }
}

// Chunks of a temporal range of n tiles, given `spatial` CTAs beside them.
int split_of(int n, int spatial, int sms) {
  const int by_card = (2 * sms + spatial - 1) / spatial;
  const int by_walk = n >= kMinWalk ? n / kMinWalk : 1;
  const int chunks = by_card < by_walk ? by_card : by_walk;
  return chunks > 1 ? chunks : 1;
}

template <typename T>
cudaError_t launch(Params p, int dataflow, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem =
      ((size_t)p.ni * 16 * (p.bf + 1) + (size_t)p.bf * p.nj * 16) * sizeof(float);
  void (*kernel)(const Params);
  dim3 grid;
  if (dataflow == 0) {
    kernel = gemm_os_kernel<T>;
    grid = dim3((unsigned)p.ng, (unsigned)p.nv);
  } else if (dataflow == 1) {
    p.split = split_of(p.nv, p.ng, sms);
    kernel = gemm_ws_kernel<T>;
    grid = dim3((unsigned)p.ng, (unsigned)p.split);
  } else if (dataflow == 2) {
    p.split = split_of(p.ng, p.nv, sms);
    kernel = gemm_is_kernel<T>;
    grid = dim3((unsigned)p.nv, (unsigned)p.split);
  } else {
    return cudaErrorInvalidValue;
  }
  if (grid.y > 65535) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (V, F), w (F, G), out (V, G) row-major; ws a float32 (V, G) workspace
// for weight/input-stationary (may be out itself when out is float32).
// dataflow: 0 output-, 1 weight-, 2 input-stationary.  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t.
int gemm_dataflow_launch(const void* x, const void* w, void* out, void* ws,
                         int v, int f, int g, int bv, int bg, int bf,
                         int dataflow, int dtype, void* stream) {
  if (v <= 0 || g <= 0 || f <= 0) return (int)cudaSuccess;
  if (bv < 1 || bv > 16 * kR || bg < 1 || bg > 16 * kR || bf < 1)
    return (int)cudaErrorInvalidValue;
  Params p{x, w, out, static_cast<float*>(ws), v, f, g, bv, bg, bf,
           (v + bv - 1) / bv, (g + bg - 1) / bg, (f + bf - 1) / bf, 1,
           round16(bv) / 16, round16(bg) / 16};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, dataflow, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, dataflow, s);
  return (int)cudaErrorInvalidValue;
}

const char* gemm_dataflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
