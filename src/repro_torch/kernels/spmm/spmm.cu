// ELL SpMM aggregation on Hopper: out[v, :] = sum_d wts[v, d] * x[idx[v, d], :].
//
// Replaces: src/repro/kernels/spmm/kernel.py, function spmm_ell (the Pallas
// TPU kernel behind repro.kernels.spmm.ops.spmm and spmm_streamed).
//
// What bounds it on this card: memory.  Each output element costs one
// multiply-add per real neighbor slot and one gathered x element, ~0.25
// FLOP per byte moved, far under the H100's ~20 FLOP/byte float32 balance
// point.  The least time is the bytes of the real neighbor lists, of x read
// once and of out written once, over 3.35 TB/s.
//
// What the design does about it (shared pieces in ../ell.cuh):
//   * Only the real slots are walked.  The padded ELL of the serving path
//     is 99% padding (93% at cora), and a padded slot is a real gather of
//     row 0; the CTA trims each row's trailing weight-0 slots from the
//     weights, one warp per row with __ballot_sync, inside the launch.
//   * A CTA owns R rows and stages their real (src, weight) pairs once in
//     shared memory, a flat list row after row; every column-thread then
//     reads it by broadcast instead of re-loading it from global memory per
//     slot and per column.
//   * Threads are laid out as row groups x column lanes: lanes take
//     consecutive VEC-wide column groups of a row, so each gather is a
//     coalesced read of one x row, in 8- or 16-byte loads where F and x's
//     base allow (VEC = 2 for reddit-bin's F = 3782 float32; 1 for cora's
//     5,732-byte rows).  Wide F puts all 256 threads on one row group
//     (a hub row's slots are shared by every thread of the CTA) and R = 4
//     rows in a CTA (fewer where 4 would leave under two CTAs per SM);
//     narrow F (16 in the CA order) keeps 256 / lanes rows in flight, with
//     smaller CTAs where needed for two per SM.
//   * Each thread walks NC column groups at once (NC * VEC <= 4) and issues
//     the gathers of 16 slots before their multiply-adds (ell::walk), across
//     row boundaries, so up to 64 loads are in flight even on rows of
//     degree 1-2.
//   * What holds it back at the serving shape: hub rows.  A reddit-bin
//     thread's root has up to 245 real slots, and the CTA that owns it
//     gathers 245 x rows of 15 KB on one SM (PERF.md: the batch with every
//     row cut to 16 slots, and the longest row alone, profile.py).
// Every output element is summed over its slots in ascending order, in
// float32, with no atomics and no split of a row across CTAs, so the
// result does not depend on R, the lanes or VEC: spmm_streamed stays
// bit-identical to spmm.  The one difference from the TPU kernel by design:
// trailing padded slots are not gathered, so an inf or NaN in x[0] does not
// reach rows whose padding points at it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "../ell.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 16;    // slots whose gathers are in flight together
constexpr int kMaxRows = 4;   // rows per CTA when F is wide, at most
constexpr int kCap = 4096;     // most staged slots per CTA (32 KB)

// The launch: grid, CTA size, rows per CTA, slot-list capacity, columns
// per load (vec), column lanes, and column groups a thread walks at once (nc).
struct Plan {
  int grid, threads, smem, rows, cap, vec, lanes, nc;
};

template <typename T, int VEC, int NC>
__global__ void __launch_bounds__(kMaxThreads)
spmm_ell_kernel(const int* __restrict__ idx, const float* __restrict__ wts,
                const T* __restrict__ x, T* __restrict__ out, int v_pad, int d, int v,
                int f, int lanes, int rows, int cap) {
  extern __shared__ __align__(16) char smem[];
  int *s_src, *s_off;
  float* s_wt;
  ell::carve(smem, rows, cap, &s_src, &s_wt, &s_off);
  const long row0 = (long)blockIdx.x * rows;
  ell::stage<1>(idx, wts, row0, rows, v_pad, d, v, cap, s_src, s_wt, s_off);
  const ell::Staged st{s_src, s_wt, s_off, cap};

  // row group `grp` walks rows rb .. re - 1 of the CTA; lane `lane` takes
  // the column groups lane, lane + lanes, ..., NC of them per walk
  const int lane = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  const int groups = blockDim.x / lanes, per = (rows + groups - 1) / groups;
  const int rb = min(grp * per, rows), re = min(rb + per, rows);
  const int ncol = f / VEC;
  for (int cv = lane; cv < ncol; cv += NC * lanes) {
    const int ncv = min(NC, (ncol - cv + lanes - 1) / lanes);
    ell::walk<T, VEC, NC, kUnroll>(
        st, rb, re, x, f, cv * VEC, lanes * VEC, ncv, idx, wts, row0, d, v,
        [&](int r, const float (&acc)[NC][VEC]) {
          if (row0 + r >= v_pad) return;
          T* o = out + (row0 + r) * (long)f + cv * VEC;
#pragma unroll
          for (int n = 0; n < NC; ++n)
            if (n < ncv) ell::store<T, VEC>(o + n * lanes * VEC, acc[n]);
        });
  }
}

// The widest load (vec elements, at most 16 bytes) that F and x's base
// allow while a row keeps at least 32 column groups; as many lanes as
// column groups, up to 256; CTAs shrunk (fewer threads for narrow F, fewer
// rows for wide F) until the grid holds two per SM; and up to 4 / vec
// column groups walked at once when a lane has that many.
Plan make_plan(int v_pad, int d, int f, int es, uintptr_t x) {
  Plan p{};
  auto fits = [&](int vec) {
    return vec * es <= 16 && f % vec == 0 && x % (vec * es) == 0 && f / vec >= 32;
  };
  p.vec = fits(8) ? 8 : fits(4) ? 4 : fits(2) ? 2 : 1;
  const int ncol = f / p.vec;
  p.lanes = 1;
  while (p.lanes < ncol && p.lanes < kMaxThreads) p.lanes *= 2;
  const long want = 2L * ell::sm_count();
  p.threads = kMaxThreads;
  while (p.threads > (p.lanes > 64 ? p.lanes : 64) &&
         (v_pad + p.threads / p.lanes - 1) / (p.threads / p.lanes) < want)
    p.threads /= 2;
  p.rows = p.threads / p.lanes;
  if (p.rows == 1) {
    p.rows = kMaxRows;
    while (p.rows > 1 && (v_pad + p.rows - 1) / p.rows < want) p.rows /= 2;
  }
  const int per_lane = (ncol + p.lanes - 1) / p.lanes;
  p.nc = 1;
  while (p.nc * 2 * p.vec <= 4 && p.nc * 2 <= per_lane) p.nc *= 2;
  p.cap = (int)(((long)p.rows * d) < kCap ? (long)p.rows * d : kCap);
  p.smem = ell::staged_bytes(p.rows, p.cap);
  p.grid = (v_pad + p.rows - 1) / p.rows;
  return p;
}

template <typename T, int VEC, int NC>
cudaError_t launch_plan(const Plan& p, const int* idx, const float* wts, const void* x,
                        void* out, int v_pad, int d, int v, int f, cudaStream_t stream) {
  spmm_ell_kernel<T, VEC, NC><<<p.grid, p.threads, p.smem, stream>>>(
      idx, wts, static_cast<const T*>(x), static_cast<T*>(out), v_pad, d, v, f, p.lanes,
      p.rows, p.cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const int* idx, const float* wts, const void* x, void* out, int v_pad,
                   int d, int v, int f, cudaStream_t stream) {
  const Plan p = make_plan(v_pad, d, f, sizeof(T), reinterpret_cast<uintptr_t>(x));
  auto go = [&](auto vec, auto nc) {
    return launch_plan<T, decltype(vec)::value, decltype(nc)::value>(p, idx, wts, x, out, v_pad,
                                                                     d, v, f, stream);
  };
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  if constexpr (sizeof(T) == 2) {
    if (p.vec == 8) return go(std::integral_constant<int, 8>{}, I1{});
  }
  if (p.vec == 4) return go(I4{}, I1{});
  if (p.vec == 2) return p.nc == 2 ? go(I2{}, I2{}) : go(I2{}, I1{});
  return p.nc == 4 ? go(I1{}, I4{}) : p.nc == 2 ? go(I1{}, I2{}) : go(I1{}, I1{});
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

// The launch spmm_ell_launch would make, into out[8]: grid, threads,
// shared-memory bytes, rows per CTA, slot capacity, vec, lanes, nc.
int spmm_ell_plan(int v_pad, int d, int f, int dtype, const void* x, int* out) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(v_pad, d, f, dtype == 0 ? 4 : 2, reinterpret_cast<uintptr_t>(x));
  const int vals[8] = {p.grid, p.threads, p.smem, p.rows, p.cap, p.vec, p.lanes, p.nc};
  for (int k = 0; k < 8; ++k) out[k] = vals[k];
  return (int)cudaSuccess;
}

const char* spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
