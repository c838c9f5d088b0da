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
// What the design does about it (shared pieces in ../ell.cuh):
//   * One CTA owns R rows (R = 32, halved down to 4 while the grid would
//     hold fewer than two CTAs per SM) and one tile of GT <= 32 output
//     columns.  F is cut into chunks of FC = 256 columns (F rounded up to
//     a power of two where it is narrower), and the chunks into S <= 4
//     contiguous slices, one per CTA of a thread-block cluster along
//     blockIdx.z (S: about two chunks a slice).  Each CTA sweeps its
//     slice's chunks; the cluster's S partial (R x GT) products are summed
//     in slice order through distributed shared memory by its first CTA.
//     So a hub row's gathers are spread over S SMs, and w is read from L2
//     once per R rows: (V_pad / R) * F * G * 4 bytes in all.
//   * It trims each row's trailing weight-0 slots and stages the rows' real
//     (src, weight) pairs in shared memory once, before the F loop, a warp
//     taking 4 of its rows at once: the ELL is read once per CTA, not once
//     per chunk.  A row block with no real
//     slot (the pad rows of a serving batch) writes zeros and ends there,
//     reading no w.
//   * Per chunk, threads are laid out as row groups x column lanes (lanes
//     = FC / (VEC * NC)): a thread takes two columns of the chunk, as VEC = 2
//     (one 8-byte float32 or 4-byte bfloat16 load, where F is even, at
//     least FC, and x aligned to it) or as NC = 2 one-element loads a lane
//     apart, and walks the flat slot list of its group's rows for them
//     (ell::walk, the gathers of 16 slots in flight), so each gather is a
//     coalesced read of one x row.  The sums land in the (R x FC) tile h in shared
//     memory.
//   * The matching (FC x GT) rows of w are staged with cp.async (float32;
//     bfloat16 through registers), double-buffered: chunk c + 1's w is in
//     flight during chunk c's gathers.
//   * Combination on CUDA cores in float32 (single-pass TF32 would miss the
//     2e-4 tolerance): each thread owns a 4 x 4 block of the CTA's (R x GT)
//     outputs and one of KS = 256 / (R/4 * GT/4) interleaved slices of the
//     chunk's columns, reading w as float4 from shared memory; at the end
//     the KS partials of each output are summed in ks order through shared
//     memory.
// Every aggregated element is summed over its slots in ascending order and
// every output over (slice, ks, chunk, column) in a fixed order, in float32
// with no atomics, so results are deterministic; band_size and block_f of
// the schedule do not shape the CTA.  The differences from the TPU kernel
// by design: F is summed in another order (slices and interleaved column
// sets, not block_f chunks), and trailing padded slots are not gathered, so
// an inf or NaN in x[0] does not reach rows whose padding points at it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "../ell.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kChunk = 256;      // FC: feature columns per chunk, at most
constexpr int kMaxRows = 32;     // R: rows per CTA, at most
constexpr int kMaxGT = 32;       // most output columns per CTA
constexpr int kMaxSlices = 4;    // S: CTAs of a cluster sharing one row block's F
constexpr int kUnroll = 16;      // slots whose gathers are in flight together
constexpr int kCap = 1024;       // most staged slots per CTA (8 KB)
constexpr int kRed = kThreads * 16;  // floats of the final partial sums
constexpr int kWPerThread = kChunk * kMaxGT / kThreads;  // bfloat16: w in registers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// smem floats past the staging: h (rows of fc + 1, so that neither the
// column-per-thread stores nor the row reads of the combination meet in one
// bank), or the final partials and the CTA's (R x GT) sum; then w's two
// buffers
__host__ __device__ constexpr int h_floats(int fc, int rows) {
  return (fc + 1) * rows > kRed + kMaxRows * kMaxGT ? (fc + 1) * rows
                                                    : kRed + kMaxRows * kMaxGT;
}

template <typename T, int VEC, int NC>
__global__ void __launch_bounds__(kThreads)
fused_agg_cmb_kernel(const int* __restrict__ idx, const float* __restrict__ wts,
                     const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int v_pad, int d, int v, int f, int g,
                     int gt, int fc, int rows, int cap, int w16) {
  extern __shared__ __align__(16) char smem[];
  int *s_src, *s_off;
  float* s_wt;
  float* h_s = reinterpret_cast<float*>(ell::carve(smem, rows, cap, &s_src, &s_wt, &s_off));
  float* w_s = h_s + h_floats(fc, rows);  // [2][fc][gt]
  const int hld = fc + 1;                 // h_s: [rows][fc + 1]

  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * rows;
  const int g0 = blockIdx.y * gt;
  const int g_here = min(gt, g - g0);
  // this CTA's slice of F: chunks c_begin .. c_end - 1
  const int nchunks = (f + fc - 1) / fc, slices = gridDim.z, slice = blockIdx.z;
  const int c_begin = slice * nchunks / slices, c_end = (slice + 1) * nchunks / slices;
  const int wn = fc * gt;

  // w rows f0 .. f0 + fc - 1, columns g0 .. g0 + gt - 1, zero past F and G
  auto w_async = [&](int f0, float* dst) {  // float32: cp.async, one group
    if (w16) {
      for (int e = tid * 4; e < wn; e += kThreads * 4) {
        const int gg = e % gt, fr = f0 + e / gt;
        const int n = fr < f ? max(0, min(4, g_here - gg)) : 0;
        cp_async16(dst + e, n ? reinterpret_cast<const float*>(w) + (long)fr * g + g0 + gg
                              : reinterpret_cast<const float*>(w), 4 * n);
      }
    } else {
      for (int e = tid; e < wn; e += kThreads) {
        const int gg = e % gt, fr = f0 + e / gt;
        const bool ok = fr < f && gg < g_here;
        cp_async4(dst + e, ok ? reinterpret_cast<const float*>(w) + (long)fr * g + g0 + gg
                              : reinterpret_cast<const float*>(w), ok ? 4 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  float wr[kWPerThread];  // bfloat16: the next chunk's w, held in registers
  auto w_load = [&](int f0) {
#pragma unroll
    for (int i = 0; i < kWPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int gg = e % gt, fr = f0 + e / gt;
      wr[i] = (e < wn && fr < f && gg < g_here) ? to_f32(w[(long)fr * g + g0 + gg]) : 0.f;
    }
  };
  auto w_store = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < kWPerThread; ++i)
      if (tid + i * kThreads < wn) dst[tid + i * kThreads] = wr[i];
  };

  if constexpr (sizeof(T) == 4) {
    if (c_begin < c_end) w_async(c_begin * fc, w_s);
  } else {
    w_load(c_begin * fc);
    w_store(w_s);
  }
  ell::stage<4>(idx, wts, row0, rows, v_pad, d, v, cap, s_src, s_wt, s_off);
  const ell::Staged st{s_src, s_wt, s_off, cap};

  if (s_off[rows] == 0) {
    // no real slot in the row block (every CTA of the cluster stages the
    // same rows, so all take this branch): zeros, and no w read past chunk 0
    if constexpr (sizeof(T) == 4) asm volatile("cp.async.wait_all;\n" ::);
    if (slice == 0)
      for (int o = tid; o < rows * gt; o += kThreads) {
        const int r = o / gt, gg = o % gt;
        if (row0 + r < v_pad && gg < g_here) out[(row0 + r) * g + g0 + gg] = from_f32<T>(0.f);
      }
    return;
  }

  // aggregation: the VEC columns at (lane + n * lanes) * VEC (n < NC) of the
  // chunk, rows rb .. re - 1
  const int lanes = fc / (VEC * NC), lane = tid % lanes, grp = tid / lanes;
  const int groups = kThreads / lanes, per = (rows + groups - 1) / groups;
  const int rb = min(grp * per, rows), re = min(rb + per, rows);
  // combination: a 4 x 4 output block (rt, gq) and the column slice ks
  const int rtn = rows / 4, gqn = gt / 4, tiles = rtn * gqn, ksn = kThreads / tiles;
  const int tile = tid % tiles, ks = tid / tiles, rt = tile % rtn, gq = tile / rtn;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int f0 = c * fc;
    float* w_cur = w_s + ((c - c_begin) & 1) * wn;
    float* w_next = w_s + ((c - c_begin + 1) & 1) * wn;
    const bool more = c + 1 < c_end;
    if constexpr (sizeof(T) == 4) {
      if (more) w_async(f0 + fc, w_next);
    } else {
      if (more) w_load(f0 + fc);
    }

    if (f0 + lane * VEC < f) {
      const int ncv = min(NC, ((f - f0) / VEC - lane + lanes - 1) / lanes);
      ell::walk<T, VEC, NC, kUnroll>(
          st, rb, re, x, f, f0 + lane * VEC, lanes * VEC, ncv, idx, wts, row0, d, v,
          [&](int r, const float (&a)[NC][VEC]) {
#pragma unroll
            for (int n = 0; n < NC; ++n)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                if (n < ncv) h_s[r * hld + (lane + n * lanes) * VEC + e] = a[n][e];
          });
    }

    if constexpr (sizeof(T) == 4) {
      if (more) asm volatile("cp.async.wait_group 1;\n" ::);
      else asm volatile("cp.async.wait_group 0;\n" ::);
    } else {
      if (more) w_store(w_next);
    }
    __syncthreads();

    // columns cc = ks, ks + ksn, ... of the chunk, in ascending order
    const int nc = min(fc, f - f0);
    const float* hrow = h_s + rt * 4 * hld;
    const float4* w4 = reinterpret_cast<const float4*>(w_cur);
    for (int cc = ks; cc < nc; cc += ksn) {
      const float4 wv = w4[cc * gqn + gq];
      const float hr[4] = {hrow[cc], hrow[hld + cc], hrow[2 * hld + cc], hrow[3 * hld + cc]};
      const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hr[i], wc[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the KS partials of each output, summed in ks order
  float* red = h_s;           // [ksn][rows][gt]
  float* part = h_s + kRed;   // [rows][gt]: this CTA's sum over its slice
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(ks * rows + rt * 4 + i) * gt + gq * 4 + j] = acc[i][j];
  __syncthreads();
  for (int o = tid; o < rows * gt; o += kThreads) {
    const int r = o / gt, gg = o % gt;
    float s = red[r * gt + gg];
    for (int k = 1; k < ksn; ++k) s += red[(k * rows + r) * gt + gg];
    if (slices == 1) {
      if (row0 + r < v_pad && gg < g_here) out[(row0 + r) * g + g0 + gg] = from_f32<T>(s);
    } else {
      part[o] = s;
    }
  }
  if (slices == 1) return;
  // the cluster's S slice sums, added in slice order by its first CTA; the
  // second barrier keeps every CTA's shared memory alive until it is read
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (slice == 0) {
    for (int o = tid; o < rows * gt; o += kThreads) {
      const int r = o / gt, gg = o % gt;
      float s = part[o];
      for (int q = 1; q < slices; ++q) s += cluster.map_shared_rank(part, q)[o];
      if (row0 + r < v_pad && gg < g_here) out[(row0 + r) * g + g0 + gg] = from_f32<T>(s);
    }
  }
  cluster.sync();
}

// The launch: grid (row blocks x G tiles x F slices, a cluster of S CTAs
// along z), shared-memory bytes, rows per CTA, slot-list capacity, feature
// columns per chunk, output columns per CTA, columns per load, column
// groups per thread.
struct Plan {
  int grid_x, grid_y, slices, smem, rows, cap, fc, gt, vec, nc;
};

// GT: G rounded up to a power of two in 4 .. 32; FC: F rounded up to a
// power of two, at most 256; VEC = 2 where F is even, at least FC and x
// aligned to two elements, else 1 and NC = 2 where FC >= 64; S: the chunks
// halved, rounded up, at
// most 4; R: the largest power of two up to kMaxRows (at least 4) whose
// grid still gives two CTAs per SM.
Plan make_plan(int v_pad, int d, int f, int g, int es, uintptr_t x) {
  Plan p{};
  p.gt = 4;
  while (p.gt < g && p.gt < kMaxGT) p.gt *= 2;
  p.fc = 1;
  while (p.fc < f && p.fc < kChunk) p.fc *= 2;
  p.vec = (f % 2 == 0 && f >= p.fc && p.fc >= 64 && x % (2 * es) == 0) ? 2 : 1;
  p.nc = p.vec == 1 && p.fc >= 64 ? 2 : 1;
  const int nchunks = (f + p.fc - 1) / p.fc;
  p.slices = (nchunks + 1) / 2 < kMaxSlices ? (nchunks + 1) / 2 : kMaxSlices;
  if (p.slices < 1) p.slices = 1;
  p.grid_y = (g + p.gt - 1) / p.gt;
  const long want = 2L * ell::sm_count();
  p.rows = kMaxRows;
  while (p.rows > 4 &&
         (long)((v_pad + p.rows - 1) / p.rows) * p.grid_y * p.slices < want)
    p.rows /= 2;
  p.cap = (int)(((long)p.rows * d) < kCap ? (long)p.rows * d : kCap);
  p.smem = ell::staged_bytes(p.rows, p.cap) + 4 * (h_floats(p.fc, p.rows) + 2 * p.fc * p.gt);
  p.grid_x = (v_pad + p.rows - 1) / p.rows;
  return p;
}

template <typename T, int VEC, int NC>
cudaError_t launch_plan(const Plan& p, const int* idx, const float* wts, const void* x,
                        const void* w, void* out, int v_pad, int d, int v, int f, int g,
                        cudaStream_t stream) {
  static bool raised = false;  // the opt-in above 48 KB, once per instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_agg_cmb_kernel<T, VEC, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ell::staged_bytes(kMaxRows, kCap) +
            4 * (h_floats(kChunk, kMaxRows) + 2 * kChunk * kMaxGT));
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const int w16 = sizeof(T) == 4 && g % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid_x, p.grid_y, p.slices);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.slices;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fused_agg_cmb_kernel<T, VEC, NC>, idx, wts,
                            static_cast<const T*>(x), static_cast<const T*>(w),
                            static_cast<T*>(out), v_pad, d, v, f, g, p.gt, p.fc, p.rows,
                            p.cap, w16);
}

template <typename T>
cudaError_t launch(const int* idx, const float* wts, const void* x, const void* w,
                   void* out, int v_pad, int d, int v, int f, int g,
                   cudaStream_t stream) {
  const Plan p = make_plan(v_pad, d, f, g, sizeof(T), reinterpret_cast<uintptr_t>(x));
  if (p.vec == 2) return launch_plan<T, 2, 1>(p, idx, wts, x, w, out, v_pad, d, v, f, g, stream);
  if (p.nc == 2) return launch_plan<T, 1, 2>(p, idx, wts, x, w, out, v_pad, d, v, f, g, stream);
  return launch_plan<T, 1, 1>(p, idx, wts, x, w, out, v_pad, d, v, f, g, stream);
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

// The launch fused_agg_cmb_launch would make, into out[11]: grid x, grid y,
// F slices (grid z, the cluster's size), threads, shared-memory bytes, rows
// per CTA, slot capacity, FC, GT, VEC, NC.
int fused_agg_cmb_plan(int v_pad, int d, int f, int g, int dtype, const void* x, int* out) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const Plan p =
      make_plan(v_pad, d, f, g, dtype == 0 ? 4 : 2, reinterpret_cast<uintptr_t>(x));
  const int vals[11] = {p.grid_x, p.grid_y, p.slices, kThreads, p.smem, p.rows,
                        p.cap,    p.fc,     p.gt,     p.vec,    p.nc};
  for (int k = 0; k < 11; ++k) out[k] = vals[k];
  return (int)cudaSuccess;
}

const char* fused_agg_cmb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
