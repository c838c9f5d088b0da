// Shared pieces of the two ELL kernels (spmm.cu, fused_agg_cmb.cu):
// staging a CTA's real neighbor slots in shared memory, and walking them.
//
// Trim.  In a padded ELL (graphs/csr.py to_ell, batching.assemble) a row's
// real slots come first and the padding after, each padded slot pointing at
// row 0 with weight 0.  A row's real slots are those before its trailing
// run of weight-exactly-0 slots; one warp finds that length from the
// weights alone, 32 slots at a time with __ballot_sync.  Skipping a trailing weight-0 slot leaves every finite sum
// exactly as it was (fmaf(0, x, acc) == acc); a weight-0 slot in the middle
// of a row is still walked.
//
// Stage.  The CTA packs (src, weight) of its R rows' real slots into one
// flat list in shared memory, row after row (row r's slots at
// off[r] .. off[r+1]), so every column-thread reads them by broadcast.  The
// list holds at most `cap` slots; slots past it (more real slots in R rows
// than `cap`, which the launchers make rare) are read from global memory
// in the walk.  The ELL is read once per CTA: the weights of every slot,
// the indices of the real ones.
//
// Walk.  A thread walks the flat slots of a contiguous range of rows for
// one or a few groups of columns: it issues the gathers of x for U slots
// (their rows read from shared memory), and only then applies the
// multiply-adds in slot order (their weights read from shared memory), closing a row (handing its sum to the sink)
// when the next slot belongs to the next row.  So U gathers per column
// group are in flight whatever the rows' lengths, and every output is
// summed over its slots in ascending order, in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ell {

// Device-side view of a CTA's staged slot lists.
struct Staged {
  const int* src;    // [cap] gathered row, clamped into [0, v)
  const float* wt;   // [cap]
  const int* off;    // [R + 1] flat offset of each row's first slot
  int cap;
};

// Bytes of shared memory a CTA of `rows` rows and a list of `cap` slots
// takes for its staging, rounded up to 16.
__host__ __device__ constexpr int staged_bytes(int rows, int cap) {
  return ((cap * 8 + (rows + 1) * 4) + 15) / 16 * 16;
}

// Lays the staging arrays out at `smem`; returns the first byte after them.
__device__ __forceinline__ char* carve(char* smem, int rows, int cap, int** src,
                                       float** wt, int** off) {
  *src = reinterpret_cast<int*>(smem);
  *wt = reinterpret_cast<float*>(smem + cap * 4);
  *off = reinterpret_cast<int*>(smem + cap * 8);
  return smem + staged_bytes(rows, cap);
}

// Trims and stages rows row0 .. row0 + rows - 1 (rows past v_pad count as
// empty).  Every thread of the CTA calls it; blockDim.x is a multiple of 32.
// A warp takes RIF of its rows at once, their loads in flight together (RIF
// > 1 pays where a CTA has several rows a warp).  Ends with __syncthreads().
template <int RIF>
__device__ __forceinline__ void stage(const int* __restrict__ idx, const float* __restrict__ wts,
                                      long row0, int rows, int v_pad, int d, int v, int cap,
                                      int* s_src, float* s_wt, int* s_off) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  // 1. trimmed length of each row, into s_off[r + 1]: the weights of up to
  //    256 slots of each of the warp's RIF rows loaded together, then tested
  //    32 at a time
  for (int r0 = warp; r0 < rows; r0 += nwarps * RIF) {
    int len[RIF] = {};
    for (int base = 0; base < d; base += 256) {
      float wv[RIF][8];
#pragma unroll
      for (int q = 0; q < RIF; ++q) {
        const long r = row0 + r0 + q * nwarps;
        const bool live = r0 + q * nwarps < rows && r < v_pad;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = base + 32 * i + lane;
          wv[q][i] = live && j < d ? __ldg(wts + r * d + j) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < RIF; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const unsigned m = __ballot_sync(0xffffffffu, wv[q][i] != 0.f);
          if (m) len[q] = base + 32 * i + 32 - __clz(m);
        }
    }
#pragma unroll
    for (int q = 0; q < RIF; ++q)
      if (lane == 0 && r0 + q * nwarps < rows) s_off[r0 + q * nwarps + 1] = len[q];
  }
  __syncthreads();
  // 2. exclusive scan of the lengths (warp 0)
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < rows; base += 32) {
      const int r = base + lane;
      int x = r < rows ? s_off[r + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (r < rows) s_off[r + 1] = carry + x;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) s_off[0] = 0;
  }
  __syncthreads();
  // 3. the real slots' (src, weight), packed row after row: the first 32
  //    of the warp's RIF rows loaded together, then any further slots
  for (int r0 = warp; r0 < rows; r0 += nwarps * RIF) {
    int src[RIF];
    float wt[RIF];
#pragma unroll
    for (int q = 0; q < RIF; ++q) {
      const int r = r0 + q * nwarps;
      const int o = r < rows ? s_off[r] : 0, len = r < rows ? s_off[r + 1] - o : 0;
      const long e0 = (row0 + r) * (long)d;
      if (lane < len && o + lane < cap) {
        src[q] = __ldg(idx + e0 + lane);
        wt[q] = __ldg(wts + e0 + lane);
      }
    }
#pragma unroll
    for (int q = 0; q < RIF; ++q) {
      const int r = r0 + q * nwarps;
      const int o = r < rows ? s_off[r] : 0, len = r < rows ? s_off[r + 1] - o : 0;
      const long e0 = (row0 + r) * (long)d;
      if (lane < len && o + lane < cap) {
        s_src[o + lane] = min(max(src[q], 0), v - 1);
        s_wt[o + lane] = wt[q];
      }
      for (int j = lane + 32; j < len && o + j < cap; j += 32) {
        s_src[o + j] = min(max(__ldg(idx + e0 + j), 0), v - 1);
        s_wt[o + j] = __ldg(wts + e0 + j);
      }
    }
  }
  __syncthreads();
}

// VEC consecutive elements of T from global memory as float32, in one load
// of VEC * sizeof(T) bytes (p aligned to it).
template <typename T, int VEC> struct Load;
template <> struct Load<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float (&f)[1]) { f[0] = __ldg(p); }
};
template <> struct Load<float, 2> {
  static __device__ __forceinline__ void run(const float* p, float (&f)[2]) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    f[0] = t.x; f[1] = t.y;
  }
};
template <> struct Load<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float (&f)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
  }
};
// bf16 -> f32 is exact: the bf16 bits are the high half of the f32
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
template <> struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&f)[1]) {
    f[0] = lo_bf16(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
};
template <> struct Load<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&f)[2]) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
    f[0] = lo_bf16(u); f[1] = hi_bf16(u);
  }
};
template <> struct Load<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&f)[4]) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    f[0] = lo_bf16(u.x); f[1] = hi_bf16(u.x); f[2] = lo_bf16(u.y); f[3] = hi_bf16(u.y);
  }
};
template <> struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    f[0] = lo_bf16(u.x); f[1] = hi_bf16(u.x); f[2] = lo_bf16(u.y); f[3] = hi_bf16(u.y);
    f[4] = lo_bf16(u.z); f[5] = hi_bf16(u.z); f[6] = lo_bf16(u.w); f[7] = hi_bf16(u.w);
  }
};

// Walks the staged slots of rows rb .. re - 1 for NC groups of VEC columns,
// at x + col + n * cstep for n < ncv (ld: x's row length in elements), with
// U * NC gathers in flight; calls sink(r, acc) once per row, in row order,
// empty rows with zeros (acc: float[NC][VEC]).
template <typename T, int VEC, int NC, int U, typename Sink>
__device__ __forceinline__ void walk(const Staged& st, int rb, int re, const T* __restrict__ x,
                                     long ld, int col, int cstep, int ncv,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ wts, long row0, int d, int v,
                                     Sink&& sink) {
  if (rb >= re) return;
  float acc[NC][VEC];
  auto zero = [&]() {
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[n][e] = 0.f;
  };
  zero();
  int cur = rb, nxt = st.off[rb + 1];
  int k = st.off[rb];
  const int kend = st.off[re], kst = max(k, min(kend, st.cap));
  auto close_rows = [&](int kk) {
    while (kk >= nxt) {
      sink(cur, acc);
      zero();
      ++cur;
      nxt = st.off[cur + 1];
    }
  };
  auto fma_slot = [&](float w, const float (&xv)[NC][VEC]) {
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[n][e] = fmaf(w, xv[n][e], acc[n][e]);
  };
  // batches of U slots; the last batch's missing slots are predicated off,
  // so its gathers too are issued together
  for (; k < kst; k += U) {
    float xv[U][NC][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u < kst) {
        const T* row = x + (long)st.src[k + u] * ld + col;
#pragma unroll
        for (int n = 0; n < NC; ++n)
          if (n < ncv) Load<T, VEC>::run(row + n * cstep, xv[u][n]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u < kst) {
        close_rows(k + u);
        fma_slot(st.wt[k + u], xv[u]);
      }
    }
  }
  k = kst;
  // slots past the staged list: straight from the ELL in global memory
  for (; k < kend; ++k) {
    close_rows(k);
    const long el = (row0 + cur) * (long)d + (k - st.off[cur]);
    const int src = min(max(__ldg(idx + el), 0), v - 1);
    float xv[NC][VEC];
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (n < ncv) Load<T, VEC>::run(x + (long)src * ld + col + n * cstep, xv[n]);
    fma_slot(__ldg(wts + el), xv);
  }
  for (; cur < re; ++cur) {
    sink(cur, acc);
    zero();
  }
}

// Float32 values to VEC elements of T at p (aligned to VEC * sizeof(T)).
template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&f)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (VEC == 1) *p = f[0];
    else if constexpr (VEC == 2) *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    else *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = __float2bfloat16_rn(f[e]);
  }
}

// The multiprocessor count of the current device (read once).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

}  // namespace ell
