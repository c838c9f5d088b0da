// Dataflow-configurable GEMM on Hopper: out = x (V, F) @ w (F, G),
// accumulated in float32 and cast back to the input dtype.
//
// Replaces: src/repro/kernels/gemm_dataflow/kernel.py, function
// gemm_dataflow (the Pallas TPU kernel behind
// repro.kernels.gemm_dataflow.ops.gemm).
//
// The three dataflows of the paper's Table 1 are three loop orders, each
// keeping its named operand resident in shared memory across the temporal
// loop, as kernel.py:69-88 defines them:
// - output_stationary ({V_s G_s} F_t): a CTA owns an output tile, keeps its
//   accumulator in registers and walks F.
// - weight_stationary ({G_s F_s} V_t): a CTA holds the weight tiles of one
//   G column block resident (as many F tiles as fit: a "slab") and walks
//   V tiles under them.
// - input_stationary ({V_s F_s} G_t): a CTA holds the input tiles of one V
//   row block resident and walks G tiles under them.
// The TPU version revisits its output block in order.  Here the revisits
// of an output tile across F happen in registers while F fits in one slab;
// past that, slab partials go to a float32 workspace owned element by
// element by one CTA, summed in slab order.  No atomics: every result is
// bit-identical across calls.  The paper's tile sizes (block_v/g/f) stay
// at the op's signature; how a CTA covers the work is this kernel's
// choice, planned in ops.py (`plan`) and passed in.
//
// Two routes, chosen by ops.py:
// 1. bf16 with TMA-legal operands (rows of x and w multiples of 16 bytes,
//    bases 16-byte aligned): tensor cores.  CTA tile 128 (V) x 128 (G),
//    K step 64.  Warp 8 is the producer: one thread issues TMA loads into
//    a 4-stage ring of shared-memory tiles under full/empty mbarriers (and
//    the resident slab under its own pair).  Warpgroups 0 and 1 each own
//    64 rows and run wgmma m64n128k16 with the f32 accumulator in
//    registers.  x is the K-major A operand; w (F, G) row-major is an
//    MN-major B operand, read through the transpose bit (no copy of w).
//    Output-stationary is persistent: min(tiles, SMs) CTAs walk the
//    (V tile, G tile) list.
// 2. float32, and bf16 that TMA refuses: CUDA cores, built for skinny G.
//    A CTA of 4 warps owns 16 rows x 16 columns; each warp 4 rows.  Lanes
//    split F (lane l takes f = l, l + 32, ...), so x is read coalesced
//    straight from device memory with no per-element divide, and w is
//    read as float4 from a resident shared-memory slab (whole F up to 1536
//    rows; float4 chunks XOR-swizzled so a quarter-warp reads without
//    bank conflicts).  Each lane holds 4 x 16 partial sums; a fixed
//    butterfly of shuffles leaves lane l with outputs 2l and 2l + 1.  At
//    cora's layer 0 (2708 x 1433 @ 1433 x 16) that is 170 CTAs, two per SM,
//    with the whole of w resident.  Single-pass TF32 is not used: it keeps
//    ~10 mantissa bits and would miss the 1e-4 gate at F = 1433.
//
// What bounds it on this card: at cora's layer-0 combination (f32) bytes,
// ~15.8 MB (~4.7 us at 3.35 TB/s); at smollm's w_gate (4096 x 576 @
// 576 x 1536, bf16) operations, ~7.2 GFLOP (~7.3 us at the bf16 peak).
#include "../hopper.cuh"

namespace {

// ============================================================ common

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One output value of slab `slab` of `nslab`: a single slab writes the
// output; otherwise the first stores into the f32 workspace, later ones add
// to it and the last writes the output in its dtype.
template <typename T>
__device__ __forceinline__ void emit(T* out, float* ws, long long idx, float val, int slab,
                                     int nslab) {
  if (nslab == 1) {
    out[idx] = from_f32<T>(val);
    return;
  }
  const float sum = slab == 0 ? val : ws[idx] + val;
  if (slab == nslab - 1) out[idx] = from_f32<T>(sum);
  else ws[idx] = sum;
}

enum Dataflow { kOutput = 0, kWeight = 1, kInput = 2 };

struct Params {
  const void* x;
  const void* w;
  void* out;
  float* ws;   // slab partials (may alias out when out is f32)
  int v, f, g;
  int slab;    // F rows per slab
  int nslab;
  int split;   // CTAs along the temporal dimension (weight / input)
};

// ============================================================ CUDA cores

constexpr int kCcWarps = 4;
constexpr int kCcThreads = 32 * kCcWarps;
constexpr int kCcRowsPerWarp = 4;
constexpr int kCcRows = kCcWarps * kCcRowsPerWarp;  // 16
constexpr int kCcCols = 16;

// w slab (slab rows x 16 columns, f32) in shared memory: row r's float4
// chunk c sits at chunk c ^ ((r >> 1) & 3).
__device__ __forceinline__ int wsw(int r, int c) {
  return r * kCcCols + ((((c >> 2) ^ (r >> 1)) & 3) << 2) + (c & 3);
}

// One element of a resident slab: float32 by a 4-byte cp.async (no
// register round trip, so every copy of the fill is in flight at once), a
// zero by a plain store, bf16 converted through a register.
__device__ __forceinline__ void fill(float* dst, const float* src, bool ok) {
  if (ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(hopper::smem_u32(dst)), "l"(src) : "memory");
  } else {
    *dst = 0.f;
  }
}
__device__ __forceinline__ void fill(float* dst, const __nv_bfloat16* src, bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.f;
}

// Waits for this thread's cp.async copies; the caller's __syncthreads then
// publishes the slab.
__device__ __forceinline__ void fill_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__device__ void cc_load_w(const Params& p, float* wsm, int k0, int rows, int c0) {
  const T* w = static_cast<const T*>(p.w);
#pragma unroll 8
  for (int e = threadIdx.x; e < rows * kCcCols; e += kCcThreads) {
    const int r = e >> 4, c = e & 15, gj = c0 + c;
    fill(wsm + wsw(r, c), w + (long long)(k0 + r) * p.g + gj, gj < p.g);
  }
  fill_wait();
}

template <typename T>
__device__ void cc_load_x(const Params& p, float* xs, int r0, int k0, int cols) {
  const T* x = static_cast<const T*>(p.x);
  for (int r = 0; r < kCcRows; ++r) {
    const int gi = r0 + r;
#pragma unroll 8
    for (int c = threadIdx.x; c < cols; c += kCcThreads)
      fill(xs + r * p.slab + c, x + (long long)gi * p.f + k0 + c, gi < p.v);
  }
  fill_wait();
}

// acc[i][j] += sum over this lane's f in [k0, k0 + rows) of
// x[r0 + 4 warp + i, f] * w[f, c0 + j]; x from shared memory when XRes
// (xs holds rows r0.., columns k0..), else from device memory; w from the
// resident slab when WRes, else from device memory.
template <typename T, bool XRes, bool WRes>
__device__ __forceinline__ void cc_partial(const Params& p, const float* xs, const float* wsm,
                                           int r0, int c0, int k0, int rows,
                                           float (&acc)[kCcRowsPerWarp][kCcCols]) {
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = r0 + warp * kCcRowsPerWarp;
  const bool wvec = sizeof(T) == 4 && p.g % 4 == 0 && c0 + kCcCols <= p.g &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const T* xrow[kCcRowsPerWarp];
  bool rok[kCcRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kCcRowsPerWarp; ++i) {
    rok[i] = rw + i < p.v;
    xrow[i] = x + (long long)(rok[i] ? rw + i : 0) * p.f + k0;
  }
#pragma unroll 4
  for (int r = lane; r < rows; r += 32) {
    float xv[kCcRowsPerWarp], wv[kCcCols];
#pragma unroll
    for (int i = 0; i < kCcRowsPerWarp; ++i) {
      if (XRes) xv[i] = xs[(warp * kCcRowsPerWarp + i) * p.slab + r];
      else xv[i] = rok[i] ? to_f32(xrow[i][r]) : 0.f;
    }
    if (WRes) {
      const float4* row = reinterpret_cast<const float4*>(wsm + r * kCcCols);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 t = row[(c ^ (r >> 1)) & 3];
        wv[4 * c] = t.x; wv[4 * c + 1] = t.y; wv[4 * c + 2] = t.z; wv[4 * c + 3] = t.w;
      }
    } else if (wvec) {  // a full, 16-byte aligned row of 16 floats
      const float4* wr = reinterpret_cast<const float4*>(w + (long long)(k0 + r) * p.g + c0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 t = __ldg(wr + c);
        wv[4 * c] = t.x; wv[4 * c + 1] = t.y; wv[4 * c + 2] = t.z; wv[4 * c + 3] = t.w;
      }
    } else {
      const T* wr = w + (long long)(k0 + r) * p.g + c0;
#pragma unroll
      for (int j = 0; j < kCcCols; ++j) wv[j] = c0 + j < p.g ? to_f32(wr[j]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kCcRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kCcCols; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void cc_zero(float (&acc)[kCcRowsPerWarp][kCcCols]) {
#pragma unroll
  for (int i = 0; i < kCcRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kCcCols; ++j) acc[i][j] = 0.f;
}

// One butterfly step over 2 Half values: the lanes with bit Half / 2 set
// keep the upper half, the others the lower, each adding its partner's.
template <int Half>
__device__ __forceinline__ void butterfly(float (&v)[64], int lane) {
  constexpr int m = Half / 2;
  const bool hi = lane & m;
#pragma unroll
  for (int k = 0; k < Half; ++k) {
    const float send = hi ? v[k] : v[k + Half];
    const float keep = hi ? v[k + Half] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
  if constexpr (Half > 2) butterfly<Half / 2>(v, lane);
}

// Sums the 64 partials across the warp in a fixed butterfly; lane l ends
// with the totals of flat index 2 l and 2 l + 1 (row l / 8, columns
// 2 (l % 8) + {0, 1}).
__device__ __forceinline__ float2 cc_reduce(const float (&acc)[kCcRowsPerWarp][kCcCols]) {
  float v[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) v[i] = acc[i / 16][i % 16];
  butterfly<32>(v, threadIdx.x & 31);
  return make_float2(v[0], v[1]);
}

template <typename T>
__device__ __forceinline__ void cc_store(const Params& p, int r0, int c0, float2 val, int slab,
                                         int nslab) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = r0 + warp * kCcRowsPerWarp + lane / 8, gj = c0 + 2 * (lane % 8);
  if (gi >= p.v) return;
  T* out = static_cast<T*>(p.out);
  const long long idx = (long long)gi * p.g + gj;
  if (gj < p.g) emit<T>(out, p.ws, idx, val.x, slab, nslab);
  if (gj + 1 < p.g) emit<T>(out, p.ws, idx + 1, val.y, slab, nslab);
}

// grid (split, G blocks): the w slab of G block blockIdx.y resident while
// the CTA walks row groups blockIdx.x, + split, ...  Output-stationary
// (KeepAcc) plans split = row groups, so a CTA owns one 16 x 16 output
// tile and keeps its accumulator in registers across the slabs of F;
// weight-stationary walks its row groups under each slab and sums slab
// partials in the workspace.
template <typename T, bool KeepAcc>
__global__ void __launch_bounds__(kCcThreads) cc_w_resident_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  const int c0 = blockIdx.y * kCcCols, nr = (p.v + kCcRows - 1) / kCcRows;
  float acc[kCcRowsPerWarp][kCcCols];
  cc_zero(acc);
  for (int s = 0; s < p.nslab; ++s) {
    const int k0 = s * p.slab, rows = min(p.slab, p.f - k0);
    __syncthreads();
    cc_load_w<T>(p, wsm, k0, rows, c0);
    __syncthreads();
    for (int rg = blockIdx.x; rg < nr; rg += p.split) {
      if (!KeepAcc) cc_zero(acc);
      cc_partial<T, false, true>(p, nullptr, wsm, rg * kCcRows, c0, k0, rows, acc);
      if (!KeepAcc) cc_store<T>(p, rg * kCcRows, c0, cc_reduce(acc), s, p.nslab);
    }
  }
  if (KeepAcc) cc_store<T>(p, blockIdx.x * kCcRows, c0, cc_reduce(acc), 0, 1);
}

// grid (row groups, split): the x slab of one row group resident while the
// CTA walks G blocks blockIdx.y, + split, ...
template <typename T>
__global__ void __launch_bounds__(kCcThreads) cc_input_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int r0 = blockIdx.x * kCcRows, ng = (p.g + kCcCols - 1) / kCcCols;
  for (int s = 0; s < p.nslab; ++s) {
    const int k0 = s * p.slab, rows = min(p.slab, p.f - k0);
    __syncthreads();
    cc_load_x<T>(p, xs, r0, k0, rows);
    __syncthreads();
    for (int cb = blockIdx.y; cb < ng; cb += p.split) {
      float acc[kCcRowsPerWarp][kCcCols];
      cc_zero(acc);
      cc_partial<T, true, false>(p, xs, nullptr, r0, cb * kCcCols, k0, rows, acc);
      cc_store<T>(p, r0, cb * kCcCols, cc_reduce(acc), s, p.nslab);
    }
  }
}

template <typename T>
cudaError_t cc_launch(const Params& p, int dataflow, dim3 grid, cudaStream_t stream) {
  void (*kernel)(const Params);
  size_t smem;
  if (dataflow != kInput) {
    if (dataflow == kOutput && p.split != (p.v + kCcRows - 1) / kCcRows)
      return cudaErrorInvalidValue;  // one row group per CTA
    kernel = dataflow == kOutput ? cc_w_resident_kernel<T, true> : cc_w_resident_kernel<T, false>;
    smem = (size_t)p.slab * kCcCols * sizeof(float);
  } else {
    kernel = cc_input_kernel<T>;
    smem = (size_t)p.slab * kCcRows * sizeof(float);
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kCcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ============================================================ tensor cores

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 4;
constexpr int kTcThreads = 288;           // 2 consumer warpgroups + 1 producer warp
constexpr int kConsumers = 256;
constexpr uint32_t kTileA = kBM * kBK * 2;  // 16 KB: 128 rows of 128 bytes
constexpr uint32_t kTileB = kBK * kBN * 2;  // 16 KB: 2 panels of 64 rows x 128 bytes
constexpr uint32_t kPanelB = kBK * 128;     // 8 KB
constexpr int kMaxResident = 9;             // resident 16 KB tiles (weight / input)
// Output-stationary: a ring of 4 (A, B) stage pairs, 128 KB.  Weight- and
// input-stationary: a ring of 4 tiles of the walked operand (64 KB), then
// up to 9 resident tiles (144 KB).  Then the barriers.
constexpr uint32_t kRingBytes = kStages * (kTileA + kTileB);
constexpr uint32_t kResOffset = kStages * 16384;
constexpr uint32_t kBarOffset = kResOffset + kMaxResident * 16384;
constexpr size_t kTcSmem = 1024 + kBarOffset + 256;
static_assert(kRingBytes <= kBarOffset, "the output-stationary ring must fit");
static_assert(kTcSmem <= 232448, "227 KB of shared memory per CTA");

struct TcShared {
  uint8_t* ring_a[kStages];
  uint8_t* ring_b[kStages];
  uint8_t* res;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* res_full;
  uint64_t* res_empty;
};

template <int Dataflow>
__device__ __forceinline__ TcShared tc_carve(uint8_t* raw) {
  uint8_t* base = raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
  TcShared s;
  for (int i = 0; i < kStages; ++i) {
    if (Dataflow == kOutput) {
      s.ring_a[i] = base + i * (kTileA + kTileB);
      s.ring_b[i] = s.ring_a[i] + kTileA;
    } else {
      s.ring_a[i] = s.ring_b[i] = base + i * 16384;
    }
  }
  s.res = base + kResOffset;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kBarOffset);
  s.full = bars;
  s.empty = bars + kStages;
  s.res_full = bars + 2 * kStages;
  s.res_empty = bars + 2 * kStages + 1;
  return s;
}

struct TcParams {
  Params p;
  int nv, ng, nk;       // 128-row, 128-column and 64-deep tile counts
  int slab_tiles;       // K tiles per slab (weight / input)
};

// acc += A (128 x 64 tile a, this warpgroup's 64 rows) @ B (64 x 128 tile b)
__device__ __forceinline__ void tc_mma(float (&acc)[64], const uint8_t* a, const uint8_t* b,
                                       int wg) {
  const uint32_t a0 = hopper::smem_u32(a) + wg * 64 * 128, b0 = hopper::smem_u32(b);
  hopper::fence_operands(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    hopper::wgmma_ss_n128<1>(acc, hopper::desc_b128(a0 + kk * 32, 16, 1024),
                             hopper::desc_b128(b0 + kk * 2048, kPanelB, 1024), 1);
  hopper::wgmma_commit();
  hopper::fence_operands(acc);
}

// Writes this thread's accumulator fragment of the (tv, tg) tile.
__device__ __forceinline__ void tc_store(const Params& p, const float (&acc)[64], int tv, int tg,
                                         int slab, int nslab) {
  const int t = threadIdx.x, wg = t / 128, warp = (t / 32) % 4, lane = t % 32;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const int row0 = tv * kBM + wg * 64 + warp * 16 + lane / 4;
  const int col0 = tg * kBN + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = row0 + 8 * h;
    if (gi >= p.v) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int gj = col0 + 8 * j;
      if (gj >= p.g) continue;  // g is a multiple of 8: gj + 1 < g too
      const float lo = acc[4 * j + 2 * h], hi = acc[4 * j + 2 * h + 1];
      const long long idx = (long long)gi * p.g + gj;
      if (nslab == 1) {
        *reinterpret_cast<__nv_bfloat162*>(out + idx) = __floats2bfloat162_rn(lo, hi);
      } else {
        float2 sum = make_float2(lo, hi);
        if (slab > 0) {
          const float2 prev = *reinterpret_cast<const float2*>(p.ws + idx);
          sum.x = prev.x + lo;
          sum.y = prev.y + hi;
        }
        if (slab == nslab - 1)
          *reinterpret_cast<__nv_bfloat162*>(out + idx) = __floats2bfloat162_rn(sum.x, sum.y);
        else
          *reinterpret_cast<float2*>(p.ws + idx) = sum;
      }
    }
  }
}

// The consumer's position in the ring.  A stage is released once the
// wgmma group that read it has retired, which is checked after the next
// stage's group is issued (one group stays in flight).
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  int pending = -1;  // stage whose wgmma group may still be in flight

  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void consumer_release(const TcShared& sh, Ring& ring) {
  hopper::wgmma_wait<1>();
  if (ring.pending >= 0) hopper::mbar_arrive(&sh.empty[ring.pending]);
  ring.pending = ring.stage;
  ring.advance();
}

__device__ __forceinline__ void consumer_drain(const TcShared& sh, Ring& ring) {
  hopper::wgmma_wait<0>();
  if (ring.pending >= 0) hopper::mbar_arrive(&sh.empty[ring.pending]);
  ring.pending = -1;
}

template <int Dataflow>
__global__ void __launch_bounds__(kTcThreads, 1)
    tc_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
              const TcParams tp) {
  extern __shared__ uint8_t smem_raw[];
  const TcShared sh = tc_carve<Dataflow>(smem_raw);
  const Params& p = tp.p;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&sh.full[i], 1);
      hopper::mbar_init(&sh.empty[i], kConsumers);
    }
    hopper::mbar_init(sh.res_full, 1);
    hopper::mbar_init(sh.res_empty, kConsumers);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int nslab = (tp.nk + tp.slab_tiles - 1) / tp.slab_tiles;
  if (threadIdx.x >= kConsumers) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x != kConsumers) return;
    int s = 0;
    uint32_t ph = 0, rph = 0;
    auto acquire = [&](uint32_t bytes) {
      hopper::mbar_wait(&sh.empty[s], ph ^ 1);
      hopper::mbar_arrive_expect_tx(&sh.full[s], bytes);
    };
    auto next = [&]() {
      if (++s == kStages) { s = 0; ph ^= 1; }
    };
    auto load_a = [&](uint8_t* dst, uint64_t* bar, int kt, int tv) {
      hopper::tma_load_2d(dst, &map_x, bar, kt * kBK, tv * kBM);
    };
    auto load_b = [&](uint8_t* dst, uint64_t* bar, int kt, int tg) {
      hopper::tma_load_2d(dst, &map_w, bar, tg * kBN, kt * kBK);
      hopper::tma_load_2d(dst + kPanelB, &map_w, bar, tg * kBN + 64, kt * kBK);
    };
    if (Dataflow == kOutput) {
      for (int tile = blockIdx.x; tile < tp.nv * tp.ng; tile += gridDim.x) {
        const int tv = tile / tp.ng, tg = tile % tp.ng;
        for (int kt = 0; kt < tp.nk; ++kt) {
          acquire(kTileA + kTileB);
          load_a(sh.ring_a[s], &sh.full[s], kt, tv);
          load_b(sh.ring_b[s], &sh.full[s], kt, tg);
          next();
        }
      }
    } else {
      // weight: resident w tiles of G block blockIdx.y, ring of x tiles;
      // input: resident x tiles of V block blockIdx.x, ring of w tiles.
      const int fixed = Dataflow == kWeight ? blockIdx.y : blockIdx.x;
      const int walk0 = Dataflow == kWeight ? blockIdx.x : blockIdx.y;
      const int nwalk = Dataflow == kWeight ? tp.nv : tp.ng;
      for (int sl = 0; sl < nslab; ++sl) {
        const int kt0 = sl * tp.slab_tiles, kt1 = min(tp.nk, kt0 + tp.slab_tiles);
        hopper::mbar_wait(sh.res_empty, rph ^ 1);
        hopper::mbar_arrive_expect_tx(sh.res_full, (kt1 - kt0) * 16384);
        for (int kt = kt0; kt < kt1; ++kt) {
          uint8_t* dst = sh.res + (kt - kt0) * 16384;
          if (Dataflow == kWeight) load_b(dst, sh.res_full, kt, fixed);
          else load_a(dst, sh.res_full, kt, fixed);
        }
        rph ^= 1;
        for (int t = walk0; t < nwalk; t += p.split) {
          for (int kt = kt0; kt < kt1; ++kt) {
            acquire(16384);
            if (Dataflow == kWeight) load_a(sh.ring_a[s], &sh.full[s], kt, t);
            else load_b(sh.ring_b[s], &sh.full[s], kt, t);
            next();
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = threadIdx.x / 128;
  Ring ring;
  float acc[64];
  if (Dataflow == kOutput) {
    for (int tile = blockIdx.x; tile < tp.nv * tp.ng; tile += gridDim.x) {
      const int tv = tile / tp.ng, tg = tile % tp.ng;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < tp.nk; ++kt) {
        hopper::mbar_wait(&sh.full[ring.stage], ring.phase);
        tc_mma(acc, sh.ring_a[ring.stage], sh.ring_b[ring.stage], wg);
        consumer_release(sh, ring);
      }
      consumer_drain(sh, ring);
      tc_store(p, acc, tv, tg, 0, 1);
    }
  } else {
    const int fixed = Dataflow == kWeight ? blockIdx.y : blockIdx.x;
    const int walk0 = Dataflow == kWeight ? blockIdx.x : blockIdx.y;
    const int nwalk = Dataflow == kWeight ? tp.nv : tp.ng;
    uint32_t rph = 0;
    for (int sl = 0; sl < nslab; ++sl) {
      const int kt0 = sl * tp.slab_tiles, kt1 = min(tp.nk, kt0 + tp.slab_tiles);
      hopper::mbar_wait(sh.res_full, rph);
      for (int t = walk0; t < nwalk; t += p.split) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        for (int kt = kt0; kt < kt1; ++kt) {
          hopper::mbar_wait(&sh.full[ring.stage], ring.phase);
          const uint8_t* resident = sh.res + (kt - kt0) * 16384;
          if (Dataflow == kWeight) tc_mma(acc, sh.ring_a[ring.stage], resident, wg);
          else tc_mma(acc, resident, sh.ring_b[ring.stage], wg);
          consumer_release(sh, ring);
        }
        consumer_drain(sh, ring);
        if (Dataflow == kWeight) tc_store(p, acc, t, fixed, sl, nslab);
        else tc_store(p, acc, fixed, t, sl, nslab);
      }
      hopper::mbar_arrive(sh.res_empty);
      rph ^= 1;
    }
  }
}

cudaError_t tc_maps(const Params& p, CUtensorMap* mx, CUtensorMap* mw) {
  const uint64_t dx[2] = {(uint64_t)p.f, (uint64_t)p.v}, sx[1] = {(uint64_t)p.f * 2};
  const uint32_t bx[2] = {kBK, kBM};
  cudaError_t err = hopper::make_map_bf16(mx, p.x, 2, dx, sx, bx);
  if (err != cudaSuccess) return err;
  const uint64_t dw[2] = {(uint64_t)p.g, (uint64_t)p.f}, sw[1] = {(uint64_t)p.g * 2};
  const uint32_t bw[2] = {64, kBK};
  return hopper::make_map_bf16(mw, p.w, 2, dw, sw, bw);
}

cudaError_t tc_launch(const Params& p, int dataflow, dim3 grid, cudaStream_t stream) {
  if (p.f % 8 || p.g % 8) return cudaErrorInvalidValue;
  TcParams tp{p, (p.v + kBM - 1) / kBM, (p.g + kBN - 1) / kBN, (p.f + kBK - 1) / kBK,
              (p.slab + kBK - 1) / kBK};
  if (dataflow != kOutput && (tp.slab_tiles < 1 || tp.slab_tiles > kMaxResident))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  cudaError_t err = tc_maps(p, &mx, &mw);
  if (err != cudaSuccess) return err;
  void (*kernel)(const CUtensorMap, const CUtensorMap, const TcParams);
  if (dataflow == kOutput) kernel = tc_kernel<kOutput>;
  else if (dataflow == kWeight) kernel = tc_kernel<kWeight>;
  else kernel = tc_kernel<kInput>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, kTcSmem, stream>>>(mx, mw, tp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (V, F), w (F, G), out (V, G) row-major; ws a float32 (V, G) workspace
// for slab partials (may be out itself when out is float32; unused when
// nslab is 1).  dataflow: 0 output-, 1 weight-, 2 input-stationary.
// dtype: 0 = float32, 1 = bfloat16.  route: 0 CUDA cores, 1 tensor cores
// (bf16 only).  slab: F rows per slab; split and the grid as ops.plan
// gives them.  Returns a cudaError_t.
int gemm_dataflow_launch(const void* x, const void* w, void* out, void* ws, int v, int f, int g,
                         int dataflow, int dtype, int route, int slab, int split, int grid_x,
                         int grid_y, void* stream) {
  if (v <= 0 || g <= 0 || f <= 0) return (int)cudaSuccess;
  if (dataflow < 0 || dataflow > 2 || slab < 1 || split < 1 || grid_x < 1 || grid_y < 1 ||
      grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{x, w, out, static_cast<float*>(ws), v, f, g, slab, (f + slab - 1) / slab, split};
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)tc_launch(p, dataflow, grid, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)cc_launch<float>(p, dataflow, grid, s);
  if (dtype == 1) return (int)cc_launch<__nv_bfloat16>(p, dataflow, grid, s);
  return (int)cudaErrorInvalidValue;
}

const char* gemm_dataflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
