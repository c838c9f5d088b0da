// Flash-attention forward on Hopper: out = softmax(q k^T * scale, masked) v,
// one online-softmax pass over the keys, the (q x k) score tile never
// leaving the CTA.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, function
// flash_attention_kernel (the Pallas TPU kernel behind
// repro.kernels.flash_attention.ops.flash_attention), and with it the
// lax.scan form _attend_chunked in src/repro/models/attention.py, which the
// TPU kernel "implements the same schedule" as.  Both compute this function.
//
// Semantics kept exactly:
// - float32 scores, running max, denominator and (q rows x D) accumulator;
//   the output in the input dtype;
// - a masked score is the finite sentinel -1e30, not -inf (exp(-inf - -inf)
//   is NaN), and p = exp(s - m_new), alpha = exp(m_prev - m_new) are taken
//   on it as the reference takes them;
// - key blocks are walked in increasing order, so the alpha rescale clears
//   whatever a row gathered before its first valid key;
// - masking is on int32 position vectors (key j is seen by query i when
//   k_pos[j] <= q_pos[i], and k_pos[j] > q_pos[i] - window when window > 0),
//   which is how _attend_chunked masks: the model route passes its
//   positions, the reference op's causal-on-indices mask passes 0..S-1.
//   Keys at index >= Sk are never seen.  With causal = 0 every real key is.
// - GQA without repeating K/V: query head h reads KV head h / (Hq / Hkv),
//   as jnp.repeat(k, rep, axis=1) and _group's reshape both do.
// A key block in which no (query, key) pair of the CTA's tile is seen is
// skipped.  For every row that has already seen a valid key it would add
// exactly 0; a row that never sees one has no defined answer in either
// version (the reference returns a mean of v weighted by its padding), and
// the model's forward passes 0..S-1, where every row sees key 0.
//
// What bounds it on this card: operations.  At smollm-135m prefill (B 4,
// Hq 9, Hkv 3, S 1024, D 64, bf16, causal) the work is ~4.8 GFLOP, ~4.9 us
// at the bf16 tensor-core peak, against ~12.6 MB of q, k, v and out
// (~3.8 us at 3.35 TB/s).
//
// Two routes, chosen by ops.py:
// 1. bf16 whose strides TMA takes (every stride of q, k and v a multiple of
//    16 bytes, bases 16-byte aligned): tensor cores, the FA3 shape.  One CTA
//    takes a 64-row q tile of one (batch, query head), launched heaviest
//    first (the last q tiles see the most keys under the causal mask).
//    The warp after the consumers is the producer: one thread brings q once, then K and V tiles
//    of 64 keys through a 3-stage (D 256: 2) TMA ring under full/empty mbarriers (4-D
//    tensor maps over the (D, S, H, B) strides, so the model's (B, S, H, D)
//    and the op's (B, H, S, D) are read as they lie; D is zero-padded to
//    64, 128 or 256 by the TMA box).  It decides which key blocks to skip from
//    the position ranges and hands each stage's block index to the
//    consumers, flagged when every pair in it is seen (no mask to apply).
//    The consumer warpgroup computes S = q k^T by wgmma (k is the K-major
//    B operand as stored), the online softmax on the
//    accumulator fragments (a row lives in the 4 lanes of a quad, so its
//    max and sum take 2 shuffles), P rounded to bf16 in registers and fed
//    to the second wgmma as its register A operand against V, the MN-major
//    B operand read through the transpose bit.  The score tile never
//    reaches shared memory.  The P V product of one key block is issued
//    before S of the next, so the tensor cores run the two back to back
//    while the softmax waits.  Scores are scaled by scale * log2(e) and
//    exponentiated with exp2, which is the same function.  Rounding P to
//    bf16 is the one rounding the plain version (p in f32) does not make.
//    At D = 256 (recurrentgemma's local blocks, MQA 10 / 1, window 2048)
//    the O accumulator is 128 f32 registers a thread and the q panels plus
//    the K/V ring take 165 KB of shared memory in two stages (three would
//    leave 1.8 KB of the 227 KB a block may take): one CTA an SM, and P V
//    is two m64n128 products, one per half of O.  This is the simple form
//    of D = 256; it was not tuned.
// 2. float32, and bf16 that TMA refuses: CUDA cores (this route was not
//    redesigned).  One CTA of 256 threads per (batch * q-head, 64-row q
//    block); q, then each 64-key K/V block, staged in shared memory as f32
//    (row stride D + 1, so the score loop reads without bank conflicts);
//    each thread owns a 4 x 4 patch of the score tile and a 4 x ceil(D/16)
//    patch of the accumulator (4 x 16 past D = 128), all products in f32
//    (214 KB of shared memory at D = 256).  Row max and row sum
//    are shuffles across the 16 threads that share a row.  Single-pass TF32
//    tensor cores would miss the f32 gate (2e-4 / 2e-5).
#include <climits>

#include "../hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int kLdp = kBlockK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* q_pos;
  const int* k_pos;
  int b, hq, hkv, sq, sk, d, causal, window;
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

size_t smem_bytes(int d) {
  const size_t floats = (size_t)kBlockQ * (d + 1) + (size_t)kBlockK * (d + 1) +
                        (size_t)kBlockK * d + (size_t)kBlockQ * kLdp;
  return floats * sizeof(float) + 2 * (kBlockQ + kBlockK) * sizeof(int);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NC: output column groups of 16 per thread (D <= 16 * NC).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int d = p.d, ld = d + 1;
  float* qs = smem;                        // [kBlockQ][d + 1], q * scale
  float* ks = qs + kBlockQ * ld;           // [kBlockK][d + 1]
  float* vs = ks + kBlockK * ld;           // [kBlockK][d]
  float* ps = vs + kBlockK * d;            // [kBlockQ][kLdp], probabilities
  int* qpos = reinterpret_cast<int*>(ps + kBlockQ * kLdp);
  int* qok = qpos + kBlockQ;
  int* kpos = qok + kBlockQ;
  int* kok = kpos + kBlockK;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.x / p.hq, h = blockIdx.x % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.out) + bi * p.o_sb + h * p.o_sh;

  for (int e = tid; e < kBlockQ * d; e += kThreads) {
    const int r = e / d, c = e - r * d, qi = q0 + r;
    qs[r * ld + c] = qi < p.sq ? to_f32(q[qi * p.q_ss + c]) * p.scale : 0.f;
  }
  if (tid < kBlockQ) {
    const int qi = q0 + tid;
    qok[tid] = qi < p.sq;
    qpos[tid] = qi < p.sq ? p.q_pos[qi] : 0;
  }

  float acc[4][NC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kb = (p.sk + kBlockK - 1) / kBlockK;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // the previous block's reads of ks / vs / ps are done
    if (tid < kBlockK) {
      const int kj = k0 + tid;
      kok[tid] = kj < p.sk;
      kpos[tid] = kj < p.sk ? p.k_pos[kj] : 0;
    }
    __syncthreads();

    // which of this thread's 16 (row, key) pairs are seen
    unsigned seen = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        bool ok = qok[r] && kok[c];
        if (ok && p.causal) {
          const long long qp = qpos[r], kp = kpos[c];
          ok = kp <= qp && (p.window <= 0 || kp > qp - p.window);
        }
        if (ok) seen |= 1u << (i * 4 + j);
      }
    }
    if (!__syncthreads_or(seen != 0)) continue;  // adds exactly 0 (see note)

    for (int e = tid; e < kBlockK * d; e += kThreads) {
      const int r = e / d, c = e - r * d, kj = k0 + r;
      const bool in = kj < p.sk;
      ks[r * ld + c] = in ? to_f32(k[kj * p.k_ss + c]) : 0.f;
      vs[r * d + c] = in ? to_f32(v[kj * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!((seen >> (i * 4 + j)) & 1u)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        ps[(ty + 16 * i) * kLdp + tx + 16 * j] = s[i][j];
      }
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + row_sum16(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kBlockK; ++kk) {
      float pr[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * kLdp + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < d ? vs[kk * d + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) o[qi * p.o_ss + col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.d);
  auto kernel = flash_fwd_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(p.b * p.hq), (unsigned)((p.sq + kBlockQ - 1) / kBlockQ));
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  switch ((p.d + 15) / 16) {
    case 1: return launch_nc<T, 1>(p, stream);
    case 2: return launch_nc<T, 2>(p, stream);
    case 3: return launch_nc<T, 3>(p, stream);
    case 4: return launch_nc<T, 4>(p, stream);
    case 5: return launch_nc<T, 5>(p, stream);
    case 6: return launch_nc<T, 6>(p, stream);
    case 7: return launch_nc<T, 7>(p, stream);
    case 8: return launch_nc<T, 8>(p, stream);
  }
  return p.d <= 256 ? launch_nc<T, 16>(p, stream) : cudaErrorInvalidValue;
}

// ============================================================ tensor cores

// One consumer warpgroup (64 q rows) a CTA, so more and smaller CTAs share
// each SM (three at D <= 64) and the causal work spreads more evenly.
template <int DP>
__host__ __device__ constexpr int tc_min_blocks() {
  return DP == 64 ? 3 : (DP == 128 ? 2 : 1);
}
// K/V ring stages: three, two at D = 256 (where three would fill a block's
// shared memory but for 1.8 KB)
template <int DP>
__host__ __device__ constexpr int tc_stages() { return DP == 256 ? 2 : 3; }
constexpr int kTcBlockQ = 64;                 // one consumer warpgroup's rows
constexpr int kTcBlockK = 64;
constexpr int kTcConsumers = 128;
constexpr int kTcThreads = kTcConsumers + 32;  // + 1 producer warp
constexpr uint32_t kQPanel = kTcBlockQ * 128;   // kTcBlockQ rows x 64 bf16
constexpr uint32_t kKVPanel = kTcBlockK * 128;  // 8 KB: 64 keys x 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

struct TcParams {
  Params p;
  int q_ord[3], k_ord[3], v_ord[3];  // map dim 1..3 -> 0 = S, 1 = H, 2 = B
};

template <int DP>
constexpr size_t tc_smem_bytes() {
  return 1024 + (size_t)(DP / 64) * (kQPanel + 2 * tc_stages<DP>() * kKVPanel) + 256;
}

__device__ __forceinline__ int pick(int which, int s, int h, int b) {
  return which == 0 ? s : (which == 1 ? h : b);
}

__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         const int (&ord)[3], int col, int s, int h, int b) {
  hopper::tma_load_4d(dst, map, bar, col, pick(ord[0], s, h, b), pick(ord[1], s, h, b),
                      pick(ord[2], s, h, b));
}

// DP: head_dim padded to 64, 128 or 256 (one, two or four 64-column
// panels).  Below 256 several CTAs share an SM, so one CTA's softmax
// overlaps another's products.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<DP>())
    flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const TcParams tp) {
  constexpr int NP = DP / 64;
  constexpr int kTcStages = tc_stages<DP>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                                    // NP x 16 KB
  uint8_t* ks = qs + NP * kQPanel;                       // stages x NP x 8 KB
  uint8_t* vs = ks + kTcStages * NP * kKVPanel;          // stages x NP x 8 KB
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kTcStages * NP * kKVPanel);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kTcStages;
  int* stage_kb = reinterpret_cast<int*>(empty + kTcStages);

  const Params& p = tp.p;
  const int n_qt = (p.sq + kTcBlockQ - 1) / kTcBlockQ, bhs = p.b * p.hq;
  const int qt = n_qt - 1 - (int)(blockIdx.x / bhs);  // heaviest q tiles first
  const int bh = blockIdx.x % bhs, bi = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = qt * kTcBlockQ;
  const int n_kb = (p.sk + kTcBlockK - 1) / kTcBlockK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < kTcStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kTcConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    // ------------------------------------------------------------ producer
    const int lane = threadIdx.x - kTcConsumers;
    // position range of the tile's real rows, for the block skip
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int r = lane; r < kTcBlockQ; r += 32) {
      if (q0 + r < p.sq) {
        const int qp = p.q_pos[q0 + r];
        qmin = min(qmin, qp);
        qmax = max(qmax, qp);
      }
    }
    qmin = __reduce_min_sync(0xffffffffu, qmin);
    qmax = __reduce_max_sync(0xffffffffu, qmax);
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(q_full, NP * kQPanel);
      for (int pn = 0; pn < NP; ++pn)
        tma_tile(qs + pn * kQPanel, &map_q, q_full, tp.q_ord, pn * 64, q0, h, bi);
    }
    int s = 0;
    uint32_t ph = 0;
    for (int kb = 0; kb < n_kb; ++kb) {
      const int k0 = kb * kTcBlockK;
      // a block every pair of which is seen needs no mask
      bool unmasked = k0 + kTcBlockK <= p.sk;
      if (p.causal) {
        // skip a block none of whose (row, key) pairs is seen: every key
        // after every row, or (window) every key too far behind every row
        int kmin = INT_MAX, kmax = INT_MIN;
        for (int c = lane; c < kTcBlockK; c += 32) {
          if (k0 + c < p.sk) {
            const int kp = p.k_pos[k0 + c];
            kmin = min(kmin, kp);
            kmax = max(kmax, kp);
          }
        }
        kmin = __reduce_min_sync(0xffffffffu, kmin);
        kmax = __reduce_max_sync(0xffffffffu, kmax);
        if ((long long)kmin > qmax ||
            (p.window > 0 && (long long)kmax <= (long long)qmin - p.window))
          continue;
        unmasked = unmasked && kmax <= qmin &&
               (p.window <= 0 || (long long)kmin > (long long)qmax - p.window);
      }
      if (lane == 0) {
        hopper::mbar_wait(&empty[s], ph ^ 1);
        stage_kb[s] = 2 * kb + (unmasked ? 1 : 0);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * NP * kKVPanel);
        for (int pn = 0; pn < NP; ++pn) {
          uint8_t* kd = ks + (s * NP + pn) * kKVPanel;
          uint8_t* vd = vs + (s * NP + pn) * kKVPanel;
          tma_tile(kd, &map_k, &full[s], tp.k_ord, pn * 64, k0, hk, bi);
          tma_tile(vd, &map_v, &full[s], tp.v_ord, pn * 64, k0, hk, bi);
        }
      }
      __syncwarp();
      if (++s == kTcStages) { s = 0; ph ^= 1; }
    }
    if (lane == 0) {  // the end of the walk
      hopper::mbar_wait(&empty[s], ph ^ 1);
      stage_kb[s] = -1;
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  int qp[2];
  bool qok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + lane / 4 + 8 * hh;
    qok[hh] = qi < p.sq;
    qp[hh] = qok[hh] ? p.q_pos[qi] : 0;
  }
  const float scale2 = p.scale * kLog2e;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  const uint32_t q_addr = hopper::smem_u32(qs);

  float sc[32];   // S, then P, of the current key block (64 rows x 64 keys)
  uint32_t pa[4][4];  // P in bf16: the A fragments of the four k16 steps
  float alpha[2];

  // S = q k^T for the block in stage st, issued and committed
  auto issue_scores = [&](int st) {
    const uint32_t k_addr = hopper::smem_u32(ks + st * NP * kKVPanel);
    hopper::fence_operands(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      hopper::wgmma_ss_n64<0>(
          sc, hopper::desc_b128(q_addr + (kk / 4) * kQPanel + off, 16, 1024),
          hopper::desc_b128(k_addr + (kk / 4) * kKVPanel + off, 16, 1024), kk > 0 ? 1 : 0);
    }
    hopper::wgmma_commit();
  };

  // mask (unless the producer found every pair seen), scale (log2 domain),
  // online softmax on the fragments; leaves P in pa and the rescale in alpha
  auto softmax = [&](int code) {
    hopper::fence_operands(sc);
    const int k0 = (code >> 1) * kTcBlockK;
    const bool unmasked = code & 1;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + 2 * quad + e;
        const bool kok = kj < p.sk;
        const long long kp = kok && !unmasked ? __ldg(p.k_pos + kj) : 0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          bool seen = kok;
          if (seen && p.causal && !unmasked)
            seen = kp <= qp[hh] && (p.window <= 0 || kp > (long long)qp[hh] - p.window);
          float& x = sc[4 * j + 2 * hh + e];
          x = seen ? x * scale2 : kNegInf;
          mx[hh] = fmaxf(mx[hh], x);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_i[hh], mx[hh]);
      alpha[hh] = exp2f(m_i[hh] - m_new);
      m_i[hh] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * hh + e];
          x = exp2f(x - m_i[hh]);
          sum[hh] += x;
        }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l_i[hh] = alpha[hh] * l_i[hh] + sum[hh];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hopper::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  // The walk: PV of block j is issued, then S of block j + 1 behind it, so
  // the tensor cores run the two back to back; one wait retires both, the
  // stage of block j is released and the softmax of block j + 1 follows.
  hopper::mbar_wait(q_full, 0);
  int s = 0;
  uint32_t ph = 0;
  hopper::mbar_wait(&full[s], ph);
  int code = stage_kb[s];
  if (code >= 0) {
    issue_scores(s);
    hopper::wgmma_wait<0>();
    softmax(code);
    while (true) {
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          o[4 * j + 2 * hh] *= alpha[hh];
          o[4 * j + 2 * hh + 1] *= alpha[hh];
        }
      // O += P V (64 rows x DP)
      const uint32_t v_addr = hopper::smem_u32(vs + s * NP * kKVPanel);
      hopper::fence_operands(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = hopper::desc_b128(v_addr + kk * 2048, kKVPanel, 1024);
        if constexpr (DP == 64) {
          hopper::wgmma_rs_n64<1>(o, pa[kk], dv, 1);
        } else if constexpr (DP == 128) {
          hopper::wgmma_rs_n128<1>(o, pa[kk], dv, 1);
        } else {  // columns 0-127, then 128-255 (panels 2 and 3)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            hopper::wgmma_rs_n128<1>(
                *reinterpret_cast<float(*)[64]>(o + 64 * half), pa[kk],
                hopper::desc_b128(v_addr + 2 * half * kKVPanel + kk * 2048, kKVPanel, 1024),
                1);
        }
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::fence_operands(pa[kk]);
      const int cur = s;
      if (++s == kTcStages) { s = 0; ph ^= 1; }
      hopper::mbar_wait(&full[s], ph);
      code = stage_kb[s];
      if (code >= 0) issue_scores(s);
      hopper::wgmma_wait<0>();
      hopper::fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::fence_operands(pa[kk]);
      hopper::mbar_arrive(&empty[cur]);
      if (code < 0) break;
      softmax(code);
    }
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + bi * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!qok[hh]) continue;
    const int qi = q0 + warp * 16 + lane / 4 + 8 * hh;
    const float denom = fmaxf(l_i[hh], 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (col < p.d)  // d is a multiple of 8: col + 1 < d too
        *reinterpret_cast<__nv_bfloat162*>(out + qi * p.o_ss + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] / denom, o[4 * j + 2 * hh + 1] / denom);
    }
  }
}

// A 4-D map over a (B, H, S, D) view with element strides sb, sh, ss: dim 0
// is D (box 64), the other three in increasing stride (a dim of extent 1
// never steps and takes the largest stride); ord names each.
cudaError_t qkv_map(CUtensorMap* map, const void* base, int d, int s, int h, int b,
                    long long ss, long long sh, long long sb, int box_rows, int (&ord)[3]) {
  struct Dim {
    uint64_t ext, stride;
    uint32_t box;
    int logical;
  } dims[3] = {{(uint64_t)s, (uint64_t)ss * 2, (uint32_t)box_rows, 0},
               {(uint64_t)h, (uint64_t)sh * 2, 1, 1},
               {(uint64_t)b, (uint64_t)sb * 2, 1, 2}};
  uint64_t widest = 16;
  for (const Dim& dm : dims)
    if (dm.ext > 1 && dm.stride > widest) widest = dm.stride;
  for (Dim& dm : dims)
    if (dm.ext == 1) dm.stride = widest;
  for (int i = 1; i < 3; ++i)  // insertion sort by stride
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  const uint64_t gd[4] = {(uint64_t)d, dims[0].ext, dims[1].ext, dims[2].ext};
  const uint64_t gs[3] = {dims[0].stride, dims[1].stride, dims[2].stride};
  const uint32_t box[4] = {64, dims[0].box, dims[1].box, dims[2].box};
  for (int i = 0; i < 3; ++i) ord[i] = dims[i].logical;
  return hopper::make_map_bf16(map, base, 4, gd, gs, box);
}

template <int DP>
cudaError_t tc_launch_dp(const Params& p, cudaStream_t stream) {
  TcParams tp{p, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
  CUtensorMap mq, mk, mv;
  cudaError_t err = qkv_map(&mq, p.q, p.d, p.sq, p.hq, p.b, p.q_ss, p.q_sh, p.q_sb,
                            kTcBlockQ, tp.q_ord);
  if (err == cudaSuccess)
    err = qkv_map(&mk, p.k, p.d, p.sk, p.hkv, p.b, p.k_ss, p.k_sh, p.k_sb, kTcBlockK, tp.k_ord);
  if (err == cudaSuccess)
    err = qkv_map(&mv, p.v, p.d, p.sk, p.hkv, p.b, p.v_ss, p.v_sh, p.v_sb, kTcBlockK, tp.v_ord);
  if (err != cudaSuccess) return err;
  auto kernel = flash_tc_kernel<DP>;
  constexpr size_t smem = tc_smem_bytes<DP>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)p.b * p.hq * ((p.sq + kTcBlockQ - 1) / kTcBlockQ);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, kTcThreads, smem, stream>>>(mq, mk, mv, tp);
  return cudaGetLastError();
}

cudaError_t tc_launch(const Params& p, cudaStream_t stream) {
  if (p.d <= 64) return tc_launch_dp<64>(p, stream);
  return p.d <= 128 ? tc_launch_dp<128>(p, stream) : tc_launch_dp<256>(p, stream);
}

}  // namespace

extern "C" {

// q, k, v, out: (B, H, S, D) views given by element strides (D has unit
// stride); q_pos (Sq,), k_pos (Sk,) int32.  dtype: 0 = float32, 1 = bfloat16.
// route: 0 CUDA cores, 1 tensor cores (bf16 whose strides TMA takes).
// Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           const void* q_pos, const void* k_pos,
                           int b, int hq, int hkv, int sq, int sk, int d,
                           int causal, int window, float scale,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long o_sb, long long o_sh, long long o_ss,
                           int dtype, int route, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || d < 8 || d > 256 || d % 8 != 0 ||
      (sq + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out,
                 static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
                 b, hq, hkv, sq, sk, d, causal, window, scale,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss};
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 1) return dtype == 1 ? (int)tc_launch(p, s) : (int)cudaErrorInvalidValue;
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
