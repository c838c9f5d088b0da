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
// - float32 scores, running max, denominator and (64 x D) accumulator; the
//   output in the input dtype;
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
// What this first design does about it: little yet -- it is the simple,
// right version.  One CTA of 256 threads per (batch * q-head, 64-row q
// block); q, then each 64-key K/V block, staged in shared memory as f32
// (row stride D + 1, so the score loop reads without bank conflicts); each
// thread owns a 4 x 4 patch of the score tile and a 4 x ceil(D/16) patch of
// the accumulator, all products on CUDA cores in f32.  Row max and row sum
// are shuffles across the 16 threads that share a row.  It sits far above
// the tensor-core bound; wgmma / TMA is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

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
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, out: (B, H, S, D) views given by element strides (D has unit
// stride); q_pos (Sq,), k_pos (Sk,) int32.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           const void* q_pos, const void* k_pos,
                           int b, int hq, int hkv, int sq, int sk, int d,
                           int causal, int window, float scale,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long o_sb, long long o_sh, long long o_ss,
                           int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || d < 8 || d > 128 || d % 8 != 0 ||
      (sq + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out,
                 static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
                 b, hq, hkv, sq, sk, d, causal, window, scale,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
