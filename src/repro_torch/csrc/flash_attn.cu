// flash_attn: causal (optionally sliding-window) self-attention with the
// online softmax, for prefill.
//
// Replaces the TPU kernel flash_attention_raw (_make_kernel) in
// src/repro/kernels/flash_attn/flash_attn.py.  Per (batch, query head,
// query tile) it walks the key tiles up to the causal limit, keeping the
// softmax state in f32 as the TPU kernel's scratch does:
//
//     s     = q k_j^T * scale          (masked: kp <= qp, kp > qp - window)
//     m'    = max(m, rowmax(s));  alpha = exp(m - m')
//     p     = where(valid, exp(s - m'), 0)
//     l     = alpha*l + rowsum(p);  acc = alpha*acc + p v_j
//     out   = acc / max(l, 1e-30)
//
// Scores and probabilities never leave shared memory: device memory sees the
// q/k/v reads and the output write only.  GQA reads kv head h / (H / KV)
// directly; K/V are never repeated in device memory.  The sequence length is
// taken as it is, with no padding in device memory, so the TPU kernel's
// `s_valid` mask is the sequence end: rows and keys past S do not exist.
//
// What bounds it on an H100: at the serving prefill shapes (B = 1, S = 16 to
// 64, H = 12, hd = 64, bf16) the work is a few MFLOP and a few hundred KB per
// layer, microseconds or less either way; the launch and the serial
// per-tile steps set the time.  At long sequences the S^2*hd score and
// value products make it bound by operations on the tensor cores, which this
// simple kernel does not use.
//
// Design (simple and right first): one 128-thread block per (query tile of
// 16 rows, head, batch); each key tile of 32 rows is staged as f32 in shared
// memory (K rows padded by one float, so that neighbouring threads scoring
// neighbouring keys hit distinct banks), scored by dot products in f32, its
// statistics updated by one thread per query row, and the f32 accumulator
// rescaled in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 16;  // query rows per block
constexpr int BK = 32;  // keys per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ bool visible(int qp, int kp, int window) {
  return kp <= qp && (window == 0 || kp > qp - window);
}

// Shared layout (f32): q[BQ*hd] | k[BK*(hd+1)] | v[BK*hd] | p[BQ*BK]
//                      | acc[BQ*hd] | m[BQ] | l[BQ] | alpha[BQ]
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S, int H,
                  int KV, int hd, float scale, int window) {
  extern __shared__ float smem[];
  const int kstride = hd + 1;
  float* q_s = smem;
  float* k_s = q_s + BQ * hd;
  float* v_s = k_s + BK * kstride;
  float* p_s = v_s + BK * hd;
  float* acc_s = p_s + BQ * BK;
  float* m_s = acc_s + BQ * hd;
  float* l_s = m_s + BQ;
  float* alpha_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int nq = min(BQ, S - q0);
  // q / out: (B, S, H, hd); k / v: (B, S, KV, hd), all contiguous
  const size_t q_row = static_cast<size_t>(H) * hd;
  const size_t kv_row = static_cast<size_t>(KV) * hd;
  const T* qb = q + (static_cast<size_t>(b) * S + q0) * q_row + static_cast<size_t>(h) * hd;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kvh) * hd;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kvh) * hd;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd;
    const int d = i % hd;
    q_s[i] = r < nq ? to_f32(qb[r * q_row + d]) : 0.f;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // Keys that any row of the tile can see: [k_lo, q0 + nq).
  const int k_hi = q0 + nq;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  for (int j0 = (k_lo / BK) * BK; j0 < k_hi; j0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int t = i / hd;
      const int d = i % hd;
      const bool in = j0 + t < S;
      const size_t off = static_cast<size_t>(j0 + t) * kv_row + d;
      k_s[t * kstride + d] = in ? to_f32(kb[off]) : 0.f;
      v_s[i] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < BQ * BK; i += THREADS) {
      const int r = i / BK;
      const int t = i % BK;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += q_s[r * hd + d] * k_s[t * kstride + d];
      s *= scale;
      p_s[i] = (r < nq && visible(q0 + r, j0 + t, window)) ? s : NEG_INF;
    }
    __syncthreads();

    for (int r = tid; r < BQ; r += THREADS) {
      float mx = NEG_INF;
      for (int t = 0; t < BK; ++t) mx = fmaxf(mx, p_s[r * BK + t]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < BK; ++t) {
        const bool ok = r < nq && visible(q0 + r, j0 + t, window);
        const float p = ok ? expf(p_s[r * BK + t] - m_new) : 0.f;
        p_s[r * BK + t] = p;
        sum += p;
      }
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
      alpha_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < BQ * hd; i += THREADS) {
      const int r = i / hd;
      const int d = i % hd;
      float pv = 0.f;
      for (int t = 0; t < BK; ++t) pv += p_s[r * BK + t] * v_s[t * hd + d];
      acc_s[i] = alpha_s[r] * acc_s[i] + pv;
    }
  }
  __syncthreads();

  T* ob = out + (static_cast<size_t>(b) * S + q0) * q_row + static_cast<size_t>(h) * hd;
  for (int i = tid; i < nq * hd; i += THREADS) {
    const int r = i / hd;
    const int d = i % hd;
    ob[r * q_row + d] = from_f32<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int H, int KV, int hd, float scale, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(BQ) * hd * 2 + static_cast<size_t>(BK) * (2 * hd + 1) +
       BQ * BK + 3 * BQ);
  auto kernel = flash_attn_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KV, hd, scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, S, H, hd); k, v: (B, S, KV, hd); all contiguous, one dtype:
// 0 = f32, 1 = bf16.  H must be a multiple of KV.  Returns a cudaError_t
// value, or -1 for a dtype the kernel does not take.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int S, int H, int KV, int hd,
                                 float scale, int window, int dtype, void* stream,
                                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (KV <= 0 || H % KV != 0 || hd <= 0 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, B, S, H, KV, hd, scale, window, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, scale, window, s);
  }
  return -1;
}
