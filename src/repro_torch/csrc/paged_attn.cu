// paged_attn: single-token flash decode over paged K/V pools.
//
// Replaces the TPU kernel paged_flash_decode_raw (_make_kernel) in
// src/repro/kernels/paged_attn/paged_attn.py.  For every (slot b, kv-head h)
// it reads the slot's pool blocks through its block table and keeps the
// online-softmax state (m, l, acc) in f32 for the `rep` query heads that
// share the kv-head (grouped GQA: K/V are never repeated):
//
//     s     = q_g k_j^T * scale          (masked: ctx <= pos, sliding window)
//     m'    = max(m, rowmax(s));  alpha = exp(m - m')
//     p     = where(valid, exp(s - m'), 0)
//     l     = alpha*l + rowsum(p);  acc = alpha*acc + p v_j
//     out   = acc / max(l, 1e-30)
//
// Table entries of -1 (never allocated) and blocks wholly outside the
// ctx <= pos / window span are skipped.  int8 pools dequantize in registers
// against their f16 scale pools.  A slot with an empty table flushes zeros.
//
// What bounds it on an H100: the live K/V bytes it must read (pos+1 rows of
// KV*hd per slot, twice), a fraction of a megabyte per decode launch at the
// demonstrator's size, i.e. well under a microsecond at 3.35 TB/s: the
// launch itself dominates.  It does a few FLOPs per byte, so bytes, not the
// tensor cores, are the limit at any context length.
//
// Design (simple and right first): one 128-thread block per (slot, kv-head);
// a loop over the slot's table blocks stages each (block_size, hd) K and V
// panel into shared memory as f32, scores the rep x block_size tile, updates
// (m, l) with one thread per query head, and rescales the rep x hd f32
// accumulator in shared memory.  The gathered span never exists in device
// memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ bool in_span(int ctx, int pos, int window) {
  return ctx <= pos && (window == 0 || ctx > pos - window);
}

// Shared layout (f32): q[rep*hd] | k[bs*hd] | v[bs*hd] | p[rep*bs] | acc[rep*hd]
//                      | m[rep] | l[rep] | alpha[rep]
template <typename QT, typename KT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                    const KT* __restrict__ v_pool, const __half* __restrict__ k_scale,
                    const __half* __restrict__ v_scale,
                    const int32_t* __restrict__ table, const int32_t* __restrict__ pos_arr,
                    QT* __restrict__ out, int KV, int rep, int hd, int bs, int MB,
                    float scale, int window) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + rep * hd;
  float* v_s = k_s + bs * hd;
  float* p_s = v_s + bs * hd;
  float* acc_s = p_s + rep * bs;
  float* m_s = acc_s + rep * hd;
  float* l_s = m_s + rep;
  float* alpha_s = l_s + rep;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int pos = pos_arr[b];
  const bool int8 = k_scale != nullptr;

  // q: (B, KV, rep, hd) contiguous
  const QT* qb = q + (static_cast<size_t>(b) * KV + h) * rep * hd;
  for (int i = tid; i < rep * hd; i += THREADS) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < MB; ++j) {
    const int entry = table[static_cast<size_t>(b) * MB + j];
    const int base = j * bs;
    bool live = entry >= 0 && base <= pos;
    if (window) live = live && (base + bs > pos - window);
    if (!live) continue;  // uniform across the block: same entry, base, pos

    // Stage the (bs, hd) K and V panels of kv-head h as f32.
    for (int i = tid; i < bs * hd; i += THREADS) {
      const int t = i / hd;
      const int d = i % hd;
      const size_t row = static_cast<size_t>(entry) * bs + t;  // flat pool row
      const size_t off = (row * KV + h) * hd + d;
      float kf = to_f32(k_pool[off]);
      float vf = to_f32(v_pool[off]);
      if (int8) {
        kf *= __half2float(k_scale[row * KV + h]);
        vf *= __half2float(v_scale[row * KV + h]);
      }
      k_s[i] = kf;
      v_s[i] = vf;
    }
    __syncthreads();

    // Scores for the rep x bs tile.
    for (int i = tid; i < rep * bs; i += THREADS) {
      const int r = i / bs;
      const int t = i % bs;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += q_s[r * hd + d] * k_s[t * hd + d];
      s *= scale;
      p_s[i] = in_span(base + t, pos, window) ? s : NEG_INF;
    }
    __syncthreads();

    // Online-softmax statistics, one thread per query head.
    for (int r = tid; r < rep; r += THREADS) {
      float mx = NEG_INF;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, p_s[r * bs + t]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = in_span(base + t, pos, window) ? expf(p_s[r * bs + t] - m_new) : 0.f;
        p_s[r * bs + t] = p;
        sum += p;
      }
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
      alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc = alpha * acc + p v
    for (int i = tid; i < rep * hd; i += THREADS) {
      const int r = i / hd;
      const int d = i % hd;
      float pv = 0.f;
      for (int t = 0; t < bs; ++t) pv += p_s[r * bs + t] * v_s[t * hd + d];
      acc_s[i] = alpha_s[r] * acc_s[i] + pv;
    }
    __syncthreads();
  }

  QT* ob = out + (static_cast<size_t>(b) * KV + h) * rep * hd;
  for (int i = tid; i < rep * hd; i += THREADS) {
    ob[i] = from_f32<QT>(acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int32_t* table, const int32_t* pos, void* out,
           int B, int KV, int rep, int hd, int bs, int MB, float scale,
           int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(rep) * hd * 2 + static_cast<size_t>(bs) * hd * 2 +
       static_cast<size_t>(rep) * bs + 3 * static_cast<size_t>(rep));
  auto kernel = paged_decode_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(KV, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp), static_cast<const KT*>(vp),
      static_cast<const __half*>(ks), static_cast<const __half*>(vs), table, pos,
      static_cast<QT*>(out), KV, rep, hd, bs, MB, scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype: 0 = f32, 1 = bf16.  kv_dtype: 0 = f32, 1 = bf16, 2 = int8 (with
// f16 scale pools ks/vs; null otherwise).  Returns a cudaError_t value, or
// -1 for a dtype pair the kernel does not take.
extern "C" int paged_attn_launch(const void* q, const void* kp, const void* vp,
                                 const void* ks, const void* vs, const void* table,
                                 const void* pos, void* out, int B, int KV, int rep,
                                 int hd, int bs, int MB, float scale, int window,
                                 int q_dtype, int kv_dtype, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || KV <= 0) return 0;
  const int32_t* t = static_cast<const int32_t*>(table);
  const int32_t* p = static_cast<const int32_t*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_ARGS q, kp, vp, ks, vs, t, p, out, B, KV, rep, hd, bs, MB, scale, window, s
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float>(PA_ARGS);
  if (q_dtype == 1 && kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t>(PA_ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return launch<__nv_bfloat16, int8_t>(PA_ARGS);
#undef PA_ARGS
  return -1;
}
