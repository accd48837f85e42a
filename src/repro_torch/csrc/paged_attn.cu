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
// launch and the chain of dependent memory trips (table entry, rows, merge)
// set the time.  It does a few FLOPs per byte, so bytes, not the tensor
// cores, are the limit at any context length.
//
// Two kernels, chosen by the wrapper's rule:
//
// * paged_split_kernel (rep 1..8, rows that split into 1..32 lanes of one
//   16-byte load each, 8 bytes for int8): one 4-warp block per (slot,
//   kv-head); warp w walks table blocks w, w + 4, ..., reading the next
//   table entry before it scores the current block.  Inside a warp a key
//   row is read by a group of hd / E lanes (8 lanes for an hd-64 bf16 row,
//   so 4 rows per load instruction); each lane holds its E dims of the rep
//   query vectors, so one loaded K/V row serves every query head of the
//   kv-head, and the dot products reduce by shuffles inside the group.
//   Each group keeps its online-softmax state (m, l, acc) in registers; no
//   barrier inside the key loop and nothing staged in shared memory.  At
//   the end the groups merge by a butterfly of shuffles and the 4 warps
//   through a small shared buffer, by the log-sum-exp rule, in which a
//   split that saw no key (m = -inf, l = 0) weighs 0.
// * paged_decode_kernel (every other geometry; staged): one 128-thread block
//   per (slot, kv-head); a loop over the slot's table blocks stages each
//   (block_size, hd) K and V panel into shared memory as f32, scores the
//   rep x block_size tile, updates (m, l) with one thread per query head,
//   and rescales the rep x hd f32 accumulator in shared memory.
//
// The gathered span never exists in device memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
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


// ------------------------------------------------------ the split kernel
namespace split {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// One lane's load of a key row: E elements, 16 bytes (8 for int8, so that
// a lane's q and acc slices stay at 8 floats per query head).
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int E = 4;
  using V = float4;
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  using V = uint4;
};
template <> struct Chunk<int8_t> {
  static constexpr int E = 8;
  using V = uint2;
};

__device__ __forceinline__ void unpack(const float4& x, float (&f)[4]) {
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void unpack(const uint4& x, float (&f)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint2& x, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = i < 4 ? x.x : x.y;
    f[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * (i & 3))));
  }
}

// Merge the online-softmax state (m, l) / acc of a partner split into this
// one by the log-sum-exp rule.  A split that saw no key (m = -inf, l = 0)
// weighs 0: exp(m - M) is never formed for it (with two empty splits it
// would be exp(-inf + inf) = nan).
__device__ __forceinline__ float weight(float m, float l, float mx) {
  return l > 0.f ? expf(m - mx) : 0.f;
}

// Block (kv head, slot), 4 warps; warp w walks table blocks w, w + 4, ...
// A key row is read by a group of `lanes` = hd / E lanes (a power of two,
// 1..32; lshift = log2(lanes)), so a warp has 32 / lanes rows in flight
// per load instruction; each group keeps its own (m, l, acc) for the REP
// query heads of the kv head.  Rows outside ctx <= pos / the window are
// never loaded.  No barrier inside the key loop: the groups merge by a
// butterfly of shuffles, the warps through shared memory.
template <typename QT, typename KT, int REP>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                   const KT* __restrict__ v_pool, const __half* __restrict__ k_scale,
                   const __half* __restrict__ v_scale, const int32_t* __restrict__ table,
                   const int32_t* __restrict__ pos_arr, QT* __restrict__ out, int KV, int hd,
                   int bs, int MB, int lshift, float scale, int window) {
  using V = typename Chunk<KT>::V;
  constexpr int E = Chunk<KT>::E;
  constexpr int U = REP <= 2 ? 4 : 2;  // rows per group loaded at once
  constexpr bool INT8 = sizeof(KT) == 1;
  __shared__ float m_s[WARPS][REP], l_s[WARPS][REP];
  extern __shared__ float acc_s[];  // [WARPS][REP][hd]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lanes = 1 << lshift;
  const int groups = 32 >> lshift;
  const int grp = lane >> lshift;
  const int sub = lane & (lanes - 1);  // this lane's E elements: sub * E ...
  const int pos = pos_arr[b];

  // q: (B, KV, REP, hd) contiguous
  float qf[REP][E];
  const QT* qb = q + (static_cast<size_t>(b) * KV + h) * REP * hd + sub * E;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) qf[r][e] = to_f32(qb[r * hd + e]);
  }
  float m[REP], l[REP], acc[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const int32_t* trow = table + static_cast<size_t>(b) * MB;
  int entry = warp < MB ? trow[warp] : -1;
  for (int j = warp; j < MB; j += WARPS) {
    const int next = j + WARPS < MB ? trow[j + WARPS] : -1;  // ahead of the scores
    const int base = j * bs;
    bool live = entry >= 0 && base <= pos;
    if (window) live = live && base + bs > pos - window;
    if (live) {  // uniform across the warp
      for (int t0 = 0; t0 < bs; t0 += groups * U) {
        V kr[U], vr[U];
        float ks[U], vs[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = t0 + u * groups + grp;
          ok[u] = t < bs && in_span(base + t, pos, window);
          kr[u] = V{};
          vr[u] = V{};
          ks[u] = vs[u] = 1.f;
          if (ok[u]) {
            const size_t row = static_cast<size_t>(entry) * bs + t;  // flat pool row
            const size_t off = (row * KV + h) * hd + sub * E;
            kr[u] = *reinterpret_cast<const V*>(k_pool + off);
            vr[u] = *reinterpret_cast<const V*>(v_pool + off);
            if (INT8) {
              ks[u] = __half2float(k_scale[row * KV + h]);
              vs[u] = __half2float(v_scale[row * KV + h]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float kf[E], vf[E];
          unpack(kr[u], kf);
          unpack(vr[u], vf);
          if (INT8) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              kf[e] *= ks[u];
              vf[e] *= vs[u];
            }
          }
          float s[REP];
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) d += qf[r][e] * kf[e];
            for (int o = 1; o < lanes; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
            s[r] = d * scale;
          }
          if (ok[u]) {
#pragma unroll
            for (int r = 0; r < REP; ++r) {
              const float m_new = fmaxf(m[r], s[r]);
              const float alpha = expf(m[r] - m_new);  // exp(-inf) = 0 at the first key
              const float p = expf(s[r] - m_new);
              l[r] = alpha * l[r] + p;
#pragma unroll
              for (int e = 0; e < E; ++e) acc[r][e] = alpha * acc[r][e] + p * vf[e];
              m[r] = m_new;
            }
          }
        }
      }
    }
    entry = next;
  }

  // The lane groups of a warp: a butterfly over xor distances lanes ... 16.
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mx = fmaxf(m[r], mo);
      const float ea = weight(m[r], l[r], mx), eb = weight(mo, lo, mx);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = ea * acc[r][e] + eb * ao;
      }
      l[r] = ea * l[r] + eb * lo;
      m[r] = mx;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc_s[(warp * REP + r) * hd + sub * E + e] = acc[r][e];
      if (lane == 0) {
        m_s[warp][r] = m[r];
        l_s[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // The warps, through shared memory; an empty slot flushes zeros.
  QT* ob = out + (static_cast<size_t>(b) * KV + h) * REP * hd;
  for (int i = tid; i < REP * hd; i += THREADS) {
    const int r = i / hd;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][r]);
    float tot = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = weight(m_s[w][r], l_s[w][r], mx);
      tot += e * l_s[w][r];
      o += e * acc_s[(w * REP + r) * hd + i % hd];
    }
    ob[i] = from_f32<QT>(o / fmaxf(tot, 1e-30f));
  }
}

template <typename QT, typename KT, int REP>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const int32_t* table, const int32_t* pos, void* out, int B, int KV, int hd,
           int bs, int MB, int lshift, float scale, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * WARPS * REP * hd;
  auto kernel = paged_split_kernel<QT, KT, REP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(KV, B), THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp), static_cast<const KT*>(vp),
      static_cast<const __half*>(ks), static_cast<const __half*>(vs), table, pos,
      static_cast<QT*>(out), KV, hd, bs, MB, lshift, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_rep(int rep, const void* q, const void* kp, const void* vp, const void* ks,
               const void* vs, const int32_t* table, const int32_t* pos, void* out, int B,
               int KV, int hd, int bs, int MB, float scale, int window, cudaStream_t s) {
  const int lanes = hd / Chunk<KT>::E;
  if (hd % Chunk<KT>::E != 0 || lanes > 32 || (lanes & (lanes - 1)) != 0) return -1;
  const size_t align = sizeof(typename Chunk<KT>::V);
  if (reinterpret_cast<uintptr_t>(kp) % align || reinterpret_cast<uintptr_t>(vp) % align) {
    return -1;
  }
  int lshift = 0;
  while ((1 << lshift) < lanes) ++lshift;
#define PS_ARGS q, kp, vp, ks, vs, table, pos, out, B, KV, hd, bs, MB, lshift, scale, window, s
  switch (rep) {
    case 1: return launch<QT, KT, 1>(PS_ARGS);
    case 2: return launch<QT, KT, 2>(PS_ARGS);
    case 3: return launch<QT, KT, 3>(PS_ARGS);
    case 4: return launch<QT, KT, 4>(PS_ARGS);
    case 5: return launch<QT, KT, 5>(PS_ARGS);
    case 6: return launch<QT, KT, 6>(PS_ARGS);
    case 7: return launch<QT, KT, 7>(PS_ARGS);
    case 8: return launch<QT, KT, 8>(PS_ARGS);
    default: return -1;
  }
#undef PS_ARGS
}

}  // namespace split

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

// The split kernel; the arguments of paged_attn_launch.  Takes rep 1..8 and
// rows that split into a power of two of lanes, 1..32, of 16 bytes (f32,
// bf16) or 8 bytes (int8) each, from pools aligned to that size.  Returns
// a cudaError_t value, or -1 for a dtype pair or geometry it does not take.
extern "C" int paged_attn_split_launch(const void* q, const void* kp, const void* vp,
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
#define PS_ARGS rep, q, kp, vp, ks, vs, t, p, out, B, KV, hd, bs, MB, scale, window, s
  if (q_dtype == 0 && kv_dtype == 0) return split::launch_rep<float, float>(PS_ARGS);
  if (q_dtype == 1 && kv_dtype == 1) {
    return split::launch_rep<__nv_bfloat16, __nv_bfloat16>(PS_ARGS);
  }
  if (q_dtype == 0 && kv_dtype == 2) return split::launch_rep<float, int8_t>(PS_ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return split::launch_rep<__nv_bfloat16, int8_t>(PS_ARGS);
#undef PS_ARGS
  return -1;
}
