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
// Three kernels, chosen by the wrapper's rule:
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
// * paged_ctx_kernel + paged_ctx_merge_kernel (rep 9..16, bf16 queries over
//   bf16 or int8 pools, hd % 16 == 0 and hd <= 256: recurrentgemma-9b's 16
//   heads over one KV head at hd 256).  At KV = 1 a block per (slot,
//   kv-head) is 4 blocks on 132 SMs; so the slot's span is split across
//   blocks.  The grid is (KV, B, C), C = ceil(MB * bs / 64) fixed by the
//   table's shape, never by pos (a CUDA graph replays the launch while pos
//   moves on the device).  Block c takes the 64 keys c*64 ... c*64 + 63,
//   each through its own table entry; a chunk with no visible key (wholly
//   past pos, left of the window, or on -1 entries) writes the empty
//   partial m = -inf, l = 0 and exits.  Otherwise the block stages Q and the
//   chunk's K and V rows into shared memory with 16-byte cp.async (keys not
//   visible zero-filled) in one group: a block holds one chunk, so there is
//   no key loop to double-buffer, and two blocks an SM (93 KB each) overlap
//   one's loads with the other's products.  The rep <= 16 query heads of
//   the kv head are one mma.sync m16n8k16 A tile (rows past rep zeros,
//   never stored).  S = Q K^T: warp w contracts the 16-dim groups w, w + 4,
//   ... of hd (4 k16 steps each at hd 256) into a 16 x 64 partial, the
//   four partials meet in shared memory and every warp sums them in the
//   same order, so each holds the same S, m, l and P.  The chunk's softmax
//   is one pass (no rescaling).  P.V keeps f32 accuracy by the P_hi + P_lo
//   split of the flash kernel; warp w owns the output columns of its
//   groups, a 16 x 64 f32 slice at hd 256 (32 registers a lane).  The
//   partial (m, l, unnormalized acc) goes to scratch that the wrapper
//   allocates uninitialized; the merge launch (one thread an output, the
//   partials' (m, l) staged in shared memory) combines a slot's C partials
//   by the log-sum-exp rule over the list of chunks that saw a key (l = 0
//   partials' acc is never read), and flushes zeros for an empty table.
//   A slot's table may span at most 1024 chunks (65,536 keys).
//   int8 pools: the values are exact in bf16, so K and V stage as bf16
//   integers.  k_scale multiplies each score column after the mma and
//   v_scale each column of P before the P.V split (l sums P before it).
//   The score is then the f32 value of q . (k * k_scale) and P.V that of
//   sum p v v_scale to ~2^-16 relative, where the plain version rounds the
//   dequantized K and V to bf16 and P to bf16 (2^-9 each): the two differ
//   by the plain version's roundings, as the split kernel (which
//   dequantizes in f32) does, within the int8 bound (1e-2) below |out| = 2
//   and one bf16 output ulp above it (chip_smoke.py --int8-witness).
//   What bounds it: the live K/V bytes, over as many SMs as the span has
//   chunks, plus a partial of 16 x hd f32 per live chunk written and read
//   back (a quarter of a bf16 chunk's K and V at hd 256).
// * paged_decode_kernel (every other geometry; staged): one 128-thread block
//   per (slot, kv-head); a loop over the slot's table blocks stages each
//   (block_size, hd) K and V panel into shared memory as f32, scores the
//   rep x block_size tile, updates (m, l) with one thread per query head,
//   and rescales the rep x hd f32 accumulator in shared memory.  It takes
//   f32 pools at rep > 8 or past 32 lanes, f32 queries over int8 pools at
//   rep > 8, rep > 16, lane groups that are not a power of two (hd 24),
//   and pointers the other two cannot load from.
//
// The gathered span never exists in device memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

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


// ------------------------------------------------ the context-split kernel
namespace ctx {

using namespace attn_mma;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TK = 64;       // keys of a chunk: 8 n8 tiles of S, 4 k16 steps of P.V
constexpr int MR = 16;       // rows of the m16 tile: rep <= 16 query heads, the rest zeros
constexpr int SLD = TK + 8;  // row stride of a warp's partial S (floats)
constexpr int MERGE_THREADS = 128;
constexpr int MAX_CHUNKS = 1024;  // 65,536 keys a slot: the merge's 133 KB of shared memory

__device__ __forceinline__ uint32_t i8pair(uint32_t w, int i) {  // bytes i, i+1 as bf16
  const __nv_bfloat16 a = __float2bfloat16(static_cast<float>(static_cast<int8_t>(w >> (8 * i))));
  const __nv_bfloat16 b =
      __float2bfloat16(static_cast<float>(static_cast<int8_t>(w >> (8 * i + 8))));
  return pack(a, b);
}

// 16 int8 values (exact in bf16) -> 16 bf16 in shared memory.
__device__ __forceinline__ void store_i8(__nv_bfloat16* dst, const uint4& x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint4 lo, hi;
  lo.x = i8pair(w[0], 0);
  lo.y = i8pair(w[0], 2);
  lo.z = i8pair(w[1], 0);
  lo.w = i8pair(w[1], 2);
  hi.x = i8pair(w[2], 0);
  hi.y = i8pair(w[2], 2);
  hi.z = i8pair(w[3], 0);
  hi.w = i8pair(w[3], 2);
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

// Block (kv head h, slot b, chunk c): the TK keys ctx = c*TK ... c*TK + TK-1
// of slot b, each found through its own table entry.  Writes the chunk's
// partial (m, l) for the MR rows to part_ml[(b*KV + h)*C + c] = {m[MR],
// l[MR]} and, unless the chunk is empty, its unnormalized rep x hd output
// to part_acc[(b*KV + h)*C + c][MR][hd].  An empty chunk (no visible key)
// writes m = -inf, l = 0 and returns.
//
// Shared layout: q[MR][LD] | k[TK][LD] | v[TK][LD] (bf16, LD = hd + 8) |
// s[WARPS][MR][SLD] (f32 partial S) | kmul[TK] | vmul[TK] (f32) | row[TK].
template <typename KT, int NG>
__global__ void __launch_bounds__(THREADS)
paged_ctx_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k_pool,
                 const KT* __restrict__ v_pool, const __half* __restrict__ k_scale,
                 const __half* __restrict__ v_scale, const int32_t* __restrict__ table,
                 const int32_t* __restrict__ pos_arr, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int KV, int rep, int hd, int bs, int MB, int C,
                 float scale, int window) {
  constexpr bool INT8 = sizeof(KT) == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = hd + 8;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + MR * LD;
  __nv_bfloat16* v_s = k_s + TK * LD;
  float* s_s = reinterpret_cast<float*>(v_s + TK * LD);
  float* kmul_s = s_s + WARPS * MR * SLD;
  float* vmul_s = kmul_s + TK;
  int* row_s = reinterpret_cast<int*>(vmul_s + TK);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pos = pos_arr[b];
  const int lo = window ? pos - window + 1 : 0;  // the first visible ctx
  const size_t bkv = static_cast<size_t>(b) * KV + h;
  float* ml = part_ml + (bkv * C + c) * 2 * MR;

  // Each key's flat pool row, -1 where it is not visible: past pos, left
  // of the window, past the table or on a -1 entry.  Entries are read only
  // for keys in [lo, pos].
  bool any = false;
  if (tid < TK) {
    const int cx = c * TK + tid;
    const int j = cx / bs;
    int row = -1;
    if (cx <= pos && cx >= lo && j < MB) {
      const int entry = table[static_cast<size_t>(b) * MB + j];
      if (entry >= 0) row = entry * bs + cx % bs;
    }
    float km = scale, vm = 1.f;
    if (INT8 && row >= 0) {
      km *= __half2float(k_scale[static_cast<size_t>(row) * KV + h]);
      vm = __half2float(v_scale[static_cast<size_t>(row) * KV + h]);
    }
    row_s[tid] = row;
    kmul_s[tid] = km;
    vmul_s[tid] = vm;
    any = row >= 0;
  }
  if (!__syncthreads_or(any)) {  // an empty chunk weighs 0 in the merge
    if (tid < MR) {
      ml[tid] = -INFINITY;
      ml[MR + tid] = 0.f;
    }
    return;
  }

  // Stage Q (rows past rep zero-filled) and the chunk's K and V rows (keys
  // not visible zero-filled, so that 0 * garbage never reaches P.V).
  const int CH = hd / 8;  // 16-byte chunks of a bf16 row
  const __nv_bfloat16* qb = q + bkv * rep * hd;
  for (int i = tid; i < MR * CH; i += THREADS) {
    const int r = i / CH, cc = i % CH;
    const bool in = r < rep;
    cp_async16(q_s + r * LD + cc * 8, in ? qb + r * hd + cc * 8 : qb, in);
  }
  if constexpr (!INT8) {
    for (int i = tid; i < TK * CH; i += THREADS) {
      const int t = i / CH, cc = i % CH;
      const int row = row_s[t];
      const size_t off = (static_cast<size_t>(row >= 0 ? row : 0) * KV + h) * hd + cc * 8;
      cp_async16(k_s + t * LD + cc * 8, k_pool + off, row >= 0);
      cp_async16(v_s + t * LD + cc * 8, v_pool + off, row >= 0);
    }
  } else {
    const int C16 = hd / 16;  // 16-byte chunks of an int8 row
    for (int i = tid; i < TK * C16; i += THREADS) {
      const int t = i / C16, cc = i % C16;
      const int row = row_s[t];
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (row >= 0) {
        const size_t off = (static_cast<size_t>(row) * KV + h) * hd + cc * 16;
        kr = *reinterpret_cast<const uint4*>(k_pool + off);
        vr = *reinterpret_cast<const uint4*>(v_pool + off);
      }
      store_i8(k_s + t * LD + cc * 16, kr);
      store_i8(v_s + t * LD + cc * 16, vr);
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // Partial S: warp w contracts the 16-dim groups w, w + 4, ... of hd.
  const int g = lane >> 2;   // the fragment row (and row + 8) this lane holds
  const int tg = lane & 3;   // its column pair within an n8 tile
  const int mi = lane >> 3;  // the ldmatrix matrix whose row address it gives
  const int ngr = hd / 16;
  float s[TK / 8][4];
#pragma unroll
  for (int n = 0; n < TK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    const int gr = warp + gi * WARPS;
    if (gr < ngr) {  // uniform across the warp
      uint32_t qa[4];
      ldsm4(qa, q_s + ((mi & 1) * 8 + (lane & 7)) * LD + gr * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {  // 16 keys: two n8 tiles
        uint32_t kb[4];
        ldsm4(kb, k_s + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * LD + gr * 16 + (mi & 1) * 8);
        mma(s[2 * np], qa, kb[0], kb[1]);
        mma(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }
  }
  float* sw = s_s + warp * MR * SLD;
#pragma unroll
  for (int n = 0; n < TK / 8; ++n) {
    const int col = n * 8 + tg * 2;
    *reinterpret_cast<float2*>(sw + g * SLD + col) = make_float2(s[n][0], s[n][1]);
    *reinterpret_cast<float2*>(sw + (g + 8) * SLD + col) = make_float2(s[n][2], s[n][3]);
  }
  __syncthreads();
  // Every warp sums the four partials in the same order: each holds the
  // same S, bit for bit, and so the same m, l and P.
#pragma unroll
  for (int n = 0; n < TK / 8; ++n) {
    const int col = n * 8 + tg * 2;
    float2 a = make_float2(0.f, 0.f), d = a;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float2 x = *reinterpret_cast<const float2*>(s_s + (w * MR + g) * SLD + col);
      const float2 y = *reinterpret_cast<const float2*>(s_s + (w * MR + g + 8) * SLD + col);
      a.x += x.x;
      a.y += x.y;
      d.x += y.x;
      d.y += y.y;
    }
    s[n][0] = a.x;
    s[n][1] = a.y;
    s[n][2] = d.x;
    s[n][3] = d.y;
  }

  // The chunk's softmax: one pass, its max over the visible keys (finite:
  // the chunk has one), its sum l; int8 scales k_scale on each score column
  // and v_scale on P's column (l sums P before v_scale).
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < TK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = n * 8 + tg * 2 + e;
      const bool vis = row_s[t] >= 0;
      s[n][e] = vis ? s[n][e] * kmul_s[t] : -INFINITY;
      s[n][2 + e] = vis ? s[n][2 + e] * kmul_s[t] : -INFINITY;
      mx0 = fmaxf(mx0, s[n][e]);
      mx1 = fmaxf(mx1, s[n][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the quad that shares a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < TK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = n * 8 + tg * 2 + e;
      const bool vis = row_s[t] >= 0;
      const float p0 = vis ? expf(s[n][e] - mx0) : 0.f;
      const float p1 = vis ? expf(s[n][2 + e] - mx1) : 0.f;
      l0 += p0;
      l1 += p1;
      s[n][e] = INT8 ? p0 * vmul_s[t] : p0;
      s[n][2 + e] = INT8 ? p1 * vmul_s[t] : p1;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (warp == 0 && tg == 0) {
    ml[g] = mx0;
    ml[g + 8] = mx1;
    ml[MR + g] = l0;
    ml[MR + g + 8] = l1;
  }

  // P.V on the warp's 16-dim groups of hd, P as P_hi + P_lo.
  float o[NG][2][4];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
#pragma unroll
    for (int t = 0; t < 2; ++t) o[gi][t][0] = o[gi][t][1] = o[gi][t][2] = o[gi][t][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {  // 16 keys of P.V
    // The C fragments of n8 tiles 2kk and 2kk+1 are the A fragment.
    uint32_t ph[4], pl[4];
    split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
    split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
    split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
    split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      const int gr = warp + gi * WARPS;
      if (gr < ngr) {
        uint32_t vb[4];
        ldsm4_t(vb, v_s + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD + gr * 16 + (mi >> 1) * 8);
        mma(o[gi][0], ph, vb[0], vb[1]);
        mma(o[gi][0], pl, vb[0], vb[1]);
        mma(o[gi][1], ph, vb[2], vb[3]);
        mma(o[gi][1], pl, vb[2], vb[3]);
      }
    }
  }
  float* acc = part_acc + (bkv * C + c) * MR * hd;
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    const int gr = warp + gi * WARPS;
    if (gr < ngr) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = gr * 16 + t * 8 + tg * 2;
        if (g < rep) {
          *reinterpret_cast<float2*>(acc + g * hd + col) = make_float2(o[gi][t][0], o[gi][t][1]);
        }
        if (g + 8 < rep) {
          *reinterpret_cast<float2*>(acc + (g + 8) * hd + col) =
              make_float2(o[gi][t][2], o[gi][t][3]);
        }
      }
    }
  }
}

// Block (slot b * KV + kv head, 128 outputs of its rep x hd): the slot's
// C partials by the log-sum-exp rule.  The block stages the partials' (m, l)
// in shared memory, turns m into each chunk's weight exp(m - max) (8
// threads a row; 0 for a partial with l = 0, whose acc is never read: the
// wrapper's scratch is uninitialized) and lists the chunks that saw a key
// (l > 0 in every row, read in row 0); then each thread sums its output
// over that list, the loads independent of each other.  An empty slot
// (no chunk listed) flushes zeros.
// Shared layout: ml[C][2][MR] (m, then l; m becomes the weight) | tot[MR] |
// live[C].
__global__ void __launch_bounds__(MERGE_THREADS)
paged_ctx_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                       __nv_bfloat16* __restrict__ out, int rep, int hd, int C) {
  static_assert(MERGE_THREADS == 8 * MR, "8 threads a row for the weights");
  extern __shared__ float ml_s[];
  float* tot_s = ml_s + C * 2 * MR;
  int* live_s = reinterpret_cast<int*>(tot_s + MR);
  __shared__ int nlive_s;
  const size_t bkv = blockIdx.x;
  const int tid = threadIdx.x;
  const float* ml = part_ml + bkv * C * 2 * MR;
  for (int i = tid; i < C * 2 * MR; i += MERGE_THREADS) ml_s[i] = ml[i];
  __syncthreads();
  {
    const int r = tid >> 3, sub = tid & 7;
    float mx = -INFINITY;
    for (int c = sub; c < C; c += 8) {
      if (ml_s[(2 * c + 1) * MR + r] > 0.f) mx = fmaxf(mx, ml_s[2 * c * MR + r]);
    }
    for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float tot = 0.f;
    for (int c = sub; c < C; c += 8) {
      const float l = ml_s[(2 * c + 1) * MR + r];
      const float w = l > 0.f ? expf(ml_s[2 * c * MR + r] - mx) : 0.f;
      ml_s[2 * c * MR + r] = w;
      tot += w * l;
    }
    for (int o = 1; o < 8; o <<= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    if (sub == 0) tot_s[r] = tot;
  }
  if (tid < 32) {
    int n = 0;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + tid;
      const bool lv = c < C && ml_s[(2 * c + 1) * MR] > 0.f;
      const unsigned bits = __ballot_sync(0xffffffffu, lv);
      if (lv) live_s[n + __popc(bits & ((1u << tid) - 1))] = c;
      n += __popc(bits);
    }
    if (tid == 0) nlive_s = n;
  }
  __syncthreads();
  const int i = blockIdx.y * MERGE_THREADS + tid;
  if (i >= rep * hd) return;
  const int r = i / hd;
  const float* acc = part_acc + bkv * C * MR * hd + i;
  const int n = nlive_s;
  float o = 0.f;
#pragma unroll 16  // 16 loads in flight: 5% off a step (PERF.md)
  for (int j = 0; j < n; ++j) {
    const int c = live_s[j];
    o += ml_s[2 * c * MR + r] * acc[static_cast<size_t>(c) * MR * hd];
  }
  out[bkv * rep * hd + i] = __float2bfloat16(o / fmaxf(tot_s[r], 1e-30f));
}

template <typename KT, int NG>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const int32_t* table, const int32_t* pos, void* out, float* part_acc,
           float* part_ml, int B, int KV, int rep, int hd, int bs, int MB, int C, float scale,
           int window, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (MR + 2 * TK) * (hd + 8) +
                      sizeof(float) * (WARPS * MR * SLD + 2 * TK) + sizeof(int) * TK;
  auto kernel = paged_ctx_kernel<KT, NG>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(KV, B, C), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), static_cast<const __half*>(ks),
      static_cast<const __half*>(vs), table, pos, part_acc, part_ml, KV, rep, hd, bs, MB, C,
      scale, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t msmem = sizeof(float) * (static_cast<size_t>(C) * 2 * MR + MR) +
                       sizeof(int) * static_cast<size_t>(C);
  if (msmem > 48 * 1024) {
    err = cudaFuncSetAttribute(paged_ctx_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(msmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 mgrid(B * KV, (rep * hd + MERGE_THREADS - 1) / MERGE_THREADS);
  paged_ctx_merge_kernel<<<mgrid, MERGE_THREADS, msmem, stream>>>(
      part_acc, part_ml, static_cast<__nv_bfloat16*>(out), rep, hd, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int launch_hd(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
              const int32_t* table, const int32_t* pos, void* out, float* part_acc,
              float* part_ml, int B, int KV, int rep, int hd, int bs, int MB, int C,
              float scale, int window, cudaStream_t s) {
  if (rep < 1 || rep > MR || hd <= 0 || hd % 16 != 0 || hd > 256 || bs <= 0 ||
      MB <= 0 || C != (MB * bs + TK - 1) / TK || C > MAX_CHUNKS) {
    return -1;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kp) |
       reinterpret_cast<uintptr_t>(vp)) % 16) {
    return -1;
  }
#define PC_ARGS q, kp, vp, ks, vs, table, pos, out, part_acc, part_ml, B, KV, rep, hd, bs, MB, C, \
                scale, window, s
  switch ((hd + 63) / 64) {  // 16-dim groups per warp
    case 1: return launch<KT, 1>(PC_ARGS);
    case 2: return launch<KT, 2>(PC_ARGS);
    case 3: return launch<KT, 3>(PC_ARGS);
    default: return launch<KT, 4>(PC_ARGS);
  }
#undef PC_ARGS
}

}  // namespace ctx

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

// The context-split kernel and its merge; the arguments of
// paged_attn_launch, plus part_acc (f32, B*KV*C*16*hd) and part_ml (f32,
// B*KV*C*32) scratch, uninitialized, and C = ceil(MB * bs / 64) <= 1024,
// the chunks of 64 keys a slot's table spans.  Takes bf16 queries over bf16 or int8
// pools (int8 with f16 scale pools), rep 1..16, hd % 16 == 0 and hd <= 256,
// q and the pools 16-byte aligned.  Returns a cudaError_t value, or -1 for
// a dtype pair or geometry it does not take.
extern "C" int paged_attn_ctx_launch(const void* q, const void* kp, const void* vp,
                                     const void* ks, const void* vs, const void* table,
                                     const void* pos, void* out, void* part_acc,
                                     void* part_ml, int B, int KV, int rep, int hd, int bs,
                                     int MB, int C, float scale, int window, int q_dtype,
                                     int kv_dtype, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || KV <= 0) return 0;
  const int32_t* t = static_cast<const int32_t*>(table);
  const int32_t* p = static_cast<const int32_t*>(pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PC_ARGS q, kp, vp, ks, vs, t, p, out, pa, pm, B, KV, rep, hd, bs, MB, C, scale, window, s
  if (q_dtype == 1 && kv_dtype == 1) return ctx::launch_hd<__nv_bfloat16>(PC_ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return ctx::launch_hd<int8_t>(PC_ARGS);
#undef PC_ARGS
  return -1;
}
