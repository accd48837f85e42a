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
// Scores and probabilities never leave the SM: device memory sees the
// q/k/v reads and the output write only.  GQA reads kv head h / (H / KV)
// directly; K/V are never repeated in device memory.  The sequence length is
// taken as it is, with no padding in device memory, so the TPU kernel's
// `s_valid` mask is the sequence end: rows and keys past S do not exist.
//
// What bounds it on an H100: at the serving prefill shapes (B = 1, S = 16 to
// 64, H = 12, hd = 64, bf16) the work is a few MFLOP and a few hundred KB per
// layer, a microsecond or less either way; the launch, the load latency and
// the dependent chains of each key tile set the time.  At long sequences
// the S^2*hd score and value products make it bound by operations on the
// tensor cores.
//
// Two kernels, chosen by flash_attn_tc_launch's caller (the wrapper's rule):
//
// * flash_attn_tc_kernel (bf16, hd % 16 == 0 and hd <= 128, or hd 256):
//   each warp owns 16 query rows, held in registers as mma A-fragments
//   (ldmatrix from a cp.async-staged copy).  Key tiles of 32 rows of K and
//   V are staged into shared memory with 16-byte cp.async, double-buffered,
//   rows padded by 16 bytes so that ldmatrix (.trans for V) reads them
//   without bank conflicts.  S = Q K^T runs on mma.sync m16n8k16 bf16 with an f32
//   accumulator; masks, row max (shuffles within the quad of lanes that
//   shares a row) and the online softmax stay in registers.  P.V keeps the
//   accuracy of an f32 P by splitting P into P_hi = bf16(P) and
//   P_lo = bf16(P - P_hi), two mma into one f32 accumulator (V is exact in
//   bf16).  Tiles wholly past a warp's last row or left of its window are
//   skipped; rows and keys past S load as zeros and are never stored.
//   WARPS = 4 warps per block share one head's K/V tiles (on the H100 this
//   was 0.5-3% faster than one warp per block loading its own causal
//   prefix; PERF.md).
//   hd 256 (gemma3-12b, recurrentgemma-9b) is the instance <256, 2, 2>.
//   Held as above, a warp's Q fragments (64 registers a lane) and its
//   16 x 256 f32 output (128) leave no room under the 255-register cap for
//   S, P and addresses, and the kernel would spill.  So two warps share
//   each 16-row group: each reads Q's A-fragment from shared memory
//   by ldmatrix at each k16 step instead of holding it, computes the whole
//   S = Q K^T tile, and keeps the online softmax and the output for its 128
//   of the 256 columns (64 accumulator registers).  Both warps of a pair run
//   the same instructions on the same tiles, so their m and l are equal bit
//   for bit and no P crosses shared memory: the pair meets at no barrier
//   beyond the block's two a tile.  The price is S computed twice (64 more
//   mma a 32-key tile per warp, against the 128 of its half of P.V).  The
//   other way, each warp of the pair scoring half of hd and the two
//   exchanging partial S through shared memory, adds a barrier a tile.
//   A block holds two such groups (32 rows, 4 warps): on the H100 that was
//   9-13% faster than four groups (8 warps sharing a tensor core two by
//   two) from S 64 to 2048, and than one group past S 1024, where more
//   blocks read each K/V tile again (PERF.md).
// * flash_attn_kernel (f32, and bf16 at any other hd; CUDA cores): one 128-thread
//   block per (query tile of 16 rows, head, batch); each key tile of 32 rows
//   is staged as f32 in shared memory (K rows padded by one float), scored
//   by dot products in f32, its statistics updated by one thread per query
//   row, and the f32 accumulator rescaled in shared memory.  f32 keeps it:
//   its 3e-6 bound rules out TF32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

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


// ------------------------------------------------- the tensor-core kernel
namespace tc {

constexpr int BQ = 16;  // query rows per warp: one m16 tile
constexpr int BK = 32;  // keys per tile: four n8 tiles of S, two k16 of P.V
constexpr int WARPS = 4;  // 16-row groups a block (default), sharing one head's K/V tiles

using namespace attn_mma;

// Shared layout (bf16, rows padded to LD = HD + 8): q[RG*BQ][LD] |
// k[2][BK][LD] | v[2][BK][LD].  The 16-byte pad puts the 8 rows that one
// ldmatrix reads on 8 distinct 4-bank groups.
//
// RG 16-row groups a block (WARPS at hd <= 128, 2 at hd 256); HS warps
// share each group (HS = 1 at hd <= 128, 2 at hd 256): warp
// `half` of a group computes the whole S = Q K^T tile and writes output
// columns [half * HD / HS, (half + 1) * HD / HS).  At HS = 1 a warp holds
// its Q as KS A-fragments, loaded once; at HS = 2 it reads each k16 step's
// A-fragment from q_s by ldmatrix where it uses it (module header).
template <int HD, int HS, int RG>
__global__ void __launch_bounds__(RG * HS * 32)
flash_attn_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     int S, int H, int KV, float scale, int window) {
  constexpr int LD = HD + 8;
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k16 steps of Q K^T
  constexpr int OD = HD / HS;  // output columns per warp
  constexpr int NT = OD / 8;   // n8 tiles of the warp's output
  constexpr int THREADS = RG * HS * 32;
  static_assert(OD % 16 == 0, "a warp's output is whole k16 column pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + RG * BQ * LD;
  __nv_bfloat16* v_s = k_s + 2 * BK * LD;

  const int tid = threadIdx.x;
  const int warp = (tid >> 5) / HS;  // the warp's 16-row group
  const int half = (tid >> 5) % HS;  // which OD columns of the output it writes
  const int lane = tid & 31;
  const int g = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int tg = lane & 3;  // its column pair within an n8 tile
  const int mi = lane >> 3;  // the ldmatrix matrix whose row address it gives
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qb0 = blockIdx.x * RG * BQ;  // the block's first row
  const int q0 = qb0 + warp * BQ;           // the warp's first row
  // q / out: (B, S, H, HD); k / v: (B, S, KV, HD), all contiguous
  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(KV) * HD;
  const __nv_bfloat16* qg = q + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * HD;
  const __nv_bfloat16* kg = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kvh) * HD;
  const __nv_bfloat16* vg = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kvh) * HD;

  // Key tiles any row of the block can see: [t_first, t_end).
  const int kb_hi = min(S, qb0 + RG * BQ);
  const int kb_lo = window ? max(0, qb0 - window + 1) : 0;
  const int t_first = kb_lo / BK;
  const int t_end = (kb_hi + BK - 1) / BK;
  // Keys this warp's rows can see: [kw_lo, kw_hi).
  const int kw_hi = min(S, q0 + BQ);
  const int kw_lo = window ? max(0, q0 - window + 1) : 0;

  for (int i = tid; i < RG * BQ * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool in = qb0 + r < S;
    cp_async16(q_s + r * LD + c * 8, in ? qg + (qb0 + r) * q_row + c * 8 : qg, in);
  }
  auto load_tile = [&](int t, int buf) {
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const int key = t * BK + r;
      const bool in = key < S;
      const size_t off = static_cast<size_t>(key) * kv_row + c * 8;
      cp_async16(k_s + (buf * BK + r) * LD + c * 8, in ? kg + off : kg, in);
      cp_async16(v_s + (buf * BK + r) * LD + c * 8, in ? vg + off : vg, in);
    }
  };
  load_tile(t_first, 0);
  cp_commit();  // one group: Q and the first tile

  const int r0 = q0 + g, r1 = r0 + 8;  // this lane's two query rows
  auto visible = [&](int key, int row) {
    return key <= row && key < S && (window == 0 || key > row - window);
  };
  uint32_t qf[HS == 1 ? KS : 1][4];  // HS = 1: the warp's Q, held
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this lane's part

  for (int t = t_first; t < t_end; ++t) {
    const int buf = (t - t_first) & 1;
    if (t + 1 < t_end) {
      load_tile(t + 1, buf ^ 1);  // its buffer was released by the last barrier
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // every thread's copies of tile t (and Q) have landed
    if constexpr (HS == 1) {
      if (t == t_first) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          ldsm4(qf[ks], q_s + (warp * BQ + (mi & 1) * 8 + (lane & 7)) * LD + ks * 16 + (mi >> 1) * 8);
        }
      }
    }
    const int j0 = t * BK;
    if (q0 < S && j0 < kw_hi && j0 + BK > kw_lo) {  // uniform across the warp
      const __nv_bfloat16* kt = k_s + buf * BK * LD;
      const __nv_bfloat16* vt = v_s + buf * BK * LD;
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      if constexpr (HS == 1) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {  // 16 keys: two n8 tiles
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t kb[4];
            ldsm4(kb, kt + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * LD + ks * 16 + (mi & 1) * 8);
            mma(s[2 * np], qf[ks], kb[0], kb[1]);
            mma(s[2 * np + 1], qf[ks], kb[2], kb[3]);
          }
        }
      } else {  // each k16 step's Q fragment read where it is used
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t qa[4];
          ldsm4(qa, q_s + (warp * BQ + (mi & 1) * 8 + (lane & 7)) * LD + ks * 16 + (mi >> 1) * 8);
#pragma unroll
          for (int np = 0; np < BK / 16; ++np) {
            uint32_t kb[4];
            ldsm4(kb, kt + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * LD + ks * 16 + (mi & 1) * 8);
            mma(s[2 * np], qa, kb[0], kb[1]);
            mma(s[2 * np + 1], qa, kb[2], kb[3]);
          }
        }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j0 + n * 8 + tg * 2 + e;
          s[n][e] = visible(key, r0) ? s[n][e] * scale : NEG_INF;
          s[n][2 + e] = visible(key, r1) ? s[n][2 + e] * scale : NEG_INF;
          mx0 = fmaxf(mx0, s[n][e]);
          mx1 = fmaxf(mx1, s[n][2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the quad that shares a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j0 + n * 8 + tg * 2 + e;
          s[n][e] = visible(key, r0) ? expf(s[n][e] - mn0) : 0.f;
          s[n][2 + e] = visible(key, r1) ? expf(s[n][2 + e] - mn1) : 0.f;
          sum0 += s[n][e];
          sum1 += s[n][2 + e];
        }
      }
      l0 = a0 * l0 + sum0;
      l1 = a1 * l1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // 16 keys of P.V
        // The C fragments of n8 tiles 2kk and 2kk+1 are the A fragment.
        uint32_t ph[4], pl[4];
        split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < OD / 16; ++np) {
          uint32_t vb[4];
          ldsm4_t(vb, vt + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD + half * OD + np * 16 +
                          (mi >> 1) * 8);
          mma(o[2 * np], ph, vb[0], vb[1]);
          mma(o[2 * np], pl, vb[0], vb[1]);
          mma(o[2 * np + 1], ph, vb[2], vb[3]);
          mma(o[2 * np + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // tile t's buffer is free for tile t + 2
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = half * OD + n * 8 + tg * 2;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(ob + r0 * q_row + col) =
          pack(__float2bfloat16(o[n][0] / d0), __float2bfloat16(o[n][1] / d0));
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(ob + r1 * q_row + col) =
          pack(__float2bfloat16(o[n][2] / d1), __float2bfloat16(o[n][3] / d1));
    }
  }
}

template <int HD, int HS = 1, int RG = WARPS>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int KV, float scale, int window, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (RG * BQ + 4 * BK) * (HD + 8);
  auto kernel = flash_attn_tc_kernel<HD, HS, RG>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + RG * BQ - 1) / (RG * BQ), H, B);
  kernel<<<grid, RG * HS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, H, KV, scale,
      window);
  return static_cast<int>(cudaGetLastError());
}

int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
              int KV, int hd, float scale, int window, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, B, S, H, KV, scale, window, s);
    case 32: return launch<32>(q, k, v, out, B, S, H, KV, scale, window, s);
    case 48: return launch<48>(q, k, v, out, B, S, H, KV, scale, window, s);
    case 64: return launch<64>(q, k, v, out, B, S, H, KV, scale, window, s);
    case 80: return launch<80>(q, k, v, out, B, S, H, KV, scale, window, s);
    case 96: return launch<96>(q, k, v, out, B, S, H, KV, scale, window, s);
    case 112: return launch<112>(q, k, v, out, B, S, H, KV, scale, window, s);
    case 128: return launch<128>(q, k, v, out, B, S, H, KV, scale, window, s);
    case 256: return launch<256, 2, 2>(q, k, v, out, B, S, H, KV, scale, window, s);
    default: return -1;
  }
}

}  // namespace tc

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

// The tensor-core kernel.  q, out: (B, S, H, hd); k, v: (B, S, KV, hd); all
// contiguous bf16 with 16-byte aligned pointers; hd in {16, 32, ..., 128,
// 256}.
// H must be a multiple of KV.  Returns a cudaError_t value, or -1 for an hd
// the kernel does not take.
extern "C" int flash_attn_tc_launch(const void* q, const void* k, const void* v,
                                    void* out, int B, int S, int H, int KV, int hd,
                                    float scale, int window, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (KV <= 0 || H % KV != 0 || hd <= 0 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tc::launch_hd(q, k, v, out, B, S, H, KV, hd, scale, window, s);
}
