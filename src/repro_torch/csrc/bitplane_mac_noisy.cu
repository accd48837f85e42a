// bitplane_mac_noisy: the paper's full bit-plane pyramid with its analog
// non-idealities (the NoiseSpec Monte-Carlo) in one launch:
//
//   out[m,n] = sum_{p,q} 2^(p+q) sum_g dec(m, n, pair = p*PW + q, g)
//   k'  = k + (sigma_m * sqrt(max(k, 0))) * z_0      k = popc(A_p[m,g] & W_q[g,n])
//   dec = #{i : thr[i] + sigma_c * z_{1+i} >= V(k')}
//
// with V the two-regime physics RBL voltage and z_d the element's normal
// draw d.  Replaces the TPU kernel bitplane_mac_noisy_raw (body
// _make_noisy_kernel) in src/repro/kernels/bitplane_mac/bitplane_mac.py.
// There each grid step seeds the TPU's hardware PRNG from the key words and
// the step index; here every draw comes from Philox4x32-10, written below,
// keyed by the two seed words (kernel arguments: no host copy, no sync) and
// counted by (n, m, group, pair << 8 | d >> 1) alone, so the draws depend on
// the element, never on the tile, warp or split that computes it, and the
// split-K partial sums still meet exactly by integer atomicAdd.  The plain
// version (kernels/bitplane_mac/ops.py::bitplane_mac_noisy_torch) computes
// the same stream with the same float32 operations, so the two agree bit
// for bit: Box-Muller's log and cos are Cephes' polynomials written one
// rounded operation at a time (kernels/common.py), sqrt is __fsqrt_rn, the
// exponential is core/rbl.py::exp_f32's (bitplane_common.cuh).
//
// What bounds it on an H100: not bytes.  A decode step's 72 projections at
// M = 4 move ~87 MB (~0.026 ms at 3.35 TB/s) but decode ~2.7 G elements,
// each with its own normal for mismatch and, under comparator offset, one
// per comparator.  Box-Muller on the special-function units costs a log, a
// sqrt and a cos per normal: at 16 SFU results per SM per clock (~4.2 T/s)
// mismatch alone is ~1.9 ms per step, mismatch and 8 comparators ~17 ms.
// This kernel does not reach that bound: it computes log and cos as
// float32 polynomials on the FMA pipes and Philox's 10 rounds on the integer
// pipes, a few hundred instructions per element, and the exponential with
// double-precision multiply-adds where the triode regime is taken.  That is
// the price of one stream that the plain version reproduces bit for bit.
//
// Design (simple and right first; geometry shared with bitplane_mac.cu):
//   * one 256-thread block per 8 x 32 output tile, lane = column, K-groups
//     split across warps and blocks (gridDim.z, ~8 blocks per SM: the work
//     per element is large, so more blocks balance better), int32 atomicAdd;
//   * operands staged as one 32-bit word per (plane, row or column, group),
//     a group count is one __popc;
//   * per (plane pair, group, row, column): one Philox call serves draws 0
//     and 1, each further call two more comparators; a sigma of 0 skips its
//     draws; the voltage and the `rows` comparisons run per element;
//   * only the real ceil(K/rows) groups are decoded (the reference masks its
//     padded groups, valid_groups); columns past N are not computed.
#include "bitplane_common.cuh"

namespace {

using namespace bitplane;

constexpr int TARGET_BLOCKS = 132 * 8;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x);
    const uint32_t lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z);
    const uint32_t lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// kernels/common.py::log_f32 (Cephes' logf), one rounded op at a time.
__device__ __forceinline__ float log_f32(float x) {
  const int bits = __float_as_int(x);
  const int e = ((bits >> 23) & 0xFF) - 126;
  float f = __int_as_float((bits & 0x7FFFFF) | (126 << 23));
  const bool small = f < f32(0.707106781186547524);
  const float fe = static_cast<float>(e - (small ? 1 : 0));
  f = small ? __fsub_rn(__fadd_rn(f, f), 1.f) : __fsub_rn(f, 1.f);
  const float z = __fmul_rn(f, f);
  float y = f32(7.0376836292e-2);
  y = __fadd_rn(__fmul_rn(y, f), f32(-1.1514610310e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(1.1676998740e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(-1.2420140846e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(1.4249322787e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(-1.6668057665e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(2.0000714765e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(-2.4999993993e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(3.3333331174e-1));
  y = __fmul_rn(__fmul_rn(y, f), z);
  y = __fadd_rn(y, __fmul_rn(fe, f32(-2.12194440e-4)));
  y = __fsub_rn(y, __fmul_rn(z, 0.5f));
  return __fadd_rn(__fadd_rn(f, y), __fmul_rn(fe, f32(0.693359375)));
}

// kernels/common.py::cos_2pi_f32: cos(2 pi u), u on a 2^-24 grid in [0, 1).
__device__ __forceinline__ float cos_2pi_f32(float u) {
  const float q = floorf(__fmul_rn(u, 4.f));
  float r = __fsub_rn(u, __fmul_rn(q, 0.25f));
  const bool hi = r > 0.125f;
  if (hi) r = __fsub_rn(0.25f, r);
  const float x = __fmul_rn(r, f32(6.283185307179586));
  const float z = __fmul_rn(x, x);
  float c = __fmul_rn(
      __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(z, f32(2.443315711809948e-5)),
                                    f32(-1.388731625493765e-3)), z),
                f32(4.166664568298827e-2)), z);
  c = __fadd_rn(__fsub_rn(__fmul_rn(c, z), __fmul_rn(z, 0.5f)), 1.f);
  float s = __fmul_rn(
      __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(z, f32(-1.9515295891e-4)),
                                    f32(8.3321608736e-3)), z),
                f32(-1.6666654611e-1)), z);
  s = __fadd_rn(__fmul_rn(s, x), x);
  const float cr = hi ? s : c;
  const float sr = hi ? c : s;
  const int qi = static_cast<int>(q);
  return qi == 0 ? cr : qi == 1 ? -sr : qi == 2 ? -cr : sr;
}

// kernels/common.py::box_muller on two uint32 words.
__device__ __forceinline__ float normal(uint32_t b1, uint32_t b2) {
  const float u1 = __fmul_rn(static_cast<float>(b1 >> 8), f32(0x1p-24));
  const float u2 = __fmul_rn(static_cast<float>(b2 >> 8), f32(0x1p-24));
  const float r = __fsqrt_rn(__fmul_rn(log_f32(__fsub_rn(1.f, u1)), -2.f));
  return __fmul_rn(r, cos_2pi_f32(u2));
}

// One element's noisy decode: mismatch on the count, the physics voltage,
// and the comparator bank with one offset per comparator.
__device__ __forceinline__ int decode_noisy(int count, const float* thr, int rows,
                                            uint32_t n, uint32_t m, uint32_t g,
                                            uint32_t pair, uint32_t k0, uint32_t k1,
                                            float ms, float cs) {
  float k = static_cast<float>(count);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (ms > 0.f || cs > 0.f) r = philox4x32_10(make_uint4(n, m, g, pair << 8), k0, k1);
  if (ms > 0.f) {
    const float z = normal(r.x, r.y);
    k = __fadd_rn(k, __fmul_rn(__fmul_rn(ms, __fsqrt_rn(fmaxf(k, 0.f))), z));
  }
  const float v = rbl_voltage(k, rows);
  int dec = 0;
  for (int i = 0; i < rows; ++i) {
    float t = thr[i];
    if (cs > 0.f) {
      const uint32_t d = static_cast<uint32_t>(i) + 1u;
      if ((d & 1u) == 0u)
        r = philox4x32_10(make_uint4(n, m, g, (pair << 8) | (d >> 1)), k0, k1);
      const float z = (d & 1u) ? normal(r.z, r.w) : normal(r.x, r.y);
      t = __fadd_rn(t, __fmul_rn(cs, z));
    }
    dec += (v <= t) ? 1 : 0;
  }
  return dec;
}

__global__ void __launch_bounds__(THREADS)
bitplane_mac_noisy_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ w,
                          const float* __restrict__ thr, int32_t* __restrict__ out,
                          int M, int N, int K, int PA, int PW, int rows,
                          int groups_per_split, bool accumulate, uint32_t k0,
                          uint32_t k1, float ms, float cs) {
  __shared__ Smem s;
  __shared__ float thr_s[MAX_ROWS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int m_rows = min(BM, M - m0);
  const int groups = (K + rows - 1) / rows;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);
  const bool live = n0 + lane < N;
  const uint32_t n = static_cast<uint32_t>(n0 + lane);

  if (tid < rows) thr_s[tid] = thr[tid];

  int acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0;

  for (int gs = g_begin; gs < g_end; gs += GK) {
    const int ng = min(GK, g_end - gs);
    __syncthreads();  // the previous step's reads are done (and thr_s written)
    stage(s, a, w, N, K, PA, PW, rows, m0, n0, m_rows, gs, ng);
    __syncthreads();
    for (int g = warp; g < ng; g += WARPS) {
      const uint32_t group = static_cast<uint32_t>(gs + g);
      uint32_t wq[MAX_PLANES];
#pragma unroll
      for (int q = 0; q < MAX_PLANES; ++q) wq[q] = (q < PW) ? s.w[q][g][lane] : 0u;
      for (int i = 0; i < BM; ++i) {
        if (i < m_rows && live) {
          const uint32_t m = static_cast<uint32_t>(m0 + i);
          int sum = 0;
          for (int p = 0; p < PA; ++p) {
            const uint32_t ap = s.a[p][i][g];
            for (int q = 0; q < PW; ++q) {
              const int dec = decode_noisy(__popc(ap & wq[q]), thr_s, rows, n, m,
                                           group, static_cast<uint32_t>(p * PW + q),
                                           k0, k1, ms, cs);
              sum += dec << (p + q);
            }
          }
          acc[i] += sum;
        }
      }
    }
  }
  store_tile(s, acc, out, N, m0, n0, m_rows, accumulate);
}

}  // namespace

// a: uint8[M,K] row-major, w: uint8[K,N] row-major (offset-binary values; only
// the low bits_a / bits_w bits are read), thr: float32[rows], out: int32[M,N];
// key0/key1: the Philox key words; a sigma <= 0 draws nothing.  Returns a
// cudaError_t value.
extern "C" int bitplane_mac_noisy_launch(const void* a, const void* w, const void* thr,
                                         void* out, int M, int N, int K, int bits_a,
                                         int bits_w, int rows, uint32_t key0,
                                         uint32_t key1, float mismatch_sigma,
                                         float comparator_sigma, void* stream,
                                         int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  bool skip = true;
  const int rc = prepare(out, M, N, K, bits_a, bits_w, rows, TARGET_BLOCKS, s,
                         &p, &skip);
  if (skip) return rc;
  bitplane_mac_noisy_kernel<<<p.grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w),
      static_cast<const float*>(thr), static_cast<int32_t*>(out), M, N, K,
      bits_a, bits_w, rows, p.per_split, p.accumulate, key0, key1,
      mismatch_sigma, comparator_sigma);
  return static_cast<int>(cudaGetLastError());
}
