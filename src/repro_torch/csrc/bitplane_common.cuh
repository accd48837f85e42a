// Shared by bitplane_mac.cu and bitplane_mac_noisy.cu:
// the tile geometry, the operand staging (uint8 values -> one 32-bit word of
// `rows` bits per plane, row or column, and K-group in shared memory), the
// float32 physics RBL voltage with core/rbl.py::exp_f32's arithmetic, the
// split of the K-groups across blocks, and the cross-warp epilogue.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bitplane {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BM = 8;           // output rows per block
constexpr int BN = 32;          // output columns per block (one per lane)
constexpr int GK = 32;          // K-groups staged per step
constexpr int MAX_PLANES = 8;
constexpr int MAX_ROWS = 32;    // one group of one plane fits one 32-bit word

// Physics constants (src/repro/core/constants.py).  Every constant that
// meets a float32 value is the float32 rounding of the double, as PyTorch
// and JAX round a Python float against a float32 tensor.
constexpr double U_LIN = 0.216845;
constexpr double V0_LEAK = 1.758;
constexpr double VD_SAT = 0.865014;

// A block's staged operands, G K-groups of them; w is reused for the warp
// sums.
template <int G>
struct SmemG {
  uint32_t a[MAX_PLANES][BM][G];
  uint32_t w[MAX_PLANES][G][BN];
  static_assert(WARPS * BM * BN <= MAX_PLANES * G * BN, "warp sums fit in w");
};
using Smem = SmemG<GK>;  // 8 KB + 32 KB
static_assert(BM * BN == THREADS, "one output per thread in the final sum");

__device__ __forceinline__ float f32(double x) { return static_cast<float>(x); }

// float32 a*b + c as core/rbl.py::_fma computes it: the product of two
// float32 values is exact in double, the sum rounds to double, then to float.
__device__ __forceinline__ float fma_via_f64(float a, float b, float c) {
  return __double2float_rn(__fma_rn(static_cast<double>(a),
                                    static_cast<double>(b),
                                    static_cast<double>(c)));
}

// core/rbl.py::exp_f32 (XLA's CPU float32 exp: Cephes), step for step.
__device__ __forceinline__ float exp_f32(float x) {
  x = fminf(fmaxf(x, f32(-88.8)), f32(88.8));
  float n = floorf(fma_via_f64(x, f32(1.44269504088896341), 0.5f));
  n = fminf(fmaxf(n, -127.f), 127.f);
  float a = fma_via_f64(n, f32(-0.693359375), x);
  a = fma_via_f64(n, f32(2.12194440e-4), a);
  float z = fma_via_f64(a, f32(1.9875691500e-4), f32(1.3981999507e-3));
  z = fma_via_f64(z, a, f32(8.3334519073e-3));
  z = fma_via_f64(z, a, f32(4.1665795894e-2));
  z = fma_via_f64(z, a, f32(1.6666665459e-1));
  z = fma_via_f64(z, a, f32(5.0000001201e-1));
  z = fma_via_f64(z, __fmul_rn(a, a), a);
  z = __fadd_rn(1.f, z);
  const float pow2 = __int_as_float((static_cast<int>(n) + 127) << 23);
  return __fmul_rn(z, pow2);
}

// core/rbl.py::rbl_voltage_physics for a (possibly fractional) count k; the
// exponential only where the triode regime is taken.
__device__ __forceinline__ float rbl_voltage(float k, int rows) {
  const float u = f32(U_LIN * (8.0 / rows));
  const float x = __fmul_rn(k, u);
  const float lin = __fsub_rn(f32(V0_LEAK), x);
  const float vd = f32(VD_SAT);
  if (lin >= vd) return lin;
  const float xt = fmaxf(__fsub_rn(x, f32(V0_LEAK - VD_SAT)), 0.f);
  return __fmul_rn(vd, exp_f32(__fdiv_rn(-xt, vd)));
}

// Stage K-groups [gs, gs + ng) of the tile at (m0, n0): A as one (row,
// group) per thread, `rows` bytes packed into PA words; W as one (group,
// column) per thread, lanes on neighbouring columns.  Values past M, N or K
// stage as zeros.
__device__ __forceinline__ void stage(Smem& s, const uint8_t* __restrict__ a,
                                      const uint8_t* __restrict__ w, int N,
                                      int K, int PA, int PW, int rows, int m0,
                                      int n0, int m_rows, int gs, int ng) {
  const int tid = threadIdx.x;
  for (int t = tid; t < BM * GK; t += THREADS) {
    const int i = t / GK;
    const int g = t % GK;
    uint32_t word[MAX_PLANES];
#pragma unroll
    for (int p = 0; p < MAX_PLANES; ++p) word[p] = 0u;
    if (i < m_rows && g < ng) {
      const uint8_t* row = a + static_cast<size_t>(m0 + i) * K;
      const int kb = (gs + g) * rows;
      for (int r = 0; r < rows; ++r) {
        const uint32_t v = (kb + r < K) ? row[kb + r] : 0u;
#pragma unroll
        for (int p = 0; p < MAX_PLANES; ++p) word[p] |= ((v >> p) & 1u) << r;
      }
    }
#pragma unroll
    for (int p = 0; p < MAX_PLANES; ++p)
      if (p < PA) s.a[p][i][g] = word[p];
  }
  for (int t = tid; t < GK * BN; t += THREADS) {
    const int g = t / BN;
    const int c = t % BN;
    uint32_t word[MAX_PLANES];
#pragma unroll
    for (int q = 0; q < MAX_PLANES; ++q) word[q] = 0u;
    if (g < ng && n0 + c < N) {
      const int kb = (gs + g) * rows;
      for (int r = 0; r < rows; ++r) {
        const uint32_t v =
            (kb + r < K) ? w[static_cast<size_t>(kb + r) * N + n0 + c] : 0u;
#pragma unroll
        for (int q = 0; q < MAX_PLANES; ++q) word[q] |= ((v >> q) & 1u) << r;
      }
    }
#pragma unroll
    for (int q = 0; q < MAX_PLANES; ++q)
      if (q < PW) s.w[q][g][c] = word[q];
  }
}

// Sum the 8 warps' row accumulators (lane = column) and store one output
// per thread: plainly, or by integer atomicAdd into a zeroed output when the
// K-groups are split across blocks (exact in any order).
template <int G>
__device__ __forceinline__ void store_tile(SmemG<G>& s, const int (&acc)[BM],
                                           int32_t* __restrict__ out, int N,
                                           int m0, int n0, int m_rows,
                                           bool accumulate) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();
  int* part = reinterpret_cast<int*>(&s.w[0][0][0]);
#pragma unroll
  for (int i = 0; i < BM; ++i) part[(warp * BM + i) * BN + lane] = acc[i];
  __syncthreads();
  const int i = tid / BN;
  const int c = tid % BN;
  int sum = 0;
#pragma unroll
  for (int wp = 0; wp < WARPS; ++wp) sum += part[(wp * BM + i) * BN + c];
  if (i < m_rows && n0 + c < N) {
    int32_t* o = out + static_cast<size_t>(m0 + i) * N + n0 + c;
    if (accumulate) {
      atomicAdd(o, sum);
    } else {
      *o = sum;
    }
  }
}

struct Plan {
  dim3 grid;
  int per_split;    // K-groups per block, a multiple of the granule
  bool accumulate;  // atomicAdd into a zeroed output
  int groups;
};

// Split the ceil(K/rows) K-groups across blocks until the grid has about
// `target_blocks` blocks; each split takes a multiple of `granule` groups.
// `target_blocks` is a runtime argument of the entry points (their default
// in kernels/autotune, which may hold a measured other); any target gives
// the same sums (integer atomicAdd, exact in any order).
constexpr int MAX_TARGET = 1 << 20;

inline Plan plan(int M, int N, int K, int rows, int target_blocks,
                 int granule = WARPS) {
  Plan p;
  p.groups = (K + rows - 1) / rows;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_n * tiles_m;
  int splits = (target_blocks + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : splits;
  const int most = (p.groups + granule - 1) / granule;
  splits = splits > most ? most : splits;
  splits = splits < 1 ? 1 : splits;
  int per = (p.groups + splits - 1) / splits;
  per = ((per + granule - 1) / granule) * granule;
  p.per_split = per;
  splits = p.groups == 0 ? 1 : (p.groups + per - 1) / per;
  p.accumulate = splits > 1 || p.groups == 0;
  p.grid = dim3(tiles_n, tiles_m, splits);
  return p;
}

// Checks the arguments, plans the grid and zeroes the output of a split
// launch.  Returns a cudaError_t value; sets *skip when there is nothing to
// launch.
inline int prepare(void* out, int M, int N, int K, int bits_a, int bits_w,
                   int rows, int target_blocks, cudaStream_t s, Plan* p,
                   bool* skip, int granule = WARPS) {
  *skip = true;
  if (bits_a < 1 || bits_a > MAX_PLANES || bits_w < 1 ||
      bits_w > MAX_PLANES || rows < 1 || rows > MAX_ROWS || M < 0 || N < 0 ||
      K < 0 || target_blocks < 1 || target_blocks > MAX_TARGET) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return 0;
  *p = plan(M, N, K, rows, target_blocks, granule);
  if (p->accumulate) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(int32_t) * static_cast<size_t>(M) * N, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (p->groups == 0) return static_cast<int>(cudaGetLastError());
  }
  *skip = false;
  return 0;
}

}  // namespace bitplane
