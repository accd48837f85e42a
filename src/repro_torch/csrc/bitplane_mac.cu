// bitplane_mac: the paper's full bit-plane pyramid, decode included, in one
// launch:
//
//   out[m,n] = sum_{p,q} 2^(p+q) sum_g dec[ popc(A_p[m,g] & W_q[g,n]) ]
//
// where A_p[m,g] / W_q[g,n] are the `rows` bits of plane p (q) in K-group g,
// and dec[k] = #{i : thr[i] >= V(k)} is the comparator-bank decode of the
// two-regime physics RBL voltage V(k) against the thresholds `thr`.
//
// Replaces the TPU kernel bitplane_mac_raw (_make_kernel) in
// src/repro/kernels/bitplane_mac/bitplane_mac.py, the noise-free `sim`
// engine that every projection runs in the paper's mode.  There the plane
// pair and K axes are sequential grid dimensions carrying a VMEM
// accumulator; here both are loops inside one block.
//
// What bounds it on an H100: the operands are one byte per value (the bit
// planes are the bits of the byte), so a decode step's 72 projections at
// M = 4 move ~85 MB, ~25 us at 3.35 TB/s; counted as 2*PA*PW*M*K*N binary
// MAC operations at the int8 tensor-core rate they take about as long.  This
// kernel is bound by neither: it issues one popc, one shared-memory table
// read and one shift-add per (plane pair, group, output), ~2.7 G per decode
// step, on the integer pipes.
//
// Design (simple and right first):
//   * one 256-thread block (8 warps) per 8 x 32 output tile; lane = output
//     column, each thread keeps 8 row accumulators;
//   * K-groups are split across warps inside the block and, when the output
//     tiles alone give fewer than ~2 blocks per SM (decode, M = 4), across
//     blocks too (gridDim.z), whose partial sums meet through integer
//     atomicAdd into a zeroed output: integer addition is exact in any order;
//   * each step stages 32 K-groups: the uint8 operand tiles are read from
//     device memory and packed into one 32-bit word per (plane, row or
//     column, group) in shared memory, so a group count is one __popc;
//   * the decode: counts are integers in [0, rows], so each block builds the
//     rows+1 entry table dec[] once from the live `thr` data, computing V(k)
//     in float32 exactly as the reference does (no contracted multiply-adds);
//   * ragged edges: values past M, N or K stage as zeros, never padded in
//     device memory.  Only the real ceil(K/rows) groups are decoded: a
//     zero-padded partial last group is real hardware and is decoded; a group
//     past K is not.  Rows past M are not computed, columns past N not stored.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BM = 8;           // output rows per block
constexpr int BN = 32;          // output columns per block (one per lane)
constexpr int GK = 32;          // K-groups staged per step
constexpr int MAX_PLANES = 8;
constexpr int MAX_ROWS = 32;    // one group of one plane fits one 32-bit word
constexpr int TARGET_BLOCKS = 264;  // two per SM on a 132-SM H100

// Physics constants (src/repro/core/constants.py), rounded to float32 where
// they meet a float32 value, as JAX's weak typing rounds them.
constexpr double U_LIN = 0.216845;
constexpr double V0_LEAK = 1.758;
constexpr double VD_SAT = 0.865014;

__device__ float rbl_voltage(int k, int rows) {
  const float u = static_cast<float>(U_LIN * (8.0 / rows));
  const float x = __fmul_rn(static_cast<float>(k), u);
  const float lin = __fsub_rn(static_cast<float>(V0_LEAK), x);
  const float xt = fmaxf(__fsub_rn(x, static_cast<float>(V0_LEAK - VD_SAT)), 0.f);
  const float vd = static_cast<float>(VD_SAT);
  const float tri = __fmul_rn(vd, expf(__fdiv_rn(-xt, vd)));
  return lin >= vd ? lin : tri;
}

__global__ void __launch_bounds__(THREADS)
bitplane_mac_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ w,
                    const float* __restrict__ thr, int32_t* __restrict__ out,
                    int M, int N, int K, int PA, int PW, int rows,
                    int groups_per_split, bool accumulate) {
  __shared__ uint32_t a_s[MAX_PLANES][BM][GK];   //  8 KB
  __shared__ uint32_t w_s[MAX_PLANES][GK][BN];   // 32 KB; reused for the warp sums
  __shared__ int dec_s[MAX_ROWS + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int m_rows = min(BM, M - m0);
  const int groups = (K + rows - 1) / rows;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);

  if (tid <= rows) {  // the decode table, from the live thresholds
    const float v = rbl_voltage(tid, rows);
    int d = 0;
    for (int i = 0; i < rows; ++i) d += (v <= thr[i]) ? 1 : 0;
    dec_s[tid] = d;
  }

  int acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0;

  for (int gs = g_begin; gs < g_end; gs += GK) {
    const int ng = min(GK, g_end - gs);
    __syncthreads();  // the previous step's reads are done
    // A: one (row, group) per thread, `rows` bytes packed into PA words.
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
        if (p < PA) a_s[p][i][g] = word[p];
    }
    // W: one (group, column) per thread; lanes read neighbouring columns.
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
        if (q < PW) w_s[q][g][c] = word[q];
    }
    __syncthreads();
    // Warp `warp` takes groups warp, warp + 8, ...; lane = column.
    for (int g = warp; g < ng; g += WARPS) {
      uint32_t wq[MAX_PLANES];
#pragma unroll
      for (int q = 0; q < MAX_PLANES; ++q) wq[q] = (q < PW) ? w_s[q][g][lane] : 0u;
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (i < m_rows) {
          int s = 0;
          for (int p = 0; p < PA; ++p) {
            const uint32_t ap = a_s[p][i][g];
#pragma unroll
            for (int q = 0; q < MAX_PLANES; ++q)
              if (q < PW) s += dec_s[__popc(ap & wq[q])] << (p + q);
          }
          acc[i] += s;
        }
      }
    }
  }

  // Sum the 8 warps' partial accumulators; one output per thread.
  __syncthreads();
  int* part = reinterpret_cast<int*>(&w_s[0][0][0]);
#pragma unroll
  for (int i = 0; i < BM; ++i) part[(warp * BM + i) * BN + lane] = acc[i];
  __syncthreads();
  const int i = tid / BN;
  const int c = tid % BN;
  int s = 0;
#pragma unroll
  for (int wp = 0; wp < WARPS; ++wp) s += part[(wp * BM + i) * BN + c];
  if (i < m_rows && n0 + c < N) {
    int32_t* o = out + static_cast<size_t>(m0 + i) * N + n0 + c;
    if (accumulate) {
      atomicAdd(o, s);
    } else {
      *o = s;
    }
  }
}

static_assert(BM * BN == THREADS, "one output per thread in the final sum");
static_assert(WARPS * BM * BN <= MAX_PLANES * GK * BN, "warp sums fit in w_s");

}  // namespace

// a: uint8[M,K] row-major, w: uint8[K,N] row-major (offset-binary values; only
// the low bits_a / bits_w bits are read), thr: float32[rows], out: int32[M,N].
// Returns a cudaError_t value.
extern "C" int bitplane_mac_launch(const void* a, const void* w, const void* thr,
                                   void* out, int M, int N, int K, int bits_a,
                                   int bits_w, int rows, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bits_a < 1 || bits_a > MAX_PLANES || bits_w < 1 || bits_w > MAX_PLANES ||
      rows < 1 || rows > MAX_ROWS || M < 0 || N < 0 || K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (K + rows - 1) / rows;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_n * tiles_m;
  // Split the K-groups across blocks until the grid fills the card; each
  // split takes a multiple of WARPS groups.
  int splits = (TARGET_BLOCKS + tiles - 1) / tiles;
  splits = max(1, min(splits, (groups + WARPS - 1) / WARPS));
  int per_split = (groups + splits - 1) / splits;
  per_split = ((per_split + WARPS - 1) / WARPS) * WARPS;
  splits = groups == 0 ? 1 : (groups + per_split - 1) / per_split;
  const bool accumulate = splits > 1 || groups == 0;
  if (accumulate) {
    err = cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(M) * N, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (groups == 0) return static_cast<int>(cudaGetLastError());
  }
  dim3 grid(tiles_n, tiles_m, splits);
  bitplane_mac_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w),
      static_cast<const float*>(thr), static_cast<int32_t*>(out), M, N, K,
      bits_a, bits_w, rows, per_split, splits > 1);
  return static_cast<int>(cudaGetLastError());
}
