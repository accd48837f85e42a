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
//     column, group) in shared memory, so a group count is one __popc
//     (staging, voltage, split and epilogue in bitplane_common.cuh, shared
//     with bitplane_mac_noisy.cu);
//   * the decode: counts are integers in [0, rows], so each block builds the
//     rows+1 entry table dec[] once from the live `thr` data, computing V(k)
//     in float32 exactly as the plain version does (no contracted
//     multiply-adds, core/rbl.py::exp_f32's exponential);
//   * ragged edges: values past M, N or K stage as zeros, never padded in
//     device memory.  Only the real ceil(K/rows) groups are decoded: a
//     zero-padded partial last group is real hardware and is decoded; a group
//     past K is not.  Rows past M are not computed, columns past N not stored.
#include "bitplane_common.cuh"

namespace {

using namespace bitplane;

constexpr int TARGET_BLOCKS = 264;  // two per SM on a 132-SM H100

__global__ void __launch_bounds__(THREADS)
bitplane_mac_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ w,
                    const float* __restrict__ thr, int32_t* __restrict__ out,
                    int M, int N, int K, int PA, int PW, int rows,
                    int groups_per_split, bool accumulate) {
  __shared__ Smem s;
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
    const float v = rbl_voltage(static_cast<float>(tid), rows);
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
    stage(s, a, w, N, K, PA, PW, rows, m0, n0, m_rows, gs, ng);
    __syncthreads();
    // Warp `warp` takes groups warp, warp + 8, ...; lane = column.
    for (int g = warp; g < ng; g += WARPS) {
      uint32_t wq[MAX_PLANES];
#pragma unroll
      for (int q = 0; q < MAX_PLANES; ++q) wq[q] = (q < PW) ? s.w[q][g][lane] : 0u;
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (i < m_rows) {
          int sum = 0;
          for (int p = 0; p < PA; ++p) {
            const uint32_t ap = s.a[p][i][g];
#pragma unroll
            for (int q = 0; q < MAX_PLANES; ++q)
              if (q < PW) sum += dec_s[__popc(ap & wq[q])] << (p + q);
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
// the low bits_a / bits_w bits are read), thr: float32[rows], out: int32[M,N].
// Returns a cudaError_t value.
extern "C" int bitplane_mac_launch(const void* a, const void* w, const void* thr,
                                   void* out, int M, int N, int K, int bits_a,
                                   int bits_w, int rows, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  bool skip = true;
  const int rc = prepare(out, M, N, K, bits_a, bits_w, rows, TARGET_BLOCKS, s,
                         &p, &skip);
  if (skip) return rc;
  bitplane_mac_kernel<<<p.grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w),
      static_cast<const float*>(thr), static_cast<int32_t*>(out), M, N, K,
      bits_a, bits_w, rows, p.per_split, p.accumulate);
  return static_cast<int>(cudaGetLastError());
}
