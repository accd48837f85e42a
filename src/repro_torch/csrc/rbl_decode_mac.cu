// rbl_decode_mac: the grouped binary MAC with the analog RBL decode inside
// the loop, for ONE bit-plane pair:
//
//   out[m,n] = sum_g dec[ popc(A[m,g] & W[g,n]) ]
//
// where A[m,g] / W[g,n] are the `rows` {0,1} operand bits of K-group g and
// dec[k] = #{i : thr[i] >= V(k)} is the comparator-bank decode of the
// two-regime physics RBL voltage V(k) against the live thresholds `thr`.
//
// Replaces the TPU kernel rbl_decode_mac_raw (_make_kernel) in
// src/repro/kernels/rbl_decode/rbl_decode.py: the threshold re-tuning and
// reduced-margin studies of the paper (§III-F, §IV-C) at kernel speed.  It
// is bitplane_mac.cu specialised to one plane pair: the operand bytes are
// taken as they are (bit 0 of each byte; the contract is {0,1}), with no
// offset-binary planes and no 2^(p+q) weights.  Staging, the physics voltage,
// the split of the K-groups and the epilogue are bitplane_common.cuh's.
//
// What bounds it on an H100: one byte per operand value, so one decode
// step's 72 projections at M = 4 move ~85 MB, ~25 us at 3.35 TB/s; its
// 2*M*K*N binary MACs at the int8 tensor-core rate take less.  As written it
// is bound by neither: the staging reads one byte per thread per row, and
// each (group, output) costs a popc, a shared-memory table read and an add.
//
// Padded groups: only the real ceil(K/rows) groups are decoded; a
// zero-padded partial last group is real hardware and is decoded.  The
// reference pads K to its tile (256) and decodes every padded group too,
// which under a detuned `thr` with dec[0] != 0 adds dec[0] per padded group.
#include "bitplane_common.cuh"

namespace {

using namespace bitplane;

constexpr int TARGET_BLOCKS = 264;  // two per SM on a 132-SM H100

__global__ void __launch_bounds__(THREADS)
rbl_decode_mac_kernel(const uint8_t* __restrict__ a,
                      const uint8_t* __restrict__ w,
                      const float* __restrict__ thr, int32_t* __restrict__ out,
                      int M, int N, int K, int rows, int groups_per_split,
                      bool accumulate) {
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
    stage(s, a, w, N, K, 1, 1, rows, m0, n0, m_rows, gs, ng);
    __syncthreads();
    // Warp `warp` takes groups warp, warp + 8, ...; lane = column.
    for (int g = warp; g < ng; g += WARPS) {
      const uint32_t wq = s.w[0][g][lane];
#pragma unroll
      for (int i = 0; i < BM; ++i)
        if (i < m_rows) acc[i] += dec_s[__popc(s.a[0][i][g] & wq)];
    }
  }
  store_tile(s, acc, out, N, m0, n0, m_rows, accumulate);
}

}  // namespace

// a: {0,1} bytes [M,K] row-major, w: {0,1} bytes [K,N] row-major,
// thr: float32[rows], out: int32[M,N].  Returns a cudaError_t value.
extern "C" int rbl_decode_mac_launch(const void* a, const void* w,
                                     const void* thr, void* out, int M, int N,
                                     int K, int rows, void* stream,
                                     int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  bool skip = true;
  const int rc = prepare(out, M, N, K, 1, 1, rows, TARGET_BLOCKS, s, &p,
                         &skip);
  if (skip) return rc;
  rbl_decode_mac_kernel<<<p.grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w),
      static_cast<const float*>(thr), static_cast<int32_t*>(out), M, N, K,
      rows, p.per_split, p.accumulate);
  return static_cast<int>(cudaGetLastError());
}
