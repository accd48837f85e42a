// imc_mac: int8[M,K] x int8[K,N] -> int32[M,N], exact integer accumulation.
//
// Replaces the TPU kernel imc_mac_raw (_mac_kernel) in
// src/repro/kernels/imc_mac/imc_mac.py: the `exact` fabric engine, which every
// projection of the demonstrator config runs.  Integer accumulation is exact,
// so the result is bit-identical to any other int32 GEMM of the same operands.
//
// What bounds it on an H100: at decode (M = 4 slots) the work is a few
// hundred int8 MACs per weight byte read, far below the card's ~590 int8
// ops/byte ridge, so the int8 weight bytes set the floor (K*N bytes per
// launch at 3.35 TB/s; 2.36 MB, about 0.70 us, for 768x3072).  At prefill
// (M = 16..64 padded bucket rows) it is still bytes-bound.
//
// Design (simple and right first; wgmma and TMA come later):
//   * one 128-thread block per 32x32 output tile, looping over K in 64-deep
//     steps; the grid covers ceil(N/32) x ceil(M/32) tiles, so a 768-wide
//     projection gets 24 blocks and a 3072-wide one 96;
//   * each step stages the A tile as int32 words of 4 consecutive k, and the
//     B tile transposed into int32 words of 4 consecutive k per column, in
//     shared memory; each thread then runs __dp4a on a 2x4 register tile;
//   * ragged edges are masked while staging (zeros beyond M, N or K), never
//     padded in device memory; 32-bit vector loads are used when the row
//     length is a multiple of 4 and the pointer is aligned, byte loads
//     otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 64;
constexpr int KQ = BK / 4;  // int32 words of 4 k-values per tile row
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t load_word(const int8_t* __restrict__ row,
                                              int col, int len, bool vec) {
  // Four consecutive bytes row[col..col+3] packed little-endian, zeros past len.
  if (vec && col + 3 < len) {
    return *reinterpret_cast<const uint32_t*>(row + col);
  }
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (col + i < len) {
      w |= static_cast<uint32_t>(static_cast<uint8_t>(row[col + i])) << (8 * i);
    }
  }
  return w;
}

__global__ void __launch_bounds__(THREADS)
imc_mac_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
               int32_t* __restrict__ c, int M, int N, int K) {
  __shared__ uint32_t as[BM][KQ + 1];  // +1 word: rows 2 apart hit distinct banks
  __shared__ uint32_t bs[KQ][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = tid % 8;   // output columns tx + 8*j, j < 4
  const int ty = tid / 8;   // output rows 2*ty + i, i < 2
  const bool a_vec = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(a) & 3) == 0);
  const bool b_vec = (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(b) & 3) == 0);

  int acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM rows x KQ words, 4 words per thread.
#pragma unroll
    for (int r = 0; r < (BM * KQ) / THREADS; ++r) {
      const int w = tid + r * THREADS;
      const int row = w / KQ;
      const int kq = w % KQ;
      const int gm = m0 + row;
      uint32_t word = 0;
      if (gm < M) {
        word = load_word(a + static_cast<size_t>(gm) * K, k0 + 4 * kq, K, a_vec);
      }
      as[row][kq] = word;
    }
    // B tile: a 4(k) x 4(n) byte block per thread, transposed so that each
    // column's word holds 4 consecutive k.
    {
      const int kq = tid / (BN / 4);
      const int nq = tid % (BN / 4);
      const int gn = n0 + 4 * nq;
      uint32_t rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gk = k0 + 4 * kq + i;
        rows[i] = (gk < K && gn < N)
                      ? load_word(b + static_cast<size_t>(gk) * N, gn, N, b_vec)
                      : 0u;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t col = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) col |= ((rows[i] >> (8 * j)) & 0xffu) << (8 * i);
        bs[kq][4 * nq + j] = col;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      const int a0 = static_cast<int>(as[2 * ty][kq]);
      const int a1 = static_cast<int>(as[2 * ty + 1][kq]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bw = static_cast<int>(bs[kq][tx + 8 * j]);
        acc[0][j] = __dp4a(a0, bw, acc[0][j]);
        acc[1][j] = __dp4a(a1, bw, acc[1][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + 2 * ty + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 8 * j;
      if (gn < N) c[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int imc_mac_launch(const void* a, const void* b, void* c, int M,
                              int N, int K, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  imc_mac_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int32_t*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
