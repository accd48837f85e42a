// imc_mac: int8[M,K] x int8[K,N] -> int32[M,N], exact integer accumulation.
// imc_mac_dequant: the same GEMM flushed as float32
//   out[m,n] = (float(acc) * scale_a) * scale_w[n].
//
// Replaces the TPU kernels imc_mac_raw (_mac_kernel) and imc_mac_dequant_raw
// (_mac_dequant_kernel) in src/repro/kernels/imc_mac/imc_mac.py.  imc_mac is
// the `exact` fabric engine, which every projection of the demonstrator
// config runs.  Integer accumulation is exact in any order, so the result is
// bit-identical to any other int32 GEMM of the same operands.  The dequant
// flush rounds in the reference's left-to-right order, __int2float_rn, then
// __fmul_rn by scale_a, then by scale_w[n], on the whole sum, so it is
// bit-identical too; above 2^24 (deep K) the int-to-float rounding shows and
// is the reference's.  scale_a is read from device memory (no host copy, no
// sync).
//
// What bounds it on an H100: at decode (M = 4 slots) the work is 2*M int8
// operations per weight byte, far below the card's ~590 ops/byte ridge, so
// the weight bytes set the floor: K*N bytes per launch at 3.35 TB/s (2.36
// MB, about 0.70 us, for 768x3072; 0.59 MB, 0.18 us, for 768x768).  A launch
// moves so few bytes that the floor a caller sees is one device-memory round
// trip (about 1 us) plus the launch itself.
//
// Two kernels, one rule (imc_mac_plan below; its twin is ops.imc_mac_plan):
//
//   * M <= 16 (decode with up to 16 slots, the bucket-16 prefill):
//     imc_mac_splitk_kernel<RM, DEQUANT>, written for these shapes.  The
//     tiled kernel below took 1.26 us per serial K step at decode (1.6348 ms
//     for one decode step's 72 launches, 1,296 serial 64-deep steps, from a
//     CUDA graph on an H100 80GB HBM3 at 700 W): one round trip each, with
//     2 KB of weights in flight per block and 24 blocks for a 768-wide
//     projection.  This kernel puts a launch's whole weight matrix in flight
//     at once:
//       - a block keeps RM output rows (4 when M <= 4, else 16; rows past M
//         stage as zeros and are not stored) and 256 columns, 8 per lane,
//         so a warp reads 256 contiguous bytes of a K-row with 8-byte loads
//         (4-byte or byte loads, in the same kernel, when N or the pointer
//         is not aligned for them);
//       - K is split over gridDim.y so that a launch has about 264 blocks
//         (two per SM) where K allows; inside a block the four warps take
//         disjoint runs of G "quads" (4 K-rows), G <= 4;
//       - each lane issues the loads of its whole K-slice (G quads x 4 rows
//         x 8 bytes, at most 128 bytes in registers) before the block stages
//         A and meets at its one barrier, so the weights cost one round trip
//         per launch and A's staging overlaps it;
//       - each 4(k) x 4(n) byte block turns into per-column words of 4
//         consecutive k with eight __byte_perm (prmt); one __dp4a (signed x
//         signed, so -128 works) then multiplies a row's A word, a broadcast
//         16-byte read of shared memory, into the column's sum;
//       - the warps meet by shared-memory atomicAdd into a skewed tile
//         (column c at c + c/32: both the lanes' 8-column stride and the
//         flush's unit stride are free of bank conflicts);
//       - blocks meet by integer atomicAdd into the output, which the
//         launcher zeroes with cudaMemsetAsync on the same stream (a node of
//         the graph when captured, so a replay starts from zero); exact in
//         any order.  With one split the kernel stores and there is no
//         memset.  The dequant epilogue adds into an int32 scratch instead,
//         with one arrival counter per 256-column tile in the same buffer;
//         the block that brings its tile's counter to `splits` reads the
//         tile's sums through L2 (__ldcg) and writes the float32 flush.
//     K = 0 gives one split whose loop does nothing: zeros, as the plain
//     version gives.
//
//   * M > 16 (the bucket-32/64 prefills, the macro path's 64x768x3072):
//     imc_mac_kernel, the first port's tiled kernel: one 128-thread block per
//     32x32 output tile, looping over K in 64-deep steps; each step stages
//     A as int32 words of 4 consecutive k and B transposed into words of 4
//     consecutive k per column in shared memory, then each thread runs
//     __dp4a on a 2x4 register tile.  It has no split of K: its epilogue
//     sees the whole sum.  Its time on the prefill shapes is the baseline
//     for a tensor-core (int8 mma.sync or wgmma) kernel.
//
// Ragged edges are masked while loading (zeros beyond M, N or K), never
// padded in device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ------------------------------------------------ the tiled kernel (M > 16)
constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 64;
constexpr int KQ = BK / 4;  // int32 words of 4 k-values per tile row
constexpr int THREADS = 128;

// The two epilogues: store the int32 sum, or dequantize it to float32.
struct StoreInt {
  int32_t* __restrict__ c;
  __device__ __forceinline__ void operator()(size_t i, int, int acc) const {
    c[i] = acc;
  }
};

struct Dequant {
  float* __restrict__ c;
  const float* __restrict__ scale_a;
  const float* __restrict__ scale_w;
  __device__ __forceinline__ void operator()(size_t i, int n, int acc) const {
    c[i] = __fmul_rn(__fmul_rn(__int2float_rn(acc), *scale_a), scale_w[n]);
  }
};

template <typename Epilogue>
__global__ void __launch_bounds__(THREADS)
imc_mac_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
               Epilogue epilogue, int M, int N, int K) {
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
      if (gn < N) epilogue(static_cast<size_t>(gm) * N + gn, gn, acc[i][j]);
    }
  }
}

// -------------------------------------------- the split-K kernel (M <= 16)
constexpr int SPLIT_MAX_M = 16;
constexpr int SK_WARPS = 4;
constexpr int SK_THREADS = 32 * SK_WARPS;
constexpr int SK_COLS = 8;               // columns per lane: one 8-byte load per K-row
constexpr int SK_BN = 32 * SK_COLS;      // 256 columns per block
constexpr int SK_GMAX = 4;               // quads (4 K-rows) a lane prefetches, at most
constexpr int SK_TARGET = 264;           // blocks a launch aims at: two per SM
constexpr int SK_SKEW = SK_BN + SK_BN / 32;  // a row of the shared sums

struct Plan {
  int rows;    // output rows a block keeps (4 or 16); 0: the tiled kernel
  int gx, gy, gz;
  int splits;  // blocks that share one output tile (gridDim.y)
  int kps;     // K-rows per split (a multiple of 4 * SK_WARPS)
};

Plan make_plan(int M, int N, int K) {
  if (M > SPLIT_MAX_M) {
    return {0, (N + BN - 1) / BN, (M + BM - 1) / BM, 1, 1, K};
  }
  const int tiles = (N + SK_BN - 1) / SK_BN;
  const long long quads = (static_cast<long long>(K) + 3) / 4;
  long long g = (quads * tiles + SK_WARPS * SK_TARGET - 1) /
                (SK_WARPS * SK_TARGET);
  g = g < 1 ? 1 : (g > SK_GMAX ? SK_GMAX : g);
  const int kps = static_cast<int>(4 * SK_WARPS * g);
  const int splits = K > 0 ? (K + kps - 1) / kps : 1;
  return {M <= 4 ? 4 : 16, tiles, splits, 1, splits, kps};
}

// Eight bytes row[col..col+7] packed little-endian, zeros past len; width is
// the widest load that N and the pointer allow (8, 4 or 1 bytes).
__device__ __forceinline__ uint2 load8(const int8_t* __restrict__ row, int col,
                                       int len, int width) {
  if (width == 8) {
    return col < len ? __ldg(reinterpret_cast<const uint2*>(row + col))
                     : make_uint2(0u, 0u);
  }
  return make_uint2(load_word(row, col, len, width == 4),
                    load_word(row, col + 4, len, width == 4));
}

// Rows r0..r3 hold bytes (k_i; n_0..n_3); col[j] gets (k_0..k_3; n_j).
__device__ __forceinline__ void byte_transpose(uint32_t r0, uint32_t r1,
                                               uint32_t r2, uint32_t r3,
                                               uint32_t* col) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ float dequant(int acc, float sa, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sw);
}

// sums: the int32 output (imc_mac) or the scratch (dequant, split > 1), M x N
// row-major; arrivals: one counter per 256-column tile (dequant, split > 1).
template <int RM, bool DEQUANT>
__global__ void __launch_bounds__(SK_THREADS)
imc_mac_splitk_kernel(const int8_t* __restrict__ a,
                      const int8_t* __restrict__ b, int32_t* sums,
                      float* __restrict__ out, const float* __restrict__ scale_a,
                      const float* __restrict__ scale_w, int* arrivals, int M,
                      int N, int K, int kps, int width) {
  __shared__ __align__(16) uint32_t as[SK_WARPS * SK_GMAX][RM];
  __shared__ int red[RM][SK_SKEW];
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * SK_BN;
  const int k0 = blockIdx.y * kps;
  const int splits = gridDim.y;
  const int quads = kps / 4;              // in the block's K-slice
  const int g_n = quads / SK_WARPS;       // in each warp's run
  const int col = n0 + SK_COLS * lane;

  // 1. every weight load of the lane's K-slice, before any arithmetic
  uint2 w[SK_GMAX][4];
#pragma unroll
  for (int g = 0; g < SK_GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 4 * (warp * g_n + g) + i;
      w[g][i] = (g < g_n && k < K)
                    ? load8(b + static_cast<size_t>(k) * N, col, N, width)
                    : make_uint2(0u, 0u);
    }
  }

  // 2. A's words of the slice (rows past M and k past K are zeros); zero the
  // shared sums
  const bool a_vec = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(a) & 3) == 0);
  for (int i = tid; i < RM * quads; i += SK_THREADS) {
    const int r = i / quads;
    const int q = i % quads;
    as[q][r] = r < M ? load_word(a + static_cast<size_t>(r) * K, k0 + 4 * q,
                                 K, a_vec)
                     : 0u;
  }
  for (int i = tid; i < RM * SK_SKEW; i += SK_THREADS) (&red[0][0])[i] = 0;
  __syncthreads();

  // 3. transpose each 4x4 byte block, then one dp4a per row and column
  int acc[RM][SK_COLS];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < SK_COLS; ++j) acc[r][j] = 0;
#pragma unroll
  for (int g = 0; g < SK_GMAX; ++g) {
    if (g < g_n) {
      uint32_t cw[SK_COLS];
      byte_transpose(w[g][0].x, w[g][1].x, w[g][2].x, w[g][3].x, cw);
      byte_transpose(w[g][0].y, w[g][1].y, w[g][2].y, w[g][3].y, cw + 4);
      const int q = warp * g_n + g;
#pragma unroll
      for (int r = 0; r < RM; r += 4) {
        const uint4 a4 = *reinterpret_cast<const uint4*>(&as[q][r]);
        const int av[4] = {static_cast<int>(a4.x), static_cast<int>(a4.y),
                           static_cast<int>(a4.z), static_cast<int>(a4.w)};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int j = 0; j < SK_COLS; ++j)
            acc[r + x][j] = __dp4a(av[x], static_cast<int>(cw[j]), acc[r + x][j]);
      }
    }
  }

  // 4. the warps meet in shared memory
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < SK_COLS; ++j) {
      const int c = SK_COLS * lane + j;
      atomicAdd(&red[r][c + c / 32], acc[r][j]);
    }
  __syncthreads();

  // 5. the flush: one split stores; more add into the output or the scratch
  const float sa = DEQUANT ? *scale_a : 0.f;
  for (int r = 0; r < RM && r < M; ++r) {
    for (int c = tid; c < SK_BN; c += SK_THREADS) {
      const int n = n0 + c;
      if (n >= N) continue;
      const int v = red[r][c + c / 32];
      const size_t i = static_cast<size_t>(r) * N + n;
      if (splits > 1) {
        atomicAdd(&sums[i], v);
      } else if (DEQUANT) {
        out[i] = dequant(v, sa, scale_w[n]);
      } else {
        sums[i] = v;
      }
    }
  }
  if (!DEQUANT || splits == 1) return;

  // 6. dequant: the last block of the tile to arrive flushes its sums
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&arrivals[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = 0; r < RM && r < M; ++r) {
    for (int c = tid; c < SK_BN; c += SK_THREADS) {
      const int n = n0 + c;
      if (n >= N) continue;
      const size_t i = static_cast<size_t>(r) * N + n;
      out[i] = dequant(__ldcg(&sums[i]), sa, scale_w[n]);
    }
  }
}

int b_width(const void* b, int N) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(b);
  if (N % 8 == 0 && p % 8 == 0) return 8;
  if (N % 4 == 0 && p % 4 == 0) return 4;
  return 1;
}

template <bool DEQUANT>
int launch_split(const Plan& p, const void* a, const void* b, int32_t* sums,
                 float* out, const float* scale_a, const float* scale_w,
                 int* arrivals, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid(p.gx, p.gy, p.gz);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const int width = b_width(b, N);
  if (p.rows == 4) {
    imc_mac_splitk_kernel<4, DEQUANT><<<grid, SK_THREADS, 0, stream>>>(
        a8, b8, sums, out, scale_a, scale_w, arrivals, M, N, K, p.kps, width);
  } else {
    imc_mac_splitk_kernel<16, DEQUANT><<<grid, SK_THREADS, 0, stream>>>(
        a8, b8, sums, out, scale_a, scale_w, arrivals, M, N, K, p.kps, width);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Epilogue>
int launch_tiled(const Plan& p, const void* a, const void* b, Epilogue epilogue,
                 int M, int N, int K, cudaStream_t stream) {
  const dim3 grid(p.gx, p.gy, p.gz);
  imc_mac_kernel<Epilogue><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), epilogue,
      M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan for an M x K x N product: out[0] the rows a split-K block
// keeps (4 or 16; 0 means the tiled kernel), out[1..3] the grid, out[4] the
// splits of K, out[5] the K-rows per split.  Returns 0.
extern "C" int imc_mac_plan(int M, int N, int K, int* out) {
  const Plan p = make_plan(M, N, K);
  const int v[6] = {p.rows, p.gx, p.gy, p.gz, p.splits, p.kps};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// a: int8[M,K], b: int8[K,N] row-major; c: int32[M,N].  Returns a
// cudaError_t value.
extern "C" int imc_mac_launch(const void* a, const void* b, void* c, int M,
                              int N, int K, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(M, N, K);
  auto* c32 = static_cast<int32_t*>(c);
  if (p.rows == 0) return launch_tiled(p, a, b, StoreInt{c32}, M, N, K, s);
  if (p.splits > 1) {
    err = cudaMemsetAsync(c, 0, sizeof(int32_t) * M * N, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_split<false>(p, a, b, c32, nullptr, nullptr, nullptr, nullptr,
                             M, N, K, s);
}

// As imc_mac_launch, plus scale_a: float32[1] and scale_w: float32[N] in
// device memory; c: float32[M,N].  scratch: int32, at least M*N + plan
// grid x values when the plan splits K (zeroed here), else unused.
extern "C" int imc_mac_dequant_launch(const void* a, const void* b,
                                      const void* scale_a, const void* scale_w,
                                      void* c, void* scratch,
                                      long long scratch_ints, int M, int N,
                                      int K, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(M, N, K);
  const auto* sa = static_cast<const float*>(scale_a);
  const auto* sw = static_cast<const float*>(scale_w);
  auto* out = static_cast<float*>(c);
  if (p.rows == 0) return launch_tiled(p, a, b, Dequant{out, sa, sw}, M, N, K, s);
  if (p.splits == 1) {
    return launch_split<true>(p, a, b, nullptr, out, sa, sw, nullptr, M, N, K,
                              s);
  }
  const long long need = static_cast<long long>(M) * N + p.gx;
  if (scratch == nullptr || scratch_ints < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * need, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* sums = static_cast<int32_t*>(scratch);
  return launch_split<true>(p, a, b, sums, out, sa, sw,
                            sums + static_cast<size_t>(M) * N, M, N, K, s);
}
