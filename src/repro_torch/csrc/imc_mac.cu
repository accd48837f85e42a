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
//     first port's tiled kernel took 1.26 us per serial K step at decode
//     (1.6348 ms for one decode step's 72 launches, 1,296 serial 64-deep
//     steps, from a CUDA graph on an H100 80GB HBM3 at 700 W): one round
//     trip each, with
//     2 KB of weights in flight per block and 24 blocks for a 768-wide
//     projection.  This kernel puts a launch's whole weight matrix in flight
//     at once:
//       - a block keeps RM output rows (4 when M <= 4, else 16; rows past M
//         stage as zeros and are not stored) and 256 columns, 8 per lane,
//         so a warp reads 256 contiguous bytes of a K-row with 8-byte loads
//         (4-byte or byte loads, in the same kernel, when N or the pointer
//         is not aligned for them);
//       - K is split over gridDim.y so that a launch has about sk_target
//         blocks (264 by default: two per SM) where K allows; inside a block
//         the four warps take disjoint runs of G "quads" (4 K-rows),
//         G <= sk_gmax <= 4 (the plan's Geometry, below);
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
//     imc_mac_mma_kernel<DEQUANT>, on the int8 tensor cores.  At M = 64 the
//     work is 128 int8 operations per weight byte, still far below the
//     ridge, so the weight bytes (85 MB per prefill) set the floor, and a
//     768x768 launch holds only 590 KB of them: the whole launch has to be
//     in flight at once, as at decode.  dp4a at M = 64 would take ~3x the
//     bytes bound; mma.sync.m16n8k32.s8 keeps the arithmetic far below it.
//       - a block keeps a 64 x 32 output tile (16 rows per warp, four 16x8
//         fragments each) and one K-slice of it; the blocks that share a
//         tile form one thread-block cluster of `splits` blocks (1, 2, 4 or
//         8, the portable size; at most tc_cluster), gridDim.y, so that a
//         launch has at most tc_target blocks (264 by default) where K
//         allows;
//       - each lane issues the weight loads of its share of the slice
//         (16-byte loads of 4 K-rows x 16 columns; 4-byte or byte loads, in
//         the same kernel, when N or the pointer is not aligned for them)
//         before anything else, then A's tile goes to shared memory by
//         16-byte cp.async (by words when K or the pointer do not allow
//         it), then the lane turns each 4x4 byte block into per-column words
//         of 4 consecutive k (eight prmt) and stores B transposed, K-
//         contiguous per column: B^T[n][k], the layout of the .col B
//         fragment.  Rows of 4 mod 8 words and an XOR of 16 words on the
//         second 16 columns keep both the stores and the fragment reads free
//         of bank conflicts.  One barrier, then the mma; a slice deeper than
//         384 K-rows loops (no prefill shape does);
//       - tiles past M, N or K read as zeros, masked while loading; the
//         rows of a warp whose 16 rows all lie past M are neither staged
//         nor multiplied;
//       - the cluster's blocks write their int32 partial tiles to their own
//         shared memory, meet at cluster.sync(), and each rank then sums its
//         share of the tile's elements over every rank's partial through
//         distributed shared memory (map_shared_rank), starting at its own
//         rank, and stores it once: the int32 sum, or the float32 dequant
//         of the whole sum.  No global scratch, no memset, no atomics:
//         nothing for a graph replay to reset.  A second cluster.sync()
//         keeps every partial alive until the cluster has read it.
//     K = 0 gives a slice with no K-steps: zeros, as the plain version gives.
//
// Ragged edges are masked while loading (zeros beyond M, N or K), never
// padded in device memory.
#include <cooperative_groups.h>
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

// -------------------------------------------- the split-K kernel (M <= 16)
constexpr int SPLIT_MAX_M = 16;
constexpr int SK_WARPS = 4;
constexpr int SK_THREADS = 32 * SK_WARPS;
constexpr int SK_COLS = 8;               // columns per lane: one 8-byte load per K-row
constexpr int SK_BN = 32 * SK_COLS;      // 256 columns per block
constexpr int SK_GMAX = 4;               // quads (4 K-rows) a lane prefetches, at most
constexpr int SK_TARGET = 264;           // blocks a launch aims at: two per SM
constexpr int SK_SKEW = SK_BN + SK_BN / 32;  // a row of the shared sums

// ------------------------------------ the tensor-core kernel's plan (M > 16)
constexpr int TC_BM = 64;             // output rows a block keeps: 16 a warp
constexpr int TC_BN = 32;             // output columns: four 8-column fragments
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_KC = 384;            // K-rows staged at once (3 x 128)
constexpr int TC_SW = TC_KC / 4 + 4;  // words per staged row: 4 mod 8
constexpr int TC_RED = TC_BN + 8;     // ints per partial-tile row: 8 mod 32
constexpr int TC_PAIRS =              // (quad, 16 columns) pairs per lane
    (2 * (TC_KC / 4) + TC_THREADS - 1) / TC_THREADS;
constexpr int TC_MAX_SPLITS = 8;      // the portable cluster size
constexpr int TC_TARGET = 264;        // blocks a launch aims at, at most

struct Plan {
  int rows;    // output rows a split-K block keeps (4 or 16); 0: the M > 16
               // tensor-core kernel
  int gx, gy, gz;
  int splits;  // blocks that share one output tile (gridDim.y; for M > 16
               // the cluster size)
  int kps;     // K-rows per split (a multiple of 4 * SK_WARPS; of 32 for
               // M > 16)
};

// A plan's tunable choices, runtime arguments of the entry points
// (kernels/autotune in Python holds these defaults and, measured on the
// card, a cache of others).  Each one only splits K over more or fewer
// blocks, and integer partial sums meet exactly in any order, so every
// geometry gives the same output.  Bounds: the split kernel's register
// array (SK_GMAX quads) and the portable cluster size (TC_MAX_SPLITS).
constexpr int MAX_TARGET = 1 << 20;
struct Geometry {
  int sk_gmax = SK_GMAX;           // quads a split-K lane prefetches, at most
  int sk_target = SK_TARGET;       // blocks a split-K launch aims at
  int tc_cluster = TC_MAX_SPLITS;  // tensor-core splits (the cluster), at most
  int tc_target = TC_TARGET;       // tensor-core blocks a launch aims at
};

bool geometry_ok(const Geometry& g) {
  return g.sk_gmax >= 1 && g.sk_gmax <= SK_GMAX && g.sk_target >= 1 &&
         g.sk_target <= MAX_TARGET && g.tc_cluster >= 1 &&
         g.tc_cluster <= TC_MAX_SPLITS &&
         (g.tc_cluster & (g.tc_cluster - 1)) == 0 && g.tc_target >= 1 &&
         g.tc_target <= MAX_TARGET;
}

Plan make_plan(int M, int N, int K, const Geometry& geo = Geometry()) {
  if (M > SPLIT_MAX_M) {
    // 64 x 32 tiles; double the splits (a power of two, at most tc_cluster)
    // while the launch stays within tc_target blocks and K has a 32-deep
    // step for each split (a last split may still find its slice past K: it
    // adds zeros)
    const int gx = (N + TC_BN - 1) / TC_BN;
    const int gz = (M + TC_BM - 1) / TC_BM;
    const long long tiles = static_cast<long long>(gx) * gz;
    const int steps = (K + 31) / 32;
    int splits = 1;
    while (splits < geo.tc_cluster && tiles * splits * 2 <= geo.tc_target &&
           steps >= 2 * splits) {
      splits *= 2;
    }
    return {0, gx, splits, gz, splits, 32 * ((steps + splits - 1) / splits)};
  }
  const int tiles = (N + SK_BN - 1) / SK_BN;
  const long long quads = (static_cast<long long>(K) + 3) / 4;
  const long long per = static_cast<long long>(SK_WARPS) * geo.sk_target;
  long long g = (quads * tiles + per - 1) / per;
  g = g < 1 ? 1 : (g > geo.sk_gmax ? geo.sk_gmax : g);
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

// ------------------------------------------ the tensor-core kernel (M > 16)
// Sixteen bytes row[col..col+15] packed little-endian, zeros past len; width
// is the widest load that N and the pointer allow (16, 4 or 1 bytes).
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ row,
                                        int col, int len, int width) {
  if (width == 16) {
    return col < len ? __ldg(reinterpret_cast<const uint4*>(row + col))
                     : make_uint4(0u, 0u, 0u, 0u);
  }
  const bool vec = width == 4;
  return make_uint4(load_word(row, col, len, vec),
                    load_word(row, col + 4, len, vec),
                    load_word(row, col + 8, len, vec),
                    load_word(row, col + 12, len, vec));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// d += a (16x32, row) x b (32x8, col), signed int8 in, int32 out.  Fragments
// (PTX ISA, m16n8k32 .s8; g = lane/4, t = lane%4): a0 row g, k 4t..4t+3; a1
// row g+8; a2 row g, k 16+4t..; a3 row g+8, k 16+4t..; b0 column g, k
// 4t..4t+3; b1 column g, k 16+4t..; d0,d1 row g, columns 2t, 2t+1; d2,d3
// row g+8.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

struct TcTiles {
  uint32_t a[TC_BM][TC_SW];  // A's rows: word w holds k = 4w..4w+3
  uint32_t b[TC_BN][TC_SW];  // B^T: column n, word w ^ (16 * (n / 16 % 2))
};

union TcSmem {
  TcTiles in;
  int red[TC_BM][TC_RED];    // the block's int32 partial tile
};

// grid (ceil(N/32), splits, ceil(M/64)), clusters of (1, splits, 1); c: the
// int32 output (imc_mac) or out: the float32 one (dequant).  a16: A may be
// staged by 16-byte cp.async; width: B's load width; vec_out: 16-byte stores.
template <bool DEQUANT>
__global__ void __launch_bounds__(TC_THREADS)
imc_mac_mma_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   int32_t* __restrict__ c, float* __restrict__ out,
                   const float* __restrict__ scale_a,
                   const float* __restrict__ scale_w, int M, int N, int K,
                   int kps, int a16, int width, int vec_out) {
  __shared__ __align__(16) TcSmem sm;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * TC_BN;
  const int m0 = blockIdx.z * TC_BM;
  const int splits = gridDim.y;
  const int k_begin = blockIdx.y * kps;
  const int k_end = min(K, k_begin + kps);
  const int live = min(TC_BM, M - m0);     // rows of the tile below M
  const int live16 = (live + 15) & ~15;    // rows the live warps read
  const bool warp_live = 16 * warp < live;
  const bool a4 = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(a) & 3) == 0);

  int acc[4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0;

  for (int kc0 = k_begin; kc0 < k_end; kc0 += TC_KC) {
    const int steps = (min(TC_KC, k_end - kc0) + 31) / 32;  // 32-deep K-steps
    const int pairs = 2 * 8 * steps;  // (quad q, 16 columns c) as p = 2q + c

    // 1. every weight load of the lane's pairs, before anything else
    uint4 w[TC_PAIRS][4];
#pragma unroll
    for (int j = 0; j < TC_PAIRS; ++j) {
      const int p = tid + j * TC_THREADS;
      const int q = p >> 1;
      const int col = n0 + 16 * (p & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kc0 + 4 * q + i;
        w[j][i] = (p < pairs && k < K)
                      ? load16(b + static_cast<size_t>(k) * N, col, N, width)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // 2. A's tile (rows below live16; k past K and rows past M as zeros)
    const int a_words = 8 * steps;  // per row
    if (a16) {
      const int units = live16 * (a_words / 4);
      for (int u = tid; u < units; u += TC_THREADS) {
        const int r = u / (a_words / 4);
        const int v = u % (a_words / 4);
        const int k = kc0 + 16 * v;
        const bool valid = m0 + r < M && k < K;
        cp_async16(&sm.in.a[r][4 * v],
                   valid ? a + static_cast<size_t>(m0 + r) * K + k : a, valid);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
      const int units = live16 * a_words;
      for (int u = tid; u < units; u += TC_THREADS) {
        const int r = u / a_words;
        const int v = u % a_words;
        sm.in.a[r][v] = m0 + r < M
                            ? load_word(a + static_cast<size_t>(m0 + r) * K,
                                        kc0 + 4 * v, K, a4)
                            : 0u;
      }
    }

    // 3. B transposed into K-contiguous columns
#pragma unroll
    for (int j = 0; j < TC_PAIRS; ++j) {
      const int p = tid + j * TC_THREADS;
      if (p < pairs) {
        const int q = p >> 1;
        const int c16 = 16 * (p & 1);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          uint32_t cw[4];
          byte_transpose(word(w[j][0], x), word(w[j][1], x), word(w[j][2], x),
                         word(w[j][3], x), cw);
#pragma unroll
          for (int y = 0; y < 4; ++y) sm.in.b[c16 + 4 * x + y][q ^ c16] = cw[y];
        }
      }
    }
    if (a16) asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    // 4. the products: each live warp its 16 rows x 32 columns
    if (warp_live) {
      const uint32_t* ar0 = sm.in.a[16 * warp + g];
      const uint32_t* ar1 = sm.in.a[16 * warp + g + 8];
      for (int s = 0; s < steps; ++s) {
        const uint32_t af[4] = {ar0[8 * s + t], ar1[8 * s + t],
                                ar0[8 * s + 4 + t], ar1[8 * s + 4 + t]};
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const uint32_t* br = sm.in.b[8 * f + g];
          const int sw = 16 * (f >> 1);
          mma_s8(acc[f], af, br[(8 * s + t) ^ sw], br[(8 * s + 4 + t) ^ sw]);
        }
      }
    }
    __syncthreads();  // the tiles are free for the next chunk or the partial
  }

  // 5. the partial tile in this block's shared memory
  if (warp_live) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      *reinterpret_cast<int2*>(&sm.red[16 * warp + g][8 * f + 2 * t]) =
          make_int2(acc[f][0], acc[f][1]);
      *reinterpret_cast<int2*>(&sm.red[16 * warp + g + 8][8 * f + 2 * t]) =
          make_int2(acc[f][2], acc[f][3]);
    }
  }
  cluster.sync();

  // 6. each rank sums its share of the tile over the cluster, then flushes
  const int rank = static_cast<int>(cluster.block_rank());
  const float sa = DEQUANT ? __ldg(scale_a) : 0.f;
  for (int i = rank * TC_THREADS + tid; i < live * (TC_BN / 4);
       i += splits * TC_THREADS) {
    const int r = i / (TC_BN / 4);
    const int c4 = 4 * (i % (TC_BN / 4));
    int4 v[TC_MAX_SPLITS];  // every rank's partial in flight at once
#pragma unroll
    for (int j = 0; j < TC_MAX_SPLITS; ++j) {
      if (j < splits) {
        const int src = rank + j < splits ? rank + j : rank + j - splits;
        v[j] = *cluster.map_shared_rank(
            reinterpret_cast<int4*>(&sm.red[r][c4]), src);
      }
    }
    int4 s = v[0];
#pragma unroll
    for (int j = 1; j < TC_MAX_SPLITS; ++j) {
      if (j < splits) {
        s.x += v[j].x;
        s.y += v[j].y;
        s.z += v[j].z;
        s.w += v[j].w;
      }
    }
    const int n = n0 + c4;
    if (n >= N) continue;
    const size_t o = static_cast<size_t>(m0 + r) * N + n;
    const int sv[4] = {s.x, s.y, s.z, s.w};
    if (DEQUANT) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[e] = n + e < N ? dequant(sv[e], sa, __ldg(scale_w + n + e)) : 0.f;
      }
      if (vec_out) {
        *reinterpret_cast<float4*>(out + o) =
            make_float4(f[0], f[1], f[2], f[3]);
      } else {
        for (int e = 0; e < 4 && n + e < N; ++e) out[o + e] = f[e];
      }
    } else if (vec_out) {
      *reinterpret_cast<int4*>(c + o) = s;
    } else {
      for (int e = 0; e < 4 && n + e < N; ++e) c[o + e] = sv[e];
    }
  }
  cluster.sync();  // every partial stays alive until the cluster has read it
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

template <bool DEQUANT>
int launch_mma(const Plan& p, const void* a, const void* b, int32_t* c,
               float* out, const float* scale_a, const float* scale_w, int M,
               int N, int K, cudaStream_t stream) {
  if (p.gz > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = p.splits;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.gx, p.gy, p.gz);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pc = DEQUANT ? reinterpret_cast<uintptr_t>(out)
                               : reinterpret_cast<uintptr_t>(c);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  const int a16 = K % 16 == 0 && pa % 16 == 0;
  const int width = N % 16 == 0 && pb % 16 == 0 ? 16
                    : N % 4 == 0 && pb % 4 == 0 ? 4 : 1;
  const int vec_out = N % 4 == 0 && pc % 16 == 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, imc_mac_mma_kernel<DEQUANT>, static_cast<const int8_t*>(a),
      static_cast<const int8_t*>(b), c, out, scale_a, scale_w, M, N, K, p.kps,
      a16, width, vec_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan for an M x K x N product: out[0] the rows a split-K block
// keeps (4 or 16; 0 means the M > 16 tensor-core kernel), out[1..3] the grid,
// out[4] the splits of K (for M > 16 the cluster size), out[5] the K-rows per
// split, under the geometry (sk_gmax, sk_target, tc_cluster, tc_target).
// Returns 0, or cudaErrorInvalidValue for a geometry out of its bounds.
extern "C" int imc_mac_plan(int M, int N, int K, int sk_gmax, int sk_target,
                            int tc_cluster, int tc_target, int* out) {
  const Geometry g{sk_gmax, sk_target, tc_cluster, tc_target};
  if (!geometry_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(M, N, K, g);
  const int v[6] = {p.rows, p.gx, p.gy, p.gz, p.splits, p.kps};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// a: int8[M,K], b: int8[K,N] row-major; c: int32[M,N]; the plan's geometry
// as imc_mac_plan takes it.  Returns a cudaError_t value.
extern "C" int imc_mac_launch(const void* a, const void* b, void* c, int M,
                              int N, int K, int sk_gmax, int sk_target,
                              int tc_cluster, int tc_target, void* stream,
                              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g{sk_gmax, sk_target, tc_cluster, tc_target};
  if (!geometry_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(M, N, K, g);
  auto* c32 = static_cast<int32_t*>(c);
  if (p.rows == 0) {
    return launch_mma<false>(p, a, b, c32, nullptr, nullptr, nullptr, M, N, K,
                             s);
  }
  if (p.splits > 1) {
    err = cudaMemsetAsync(c, 0, sizeof(int32_t) * M * N, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_split<false>(p, a, b, c32, nullptr, nullptr, nullptr, nullptr,
                             M, N, K, s);
}

// As imc_mac_launch, plus scale_a: float32[1] and scale_w: float32[N] in
// device memory; c: float32[M,N].  scratch: int32, at least M*N + plan
// grid x values when a split-K plan (M <= 16) splits K (zeroed here), else
// unused: sized by the plan of the same geometry.
extern "C" int imc_mac_dequant_launch(const void* a, const void* b,
                                      const void* scale_a, const void* scale_w,
                                      void* c, void* scratch,
                                      long long scratch_ints, int M, int N,
                                      int K, int sk_gmax, int sk_target,
                                      int tc_cluster, int tc_target,
                                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g{sk_gmax, sk_target, tc_cluster, tc_target};
  if (!geometry_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(M, N, K, g);
  const auto* sa = static_cast<const float*>(scale_a);
  const auto* sw = static_cast<const float*>(scale_w);
  auto* out = static_cast<float*>(c);
  if (p.rows == 0) {
    return launch_mma<true>(p, a, b, nullptr, out, sa, sw, M, N, K, s);
  }
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
