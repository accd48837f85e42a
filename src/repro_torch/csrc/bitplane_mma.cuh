// Shared by bitplane_mac.cu's bitplane_mac_mma_kernel and
// bitplane_mac_noisy.cu's bitplane_mac_noisy_mma_kernel: the served case
// (rows 8, 8 x 8 bits) above a row threshold, its 8-row group counts on the
// int8 tensor cores.  The tile geometry and its plan, the 16-byte cp.async
// staging, the byte ANDs of the groups that can count 8, the fragments of
// mma.sync.m16n8k32 / m16n8k16 with .u8 operands and the byte permute.
//
// The counts: slot k of a k-step (32 K-rows) holds K-row 32 s + k, of
// group j = k / 8; A's bytes weigh alpha_j and B's beta_j with
// alpha_j beta_j = 16^j (a0/a1, k = 4t..: alpha 16^(t/2), beta 1; a2/a3:
// alpha 4 x 16^(t/2), beta 64), so the s32 output of one mma holds the four
// groups' counts (0..8) in its four low nibbles.
#pragma once

#include "bitplane_common.cuh"

namespace bitplane {

constexpr int R8_ROWS = 8;
constexpr int R8_PLANES = 8;      // bits_a == bits_w == 8

constexpr int MM_WARPS = 4;       // a 2 x 2 grid of 32 x 32 warp tiles
constexpr int MM_THREADS = 32 * MM_WARPS;
constexpr int MM_BM = 64;         // output rows a block keeps
constexpr int MM_BN = 64;         // output columns
constexpr int MM_STEP = 32;       // K-rows of one k-step: one m16n8k32, 4 groups
constexpr int MM_KC = 128;        // K-rows staged per chunk: 4 k-steps
constexpr int MM_GC = MM_KC / R8_ROWS;  // groups per chunk (16)
constexpr int MM_AS = MM_KC + 16; // A's row stride in bytes: 36 words, 4 mod 32
constexpr int MM_WS = MM_BN + 16; // W's row stride in bytes
constexpr int MM_TARGET = 528;    // blocks a launch aims at: four per SM
static_assert(MM_BM * MM_KC / 16 % MM_THREADS == 0 &&
              MM_KC * MM_BN / 16 % MM_THREADS == 0, "whole staging rounds");

// prmt.b32 in its default mode: byte n of the result is byte (sel >> 4n) & 7
// of {hi, lo}, or, when bit 3 of that nibble is set, that byte's top bit
// replicated over all 8 bits.
__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

struct SmemMma {
  uint8_t a[2][MM_BM][MM_AS];         // A's bytes, k contiguous, 18 KB
  uint8_t w[2][MM_KC][MM_WS];         // W's bytes, n contiguous, 20 KB
  uint32_t fa[MM_BM][MM_GC / 4];      // per row: the AND of each group's
  uint32_t fw[MM_BN][MM_GC / 4];      // 8 bytes, 4 groups a word; per column
};

struct MmaPlan {
  dim3 grid;        // (column tiles, row tiles, K splits)
  int per_split;    // k-steps (32 K-rows) per split
  bool accumulate;  // atomicAdd into a zeroed output
  int steps;        // ceil(ceil(K / 8) / 4)
};

// 64 x 64 output tiles; the k-steps split across blocks until the grid has
// about `target` blocks (MM_TARGET: --bitplane-variants: 264 gave 18.9 ms
// at M = 512 and 3.2 at bucket 64, 792 15.8 and 3.0 against 528's 16.8 and
// 2.8).  Shapes only: the autotuner's `target` is the other kernels'.
inline MmaPlan mma_plan(int M, int N, int K, int target = MM_TARGET) {
  MmaPlan p;
  p.steps = ((K + R8_ROWS - 1) / R8_ROWS + 3) / 4;
  const int tiles_n = (N + MM_BN - 1) / MM_BN;
  const int tiles_m = (M + MM_BM - 1) / MM_BM;
  const long long tiles = static_cast<long long>(tiles_n) * tiles_m;
  long long splits = (target + tiles - 1) / tiles;
  splits = splits > p.steps ? p.steps : splits;
  splits = splits < 1 ? 1 : splits;
  const int per = static_cast<int>((p.steps + splits - 1) / splits);
  p.per_split = per < 1 ? 1 : per;
  const int z = p.steps == 0 ? 1 : (p.steps + p.per_split - 1) / p.per_split;
  p.accumulate = z > 1 || p.steps == 0;
  p.grid = dim3(tiles_n, tiles_m, z);
  return p;
}

// Whether the staging may take 16-byte cp.async: K and N multiples of 16,
// both operands 16-byte aligned.
inline bool mma_vec(const void* a, const void* w, int N, int K) {
  return K % 16 == 0 && N % 16 == 0 &&
         (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(w) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// d = a (16x32, row) x b (32x8, col) + c, unsigned bytes in, s32 out
// (fragments: g = lane / 4, t = lane % 4; a0 row g, k 4t..4t+3; a1 row
// g + 8; a2, a3 the same rows at k 16 + 4t..; b0 column g, k 4t..4t+3; b1
// k 16 + 4t..; d0, d1 row g, columns 2t, 2t + 1; d2, d3 row g + 8).
__device__ __forceinline__ void mma_u8_k32(uint32_t (&d)[4],
                                           const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1, uint32_t c) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c));
}

// The same at k = 16 (a0 row g, a1 row g + 8, k 4t..4t+3; b0 k 4t..4t+3).
__device__ __forceinline__ void mma_u8_k16(uint32_t (&d)[4], uint32_t a0,
                                           uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(0));
}

// Stage K-rows [kc, kc + MM_KC) of the tile at (m0, n0) into buffer `buf`:
// 16-byte cp.async when `vec` (mma_vec), else byte loads; zeros past M, N
// and k_end (the end of this block's split).  Commits one cp.async group
// either way.
__device__ __forceinline__ void mma_stage(SmemMma& s, int buf,
                                          const uint8_t* __restrict__ a,
                                          const uint8_t* __restrict__ w,
                                          int M, int N, int K, int m0, int n0,
                                          int kc, int k_end, bool vec) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < MM_BM * MM_KC / 16 / MM_THREADS; ++j) {
    const int u = tid + j * MM_THREADS;
    const int r = u / (MM_KC / 16);
    const int k = kc + 16 * (u % (MM_KC / 16));
    uint8_t* dst = &s.a[buf][r][k - kc];
    const uint8_t* row = a + static_cast<size_t>(m0 + r) * K;
    if (vec) {
      const bool ok = m0 + r < M && k < k_end;
      cp_async16(dst, ok ? row + k : a, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (m0 + r < M)
        for (int i = 0; i < 16 && k + i < k_end; ++i)
          v[i >> 2] |= static_cast<uint32_t>(row[k + i]) << (8 * (i & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < MM_KC * MM_BN / 16 / MM_THREADS; ++j) {
    const int u = tid + j * MM_THREADS;
    const int r = u / (MM_BN / 16);
    const int c = 16 * (u % (MM_BN / 16));
    uint8_t* dst = &s.w[buf][r][c];
    const uint8_t* src = w + static_cast<size_t>(kc + r) * N + n0 + c;
    if (vec) {
      const bool ok = kc + r < k_end && n0 + c < N;
      cp_async16(dst, ok ? src : w, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (kc + r < k_end)
        for (int i = 0; i < 16 && n0 + c + i < N; ++i)
          v[i >> 2] |= static_cast<uint32_t>(src[i]) << (8 * (i & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The AND of every group's 8 bytes: bit p (q) is set where plane p (q) is
// one in all 8 rows, i.e. where the group's count can reach 8.  fa[r][j/4]
// byte j % 4: row r, group j of the chunk; fw[c][j/4]: column c.
__device__ __forceinline__ void mma_full_groups(SmemMma& s, int buf) {
  const int tid = threadIdx.x;
  for (int u = tid; u < MM_BM * MM_GC / 4; u += MM_THREADS) {
    const int r = u / (MM_GC / 4);
    const int jq = u % (MM_GC / 4);
    const uint32_t* x = reinterpret_cast<const uint32_t*>(
        &s.a[buf][r][32 * jq]);
    uint32_t f = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t y = x[2 * j] & x[2 * j + 1];
      y &= y >> 16;
      y &= y >> 8;
      f |= (y & 0xffu) << (8 * j);
    }
    s.fa[r][jq] = f;
  }
  uint8_t* fw = reinterpret_cast<uint8_t*>(&s.fw[0][0]);
  for (int u = tid; u < MM_GC * MM_BN / 4; u += MM_THREADS) {
    const int j = u / (MM_BN / 4);
    const int cw = u % (MM_BN / 4);
    uint32_t y = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < R8_ROWS; ++i)
      y &= *reinterpret_cast<const uint32_t*>(&s.w[buf][8 * j + i][4 * cw]);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      fw[(4 * cw + b) * MM_GC + j] = static_cast<uint8_t>(y >> (8 * b));
  }
}

// The A fragments of one k-step (K-rows kb.. of the chunk) for the warp's
// rows wr..wr+31: ra[mi][0..3] = a0..a3 of rows wr + 16 mi + g (+ 8), raw
// bytes (all 8 planes).
__device__ __forceinline__ void mma_a_frags(const SmemMma& s, int buf, int wr,
                                            int g, int t, int kb,
                                            uint32_t (&ra)[2][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = wr + 16 * mi + g;
    ra[mi][0] = *reinterpret_cast<const uint32_t*>(&s.a[buf][r][kb + 4 * t]);
    ra[mi][1] = *reinterpret_cast<const uint32_t*>(
        &s.a[buf][r + 8][kb + 4 * t]);
    ra[mi][2] = *reinterpret_cast<const uint32_t*>(
        &s.a[buf][r][kb + 16 + 4 * t]);
    ra[mi][3] = *reinterpret_cast<const uint32_t*>(
        &s.a[buf][r + 8][kb + 16 + 4 * t]);
  }
}

// The B fragments' raw bytes of one k-step for column wc + 8 ni + g: W's 4
// K-rows at k = 4t.. (rb[ni][0]) and 16 + 4t.. (rb[ni][1]), one byte each.
__device__ __forceinline__ void mma_w_frags(const SmemMma& s, int buf, int wc,
                                            int g, int t, int kb,
                                            uint32_t (&rb)[4][2]) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = wc + 8 * ni + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kb + 16 * h + 4 * t;
      const uint32_t x01 = prmt(s.w[buf][k][col], s.w[buf][k + 1][col],
                                0x0040u);
      const uint32_t x23 = prmt(s.w[buf][k + 2][col], s.w[buf][k + 3][col],
                                0x0040u);
      rb[ni][h] = prmt(x01, x23, 0x5410u);
    }
  }
}

// Nibbles of 8 for the groups past ceil(K/8) of a k-step whose first
// `real` groups exist (the mma's accumulator input): they decode as a
// count of 8 does.
__device__ __forceinline__ uint32_t mma_pad(int real) {
  return real >= 4 ? 0u : 0x8888u & (0xffffu << (4 * real));
}

}  // namespace bitplane
