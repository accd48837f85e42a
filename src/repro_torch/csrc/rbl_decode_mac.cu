// rbl_decode_mac: the grouped binary MAC with the analog RBL decode inside
// the loop, for ONE bit-plane pair:
//
//   out[m,n] = sum over the real ceil(K/rows) groups g of dec[count(m,g,n)]
//
// where count(m,g,n) is the number of K-rows r of group g with bit 0 of
// a[m,r] and bit 0 of w[r,n] both set, and dec[k] = #{i : thr[i] >= V(k)} is
// the comparator-bank decode of the two-regime physics RBL voltage V(k)
// against the live thresholds `thr`.
//
// Replaces the TPU kernel rbl_decode_mac_raw (_make_kernel) in
// src/repro/kernels/rbl_decode/rbl_decode.py: the threshold re-tuning and
// reduced-margin studies of the paper (§III-F, §IV-C) at kernel speed.
//
// What bounds it on an H100: one byte per operand value.  At its users'
// shapes the bytes are few: one decode step's 72 projections at M = 4 move
// ~85 MB (~25 us at 3.35 TB/s; 0.18-0.70 us a launch), the threshold
// sweep's 64x768x3072 projection 3.2 MB a call (~0.95 us).  At M = 4 a
// launch is one round trip for its loads plus a chain of dependent steps
// (barriers, the cluster's meeting); at M = 64 the counting (~18.9 M group
// counts a call) on the integer pipes takes longer than the bytes.
//
// The design (the plan is rbl_decode_mac_plan below; its twin is
// ops.rbl_decode_mac_plan):
//   * no bit planes, and everything a block needs in flight at once: each
//     chunk of the block's K-groups is staged in shared memory, W's bytes by
//     8-byte cp.async copies with lanes on neighbouring columns (4-byte
//     copies, or byte loads, when N or the pointer is not aligned for them;
//     zeros past N and K), A's bit 0 of each byte as int32 0/1, [k][tile
//     row], so one 16-byte broadcast read gives four rows' bits, then one
//     barrier.  Whatever W's bytes hold above bit 0 is masked off with
//     0x01010101 as each 32-bit word is read;
//   * four outputs per word: count words c[m][word] += wmask * a_bit (one
//     IMAD) over the group's rows; a count is at most rows <= 32, so it never
//     carries out of its byte.  Any rows 2-32 and any K: a group is whatever
//     rows it has, a zero-padded partial last group is real and decoded, no
//     group past ceil(K/rows) is visited;
//   * the decode from registers, four counts at once: c | (c >> 12) leaves
//     the four counts as prmt selector nibbles (in byte order 0, 2, 1, 3).
//     rows <= 8: dec[0..7] in two words, count 8 through the selector's sign
//     bit and a second prmt of 0x80 (as bitplane_mac.cu's served case).
//     rows 9-32: five 8-entry banks looked up by the counts' low 3 bits,
//     then a tree of three prmt picks each byte's bank by the counts' bits
//     3-5.  Each block builds the table from the live `thr` and the voltages
//     V(0..rows), which the wrapper computes once per rows with the plain
//     version's function, from loads issued beside the staging's; nothing
//     is assumed of the table's shape;
//   * byte accumulation: the four decoded bytes (each <= rows) add into one
//     word for up to floor(255/rows) groups, then widen into int32 (the
//     byte order undone), so the int32 result is the exact sum;
//   * the whole card busy: 4 warps a block; M <= 4 keeps 4 rows a thread and
//     M 5-8 keeps 8, the warps and 1-4 lane groups of a warp splitting K
//     (8-32 lanes on 64-256 columns); above 8 rows the 4 warps take 8 rows
//     each of a 32-row tile and 256 columns, sharing the staged W.  K is
//     split over a thread-block cluster of 1-8 blocks (gridDim.y), ~96-264
//     blocks a launch (the plan's Geometry: at most `cluster` splits and
//     `target` blocks, 8 and 264 by default; kernels/autotune may pick
//     others, all of which give the same sums);
//   * the splits meet without a memset or output atomics: each block sums
//     its K-partitions (shuffles inside a warp, then integer atomicAdd in
//     its own shared memory, exact in any order), the cluster meets at
//     cluster.sync(), and each rank sums its share of the tile over every
//     rank's partial through distributed shared memory, starting at its own
//     rank, and stores it once.  A second cluster.sync() keeps the partials
//     alive until the cluster has read them.  Nothing for a graph replay to
//     reset.
//
// Padded groups: the reference pads K to its tile (256) and decodes every
// padded group too, which under a detuned `thr` with dec[0] != 0 adds dec[0]
// per padded group; this kernel, as the plain version, does not.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 32;       // a count fits its byte; 5 banks of 8
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 8;            // columns per lane: 8 bytes of a W row
constexpr int CW = COLS / 4;       // their 32-bit words
constexpr int MAX_SPLITS = 8;      // the portable cluster size
constexpr int TARGET = 264;        // blocks a launch aims at, at most
constexpr int WAVE = 132;          // SMs of an H100
constexpr int SM_BYTES = 45056;    // a chunk's A bits and W bytes, then the
                                   // partial tile (at most 36,864 bytes)
constexpr int TABLE_WORDS = 10;    // dec[0..39] as bytes: five banks of 8
constexpr int STAGE_UNROLL = 8;    // A words a thread has in flight at once
constexpr uint32_t BIT0 = 0x01010101u;

struct Plan {
  int rm;          // output rows a thread keeps (4 or 8)
  int wm;          // warps along M (1 or 4); the other warps split K
  int ln;          // lanes along N (8, 16 or 32); the others split K
  int gx, gy, gz;  // grid: column tiles, K splits (the cluster), row tiles
  int gps;         // K-groups per split
  int cg;          // K-groups per staging of A and W
};

// A plan's tunable choices, runtime arguments of the entry points: the
// splits (the cluster) at most, within the portable size MAX_SPLITS that
// sizes the reduction's registers, and the blocks a launch aims at.
constexpr int MAX_TARGET = 1 << 20;
struct Geometry {
  int cluster = MAX_SPLITS;
  int target = TARGET;
};

bool geometry_ok(const Geometry& g) {
  return g.cluster >= 1 && g.cluster <= MAX_SPLITS &&
         (g.cluster & (g.cluster - 1)) == 0 && g.target >= 1 &&
         g.target <= MAX_TARGET;
}

Plan make_plan(int M, int N, int K, int rows,
               const Geometry& geo = Geometry()) {
  Plan p;
  const long long groups = K > 0 ? (static_cast<long long>(K) + rows - 1) / rows
                                  : 0;
  p.rm = M <= 4 ? 4 : 8;
  p.wm = M <= 8 ? 1 : 4;
  const int bm = p.rm * p.wm;
  p.gz = (M + bm - 1) / bm;
  // the widest tile (256 columns) unless narrower ones are needed for a
  // wave of blocks at the most splits
  p.ln = 32;
  while (p.wm == 1 && p.ln > 8 &&
         static_cast<long long>((N + COLS * p.ln - 1) / (COLS * p.ln)) * p.gz *
                 geo.cluster < WAVE) {
    p.ln /= 2;
  }
  p.gx = (N + COLS * p.ln - 1) / (COLS * p.ln);
  const long long tiles = static_cast<long long>(p.gx) * p.gz;
  int splits = 1;
  while (splits < geo.cluster && tiles * splits * 2 <= geo.target &&
         groups >= 2 * splits) {
    splits *= 2;
  }
  p.gy = splits;
  p.gps = static_cast<int>((groups + splits - 1) / splits);
  p.cg = (SM_BYTES - 16) / (rows * (4 * bm + COLS * p.ln));
  return p;
}

// prmt.b32 in its default mode: byte n of the result is byte (sel >> 4n) & 7
// of {hi, lo}, or, when bit 3 of that nibble is set, that byte's top bit
// replicated over all 8 bits.
__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

// Four byte counts, each <= 8, to their decoded bytes in byte order
// (0, 2, 1, 3); d8 is dec[8] in every byte.
__device__ __forceinline__ uint32_t decode8(uint32_t c, uint32_t lo,
                                            uint32_t hi, uint32_t d8) {
  const uint32_t sel = c | (c >> 12);
  return prmt(lo, hi, sel) | (prmt(0x80u, 0u, sel) & d8);
}

// Four byte counts, each <= 32, to their decoded bytes in byte order
// (0, 2, 1, 3): banks of 8 entries by the low 3 bits, then a prmt tree by
// bits 3, 4 and 5 (selector nibble n = n + 4 * bit: byte n of either input).
__device__ __forceinline__ uint32_t decode32(uint32_t c,
                                             const uint32_t (&t)[TABLE_WORDS]) {
  const uint32_t lo = c & 0x07070707u;
  const uint32_t hi = (c >> 3) & 0x07070707u;
  const uint32_t sl = lo | (lo >> 12);
  const uint32_t sh = hi | (hi >> 12);
  const uint32_t s1 = 0x3210u | ((sh & 0x1111u) << 2);
  const uint32_t s2 = 0x3210u | ((sh & 0x2222u) << 1);
  const uint32_t s3 = 0x3210u | (sh & 0x4444u);
  const uint32_t b01 = prmt(prmt(t[0], t[1], sl), prmt(t[2], t[3], sl), s1);
  const uint32_t b23 = prmt(prmt(t[4], t[5], sl), prmt(t[6], t[7], sl), s1);
  return prmt(prmt(b01, b23, s2), prmt(t[8], t[9], sl), s3);
}

// Four consecutive bytes row[col..col+3] packed little-endian, zeros past len.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ row,
                                              int col, int len, bool vec) {
  if (vec && col + 3 < len) {
    return *reinterpret_cast<const uint32_t*>(row + col);
  }
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (col + i < len) w |= static_cast<uint32_t>(row[col + i]) << (8 * i);
  }
  return w;
}

// BYTES (4 or 8) global -> shared without registers, zero-filled when
// `valid` is false.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
}

// Byte accumulators (byte order 0, 2, 1, 3) into the int32 sums.
template <int RM>
__device__ __forceinline__ void widen(int (&acc)[RM][COLS],
                                      uint32_t (&bacc)[RM][CW]) {
#pragma unroll
  for (int m = 0; m < RM; ++m) {
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const uint32_t b = bacc[m][c];
      acc[m][4 * c + 0] += static_cast<int>(b & 0xffu);
      acc[m][4 * c + 1] += static_cast<int>((b >> 16) & 0xffu);
      acc[m][4 * c + 2] += static_cast<int>((b >> 8) & 0xffu);
      acc[m][4 * c + 3] += static_cast<int>(b >> 24);
      bacc[m][c] = 0u;
    }
  }
}

template <int RM, int R>
struct Counter {
  int acc[RM][COLS];
  uint32_t bacc[RM][CW];
  uint32_t cnt[RM][CW];
  uint32_t t[TABLE_WORDS];
  uint32_t d8;
  int pend;    // groups in the byte accumulators
  int span;    // groups they take: floor(255 / rows)
  bool wide;   // rows > 8

  // one W row (a lane's two words) against four-row slices of A's bits
  __device__ __forceinline__ void count(uint2 v, const int* __restrict__ ar) {
    const uint32_t w0 = v.x & BIT0;
    const uint32_t w1 = v.y & BIT0;
#pragma unroll
    for (int q = 0; q < RM; q += 4) {
      const int4 a4 = *reinterpret_cast<const int4*>(ar + q);
      const uint32_t av[4] = {static_cast<uint32_t>(a4.x),
                              static_cast<uint32_t>(a4.y),
                              static_cast<uint32_t>(a4.z),
                              static_cast<uint32_t>(a4.w)};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        cnt[q + x][0] += w0 * av[x];
        cnt[q + x][1] += w1 * av[x];
      }
    }
  }

  // one group: its rows' counts from the staged chunk (ws: the lane's W
  // bytes of the group's first row, bn bytes a row; as: A's bits of that
  // row, bm ints a row, this thread's rows first), decoded into the byte
  // accumulators, which widen first if they could overflow
  __device__ __forceinline__ void group(const uint8_t* ws, int bn,
                                        const int* as, int bm, int rows) {
#pragma unroll
    for (int m = 0; m < RM; ++m)
#pragma unroll
      for (int c = 0; c < CW; ++c) cnt[m][c] = 0u;
    if (R) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        count(*reinterpret_cast<const uint2*>(ws + r * bn), as + r * bm);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        count(*reinterpret_cast<const uint2*>(ws + r * bn), as + r * bm);
      }
    }
    if (pend == span) {
      widen<RM>(acc, bacc);
      pend = 0;
    }
    ++pend;
#pragma unroll
    for (int m = 0; m < RM; ++m) {
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        bacc[m][c] += (R == 0 && wide) ? decode32(cnt[m][c], t)
                                       : decode8(cnt[m][c], t[0], t[1], d8);
      }
    }
  }
};

// grid (column tiles, splits, row tiles), clusters of (1, splits, 1).  a:
// uint8[M,K], w: uint8[K,N], thr: float32[rows], volt: float32[rows + 1],
// V(k) of each count k, out: int32[M,N].  a_vec: A
// rows may be read as 4-byte words; WIDTH: W's copy width (8, 4 or 1 bytes,
// the widest that N and the pointer allow); vec_out: 16-byte stores.  R = 8,
// or 0 for rows given at run time.
template <int RM, int R, int WIDTH>
__global__ void __launch_bounds__(THREADS)
rbl_decode_mac_kernel(const uint8_t* __restrict__ a,
                      const uint8_t* __restrict__ w,
                      const float* __restrict__ thr,
                      const float* __restrict__ volt,
                      int32_t* __restrict__ out, int M, int N, int K,
                      int rows_arg, int wm_n, int ln, int gps,
                      int chunk_groups, int a_vec, int vec_out) {
  __shared__ __align__(16) uint8_t sm[SM_BYTES];
  __shared__ uint32_t table[TABLE_WORDS];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();

  const int rows = R ? R : rows_arg;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bm = RM * wm_n;                    // rows of the block's tile
  const int bn = COLS * ln;                    // its columns
  // ln, wm_n and so bm, bn and parts are powers of two: shifts and masks
  const int lg_ln = __ffs(ln) - 1;
  const int lg_bm = __ffs(bm) - 1;
  const int kpw = 32 >> lg_ln;                 // K-partitions in a warp
  const int parts = (WARPS / wm_n) * kpw;      // in the block
  const int part = (warp / wm_n) * kpw + (lane >> lg_ln);
  const int mo = (warp % wm_n) * RM;           // the thread's first tile row
  const int n0 = blockIdx.x * bn;
  const int m0 = blockIdx.z * bm;
  const int groups = K > 0 ? (K + rows - 1) / rows : 0;
  const int g_begin = min(groups, static_cast<int>(blockIdx.y) * gps);
  const int g_end = min(groups, g_begin + gps);

  Counter<RM, R> ctr;
#pragma unroll
  for (int m = 0; m < RM; ++m) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) ctr.acc[m][j] = 0;
#pragma unroll
    for (int c = 0; c < CW; ++c) ctr.bacc[m][c] = 0u;
  }
  ctr.pend = 0;
  ctr.span = 255 / rows;
  ctr.wide = rows > 8;

  for (int c0 = g_begin; c0 < g_end; c0 += chunk_groups) {
    const int c1 = min(g_end, c0 + chunk_groups);
    const int k_lo = c0 * rows;
    const int kc = (c1 - c0) * rows;  // staged K-rows (zeros past K)
    int* as = reinterpret_cast<int*>(sm);                 // [kc][bm]
    uint8_t* ws = sm + ((4 * bm * kc + 15) & ~15);        // [kc][bn]

    // 1. the chunk's W tile into shared memory, every copy in flight at once
    // (8 bytes a unit, lanes on neighbouring columns; zeros past N and K)
    for (int u = tid; u < kc * ln; u += THREADS) {
      const int r = u >> lg_ln;
      const int c = COLS * (u & (ln - 1));
      const int k = k_lo + r;
      const uint8_t* src = w + static_cast<size_t>(k) * N + n0 + c;
      uint8_t* dst = ws + r * bn + c;
      if (WIDTH == 8) {
        cp_async<8>(dst, k < K && n0 + c < N ? src : w,
                    k < K && n0 + c < N);
      } else if (WIDTH == 4) {
        cp_async<4>(dst, k < K && n0 + c < N ? src : w,
                    k < K && n0 + c < N);
        cp_async<4>(dst + 4, k < K && n0 + c + 4 < N ? src + 4 : w,
                    k < K && n0 + c + 4 < N);
      } else {
#pragma unroll
        for (int e = 0; e < COLS; ++e) {
          dst[e] = k < K && n0 + c + e < N ? src[e] : 0;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);

    // 2. A's bits of the chunk as int32 0/1, [k][tile row] (rows past M and
    // K-rows past K as zeros): STAGE_UNROLL word loads in flight a thread
    const bool vec = a_vec && k_lo % 4 == 0;
    const int units = bm * ((kc + 3) / 4);
    for (int u0 = 0; u0 < units; u0 += STAGE_UNROLL * THREADS) {
      uint32_t v[STAGE_UNROLL];
#pragma unroll
      for (int e = 0; e < STAGE_UNROLL; ++e) {
        const int u = u0 + e * THREADS + tid;
        const int m = u & (bm - 1);
        v[e] = u < units && m0 + m < M
                   ? load_word(a + static_cast<size_t>(m0 + m) * K,
                               k_lo + 4 * (u >> lg_bm), K, vec) & BIT0
                   : 0u;
      }
      if (c0 == g_begin && u0 == 0 && tid < 4 * TABLE_WORDS) {
        // 3. the decode table, dec[k] = #{i : thr[i] >= V(k)} (zero past
        // rows), from loads in flight with the others
        uint32_t d = 0;
        if (tid <= rows) {
          const float vk = volt[tid];
          float th[MAX_ROWS];
#pragma unroll
          for (int i = 0; i < MAX_ROWS; ++i) th[i] = i < rows ? thr[i] : 0.f;
#pragma unroll
          for (int i = 0; i < MAX_ROWS; ++i) {
            d += (i < rows && vk <= th[i]) ? 1u : 0u;
          }
        }
        reinterpret_cast<uint8_t*>(table)[tid] = static_cast<uint8_t>(d);
      }
#pragma unroll
      for (int e = 0; e < STAGE_UNROLL; ++e) {
        const int u = u0 + e * THREADS + tid;
        const int m = u & (bm - 1);
        const int k4 = 4 * (u >> lg_bm);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (u < units && k4 + f < kc) {
            as[(k4 + f) * bm + m] = static_cast<int>((v[e] >> (8 * f)) & 1u);
          }
        }
      }
    }

    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    if (c0 == g_begin) {
#pragma unroll
      for (int i = 0; i < TABLE_WORDS; ++i) ctr.t[i] = table[i];
      ctr.d8 = (ctr.t[2] & 0xffu) * BIT0;
    }

    // 4. count and decode the thread's groups of the chunk: part, part +
    // parts, ...
    const uint8_t* wl = ws + COLS * (lane & (ln - 1));
#pragma unroll 2
    for (int g = part; g < c1 - c0; g += parts) {
      ctr.group(wl + g * rows * bn, bn, as + g * rows * bm + mo, bm, rows);
    }
    __syncthreads();  // the chunk is consumed
  }
  widen<RM>(ctr.acc, ctr.bacc);

  // 5. the block's partial tile: the K-partitions of a warp summed by
  // shuffles, the warps' sums met in shared memory (integer atomicAdd,
  // exact in any order), columns skewed by 4 ints per 32
  for (int off = ln; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < RM; ++m) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        ctr.acc[m][j] += __shfl_xor_sync(0xffffffffu, ctr.acc[m][j], off);
      }
    }
  }
  const int stride = bn + bn / 8;
  int* red = reinterpret_cast<int*>(sm);
  if (parts > kpw) {
    for (int i = tid; i < bm * stride; i += THREADS) red[i] = 0;
    __syncthreads();
  }
  if (lane < ln) {
#pragma unroll
    for (int m = 0; m < RM; ++m) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = COLS * lane + j;
        int* p = &red[(mo + m) * stride + c + 4 * (c >> 5)];
        if (parts > kpw) {
          atomicAdd(p, ctr.acc[m][j]);
        } else {
          *p = ctr.acc[m][j];
        }
      }
    }
  }
  cluster.sync();

  // 6. each rank sums its share of the tile over the cluster, then stores
  const int splits = gridDim.y;
  const int rank = static_cast<int>(cluster.block_rank());
  const int live = min(bm, M - m0);
  const int quads = 2 * ln;                    // bn / 4 a row
  for (int i = rank * THREADS + tid; i < live * quads;
       i += splits * THREADS) {
    const int r = i >> (lg_ln + 1);
    const int c4 = 4 * (i & (quads - 1));
    int* src = &red[r * stride + c4 + 4 * (c4 >> 5)];
    int4 v[MAX_SPLITS];  // every rank's partial in flight at once
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      if (j < splits) {
        const int from = rank + j < splits ? rank + j : rank + j - splits;
        v[j] = *cluster.map_shared_rank(reinterpret_cast<int4*>(src), from);
      }
    }
    int4 sum = v[0];
#pragma unroll
    for (int j = 1; j < MAX_SPLITS; ++j) {
      if (j < splits) {
        sum.x += v[j].x;
        sum.y += v[j].y;
        sum.z += v[j].z;
        sum.w += v[j].w;
      }
    }
    const int n = n0 + c4;
    if (n >= N) continue;
    const size_t o = static_cast<size_t>(m0 + r) * N + n;
    if (vec_out) {
      *reinterpret_cast<int4*>(out + o) = sum;
    } else {
      const int sv[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n + e < N) out[o + e] = sv[e];
      }
    }
  }
  cluster.sync();  // every partial stays alive until the cluster has read it
}

template <int RM, int R>
cudaError_t launch(const Plan& p, cudaLaunchConfig_t* cfg, const void* a,
                   const void* w, const void* thr, const void* volt, void* out,
                   int M, int N, int K, int rows, int a_vec, int width,
                   int vec_out) {
  const auto* a8 = static_cast<const uint8_t*>(a);
  const auto* w8 = static_cast<const uint8_t*>(w);
  const auto* t = static_cast<const float*>(thr);
  const auto* v = static_cast<const float*>(volt);
  auto* o = static_cast<int32_t*>(out);
  auto* kernel = width == 8   ? rbl_decode_mac_kernel<RM, R, 8>
                 : width == 4 ? rbl_decode_mac_kernel<RM, R, 4>
                              : rbl_decode_mac_kernel<RM, R, 1>;
  return cudaLaunchKernelEx(cfg, kernel, a8, w8, t, v, o, M, N, K, rows, p.wm,
                            p.ln, p.gps, p.cg, a_vec, vec_out);
}

}  // namespace

// The launch plan for an M x K x N product of `rows`-row groups: out[0] the
// rows a thread keeps, out[1] the warps along M, out[2] the lanes along N,
// out[3..5] the grid (x: column tiles, y: K splits = the cluster size, z:
// row tiles), out[6] the K-groups per split, out[7] the K-groups per staging
// of A and W, under the geometry (cluster, target).  Returns 0, or
// cudaErrorInvalidValue for rows outside 2-32 or a geometry out of bounds.
extern "C" int rbl_decode_mac_plan(int M, int N, int K, int rows, int cluster,
                                   int target, int* out) {
  const Geometry g{cluster, target};
  if (rows < 2 || rows > MAX_ROWS || !geometry_ok(g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(M, N, K, rows, g);
  const int v[8] = {p.rm, p.wm, p.ln, p.gx, p.gy, p.gz, p.gps, p.cg};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// a: bytes [M,K] row-major, w: bytes [K,N] row-major (bit 0 of each byte is
// the operand bit), thr: float32[rows], volt: float32[rows + 1], the physics
// RBL voltage V(k) of each count k, out: int32[M,N]; the plan's geometry as
// rbl_decode_mac_plan takes it.  Returns a cudaError_t value.
extern "C" int rbl_decode_mac_launch(const void* a, const void* w,
                                     const void* thr, const void* volt,
                                     void* out, int M, int N, int K, int rows,
                                     int cluster, int target, void* stream,
                                     int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g{cluster, target};
  if (rows < 2 || rows > MAX_ROWS || M < 0 || N < 0 || K < 0 ||
      !geometry_ok(g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return 0;
  const Plan p = make_plan(M, N, K, rows, g);
  if (p.gz > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute dims;
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = 1;
  dims.val.clusterDim.y = p.gy;
  dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.gx, p.gy, p.gz);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pw = reinterpret_cast<uintptr_t>(w);
  const uintptr_t po = reinterpret_cast<uintptr_t>(out);
  const int a_vec = K % 4 == 0 && pa % 4 == 0;
  const int width = N % 8 == 0 && pw % 8 == 0 ? 8
                    : N % 4 == 0 && pw % 4 == 0 ? 4 : 1;
  const int vec_out = N % 4 == 0 && po % 16 == 0;
  if (p.rm == 4) {
    err = rows == 8 ? launch<4, 8>(p, &cfg, a, w, thr, volt, out, M, N, K,
                                   rows, a_vec, width, vec_out)
                    : launch<4, 0>(p, &cfg, a, w, thr, volt, out, M, N, K,
                                   rows, a_vec, width, vec_out);
  } else {
    err = rows == 8 ? launch<8, 8>(p, &cfg, a, w, thr, volt, out, M, N, K,
                                   rows, a_vec, width, vec_out)
                    : launch<8, 0>(p, &cfg, a, w, thr, volt, out, M, N, K,
                                   rows, a_vec, width, vec_out);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
