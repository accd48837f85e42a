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
// MAC operations at the int8 tensor-core rate they take about as long.
// Neither kernel here reaches that: both count on the integer pipes,
// ~2.7 G group counts per decode step.
//
// Three kernels, one launch each; bitplane_mac_launch picks one:
//
// bitplane_mac_r8 -- the paper's served case, 8-row groups and 8 x 8 bits,
//   at M <= R8_MAX_M = 8 (decode; measured below).
//   * Four groups per word.  A group of one plane is 8 bits, so one 32-bit
//     word holds four consecutive K-groups.  Group j's rows 0-3 sit in
//     nibble j (bits 4j..4j+3) and its rows 4-7 in nibble j + 4: the same
//     layout for A and W, so AND and counting do not care, and the two
//     halves of a group's count add into nibble j of the low half-word.
//   * SWAR counts: x = a_p & w_q, then the 2-bit and 4-bit steps of the
//     classic popcount and c = x + (x >> 16) leave group j's count, 0..8,
//     in nibble j: ~10 integer operations for four counts, no __popc.
//   * The decode from registers: dec[0..7] is packed into two words and
//     `prmt` (byte permute) looks up four counts at once, its selector
//     nibbles being the counts.  Count 8 sets a nibble's top bit, which in
//     prmt's default mode replicates the sign of byte 0 (dec[0] <= 8, so
//     0); a second prmt of 0x80 by the same selector gives 0xff exactly
//     there, and ORing in its AND with dec[8] completes the table.  Nothing
//     is assumed of the table's shape: any `thr` decodes as in the plain
//     version.
//   * dp4a accumulation: the four decoded bytes times 2^q (a byte for
//     q <= 7) sum into s with one __dp4a per (p, q, word); per (row, p)
//     s << p goes into the int32 accumulator.  The same integer as
//     sum dec << (p + q), with the same int32 wrap.
//   * Padded bytes: when ceil(K/8) is not a multiple of 4 the last word
//     holds bytes for groups that do not exist.  They stage as zeros and
//     decode to dec[0], which a detuned `thr` makes nonzero, so their dp4a
//     weights are zero.  plan() gives each split a multiple of WARPS = 8
//     groups (two words), so only the word of group ceil(K/8) - 1 is ever
//     partial.  A zero-padded partial last group (K % 8 != 0) is real and
//     is decoded.
//   * Warp w takes plane p = w of A for every word of the stage and all 8
//     planes of W: every warp works whatever the split leaves a block.
//     Every row of the tile is counted, without a branch (rows past M
//     stage as zeros and are not stored), and when M <= 4 (decode) a block
//     keeps 4 row accumulators instead of 8.  The decode table is built
//     while the first stage's gathers are in flight.
//   * Staging: thread (word t, column c) gathers the 32 K-rows of its word
//     as bytes (lanes on neighbouring columns, so each warp load is one
//     32-byte sector, at any N and alignment), turns each group's 8 x 8 bits
//     with a 64-bit transpose and its 8 planes x 4 groups into 8 words with
//     16 byte permutes; A likewise, one (row, word) per thread.
//
// bitplane_mac_mma -- the served case at M > 8 (prefill buckets 16-64,
//   training's M = 512): the group counts on the int8 tensor cores.
//   What bounds it on an H100 at one training forward's 72 projections at
//   M = 512: counted as binary MACs at the int8 tensor-core rate, 2.81 ms;
//   but each of its 3.48e11 group counts goes through the live comparator
//   table on the integer pipes, 20.8 ms at one instruction a count (64 an
//   SM a clock).  The r8 kernel spends ~12 a word of four counts there
//   (58.35 ms, ~2.8 issue slots a count).  This kernel spends two a word:
//   * Counts by mma.sync.m16n8k32 on 0/1 bytes: slot k of a k-step holds
//     K-row 32 s + k, of group j = k / 8, and bytes weigh alpha_j (A) and
//     beta_j (B) with alpha_j beta_j = 16^j (a0/a1, k = 4t..: alpha
//     16^(t/2), beta 1; a2/a3: alpha 4 x 16^(t/2), beta 64), so the s32
//     output of one mma holds the four groups' counts (0..8) in its four
//     low nibbles: 512 counts an mma, no expansion of B.
//   * The decode from registers: that word is the prmt selector over
//     dec[0..7] (two words), four counts at once, and one __dp4a with byte
//     weights 2^q sums them; sum_p 2^p by Horner from p = 7 down (one
//     shift a p).  A count of 8 (nibble 8) replicates dec[0]'s top bit,
//     0; dec[8] times the number of (p, q, group) counts of 8 comes back
//     through a second product, sum_g FA[m,g] FW[g,n], FA and FW the AND
//     of a group's 8 bytes (bit p set where plane p is one in all 8 rows),
//     one m16n8k16 per chunk.  Groups past ceil(K/8) (the last k-step's)
//     get 8 in their nibbles from the mma's accumulator input: they decode
//     to 0, never to dec[0].  Any table, detuned or random, takes the same
//     code.
//   * One tile serves many rows: a 128-thread block keeps a 64 x 64 output
//     tile (four warps of 32 x 32); A's and W's bytes are staged once per
//     chunk of 128 K-rows by 16-byte cp.async, double-buffered (byte loads
//     when K, N or a pointer are not 16-byte aligned), zeros past M, N and
//     the split's end; each lane then reads its fragments' bytes and
//     extracts the 8 W planes once per k-step (held in registers) and each
//     A plane once per p.  Warps whose 32 rows lie past M skip the math.
//   * K splits over blocks (gridDim.z, whole k-steps) until the launch
//     aims at MM_TARGET = 528 blocks, four per SM, from the shapes alone
//     (mma_plan; the autotuner's target is the other kernels'); partial
//     sums meet by integer atomicAdd into the output that the launcher
//     zeroes.  Everything wraps modulo 2^32, as the plain version's int32.
//   Measured (chip_smoke.py --bitplane-variants, one step's 72 launches
//   from a graph, H100 80GB HBM3 at 700 W): M = 512 16.8-17.2 ms against
//   the r8 kernel's 58.3; bucket 64 2.78-2.80 against 7.7-8.0; M = 9 and 16
//   1.95-1.97 against 2.69-2.72 (the r8 kernel keeps 8 rows a block);
//   M = 8 1.94 against 1.81-1.84 and M = 4 1.95-1.97 against 1.24-1.26, so
//   the r8 kernel keeps M <= 8.  Variants at M = 512 whose results are
//   wrong on purpose: without the mma 13.0-13.6 ms, without the prmt
//   15.1-15.3, an add for the dp4a 17.1-17.5: the integer issue slots
//   bind it, ~0.8 a count, and the mma's results wait on their latency.
//
// bitplane_mac_kernel -- every other case (bits 1-8 on either side, rows up
//   to 32): one 32-bit word per (plane, row or column, group), one __popc,
//   one shared-memory table read and one shift-add per (plane pair, group,
//   output); K-groups split across the 8 warps.  Staging, voltage, split
//   and epilogue in bitplane_common.cuh, shared with bitplane_mac_noisy.cu.
//
// Common to the r8 and generic kernels:
//   * one 256-thread block (8 warps) per 8 x 32 output tile (plan() in
//     bitplane_common.cuh); lane = output column, each thread keeps a row
//     accumulator per tile row, summed across warps at the end;
//   * when the output tiles alone give fewer than ~2 blocks per SM (decode,
//     M = 4), K-groups split across blocks too (gridDim.z), whose partial
//     sums meet through integer atomicAdd into a zeroed output: integer
//     addition is exact in any order;
//   * the decode table: counts are integers in [0, rows], so each block
//     builds the rows+1 entry table dec[] once from the live `thr` data,
//     computing V(k) in float32 exactly as the plain version does (no
//     contracted multiply-adds, core/rbl.py::exp_f32's exponential);
//   * ragged edges: values past M, N or K stage as zeros, never padded in
//     device memory.  Only the real ceil(K/rows) groups are decoded.  Rows
//     past M and columns past N are not stored.
#include "bitplane_mma.cuh"

namespace {

using namespace bitplane;

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

// ------------------------------------------- the served case: rows 8, 8 x 8
// (R8_ROWS, R8_PLANES and prmt in bitplane_mma.cuh; warp w = plane p)
constexpr int R8_WORDS = GK / 4;    // words (four groups each) per stage
static_assert(R8_PLANES == WARPS, "one warp per activation plane");
static_assert(R8_WORDS * BN == THREADS, "one W word gather per thread");
static_assert(BM * R8_WORDS <= THREADS, "one A word gather per thread");
static_assert(GK % 4 == 0 && WARPS % 4 == 0,
              "stages and splits start on a word");

template <int RB>  // output rows per block: BM, or 4 when M <= 4
struct SmemR8 {
  uint32_t a[R8_PLANES][RB][R8_WORDS];   // 2 KB at RB = 8
  uint32_t w[R8_PLANES][R8_WORDS][BN];   // 8 KB; reused for the warp sums
};
static_assert(WARPS * BM * BN <= R8_PLANES * R8_WORDS * BN,
              "warp sums fit in w");

// Transpose an 8 x 8 bit matrix held as 8 bytes (byte r = row r, bit c =
// column c): afterwards byte c bit r is the old byte r bit c (Hacker's
// Delight, transpose8).
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x ^= t ^ (t << 28);
  return x;
}

// Gather the 32 K-rows of one word (four groups) at `p`, `stride` bytes
// apart (`valid` of them inside the operand; the rest stage as zeros), and
// write plane b's word, in the nibble layout above, to word[b].
__device__ __forceinline__ void gather_word(const uint8_t* __restrict__ p,
                                            int stride, int valid,
                                            uint32_t (&word)[R8_PLANES]) {
  uint64_t lo4[2] = {0ull, 0ull};  // rows 0-3 of groups (0,1) / (2,3)
  uint64_t hi4[2] = {0ull, 0ull};  // rows 4-7
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint64_t x = 0ull;  // byte r = K-row 8j + r
#pragma unroll
    for (int r = 0; r < R8_ROWS; ++r) {
      const int k = 8 * j + r;
      const uint64_t v = (k < valid) ? p[static_cast<size_t>(k) * stride] : 0u;
      x |= v << (8 * r);
    }
    x = transpose8(x);  // byte b = plane b's 8 row bits of group j
    const int sh = 4 * (j & 1);
    lo4[j >> 1] |= (x & 0x0F0F0F0F0F0F0F0Full) << sh;
    hi4[j >> 1] |= ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) << sh;
  }
  // Byte b of lo4[0], lo4[1], hi4[0], hi4[1] are bytes 0-3 of plane b's
  // word: a 4 x 8 byte transpose, planes 0-3 from the low halves.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t A = static_cast<uint32_t>(lo4[0] >> (32 * h));
    const uint32_t B = static_cast<uint32_t>(lo4[1] >> (32 * h));
    const uint32_t C = static_cast<uint32_t>(hi4[0] >> (32 * h));
    const uint32_t D = static_cast<uint32_t>(hi4[1] >> (32 * h));
    const uint32_t ab0 = prmt(A, B, 0x5140), ab1 = prmt(A, B, 0x7362);
    const uint32_t cd0 = prmt(C, D, 0x5140), cd1 = prmt(C, D, 0x7362);
    word[4 * h + 0] = prmt(ab0, cd0, 0x5410);
    word[4 * h + 1] = prmt(ab0, cd0, 0x7632);
    word[4 * h + 2] = prmt(ab1, cd1, 0x5410);
    word[4 * h + 3] = prmt(ab1, cd1, 0x7632);
  }
}

// RB = 4 only when M <= 4, so that the grid's one row of tiles (plan()
// tiles M by BM) starts at row 0.
template <int RB>
__global__ void __launch_bounds__(THREADS)
bitplane_mac_r8_kernel(const uint8_t* __restrict__ a,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ thr,
                       int32_t* __restrict__ out, int M, int N, int K,
                       int groups_per_split, bool accumulate) {
  __shared__ SmemR8<RB> s;
  __shared__ uint32_t dec_s[R8_ROWS + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * RB;
  const int n0 = blockIdx.x * BN;
  const int m_rows = min(RB, M - m0);
  const int groups = (K + R8_ROWS - 1) / R8_ROWS;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);

  if (tid <= R8_ROWS) {  // the decode table, from the live thresholds
    const float v = rbl_voltage(static_cast<float>(tid), R8_ROWS);
    uint32_t d = 0;
    for (int i = 0; i < R8_ROWS; ++i) d += (v <= thr[i]) ? 1u : 0u;
    dec_s[tid] = d;
  }

  const int p = warp;  // this warp's activation plane
  int acc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i] = 0;

  for (int gs = g_begin; gs < g_end; gs += GK) {
    const int ng = min(GK, g_end - gs);
    const int nw = (ng + 3) / 4;
    __syncthreads();  // the previous step's reads are done
    {
      uint32_t word[R8_PLANES];
      const int t = warp;  // W: thread (word t, column lane)
      const int kb = (gs + 4 * t) * R8_ROWS;
      const bool live = t < nw && n0 + lane < N;
      gather_word(w + static_cast<size_t>(kb) * N + n0 + lane, N,
                  live ? K - kb : 0, word);
#pragma unroll
      for (int b = 0; b < R8_PLANES; ++b) s.w[b][t][lane] = word[b];
      if (tid < RB * R8_WORDS) {  // A: thread (row i, word ta)
        const int i = tid / R8_WORDS;
        const int ta = tid % R8_WORDS;
        const int ka = (gs + 4 * ta) * R8_ROWS;
        const bool alive = ta < nw && i < m_rows;
        gather_word(a + static_cast<size_t>(m0 + i) * K + ka, 1,
                    alive ? K - ka : 0, word);
#pragma unroll
        for (int b = 0; b < R8_PLANES; ++b) s.a[b][i][ta] = word[b];
      }
    }
    __syncthreads();  // also publishes dec_s, built while the gathers ran
    const uint32_t dec_lo = dec_s[0] | dec_s[1] << 8 | dec_s[2] << 16 |
                            dec_s[3] << 24;
    const uint32_t dec_hi = dec_s[4] | dec_s[5] << 8 | dec_s[6] << 16 |
                            dec_s[7] << 24;
    const uint32_t dec_8 = dec_s[8] * 0x01010101u;
    for (int t = 0; t < nw; ++t) {
      // dp4a weights: 1 per real group's byte, 0 for the padded ones
      const int real = groups - (gs + 4 * t);
      const uint32_t ones = real >= 4 ? 0x01010101u
                                      : 0x01010101u & ((1u << (8 * real)) - 1u);
      uint32_t wq[R8_PLANES], wh[R8_PLANES];
#pragma unroll
      for (int q = 0; q < R8_PLANES; ++q) {
        wq[q] = s.w[q][t][lane];
        wh[q] = (wq[q] >> 1) & 0x55555555u;
      }
      // Rows past M staged as zeros: counted, never stored, no branch.
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const uint32_t ap = s.a[p][i][t];
        const uint32_t ah = ap >> 1;
        uint32_t sum = 0;
#pragma unroll
        for (int q = 0; q < R8_PLANES; ++q) {
          uint32_t x = (ap & wq[q]) - (ah & wh[q]);         // 2-bit counts
          x = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);  // 4-bit counts
          const uint32_t c = x + (x >> 16);  // nibble j: group j's count
          const uint32_t d = prmt(dec_lo, dec_hi, c) |
                             (prmt(0x80u, 0u, c) & dec_8);
          sum = __dp4a(d, ones << q, sum);
        }
        acc[i] += static_cast<int>(sum << p);
      }
    }
  }

  // Sum the 8 warps' row accumulators (lane = column), one output per thread.
  __syncthreads();
  int* part = reinterpret_cast<int*>(&s.w[0][0][0]);
#pragma unroll
  for (int i = 0; i < RB; ++i) part[(warp * RB + i) * BN + lane] = acc[i];
  __syncthreads();
  const int i = tid / BN;
  const int c = tid % BN;
  if (i >= RB) return;
  int total = 0;
#pragma unroll
  for (int wp = 0; wp < WARPS; ++wp) total += part[(wp * RB + i) * BN + c];
  if (i < m_rows && n0 + c < N) {
    int32_t* o = out + static_cast<size_t>(m0 + i) * N + n0 + c;
    if (accumulate) {
      atomicAdd(o, total);
    } else {
      *o = total;
    }
  }
}


// -------------------------- the served case at M > 8: tensor-core counts
// (the tile geometry, mma_plan, the staging and the fragments in
// bitplane_mma.cuh, shared with bitplane_mac_noisy.cu)
constexpr int R8_MAX_M = 8;       // bitplane_mac_r8_kernel's M; above, mma

__global__ void __launch_bounds__(MM_THREADS, 3)
bitplane_mac_mma_kernel(const uint8_t* __restrict__ a,
                        const uint8_t* __restrict__ w,
                        const float* __restrict__ thr,
                        int32_t* __restrict__ out, int M, int N, int K,
                        int steps_per_split, bool accumulate, bool vec) {
  __shared__ __align__(16) SmemMma s;
  __shared__ uint32_t dec_s[R8_ROWS + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = 32 * (warp >> 1);  // the warp's rows and columns in the tile
  const int wc = 32 * (warp & 1);
  const int n0 = blockIdx.x * MM_BN;
  const int m0 = blockIdx.y * MM_BM;
  const int groups = (K + R8_ROWS - 1) / R8_ROWS;
  const int steps = (groups + 3) / 4;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(steps, s_begin + steps_per_split);
  const int k_begin = s_begin * MM_STEP;
  const int k_end = min(K, s_end * MM_STEP);
  const bool live = m0 + wr < M;  // warp-uniform: the rows are not all past M
  // slot k of an m16n8k32 holds K-row 32 * step + k, of group j = k / 8;
  // its bytes weigh alpha_j (A) x beta_j (B) = 16^j, so the s32 output
  // holds group j's count in nibble j.  a0/a1 (k = 4t..) are group t / 2:
  // alpha 16^(t/2), beta 1; a2/a3 group 2 + t / 2: alpha 4 * 16^(t/2),
  // beta 64.
  const int sa0 = 4 * (t >> 1);
  const int sa1 = sa0 + 2;

  if (tid <= R8_ROWS) {  // the decode table, from the live thresholds
    const float v = rbl_voltage(static_cast<float>(tid), R8_ROWS);
    uint32_t d = 0;
    for (int i = 0; i < R8_ROWS; ++i) d += (v <= thr[i]) ? 1u : 0u;
    dec_s[tid] = d;
  }

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][ni][x] = 0;

  const int chunks = (k_end - k_begin + MM_KC - 1) / MM_KC;
  if (chunks > 0)
    mma_stage(s, 0, a, w, M, N, K, m0, n0, k_begin, k_end, vec);
  uint32_t dec_lo = 0, dec_hi = 0, dec_8 = 0;
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const int kc = k_begin + c * MM_KC;
    if (c + 1 < chunks) {
      mma_stage(s, buf ^ 1, a, w, M, N, K, m0, n0, kc + MM_KC, k_end, vec);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk c has landed (and, at c = 0, dec_s)
    mma_full_groups(s, buf);
    if (c == 0) {
      dec_lo = dec_s[0] | dec_s[1] << 8 | dec_s[2] << 16 | dec_s[3] << 24;
      dec_hi = dec_s[4] | dec_s[5] << 8 | dec_s[6] << 16 | dec_s[7] << 24;
      dec_8 = dec_s[8];
    }
    __syncthreads();  // fa, fw
    const int step0 = kc / MM_STEP;
    const int nst = min(MM_KC / MM_STEP, s_end - step0);
    if (live) {
      for (int st = 0; st < nst; ++st) {
        const int kb = MM_STEP * st;
        // groups past ceil(K/8) (only in the last k-step) stage as zeros;
        // 8 added to their nibbles makes them decode to 0, as a count of 8
        // does (below)
        const int real = groups - 4 * (step0 + st);
        const uint32_t pad = mma_pad(real);
        uint32_t ra[2][4];
        mma_a_frags(s, buf, wr, g, t, kb, ra);
        // W's 4 K-rows of column wc + 8 ni + g at k = 4t.. (b0) and 16 +
        // 4t.. (b1), then its 8 planes: bit q of each byte, times beta
        uint32_t rb[4][2];
        mma_w_frags(s, buf, wc, g, t, kb, rb);
        uint32_t bq[R8_PLANES][4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int q = 0; q < R8_PLANES; ++q) {
            bq[q][ni][0] = (rb[ni][0] >> q) & 0x01010101u;
            bq[q][ni][1] = q <= 6 ? (rb[ni][1] << (6 - q)) & 0x40404040u
                                  : (rb[ni][1] >> (q - 6)) & 0x40404040u;
          }
        }
        // sum_p 2^p sum_q 2^q dec, by Horner over p from 7 down
        int part[2][4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int x = 0; x < 4; ++x) part[mi][ni][x] = 0;
#pragma unroll 1
        for (int p = R8_PLANES - 1; p >= 0; --p) {
          uint32_t ap[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              ap[mi][i] = ((ra[mi][i] >> p) & 0x01010101u) << (i < 2 ? sa0 : sa1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int x = 0; x < 4; ++x) part[mi][ni][x] <<= 1;
#pragma unroll
          for (int q = 0; q < R8_PLANES; ++q) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                uint32_t d[4];
                mma_u8_k32(d, ap[mi], bq[q][ni][0], bq[q][ni][1], pad);
                // four counts a word, the word the prmt selector: a count
                // of 8 (selector nibble 8) replicates dec[0]'s top bit, 0
#pragma unroll
                for (int x = 0; x < 4; ++x)
                  part[mi][ni][x] = static_cast<int>(__dp4a(
                      prmt(dec_lo, dec_hi, d[x]), 0x01010101u << q,
                      static_cast<uint32_t>(part[mi][ni][x])));
              }
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[mi][ni][x] += part[mi][ni][x];
      }
      // the counts of 8: sum_g FA[m,g] FW[g,n] = sum_{p,q} 2^(p+q) N8, one
      // m16n8k16 over the chunk's 16 groups, times dec[8]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          uint32_t d[4];
          mma_u8_k16(d, s.fa[wr + 16 * mi + g][t], s.fa[wr + 16 * mi + g + 8][t],
                     s.fw[wc + 8 * ni + g][t]);
#pragma unroll
          for (int x = 0; x < 4; ++x)
            acc[mi][ni][x] += static_cast<int>(dec_8 * d[x]);
        }
    }
    __syncthreads();  // buf and fa, fw are read before they are restaged
  }

  if (!live) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int m = m0 + wr + 16 * mi + g + 8 * (x >> 1);
        const int n = n0 + wc + 8 * ni + 2 * t + (x & 1);
        if (m < M && n < N) {
          int32_t* o = out + static_cast<size_t>(m) * N + n;
          if (accumulate) {
            atomicAdd(o, acc[mi][ni][x]);
          } else {
            *o = acc[mi][ni][x];
          }
        }
      }
}

}  // namespace

// a: uint8[M,K] row-major, w: uint8[K,N] row-major (offset-binary values; only
// the low bits_a / bits_w bits are read), thr: float32[rows], out: int32[M,N];
// target: the blocks plan() aims at for the r8 and generic kernels (264 by
// default: two per SM on a 132-SM H100); the tensor-core kernel (rows 8,
// 8 x 8 bits, M > 8) plans from the shapes alone.  *kernel is set to the
// kernel launched: 0 none (an empty output), 1 bitplane_mac_kernel, 2
// bitplane_mac_r8_kernel, 3 bitplane_mac_mma_kernel.  Returns a cudaError_t
// value.
extern "C" int bitplane_mac_launch(const void* a, const void* w, const void* thr,
                                   void* out, int M, int N, int K, int bits_a,
                                   int bits_w, int rows, int target, void* stream,
                                   int device, int* kernel) {
  *kernel = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const uint8_t*>(a);
  const auto* w8 = static_cast<const uint8_t*>(w);
  const auto* t = static_cast<const float*>(thr);
  auto* o = static_cast<int32_t*>(out);
  if (rows == R8_ROWS && bits_a == R8_PLANES && bits_w == R8_PLANES &&
      M > R8_MAX_M) {
    if (N < 0 || K < 0 || target < 1 || target > MAX_TARGET) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (N == 0) return 0;
    const MmaPlan p = mma_plan(M, N, K);
    if (p.accumulate) {
      err = cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(M) * N,
                            s);
      if (err != cudaSuccess || p.steps == 0) return static_cast<int>(err);
    }
    bitplane_mac_mma_kernel<<<p.grid, MM_THREADS, 0, s>>>(
        a8, w8, t, o, M, N, K, p.per_split, p.accumulate,
        mma_vec(a, w, N, K));
    *kernel = 3;
    return static_cast<int>(cudaGetLastError());
  }
  Plan p;
  bool skip = true;
  const int rc = prepare(out, M, N, K, bits_a, bits_w, rows, target, s, &p,
                         &skip);
  if (skip) return rc;
  if (rows == R8_ROWS && bits_a == R8_PLANES && bits_w == R8_PLANES) {
    // the padded-byte mask assumes each split starts on a word
    if (p.per_split % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (M <= 4) {
      bitplane_mac_r8_kernel<4><<<p.grid, THREADS, 0, s>>>(
          a8, w8, t, o, M, N, K, p.per_split, p.accumulate);
    } else {
      bitplane_mac_r8_kernel<BM><<<p.grid, THREADS, 0, s>>>(
          a8, w8, t, o, M, N, K, p.per_split, p.accumulate);
    }
    *kernel = 2;
  } else {
    bitplane_mac_kernel<<<p.grid, THREADS, 0, s>>>(
        a8, w8, t, o, M, N, K, bits_a, bits_w, rows, p.per_split,
        p.accumulate);
    *kernel = 1;
  }
  return static_cast<int>(cudaGetLastError());
}

// mma_plan() of the tensor-core kernel (rows 8, 8 x 8 bits, M > 8): out[0..2]
// the grid, out[3] the k-steps (32 K-rows) per split, out[4] whether the
// splits add into a zeroed output.  Returns 0, or cudaErrorInvalidValue.
extern "C" int bitplane_mma_plan(int M, int N, int K, int* out) {
  if (M <= R8_MAX_M || N < 1 || K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MmaPlan p = mma_plan(M, N, K);
  const int v[5] = {static_cast<int>(p.grid.x), static_cast<int>(p.grid.y),
                    static_cast<int>(p.grid.z), p.per_split, p.accumulate};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// bitplane_common.cuh's plan() of an M x K x N product of `rows`-row groups
// aiming at `target` blocks, splits of `granule` groups (8 here, 1 in
// bitplane_mac_noisy.cu): out[0..2] the grid (column tiles, row tiles, K
// splits), out[3] the K-groups per split, out[4] whether the splits add into
// a zeroed output.  Returns 0, or cudaErrorInvalidValue for arguments that
// prepare() refuses.
extern "C" int bitplane_plan(int M, int N, int K, int rows, int target,
                             int granule, int* out) {
  if (M < 1 || N < 1 || K < 0 || rows < 1 || rows > MAX_ROWS || target < 1 ||
      target > MAX_TARGET || granule < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(M, N, K, rows, target, granule);
  const int v[5] = {static_cast<int>(p.grid.x), static_cast<int>(p.grid.y),
                    static_cast<int>(p.grid.z), p.per_split, p.accumulate};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}
