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
// Two kernels, one launch each; bitplane_mac_launch picks one:
//
// bitplane_mac_r8 -- the paper's served case, 8-row groups and 8 x 8 bits.
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
// bitplane_mac_kernel -- every other case (bits 1-8 on either side, rows up
//   to 32): one 32-bit word per (plane, row or column, group), one __popc,
//   one shared-memory table read and one shift-add per (plane pair, group,
//   output); K-groups split across the 8 warps.  Staging, voltage, split
//   and epilogue in bitplane_common.cuh, shared with bitplane_mac_noisy.cu.
//
// Common to both:
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
#include "bitplane_common.cuh"

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
constexpr int R8_ROWS = 8;
constexpr int R8_PLANES = 8;        // bits_a == bits_w == 8; warp w = plane p
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

// prmt.b32 in its default mode: byte n of the result is byte (sel >> 4n) & 7
// of {hi, lo}, or, when bit 3 of that nibble is set, that byte's top bit
// replicated over all 8 bits.
__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

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

}  // namespace

// a: uint8[M,K] row-major, w: uint8[K,N] row-major (offset-binary values; only
// the low bits_a / bits_w bits are read), thr: float32[rows], out: int32[M,N];
// target: the blocks plan() aims at (264 by default: two per SM on a 132-SM
// H100).  Returns a cudaError_t value.
extern "C" int bitplane_mac_launch(const void* a, const void* w, const void* thr,
                                   void* out, int M, int N, int K, int bits_a,
                                   int bits_w, int rows, int target, void* stream,
                                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  bool skip = true;
  const int rc = prepare(out, M, N, K, bits_a, bits_w, rows, target, s, &p,
                         &skip);
  if (skip) return rc;
  const auto* a8 = static_cast<const uint8_t*>(a);
  const auto* w8 = static_cast<const uint8_t*>(w);
  const auto* t = static_cast<const float*>(thr);
  auto* o = static_cast<int32_t*>(out);
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
  } else {
    bitplane_mac_kernel<<<p.grid, THREADS, 0, s>>>(
        a8, w8, t, o, M, N, K, bits_a, bits_w, rows, p.per_split,
        p.accumulate);
  }
  return static_cast<int>(cudaGetLastError());
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
