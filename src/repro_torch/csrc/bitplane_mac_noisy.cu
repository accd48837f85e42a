// bitplane_mac_noisy: the paper's full bit-plane pyramid with its analog
// non-idealities (the NoiseSpec Monte-Carlo) in one launch:
//
//   out[m,n] = sum_{p,q} 2^(p+q) sum_g dec(m, n, pair = p*PW + q, g)
//   k'  = k + (sigma_m * sqrt(max(k, 0))) * z_0      k = popc(A_p[m,g] & W_q[g,n])
//   dec = #{i : thr[i] + sigma_c * z_{1+i} >= V(k')}
//
// with V the two-regime physics RBL voltage and z_d the element's normal
// draw d.  Replaces the TPU kernel bitplane_mac_noisy_raw (body
// _make_noisy_kernel) in src/repro/kernels/bitplane_mac/bitplane_mac.py.
// There each grid step seeds the TPU's hardware PRNG from the key words and
// the step index; here every draw comes from Philox4x32-10, written below,
// keyed by the call's two seed words, which the kernel reads from device
// memory (a CUDA graph replays one launch, and the words written there
// before each replay key that replay's stream), and counted by (n, m, group, pair << 8 | d >> 1) alone, so the draws depend on
// the element, never on the tile, warp or split that computes it, and the
// split-K partial sums still meet exactly by integer atomicAdd.  The plain
// version (kernels/bitplane_mac/ops.py::bitplane_mac_noisy_torch) computes
// the same stream with the same float32 operations, so the two agree bit
// for bit: Box-Muller's log and cos are Cephes' polynomials written one
// rounded operation at a time (kernels/common.py), sqrt is __fsqrt_rn, the
// exponential is core/rbl.py::exp_f32's (bitplane_common.cuh).
//
// What bounds it on an H100: not bytes (a decode step's 72 projections at
// M = 4 move ~87 MB, ~0.026 ms at 3.35 TB/s) but the draws.  A hardware
// Box-Muller (log, sqrt, cos on the special-function units) would cost
// ~2.6 ms per step for the mismatch draws alone; the bit-exact stream cannot
// use those units, and its log and cos are float32 polynomials, the voltage
// past the linear regime an exponential of double-precision multiply-adds:
// a few hundred instructions per draw.  The floor of the stream itself is
// one Philox4x32-10 (integer pipes) for every element whose decode a draw
// can change.
//
// Design: draw only where a draw can change the decode.  Box-Muller on the
// 2^-24 grid gives |z| <= Z_MAX = r(2^24 - 1) = 5.768 (r(i), the radius at
// u1 index i, is monotone on the grid and |cos| <= 1: both are checked over
// the whole grid by tests/test_torch_bitplane_noisy_skip.py), so a count k
// whose band k' in [k - s_k Z_MAX, k + s_k Z_MAX] (s_k = sigma_m sqrt(k)),
// with every comparator offset up to sigma_c Z_MAX, meets no threshold has
// the noise-free decode whatever is drawn.  At the calibrated mismatch 0.05
// that is counts 0-3 of rows 8, ~89% of the elements of uniform operands.
// Three tiers per element (n, m, group, pair):
//   1. Prologue, per block, from the live thr, rows and sigmas (no host
//      read, no extra launch): for each count k in [0, rows] the noise-free
//      decode dec0[k], and NEED where the band above is not free.  The band
//      test evaluates V at both float32 ends of the band (k' is a rounded
//      monotone function of z, so the ends are exact) and asks that no
//      threshold lie within PAD of [V(hi), V(lo)] (V is monotone in float32
//      k' on every row count 1-32; PAD is a margin for rounding the scan did
//      not see).  With mismatch alone, cut[k]: the first u1 grid index whose
//      radius r(i) >= |z| reaches the band's edge, found by a 32-way search
//      over the 24-bit grid (a warp per count, 5 rounds).
//   2. Per element: the count (one __popc), dec0[k] 2^(p+q) into the row's
//      accumulator (registers), and, for a NEED count, an entry in the
//      lane's own queue in shared memory (no warp collective per element:
//      the cost of queueing follows the share that needs a draw).
//   3. Once a lane's queue nears full (one vote per 4 rows), the warp
//      drains every lane's queue with every lane busy: a warp scan of the
//      lanes' counts numbers the entries, each lane finds its entry's owner
//      in 5 shuffles, two entries a lane where it can (two independent
//      Philox calls).  Philox for the entry; with mismatch alone, a u1 index
//      below cut[k] keeps dec0[k] (no log, cos or voltage), else the full
//      decode.  With comparator offset, the mismatch draw, V(k'), and a draw
//      only for the comparators whose threshold lies within sigma_c Z_MAX of
//      V(k') (a pair's Philox call when either of its two draws is needed).
//      The correction (dec - dec0[k]) 2^(p+q), almost always 0, goes into the
//      block's per-output slot by shared-memory atomicAdd.
// The noise-free decode is the plain version's wherever no draw can change
// it, so the output is the plain version's, bit for bit, for any thr (NaN
// thresholds never fire, duplicates and any order are fine), rows 1-32 and
// sigmas.  This is not a cheaper noise model: it is the same function,
// computed only where it can differ.
//
// Geometry: one 256-thread block per 8 x 32 output tile (bitplane_common.cuh's
// plan(), splitting K one group at a time to ~480 blocks: one wave of 4
// blocks per SM, the most that 64 registers a thread allow; 20 K-groups a
// stage, all of a decode step's split, leave shared memory for the
// queues), lane = column;
// warp w takes the (group, plane of A) units w, w + 8, ... of a staged step,
// so with 8 planes every warp works on every group; the template RL counts 4
// tile rows when M <= 4 (a decode step), else 8, as straight-line code.
// Operands are staged as one 32-bit word per (plane, row or column, group),
// each thread's byte loads 8 rows at a time; only the real ceil(K/rows)
// groups are decoded; columns past N are not computed; split-K partial sums
// meet by int32 atomicAdd.
#include "bitplane_common.cuh"

namespace {

using namespace bitplane;

// The entry point's default target (kernels/autotune: 480): a little under
// one wave of BLOCKS_PER_SM blocks on 132 SMs at the decode step's three
// shapes (M = 4; K x N = 768 x 768, 768 x 3072, 3072 x 768 each give 480
// blocks), splitting K one group at a time.
constexpr int BLOCKS_PER_SM = 4;
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint32_t U1_GRID = 1u << 24;  // u1 is the top 24 bits of a word
constexpr float PAD = 0x1p-20f;         // the band test's margin on V, volts
constexpr uint32_t NEED = 0x80000000u;  // tab_s flag: a draw can change dec0
constexpr uint32_t DEC0 = 0x3Fu;        // tab_s: dec0[k] in [0, 32]
constexpr int NGK = 20;    // K-groups staged per step: a decode step's splits
constexpr int SLOTS = 16;  // queue entries per lane; drained past SLOTS - 4
constexpr int LANE_STRIDE = SLOTS + 1;  // words: lanes' queues apart in banks

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

// The block's tables and queues (static shared memory beside the staged
// operands).
__shared__ float thr_s[MAX_ROWS];
__shared__ float tlo_s[MAX_ROWS];  // thr - sigma_c Z_MAX: fires whatever z
__shared__ float thi_s[MAX_ROWS];  // thr + sigma_c Z_MAX: below V, never
__shared__ uint32_t tab_s[MAX_ROWS + 1];  // dec0[k] | NEED
__shared__ uint32_t cut_s[MAX_ROWS + 1];  // mismatch alone: keep dec0 below
__shared__ int corr_s[BM][BN];
__shared__ uint32_t queue_s[WARPS][32 * LANE_STRIDE];  // [lane][slot]

// Philox4x32-10's round keys, computed once per thread from the call's two
// seed words (uint32, low then high), read from device memory.
struct RoundKeys {
  uint32_t k0[10];
  uint32_t k1[10];
};

__device__ __forceinline__ RoundKeys round_keys(const uint32_t* __restrict__ seed) {
  const uint32_t k0 = __ldg(seed);
  const uint32_t k1 = __ldg(seed + 1);
  RoundKeys rk;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    rk.k0[r] = k0 + static_cast<uint32_t>(r) * PHILOX_W0;
    rk.k1[r] = k1 + static_cast<uint32_t>(r) * PHILOX_W1;
  }
  return rk;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const RoundKeys& rk) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x);
    const uint32_t lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z);
    const uint32_t lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ rk.k0[r], lo1, hi0 ^ c.w ^ rk.k1[r], lo0);
  }
  return c;
}

// kernels/common.py::log_f32 (Cephes' logf), one rounded op at a time.
__device__ __forceinline__ float log_f32(float x) {
  const int bits = __float_as_int(x);
  const int e = ((bits >> 23) & 0xFF) - 126;
  float f = __int_as_float((bits & 0x7FFFFF) | (126 << 23));
  const bool small = f < f32(0.707106781186547524);
  const float fe = static_cast<float>(e - (small ? 1 : 0));
  f = small ? __fsub_rn(__fadd_rn(f, f), 1.f) : __fsub_rn(f, 1.f);
  const float z = __fmul_rn(f, f);
  float y = f32(7.0376836292e-2);
  y = __fadd_rn(__fmul_rn(y, f), f32(-1.1514610310e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(1.1676998740e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(-1.2420140846e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(1.4249322787e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(-1.6668057665e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(2.0000714765e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(-2.4999993993e-1));
  y = __fadd_rn(__fmul_rn(y, f), f32(3.3333331174e-1));
  y = __fmul_rn(__fmul_rn(y, f), z);
  y = __fadd_rn(y, __fmul_rn(fe, f32(-2.12194440e-4)));
  y = __fsub_rn(y, __fmul_rn(z, 0.5f));
  return __fadd_rn(__fadd_rn(f, y), __fmul_rn(fe, f32(0.693359375)));
}

// kernels/common.py::cos_2pi_f32: cos(2 pi u), u on a 2^-24 grid in [0, 1).
__device__ __forceinline__ float cos_2pi_f32(float u) {
  const float q = floorf(__fmul_rn(u, 4.f));
  float r = __fsub_rn(u, __fmul_rn(q, 0.25f));
  const bool hi = r > 0.125f;
  if (hi) r = __fsub_rn(0.25f, r);
  const float x = __fmul_rn(r, f32(6.283185307179586));
  const float z = __fmul_rn(x, x);
  float c = __fmul_rn(
      __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(z, f32(2.443315711809948e-5)),
                                    f32(-1.388731625493765e-3)), z),
                f32(4.166664568298827e-2)), z);
  c = __fadd_rn(__fsub_rn(__fmul_rn(c, z), __fmul_rn(z, 0.5f)), 1.f);
  float s = __fmul_rn(
      __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(z, f32(-1.9515295891e-4)),
                                    f32(8.3321608736e-3)), z),
                f32(-1.6666654611e-1)), z);
  s = __fadd_rn(__fmul_rn(s, x), x);
  const float cr = hi ? s : c;
  const float sr = hi ? c : s;
  const int qi = static_cast<int>(q);
  return qi == 0 ? cr : qi == 1 ? -sr : qi == 2 ? -cr : sr;
}

// Box-Muller's radius sqrt(-2 log(1 - u1)) at the u1 grid index idx.
__device__ __forceinline__ float radius(uint32_t idx) {
  const float u1 = __fmul_rn(static_cast<float>(idx), f32(0x1p-24));
  return __fsqrt_rn(__fmul_rn(log_f32(__fsub_rn(1.f, u1)), -2.f));
}

// kernels/common.py::box_muller on two uint32 words.
__device__ __forceinline__ float normal(uint32_t b1, uint32_t b2) {
  const float u2 = __fmul_rn(static_cast<float>(b2 >> 8), f32(0x1p-24));
  return __fmul_rn(radius(b1 >> 8), cos_2pi_f32(u2));
}

// Count k, mismatch draw z: k + (sigma_m * sqrt(k)) * z.
__device__ __forceinline__ float mismatched(float k, float ms, float z) {
  return __fadd_rn(k, __fmul_rn(__fmul_rn(ms, __fsqrt_rn(k)), z));
}

// Does count k decode to dec0[k] for every mismatch draw |z| <= rz and every
// comparator offset up to sigma_c Z_MAX (tlo_s/thi_s)?  V is monotone
// non-increasing in k', so over the band it lies in [V(hi), V(lo)]; each
// comparator must fire or stay quiet over all of it, with PAD to spare.
__device__ bool band_free(int k, float rz, int rows, float ms) {
  const float kf = static_cast<float>(k);
  float lo = kf;
  float hi = kf;
  if (ms > 0.f) {
    const float d = __fmul_rn(__fmul_rn(ms, __fsqrt_rn(kf)), rz);
    lo = __fsub_rn(kf, d);
    hi = __fadd_rn(kf, d);
  }
  const float vlo = __fadd_rn(rbl_voltage(lo, rows), PAD);
  const float vhi = __fsub_rn(rbl_voltage(hi, rows), PAD);
  bool free = true;
  for (int i = 0; i < rows; ++i)
    free = free && (tlo_s[i] >= vlo || thi_s[i] < vhi || isnan(thr_s[i]));
  return free;
}

// Warp-collective: the first u1 grid index i whose band (radius r(i)) is
// not free, for a count whose band at Z_MAX = r(2^24 - 1) is not free.
// Each round 32 lanes test evenly spaced indices; 5 rounds.
__device__ uint32_t first_cut(int k, int rows, float ms, int lane) {
  uint32_t lo = 0;
  uint32_t hi = U1_GRID - 1;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const uint32_t step = (hi - lo + 31) / 32;
    const uint32_t i = lo + static_cast<uint32_t>(lane) * step;
    const bool bad = i >= hi || !band_free(k, radius(i), rows, ms);
    const uint32_t b = __ballot_sync(FULL, bad);
    if (b == 0) {
      lo += 31 * step + 1;
    } else {
      const uint32_t j = static_cast<uint32_t>(__ffs(b) - 1);
      hi = min(hi, lo + j * step);
      if (j) lo += (j - 1) * step + 1;
    }
  }
  return lo;
}

// The full decode of a mismatch-only element from its draw-0 words.
__device__ __forceinline__ int decode_mismatch(int k, uint32_t b1, uint32_t b2,
                                               int rows, float ms) {
  const float v = rbl_voltage(mismatched(static_cast<float>(k), ms,
                                         normal(b1, b2)), rows);
  int dec = 0;
  for (int i = 0; i < rows; ++i) dec += (v <= thr_s[i]) ? 1 : 0;
  return dec;
}

// The decode of an element under comparator offset (c: the counter of its
// draws 0 and 1): the mismatch draw, then a draw only for the comparators
// that V(k') leaves undecided.
__device__ __forceinline__ int decode_offsets(int k, uint4 c, int rows,
                                              const RoundKeys& rk, float ms,
                                              float cs) {
  float kp = static_cast<float>(k);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  uint32_t rj = 0xFFFFFFFFu;  // the Philox counter word r holds
  if (ms > 0.f) {
    r = philox4x32_10(c, rk);
    rj = 0;
    kp = mismatched(kp, ms, normal(r.x, r.y));
  }
  const float v = rbl_voltage(kp, rows);
  int dec = 0;
  uint32_t draw = 0;
  for (int i = 0; i < rows; ++i) {
    if (tlo_s[i] >= v) {
      ++dec;
    } else if (!(thi_s[i] < v)) {
      draw |= 1u << i;
    }
  }
  while (draw) {
    const int i = __ffs(draw) - 1;
    draw &= draw - 1;
    const uint32_t d = static_cast<uint32_t>(i) + 1u;
    if ((d >> 1) != rj) {
      rj = d >> 1;
      r = philox4x32_10(make_uint4(c.x, c.y, c.z, c.w | rj), rk);
    }
    const bool odd = d & 1u;
    const float z = normal(odd ? r.z : r.x, odd ? r.w : r.y);
    dec += (v <= __fadd_rn(thr_s[i], __fmul_rn(cs, z))) ? 1 : 0;
  }
  return dec;
}

// One K-group of one row (stride 1) or column (stride N): its `rows` bytes
// (zeros past `valid`) into one word per plane, the loads issued 8 rows at
// a time so that they are in flight together.
__device__ __forceinline__ void gather_bits(const uint8_t* __restrict__ p,
                                            size_t stride, int rows, int valid,
                                            uint32_t (&word)[MAX_PLANES]) {
  for (int r0 = 0; r0 < rows; r0 += 8) {
    uint32_t v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      v[r] = (r0 + r < rows && r0 + r < valid) ? p[(r0 + r) * stride] : 0u;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int b = 0; b < MAX_PLANES; ++b) word[b] |= ((v[r] >> b) & 1u) << (r0 + r);
    }
  }
}

// bitplane_common.cuh's stage() for the K-groups [gs, gs + ng) with
// gather_bits' loads (the shared version loads row after row).  Words of
// rows past M are zeros; words of groups past ng are not written.
__device__ __forceinline__ void stage_groups(SmemG<NGK>& s, const uint8_t* __restrict__ a,
                                             const uint8_t* __restrict__ w, int N,
                                             int K, int PA, int PW, int rows, int m0,
                                             int n0, int m_rows, int gs, int ng) {
  for (int t = threadIdx.x; t < BM * ng; t += THREADS) {
    const int i = t / ng;
    const int g = t - i * ng;
    const int kb = (gs + g) * rows;
    uint32_t word[MAX_PLANES] = {};
    if (i < m_rows)
      gather_bits(a + static_cast<size_t>(m0 + i) * K + kb, 1, rows, K - kb, word);
#pragma unroll
    for (int p = 0; p < MAX_PLANES; ++p)
      if (p < PA) s.a[p][i][g] = word[p];
  }
  for (int t = threadIdx.x; t < ng * BN; t += THREADS) {
    const int g = t / BN;
    const int c = t - g * BN;
    const int kb = (gs + g) * rows;
    uint32_t word[MAX_PLANES] = {};
    if (n0 + c < N)
      gather_bits(w + static_cast<size_t>(kb) * N + n0 + c, N, rows, K - kb, word);
#pragma unroll
    for (int q = 0; q < MAX_PLANES; ++q)
      if (q < PW) s.w[q][g][c] = word[q];
  }
}

// A queue entry: k (6 bits) | q << 6 | p << 9 | source lane << 12 | tile
// row << 17 | staged group << 20, and what it stands for.
struct Entry {
  int k;
  uint32_t q, p, src, i;
  uint4 counter;  // Philox counter of draws 0 and 1
};

__device__ __forceinline__ Entry unpack(uint32_t e, uint32_t n0, uint32_t m0,
                                        uint32_t gs, int PW) {
  Entry x;
  x.k = static_cast<int>(e & 63u);
  x.q = (e >> 6) & 7u;
  x.p = (e >> 9) & 7u;
  x.src = (e >> 12) & 31u;
  x.i = (e >> 17) & 7u;
  x.counter = make_uint4(n0 + x.src, m0 + x.i, gs + (e >> 20),
                         (x.p * static_cast<uint32_t>(PW) + x.q) << 8);
  return x;
}

// The element's decode minus dec0[k], 2^(p+q) times, into its output slot.
__device__ __forceinline__ void correct(const Entry& x, int dec) {
  const int dec0 = static_cast<int>(tab_s[x.k] & DEC0);
  if (dec != dec0) atomicAdd(&corr_s[x.i][x.src], (dec - dec0) * (1 << (x.p + x.q)));
}

// Mismatch alone, from the element's draw-0 words: below cut[k] the decode
// is dec0[k]; else the full decode.
__device__ __forceinline__ int settle(const Entry& x, uint4 r, int rows, float ms) {
  return (r.x >> 8) < cut_s[x.k] ? static_cast<int>(tab_s[x.k] & DEC0)
                                 : decode_mismatch(x.k, r.x, r.y, rows, ms);
}

// Tier 3 for one queue entry (nothing is queued without a sigma).
__device__ __forceinline__ void resolve(uint32_t e, uint32_t n0, uint32_t m0,
                                        uint32_t gs, int PW, int rows,
                                        const RoundKeys& rk, float ms,
                                        float cs) {
  const Entry x = unpack(e, n0, m0, gs, PW);
  correct(x, cs > 0.f ? decode_offsets(x.k, x.counter, rows, rk, ms, cs)
                      : settle(x, philox4x32_10(x.counter, rk), rows, ms));
}

// Tier 3 for two entries: with mismatch alone their Philox calls are
// independent and overlap.
__device__ __forceinline__ void resolve2(uint32_t e0, uint32_t e1, uint32_t n0,
                                         uint32_t m0, uint32_t gs, int PW,
                                         int rows, const RoundKeys& rk,
                                         float ms, float cs) {
  if (cs > 0.f) {
    resolve(e0, n0, m0, gs, PW, rows, rk, ms, cs);
    resolve(e1, n0, m0, gs, PW, rows, rk, ms, cs);
    return;
  }
  const Entry x0 = unpack(e0, n0, m0, gs, PW);
  const Entry x1 = unpack(e1, n0, m0, gs, PW);
  const uint4 r0 = philox4x32_10(x0.counter, rk);
  const uint4 r1 = philox4x32_10(x1.counter, rk);
  correct(x0, settle(x0, r0, rows, ms));
  correct(x1, settle(x1, r1, rows, ms));
}

// Tier 3, warp-collective: resolve every entry of the lanes' queues (lane
// x's `count` entries at queue[x * LANE_STRIDE + slot]) with every lane
// busy.  An inclusive scan of the counts numbers the entries; entry e
// belongs to the last lane whose first number is at most e, found in 5
// shuffles.
__device__ __forceinline__ void drain(const uint32_t* queue, int count, int lane,
                                      uint32_t n0, uint32_t m0, uint32_t gs,
                                      int PW, int rows, const RoundKeys& rk,
                                      float ms, float cs) {
  int scan = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, scan, d);
    if (lane >= d) scan += y;
  }
  const int first = scan - count;  // this lane's first entry number
  const int total = __shfl_sync(FULL, scan, 31);
  auto fetch = [&](int e) {
    int owner = 0;
    int at = 0;  // the owner's first entry number (lane 0's is 0)
#pragma unroll
    for (int step = 16; step; step >>= 1) {
      const int f = __shfl_sync(FULL, first, owner + step);
      if (f <= e) {
        owner += step;
        at = f;
      }
    }
    return e < total ? queue[owner * LANE_STRIDE + e - at] : 0u;
  };
  for (int e0 = 0; e0 < total; e0 += 64) {
    const int ea = e0 + lane;
    const int eb = ea + 32;
    const uint32_t xa = fetch(ea);
    const uint32_t xb = fetch(eb);
    if (eb < total) {
      resolve2(xa, xb, n0, m0, gs, PW, rows, rk, ms, cs);
    } else if (ea < total) {
      resolve(xa, n0, m0, gs, PW, rows, rk, ms, cs);
    }
  }
}

// RL: the tile rows counted, 4 when M <= 4 (a decode step), else 8; rows
// past M count zeros and queue nothing.
template <int RL>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
bitplane_mac_noisy_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ w,
                          const float* __restrict__ thr, int32_t* __restrict__ out,
                          int M, int N, int K, int PA, int PW, int rows,
                          int groups_per_split, bool accumulate,
                          const uint32_t* __restrict__ seed, float ms, float cs) {
  __shared__ SmemG<NGK> s;
  const RoundKeys rk = round_keys(seed);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int m_rows = min(BM, M - m0);
  const int groups = (K + rows - 1) / rows;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(groups, g_begin + groups_per_split);
  const bool live = n0 + lane < N;

  // Tier 1: the tables, from the live thresholds and sigmas.
  const float zmax = radius(U1_GRID - 1);
  if (tid < rows) {
    const float t = thr[tid];
    const float reach = cs > 0.f ? __fmul_rn(cs, zmax) : 0.f;
    thr_s[tid] = t;
    tlo_s[tid] = __fsub_rn(t, reach);
    thi_s[tid] = __fadd_rn(t, reach);
  }
  corr_s[tid / BN][tid % BN] = 0;
  __syncthreads();
  if (tid <= rows) {
    const float v = rbl_voltage(static_cast<float>(tid), rows);
    uint32_t dec0 = 0;
    for (int i = 0; i < rows; ++i) dec0 += (v <= thr_s[i]) ? 1u : 0u;
    const bool need = (ms > 0.f || cs > 0.f) && !band_free(tid, zmax, rows, ms);
    tab_s[tid] = dec0 | (need ? NEED : 0u);
    cut_s[tid] = U1_GRID;
  }
  __syncthreads();
  if (ms > 0.f && !(cs > 0.f)) {  // warp w searches the w-th, w+8-th, ... NEED count
    int nth = 0;
    for (int k = 0; k <= rows; ++k) {
      if (!(tab_s[k] & NEED)) continue;
      if (nth++ % WARPS != warp) continue;
      const uint32_t c = first_cut(k, rows, ms, lane);
      if (lane == 0) cut_s[k] = c;
    }
  }

  int acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0;

  uint32_t* queue = queue_s[warp] + lane * LANE_STRIDE;  // this lane's
  for (int gs = g_begin; gs < g_end; gs += NGK) {
    const int ng = min(NGK, g_end - gs);
    __syncthreads();  // the previous step's reads are done (and the tables)
    stage_groups(s, a, w, N, K, PA, PW, rows, m0, n0, m_rows, gs, ng);
    __syncthreads();
    int count = 0;  // entries in this lane's queue
    // Warp `warp` takes the units (group g, plane p of A) warp, warp + 8,
    // ...: with 8 planes, plane p = warp of every staged group.
    for (int u = warp; u < ng * PA; u += WARPS) {
      const int g = u / PA;
      const int p = u - g * PA;
      uint32_t ap[RL];  // rows past M stage as zeros
#pragma unroll
      for (int i = 0; i < RL; ++i) ap[i] = s.a[p][i][g];
      for (int q = 0; q < PW; ++q) {
        const uint32_t wq = s.w[q][g][lane];
        const int scale = 1 << (p + q);
        const uint32_t base = (static_cast<uint32_t>(g) << 20) |
                              (static_cast<uint32_t>(lane) << 12) |
                              (static_cast<uint32_t>(p) << 9) |
                              (static_cast<uint32_t>(q) << 6);
#pragma unroll
        for (int h = 0; h < RL / 4; ++h) {
          // Tier 2 for 4 rows: the noise-free decode, and into the lane's
          // queue the elements where a draw can change it (straight-line
          // code over the rows).
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 4 * h + j;
            const uint32_t k = __popc(ap[i] & wq);
            const uint32_t t = tab_s[k];
            acc[i] += static_cast<int>(t & DEC0) * scale;
            if ((t & NEED) && live && i < m_rows)
              queue[count++] = base | (static_cast<uint32_t>(i) << 17) | k;
          }
          if (__any_sync(FULL, count > SLOTS - 4)) {  // Tier 3
            __syncwarp();
            drain(queue_s[warp], count, lane, n0, m0, gs, PW, rows, rk, ms, cs);
            __syncwarp();
            count = 0;
          }
        }
      }
    }
    __syncwarp();  // the rest of the warp's queues, before the next stage
    drain(queue_s[warp], count, lane, n0, m0, gs, PW, rows, rk, ms, cs);
  }
  __syncthreads();  // every warp's corrections are in corr_s
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < BM; ++i) acc[i] += corr_s[i][lane];
  }
  store_tile(s, acc, out, N, m0, n0, m_rows, accumulate);
}

}  // namespace

// a: uint8[M,K] row-major, w: uint8[K,N] row-major (offset-binary values; only
// the low bits_a / bits_w bits are read), thr: float32[rows], out: int32[M,N];
// seed: device memory holding the two uint32 Philox key words (low, high),
// read by the kernel; a sigma <= 0 draws nothing; target: the blocks plan()
// aims at.  Returns a cudaError_t value.
extern "C" int bitplane_mac_noisy_launch(const void* a, const void* w, const void* thr,
                                         void* out, int M, int N, int K, int bits_a,
                                         int bits_w, int rows, const void* seed,
                                         float mismatch_sigma,
                                         float comparator_sigma, int target,
                                         void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  bool skip = true;
  const int rc = prepare(out, M, N, K, bits_a, bits_w, rows, target, s, &p,
                         &skip, 1);
  if (skip) return rc;
  auto kernel = M <= 4 ? bitplane_mac_noisy_kernel<4> : bitplane_mac_noisy_kernel<8>;
  static bool carveout = false;  // all of L1 as shared memory: 4 blocks fit
  if (!carveout) {
    for (auto k : {bitplane_mac_noisy_kernel<4>, bitplane_mac_noisy_kernel<8>}) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    carveout = true;
  }
  kernel<<<p.grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w),
      static_cast<const float*>(thr), static_cast<int32_t*>(out), M, N, K,
      bits_a, bits_w, rows, p.per_split, p.accumulate,
      static_cast<const uint32_t*>(seed), mismatch_sigma, comparator_sigma);
  return static_cast<int>(cudaGetLastError());
}
