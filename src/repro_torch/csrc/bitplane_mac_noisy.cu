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
// Two kernels, one launch a call; bitplane_mac_noisy_launch picks one by the
// shapes (ops.bitplane_noisy_kernel is the rule's twin) and reports it:
//
// bitplane_mac_noisy_mma_kernel -- the served case (rows 8, 8 x 8 bits) at
//   M >= NOISY_MMA_MIN_M: the prefill buckets and training's M = 512.
//   What bounds it there: one training forward's 72 projections at M = 512
//   are 3.48e11 group counts, of which uniform operands leave ~11.4% for a
//   Philox call (~4e10, 95 ms at 40 integer operations each); the kernel
//   below spent ~8 issue slots a count on tier 2 (popc, table read, the
//   queue) and restaged W for every 8 rows.  This one takes the counts from
//   bitplane_mac.cu's tensor-core kernel (bitplane_mma.cuh: 64 x 64 tiles,
//   mma.sync.m16n8k32 on 0/1 plane bytes weighted 16^j, four groups' counts
//   in one word's nibbles), its noise-free decode (prmt over dec0[0..7],
//   dp4a, the counts of 8 by the groups' byte ANDs), reads tier 2's NEED
//   test off the same word with a second prmt (and prmt(0x80, 0, word) for
//   the counts of 8, nibble 8), appends the elements that need a draw to a
//   per-warp queue at offsets from ballots, and drains it with every lane
//   busy; the tier-3 arithmetic is the same as below, the corrections
//   go into the block's output tile in shared memory.  Details at the
//   kernel.
//   Measured (chip_smoke.py --noisy-variants, one step's 72 launches from
//   a graph, H100 80GB HBM3 at 700 W): M = 512 470 ms against the
//   8-row-tile kernel's 764-768, bucket 64 68.4-68.9 against 122.5-123.3.  Taken out
//   piece by piece at M = 512: without Philox 346.5 ms, without tier 3
//   226.0, without the queue 199.3, without the appends 97.2, without the
//   offsets 51.5 (the counts, noise-free decode and NEED words): past the
//   NEED words every piece is paid per element drawn (~4e10 of them).
//
// bitplane_mac_noisy_kernel<RL> -- every other case (the decode step, rows
// != 8, other bit widths).
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
#include "bitplane_mma.cuh"

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

__device__ __forceinline__ RoundKeys keys_of(uint32_t k0, uint32_t k1) {
  RoundKeys rk;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    rk.k0[r] = k0 + static_cast<uint32_t>(r) * PHILOX_W0;
    rk.k1[r] = k1 + static_cast<uint32_t>(r) * PHILOX_W1;
  }
  return rk;
}

__device__ __forceinline__ RoundKeys round_keys(const uint32_t* __restrict__ seed) {
  return keys_of(__ldg(seed), __ldg(seed + 1));
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const RoundKeys& rk) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    // 32 x 32 -> 64-bit products (--noisy-variants' philox_hi, __umulhi and
    // a multiply: the tensor-core kernel at M = 512 in 481 ms against 470)
    const uint64_t p0 = static_cast<uint64_t>(PHILOX_M0) * c.x;
    const uint64_t p1 = static_cast<uint64_t>(PHILOX_M1) * c.z;
    const uint32_t hi0 = static_cast<uint32_t>(p0 >> 32);
    const uint32_t lo0 = static_cast<uint32_t>(p0);
    const uint32_t hi1 = static_cast<uint32_t>(p1 >> 32);
    const uint32_t lo1 = static_cast<uint32_t>(p1);
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

// Tier 1, block-collective (every thread of the block calls it; `warps`
// warps): the tables from the live thresholds, rows and sigmas.  tab_s[k]
// = dec0[k] | NEED, and with mismatch alone cut_s[k] for each NEED count
// (warp w searches the w-th, w + warps-th, ... NEED count); cut_s is
// published by the caller's next __syncthreads.
__device__ __forceinline__ void noisy_tables(const float* __restrict__ thr,
                                             int rows, float ms, float cs,
                                             int warps) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float zmax = radius(U1_GRID - 1);
  if (tid < rows) {
    const float t = thr[tid];
    const float reach = cs > 0.f ? __fmul_rn(cs, zmax) : 0.f;
    thr_s[tid] = t;
    tlo_s[tid] = __fsub_rn(t, reach);
    thi_s[tid] = __fadd_rn(t, reach);
  }
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
  if (ms > 0.f && !(cs > 0.f)) {
    int nth = 0;
    for (int k = 0; k <= rows; ++k) {
      if (!(tab_s[k] & NEED)) continue;
      if (nth++ % warps != warp) continue;
      const uint32_t c = first_cut(k, rows, ms, lane);
      if (lane == 0) cut_s[k] = c;
    }
  }
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

  corr_s[tid / BN][tid % BN] = 0;
  noisy_tables(thr, rows, ms, cs, WARPS);  // tier 1

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

// ------------------------------ the served case above NOISY_MMA_MIN_M rows
// rows 8, 8 x 8 bits, M >= NOISY_MMA_MIN_M (the prefill buckets, training):
// bitplane_mac_noisy_mma_kernel.  The decode step (M = 4) keeps the kernel
// above, whose 4- and 8-row tiles win there (chip_smoke.py --noisy-variants,
// 72 launches from a graph: the tensor-core kernel ahead at M = 9, 16, 32,
// 33, 40 and up, behind at M = 4 and 8 and, by 2-8%, at 17 and 24).
constexpr int NOISY_MMA_MIN_M = 9;
// blocks mma_plan aims at, three waves of 3 blocks an SM (--noisy-variants:
// M = 512 in 470 ms against 513 at 528, the noise-free kernel's target, and
// 477 at 792; bucket 64 68.7 against 67.0 and 72.6)
constexpr int NOISY_MMA_TARGET = 1188;
constexpr int NQ_BATCH = 32 * 16;  // the most one mma appends: 16 counts a lane
constexpr int NQ_CAP = 768;        // a warp's queue, drained past NQ_CAP - NQ_BATCH
constexpr int OUT_S = MM_BN + 4;   // the out tile's row stride: 2-way banks at most
// A queue entry, 26 bits: the count k (4), the plane pair q (3) and p (3),
// the K-group within the chunk (4), the tile column (6) and row (6).
constexpr int EQ = 4, EP = 7, EG = 10, EC = 14, ER = 20;
static_assert(MM_GC <= 16 && MM_BM <= 64 && MM_BN <= 64, "entry fields");

struct SmemNoisyMma {
  SmemMma m;                          // bitplane_mma.cuh's staging, 40 KB
  int out[MM_BM][OUT_S];              // the block's output tile, 17 KB
  uint32_t queue[MM_WARPS][NQ_CAP];   // each warp's tier-3 entries, 12 KB
};
extern __shared__ __align__(16) uint8_t noisy_smem[];  // a SmemNoisyMma

__device__ __forceinline__ SmemNoisyMma& noisy_mma_smem() {
  return *reinterpret_cast<SmemNoisyMma*>(noisy_smem);
}

// The Philox counter of an entry's draws 0 and 1, (n, m, group, pair << 8)
// with pair = p * 8 + q (bits EQ..EP + 2 of the entry hold it whole).
__device__ __forceinline__ uint4 mma_counter(uint32_t e, uint32_t m0,
                                             uint32_t n0, uint32_t gc) {
  return make_uint4(n0 + ((e >> EC) & 63u), m0 + (e >> ER),
                    gc + ((e >> EG) & 15u), (e & (63u << EQ)) << (8 - EQ));
}

// The element's decode minus dec0[k], 2^(p+q) times, into its out slot.
__device__ __forceinline__ void mma_correct(uint32_t e, int dec) {
  const int dec0 = static_cast<int>(tab_s[e & 15u] & DEC0);
  if (dec != dec0)
    atomicAdd(&noisy_mma_smem().out[e >> ER][(e >> EC) & 63u],
              (dec - dec0) * (1 << (((e >> EP) & 7u) + ((e >> EQ) & 7u))));
}

// The rare paths, out of line: the full decode of a mismatch-only element
// (a u1 index at or above cut[k]) and every entry under comparator offset.
__device__ __noinline__ int mma_full_decode(int k, uint32_t b1, uint32_t b2,
                                            float ms) {
  return decode_mismatch(k, b1, b2, R8_ROWS, ms);
}

__device__ __noinline__ void mma_resolve_offsets(uint32_t e, uint32_t m0,
                                                 uint32_t n0, uint32_t gc,
                                                 uint32_t key0, uint32_t key1,
                                                 float ms, float cs) {
  mma_correct(e, decode_offsets(static_cast<int>(e & 15u),
                                mma_counter(e, m0, n0, gc), R8_ROWS,
                                keys_of(key0, key1), ms, cs));
}

// Tier 3, warp-collective, out of line (one copy of the Philox rounds for
// the tier-2 loop's eight append sites; inlined at all eight, M = 512 took
// 835 ms against 470: --noisy-variants' inline_drain):
// every entry of the calling warp's queue (count of them, in order), lane l
// taking entries l, l + 32, ...; with mismatch alone two a lane a round
// (two independent Philox calls), settled below cut[k] as dec0[k] (nothing
// to correct).  Nothing is queued without a sigma.
__device__ __noinline__ void mma_drain(int count, uint32_t m0, uint32_t n0,
                                       uint32_t gc, uint32_t key0,
                                       uint32_t key1, float ms, float cs) {
  const int lane = threadIdx.x & 31;
  const uint32_t* queue = noisy_mma_smem().queue[threadIdx.x >> 5];
  if (cs > 0.f) {
    for (int e = lane; e < count; e += 32)
      mma_resolve_offsets(queue[e], m0, n0, gc, key0, key1, ms, cs);
    return;
  }
  const RoundKeys rk = keys_of(key0, key1);
  for (int e = lane; e < count; e += 64) {
    const bool two = e + 32 < count;
    const uint32_t e0 = queue[e];
    const uint32_t e1 = queue[two ? e + 32 : e];
    const uint4 y0 = philox4x32_10(mma_counter(e0, m0, n0, gc), rk);
    const uint4 y1 = philox4x32_10(mma_counter(e1, m0, n0, gc), rk);
    if ((y0.x >> 8) >= cut_s[e0 & 15u])
      mma_correct(e0, mma_full_decode(static_cast<int>(e0 & 15u), y0.x, y0.y,
                                      ms));
    if (two && (y1.x >> 8) >= cut_s[e1 & 15u])
      mma_correct(e1, mma_full_decode(static_cast<int>(e1 & 15u), y1.x, y1.y,
                                      ms));
  }
}

// The warp-aggregated append's offset: this lane's n (0..16) entries go to
// [at, at + n) of the warp's queue, at = count + the entries of the lanes
// below it: one ballot per bit of n, sum_b 2^b __popc(ballot_b & lanes
// below); *added is the warp's total, sum_b 2^b __popc(ballot_b)
// (--noisy-variants' scan_offsets, a warp scan by shuffles: 474 ms at M =
// 512 against 470).
__device__ __forceinline__ int append_offset(int n, int lane, int count,
                                             int* added) {
  const uint32_t below = (1u << lane) - 1u;
  int at = count;
  *added = 0;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const uint32_t v = __ballot_sync(FULL, (n >> b) & 1);
    at += __popc(v & below) << b;
    *added += __popc(v) << b;
  }
  return at;
}

// The lane's entries of one mma at queue[at..]: sixteen predicated slots,
// word x (its row + 8 (x >> 1), column + (x & 1)) and group j, in place of
// a loop over the need word's set bits, whose trip count is the warp's
// most (--noisy-variants' bit_loop: 487 ms at M = 512 against 470).
__device__ __forceinline__ void append_slots(uint32_t* queue, int at,
                                             uint32_t need,
                                             const uint32_t (&d)[4],
                                             uint32_t base) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((need >> (8 * j + x)) & 1u)
        queue[at++] = base | static_cast<uint32_t>(x >> 1) << (ER + 3) |
                      static_cast<uint32_t>(x & 1) << EC |
                      static_cast<uint32_t>(j) << EG | ((d[x] >> (4 * j)) & 15u);
}

// bitplane_mma.cuh's 64 x 64 tiles, 4 warps of 32 x 32, K in chunks of 128
// rows (16 groups) by cp.async, split over blocks by mma_plan; per chunk:
//   tier 2: the group counts by mma, four a word in its nibbles; the
//     noise-free decode by prmt over dec0[0..7] and dp4a (Horner over p) as
//     bitplane_mac_mma_kernel's, its counts of 8 by the m16n8k16 of the
//     groups' byte ANDs times dec0[8]; the NEED bytes (1 where a draw can
//     change the decode) by a second prmt of the same word, and the counts
//     of 8 that need one by prmt(0x80, 0, word) (0xff exactly where a nibble
//     is 8: pad nibbles masked off).  Each mma's entries are appended to the
//     warp's queue at offsets from five ballots of the lanes' entry counts
//     and __popc: no per-lane queue, no owner search.  Past NQ_CAP -
//     NQ_BATCH entries, and at the chunk's end, the warp drains its queue
//     (tier 3).
//   tier 3: mma_drain; corrections into the out tile by shared atomics.
// The noise-free sums go into the out tile once per k-step (each element
// is one lane's); the tile is stored, or added by integer atomics into the
// zeroed output of a split launch, at the end.  Rows past M and columns
// past N count zeros: where a count 0 can need a draw (NEED[0], comparator
// offset only), a block at the edge masks them out of the queue.
__global__ void __launch_bounds__(MM_THREADS, 3)
bitplane_mac_noisy_mma_kernel(const uint8_t* __restrict__ a,
                              const uint8_t* __restrict__ w,
                              const float* __restrict__ thr,
                              int32_t* __restrict__ out, int M, int N, int K,
                              int steps_per_split, bool accumulate, bool vec,
                              const uint32_t* __restrict__ seed, float ms,
                              float cs) {
  SmemNoisyMma& s = noisy_mma_smem();

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
  const bool live1 = m0 + wr + 16 < M;  // and its second 16 rows
  const int sa0 = 4 * (t >> 1);   // the A weights (bitplane_mma.cuh)
  const int sa1 = sa0 + 2;
  const uint32_t key0 = __ldg(seed);
  const uint32_t key1 = __ldg(seed + 1);

  const int chunks = (k_end - k_begin + MM_KC - 1) / MM_KC;
  if (chunks > 0)
    mma_stage(s.m, 0, a, w, M, N, K, m0, n0, k_begin, k_end, vec);
  for (int u = tid; u < MM_BM * OUT_S; u += MM_THREADS) (&s.out[0][0])[u] = 0;
  noisy_tables(thr, R8_ROWS, ms, cs, MM_WARPS);  // tier 1, while chunk 0 lands

  uint32_t dec_lo = 0, dec_hi = 0, dec_8 = 0, need_lo = 0, need_hi = 0;
  bool need_8 = false;
  bool edge = false;  // NEED[0] in a block that holds rows past M or columns past N
  uint32_t* queue = s.queue[warp];
  int count = 0;  // entries in the warp's queue (warp-uniform)
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const int kc = k_begin + c * MM_KC;
    if (c + 1 < chunks) {
      mma_stage(s.m, buf ^ 1, a, w, M, N, K, m0, n0, kc + MM_KC, k_end, vec);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk c has landed (and, at c = 0, the tables)
    mma_full_groups(s.m, buf);
    if (c == 0) {  // dec0[0..7] and the NEED bytes as prmt tables
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dec_lo |= (tab_s[i] & DEC0) << (8 * i);
        dec_hi |= (tab_s[4 + i] & DEC0) << (8 * i);
        need_lo |= (tab_s[i] >> 31) << (8 * i);
        need_hi |= (tab_s[4 + i] >> 31) << (8 * i);
      }
      dec_8 = tab_s[8] & DEC0;
      need_8 = (tab_s[8] & NEED) != 0u;
      edge = (tab_s[0] & NEED) != 0u && (m0 + MM_BM > M || n0 + MM_BN > N);
    }
    __syncthreads();  // fa, fw
    const int step0 = kc / MM_STEP;
    const int nst = min(MM_KC / MM_STEP, s_end - step0);
    const uint32_t gc = static_cast<uint32_t>(kc / R8_ROWS);  // first group
    if (live) {
      for (int st = 0; st < nst; ++st) {
        const int kb = MM_STEP * st;
        const int real = groups - 4 * (step0 + st);
        const uint32_t pad = mma_pad(real);
        // byte j: a count of 8 in group j needs a draw (real groups only)
        const uint32_t n8 = !need_8 ? 0u
                            : real >= 4 ? 0x01010101u
                                        : 0x01010101u & ((1u << (8 * real)) - 1u);
        uint32_t ra[2][4];
        mma_a_frags(s.m, buf, wr, g, t, kb, ra);
        uint32_t rb[4][2];
        mma_w_frags(s.m, buf, wc, g, t, kb, rb);
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
#pragma unroll 1
          for (int q = 0; q < R8_PLANES; ++q) {
            const uint32_t wq = 0x01010101u << q;
            const uint32_t fields = (4u * st) << EG |
                                    static_cast<uint32_t>(p) << EP |
                                    static_cast<uint32_t>(q) << EQ;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const uint32_t b0 = (rb[ni][0] >> q) & 0x01010101u;
              const uint32_t b1 = ((rb[ni][1] >> q) & 0x01010101u) << 6;
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                if (mi == 1 && !live1) continue;  // 16 rows all past M
                uint32_t d[4];
                mma_u8_k32(d, ap[mi], b0, b1, pad);
                uint32_t need = 0;  // bit 8 j + x: group j of word x
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                  part[mi][ni][x] = static_cast<int>(__dp4a(
                      prmt(dec_lo, dec_hi, d[x]), wq,
                      static_cast<uint32_t>(part[mi][ni][x])));
                  need |= (prmt(need_lo, need_hi, d[x]) |
                           (prmt(0x80u, 0u, d[x]) & n8)) << x;
                }
                if (edge) {  // words x of rows past M, columns past N
                  const int mr = M - m0 - (wr + 16 * mi + g);
                  const int nc = N - n0 - (wc + 8 * ni + 2 * t);
                  const uint32_t xm = (mr > 0 && nc > 0 ? 1u : 0u) |
                                      (mr > 0 && nc > 1 ? 2u : 0u) |
                                      (mr > 8 && nc > 0 ? 4u : 0u) |
                                      (mr > 8 && nc > 1 ? 8u : 0u);
                  need &= xm * 0x01010101u;
                }
                // the warp-aggregated append
                int added;
                int at = append_offset(__popc(need), lane, count, &added);
                count += added;
                const uint32_t base =
                    fields | static_cast<uint32_t>(wr + 16 * mi + g) << ER |
                    static_cast<uint32_t>(wc + 8 * ni + 2 * t) << EC;
                append_slots(queue, at, need, d, base);
                if (count > NQ_CAP - NQ_BATCH) {  // tier 3
                  __syncwarp();
                  mma_drain(count, m0, n0, gc, key0, key1, ms, cs);
                  __syncwarp();
                  count = 0;
                }
              }
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              s.out[wr + 16 * mi + g + 8 * (x >> 1)][wc + 8 * ni + 2 * t + (x & 1)] +=
                  part[mi][ni][x];
      }
      // the counts of 8: sum_g FA[m,g] FW[g,n] = sum_{p,q} 2^(p+q) N8, one
      // m16n8k16 over the chunk's 16 groups, times dec0[8]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          uint32_t d[4];
          mma_u8_k16(d, s.m.fa[wr + 16 * mi + g][t], s.m.fa[wr + 16 * mi + g + 8][t],
                     s.m.fw[wc + 8 * ni + g][t]);
#pragma unroll
          for (int x = 0; x < 4; ++x)
            s.out[wr + 16 * mi + g + 8 * (x >> 1)][wc + 8 * ni + 2 * t + (x & 1)] +=
                static_cast<int>(dec_8 * d[x]);
        }
      __syncwarp();  // the chunk's last entries, before its group base moves
      mma_drain(count, m0, n0, gc, key0, key1, ms, cs);
      count = 0;
    }
    __syncthreads();  // buf and fa, fw are read before they are restaged
  }
  __syncthreads();  // every warp's sums and corrections are in the tile
  for (int u = tid; u < MM_BM * MM_BN; u += MM_THREADS) {
    const int r = u / MM_BN;
    const int c = u % MM_BN;
    if (m0 + r < M && n0 + c < N) {
      int32_t* o = out + static_cast<size_t>(m0 + r) * N + n0 + c;
      if (accumulate) {
        atomicAdd(o, s.out[r][c]);
      } else {
        *o = s.out[r][c];
      }
    }
  }
}

}  // namespace

// a: uint8[M,K] row-major, w: uint8[K,N] row-major (offset-binary values; only
// the low bits_a / bits_w bits are read), thr: float32[rows], out: int32[M,N];
// seed: device memory holding the two uint32 Philox key words (low, high),
// read by the kernel; a sigma <= 0 draws nothing; target: the blocks plan()
// aims at for bitplane_mac_noisy_kernel (the tensor-core kernel, rows 8 at
// 8 x 8 bits and M >= NOISY_MMA_MIN_M, plans from the shapes alone).
// *kernel is set to the kernel launched: 0 none (an empty output), 1
// bitplane_mac_noisy_kernel, 2 bitplane_mac_noisy_mma_kernel.  Returns a
// cudaError_t value.
extern "C" int bitplane_mac_noisy_launch(const void* a, const void* w, const void* thr,
                                         void* out, int M, int N, int K, int bits_a,
                                         int bits_w, int rows, const void* seed,
                                         float mismatch_sigma,
                                         float comparator_sigma, int target,
                                         void* stream, int device, int* kernel) {
  *kernel = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const uint8_t*>(a);
  const auto* w8 = static_cast<const uint8_t*>(w);
  const auto* t = static_cast<const float*>(thr);
  auto* o = static_cast<int32_t*>(out);
  const auto* sd = static_cast<const uint32_t*>(seed);
  if (rows == R8_ROWS && bits_a == R8_PLANES && bits_w == R8_PLANES &&
      M >= NOISY_MMA_MIN_M) {
    if (N < 0 || K < 0 || target < 1 || target > MAX_TARGET) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (N == 0) return 0;
    const MmaPlan p = mma_plan(M, N, K, NOISY_MMA_TARGET);
    if (p.accumulate) {
      err = cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(M) * N,
                            s);
      if (err != cudaSuccess || p.steps == 0) return static_cast<int>(err);
    }
    static bool mma_smem = false;  // 70 KB of dynamic shared memory: 3 blocks
    if (!mma_smem) {
      err = cudaFuncSetAttribute(bitplane_mac_noisy_mma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sizeof(SmemNoisyMma)));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(bitplane_mac_noisy_mma_kernel,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
      mma_smem = true;
    }
    bitplane_mac_noisy_mma_kernel<<<p.grid, MM_THREADS, sizeof(SmemNoisyMma), s>>>(
        a8, w8, t, o, M, N, K, p.per_split, p.accumulate, mma_vec(a, w, N, K),
        sd, mismatch_sigma, comparator_sigma);
    *kernel = 2;
    return static_cast<int>(cudaGetLastError());
  }
  Plan p;
  bool skip = true;
  const int rc = prepare(out, M, N, K, bits_a, bits_w, rows, target, s, &p,
                         &skip, 1);
  if (skip) return rc;
  static bool carveout = false;  // all of L1 as shared memory: 4 blocks fit
  if (!carveout) {
    for (auto k : {bitplane_mac_noisy_kernel<4>, bitplane_mac_noisy_kernel<8>}) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    carveout = true;
  }
  if (M <= 4) {
    bitplane_mac_noisy_kernel<4><<<p.grid, THREADS, 0, s>>>(
        a8, w8, t, o, M, N, K, bits_a, bits_w, rows, p.per_split, p.accumulate,
        sd, mismatch_sigma, comparator_sigma);
  } else {
    bitplane_mac_noisy_kernel<8><<<p.grid, THREADS, 0, s>>>(
        a8, w8, t, o, M, N, K, bits_a, bits_w, rows, p.per_split, p.accumulate,
        sd, mismatch_sigma, comparator_sigma);
  }
  *kernel = 1;
  return static_cast<int>(cudaGetLastError());
}
