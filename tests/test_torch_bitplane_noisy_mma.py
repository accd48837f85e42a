"""The arithmetic of ``csrc/bitplane_mac_noisy.cu``'s tensor-core kernel
(``bitplane_mac_noisy_mma_kernel``: rows 8, 8 x 8 bits, M >= 9), emulated in
int64 torch ops on the CPU and held bit for bit against
``bitplane_mac_noisy_torch``.

The kernel runs only on the card (``tests/test_torch_cuda.py``); this file
checks its arithmetic, step for step, where the CPU tests run.  The group
counts come from the same emulated ``mma.sync`` words as
``bitplane_mac_mma_kernel``'s (``bitplane_lanes``: the fragments, the 16^j
weights that leave four groups' counts in a word's nibbles, pad nibbles of
8 for the groups past ceil(K/8)), and then:

  * tier 2: the noise-free decode of every count by ``prmt`` over dec0[0..7]
    and ``dp4a`` (Horner over p), its counts of 8 by the m16n8k16 of the
    groups' byte ANDs times dec0[8]; the NEED test by a second ``prmt`` of
    the same word over NEED bytes (1 where a draw can change the count's
    decode, top bit clear, so a nibble of 8 reads 0) and, for the counts of
    8, ``prmt(0x80, 0, word)`` (0xff exactly at a nibble of 8) masked to the
    real groups when NEED[8] holds;
  * the warp-aggregated append: each lane's entry count (0..16 a mma) in
    five bits, one ballot a bit, the lane's offset sum_b 2^b popc(ballot_b
    & lanes below) and the warp's total sum_b 2^b popc(ballot_b); entries
    of 26 bits (k 4, q 3, p 3, the group within the 16-group chunk 4, tile
    column 6, tile row 6) in sixteen predicated slots, and the queue
    drained past 768 - 512 entries and at each chunk's end;
  * tier 3: each entry unpacked into its global (n, m, group, pair) and k,
    and ``tier3_decode`` (the arithmetic of ``test_torch_bitplane_noisy_skip``
    's ``emulate``): the correction (dec - dec0[k]) 2^(p+q) into the tile.

Cases: M in {17, 33, 64}, ragged K (a partial group, a partial k-step) and
N, calibrated / stress / comparator-only sigmas, calibrated and detuned
thresholds, dense 255 operands (every count 8: every element drawn), and
the mma plan's split of K against one split (the group field reaching 15).
Three mutations must each break a case: the NEED table off by one count,
the count-8 path dropped, an entry's group field one bit short.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitplane_lanes import (A16, A32, B16, B32, D_OWN, MASK32, _dp4a, _mma,
                            _pack, _prmt, tier3_decode)
from repro.kernels.bitplane_mac.ops import bitplane_mac as j_bitplane_mac
from repro_torch.kernels.bitplane_mac.ops import (LAUNCHED_NOISY,
                                                  NOISY_MMA_MIN_M,
                                                  NOISY_MMA_TARGET,
                                                  bitplane_mac_noisy_torch,
                                                  bitplane_mma_plan,
                                                  bitplane_noisy_kernel,
                                                  noisy_skip_tables,
                                                  physics_thresholds)
from repro_torch.kernels.common import seed_words

ROWS = PLANES = 8
BM = BN = 64     # a block's output tile
STEP = 32        # K-rows of a k-step
KC = 128         # K-rows of a staged chunk (16 groups)
NQ_CAP, NQ_BATCH = 768, 32 * 16  # a warp's queue; the most one mma appends
# entry fields: name -> (shift, width)
FIELDS = {"k": (0, 4), "q": (4, 3), "p": (7, 3), "group": (10, 4),
          "col": (14, 6), "row": (20, 6)}
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def pack(fields, **v):
    e = 0
    for name, (shift, width) in fields.items():
        e = e | ((v[name] & ((1 << width) - 1)) << shift)
    return e


def unpack(fields, e):
    return {name: (e >> shift) & ((1 << width) - 1)
            for name, (shift, width) in fields.items()}


def popc(x):
    """Bits set in each 32-bit value of an int64 tensor."""
    return sum((x >> i) & 1 for i in range(32))


def append_offsets(n):
    """The kernel's warp-aggregated append over the lane axis (last, 32) of
    ``n`` (each lane's entry count, 0..16): one ballot per bit of the
    counts, the lane's offset sum_b 2^b popc(ballot_b & lanes below) and the
    warp's total sum_b 2^b popc(ballot_b); (each lane's offset, the warp's
    total)."""
    below = (1 << torch.arange(32)) - 1
    at = torch.zeros_like(n)
    total = torch.zeros(n.shape[:-1], dtype=torch.int64)
    for b in range(5):
        v = (((n >> b) & 1) << torch.arange(32)).sum(-1)   # the ballot
        at += popc(v[..., None] & below) << b
        total += popc(v) << b
    return at, total


def need_bytes(d, need_lo, need_hi, n8, *, count8=True):
    """Tier 2's NEED word of each mma output word d: byte j is 1 where
    group j's count needs a draw."""
    got = _prmt(need_lo, need_hi, d)
    if count8:
        got = got | (_prmt(torch.tensor(0x80), torch.tensor(0), d) & n8)
    return got


# ------------------------------------------------------------ the kernel
def noisy_mma_emulation(ua, uw, seed, thr, ms, cs, *, per_split=None,
                        mutation=None, stats=None):
    """The kernel's arithmetic: int32[M, N].  ``per_split``: k-steps a
    block takes (the plan's when None).  ``stats`` (a dict) gets the tier-3
    share and the most a warp's queue held."""
    m, k = ua.shape
    n = uw.shape[1]
    groups = -(-k // ROWS)
    steps = -(-groups // 4)
    plan = bitplane_mma_plan(m, n, k, NOISY_MMA_TARGET)
    per = per_split or plan.per_split
    mp, np_ = BM * plan.grid_y, BN * plan.grid_x
    dec0, need, cut = noisy_skip_tables(thr, ROWS, ms or None, cs or None)
    if mutation == "need_off_by_one":  # need[k] read from count k - 1
        need = torch.cat([need[:1], need[:-1]])
    fields = dict(FIELDS)
    if mutation == "group_short":  # the group field one bit short
        fields.update(group=(10, 3), col=(13, 6), row=(19, 6))
    key = seed_words(seed)

    def table(vals):  # bytes 0..3 of a prmt table
        return torch.tensor(sum(int(v) << (8 * i) for i, v in enumerate(vals)))

    dec_lo, dec_hi = table(dec0[:4]), table(dec0[4:8])
    need_lo, need_hi = table(need[:4]), table(need[4:8])
    t = torch.arange(32) % 4
    sa = torch.stack([4 * (t >> 1)] * 2 + [4 * (t >> 1) + 2] * 2, -1)

    a = torch.zeros((mp, STEP * steps), dtype=torch.int64)
    w = torch.zeros((STEP * steps, np_), dtype=torch.int64)
    a[:m, :k] = ua
    w[:k, :n] = uw
    at = a.reshape(mp // 16, 16, steps, STEP).permute(2, 0, 1, 3)
    wt = w.reshape(steps, STEP, np_ // 8, 8).permute(0, 2, 1, 3)
    ra = _pack(at, A32)[:, :, None]                   # [S, R, 1, 32, 4]
    rb = _pack(wt, B32)[:, None]                      # [S, 1, C, 32, 2]
    real = groups - 4 * torch.arange(steps)
    pad = torch.where(real >= 4, 0,
                      0x8888 & (0xFFFF << (4 * real.clamp(1, 4))))
    n8 = torch.where(real >= 4, 0x01010101,
                     0x01010101 & ((1 << (8 * real.clamp(1, 4))) - 1))
    if not need[8]:
        n8 = torch.zeros_like(n8)
    pad, n8 = (x.reshape(-1, 1, 1, 1, 1) for x in (pad, n8))

    # each lane's entries: the tile position of its words, the group of
    # their k-step within its chunk and the chunk's first group
    lane = torch.arange(32)
    R, C = mp // 16, np_ // 8
    s_idx = torch.arange(steps)
    st = (s_idx - s_idx // per * per) % 4
    gc = (s_idx - st) * 4
    row0 = (16 * (torch.arange(R) % 4)).reshape(1, R, 1, 1) + \
        (lane // 4).reshape(1, 1, 1, 32)
    col0 = (8 * (torch.arange(C) % 8)).reshape(1, 1, C, 1) + \
        (2 * (lane % 4)).reshape(1, 1, 1, 32)
    # a warp: (row tile, column tile, row half, column half); its mma
    # (mi, ni): the row fragment's and column fragment's place in it
    warp_of = (((torch.arange(R) // 4) * (C // 8)).reshape(1, R, 1) +
               (torch.arange(C) // 8).reshape(1, 1, C)) * 4 + \
        (torch.arange(R) % 4 // 2).reshape(1, R, 1) * 2 + \
        (torch.arange(C) % 8 // 4).reshape(1, 1, C)
    order = (torch.arange(C) % 4).reshape(1, 1, C) * 2 + \
        (torch.arange(R) % 2).reshape(1, R, 1)            # ni, mi
    warp_of, order = (x.expand(steps, R, C) for x in (warp_of, order))
    # the words x (bit 8 j + x) of elements inside M x N
    rows = (16 * torch.arange(R)).reshape(R, 1, 1, 1) + \
        (lane // 4).reshape(1, 1, 32, 1) + 8 * (torch.arange(4) >> 1)
    cols = (8 * torch.arange(C)).reshape(1, C, 1, 1) + \
        (2 * (lane % 4)).reshape(1, 1, 32, 1) + (torch.arange(4) & 1)
    inside = ((rows < m) & (cols < n)).long()            # [R, C, 32, 4]
    edge = sum(inside[..., x] << x for x in range(4)) * 0x01010101

    part = torch.zeros(ra.shape[:2] + rb.shape[2:3] + (32, 4),
                       dtype=torch.int64)
    totals, entries = [], []
    for p in reversed(range(PLANES)):
        ap = ((ra >> p) & 0x01010101) << sa
        part = (part << 1) & MASK32
        for q in range(PLANES):
            b0 = (rb[..., 0] >> q) & 0x01010101
            b1 = ((rb[..., 1] >> q) & 0x01010101) << 6
            d = _mma(ap, torch.stack([b0, b1], -1), pad, A32, B32)
            part = _dp4a(_prmt(dec_lo, dec_hi, d), 0x01010101 << q, part)
            nb = need_bytes(d, need_lo, need_hi, n8,
                            count8=mutation != "count8_dropped")
            word = sum(nb[..., x] << x for x in range(4))  # bit 8 j + x
            if need[0]:  # the words of rows past M, columns past N
                word = word & edge
            nl = popc(word)
            off, total = append_offsets(nl)
            assert torch.equal(off, torch.cumsum(nl, -1) - nl)
            assert torch.equal(total, nl.sum(-1))
            totals.append(total)
            for j in range(4):
                for x in range(4):
                    i = 8 * j + x
                    sel = ((word >> i) & 1) != 0
                    if not bool(sel.any()):
                        continue
                    kk = (d[..., x] >> (4 * j)) & 15
                    e = pack(fields, k=kk, q=q, p=p,
                             group=(4 * st + j).reshape(-1, 1, 1, 1),
                             col=col0 + (x & 1), row=row0 + 8 * (x >> 1))
                    ss, rr, cc, _ = sel.nonzero(as_tuple=True)
                    entries.append((ss, warp_of[ss, rr, cc], e[sel]))

    # the queue: per warp, appends in the kernel's order (k-step, p from 7
    # down, q, ni, mi), at offsets below NQ_CAP; drained past NQ_CAP -
    # NQ_BATCH and at each chunk's end
    n_warps = int(warp_of.max()) + 1
    tot = torch.stack(totals, 1)          # [S, 64 pairs, R, C]
    held = 0
    for s in range(steps):
        if st[s] == 0:  # a chunk starts: its queue is empty
            count = torch.zeros(n_warps, dtype=torch.int64)
        for e in range(tot.shape[1]):
            for u in range(8):
                at_u = order[s] == u
                count = count + torch.zeros_like(count).index_add_(
                    0, warp_of[s][at_u], tot[s, e][at_u])
                held = max(held, int(count.max()))
                assert held <= NQ_CAP
                count = torch.where(count > NQ_CAP - NQ_BATCH, 0, count)

    # tier 3: every entry, unpacked into its element
    entries = entries or [(torch.zeros(0, dtype=torch.int64),) * 3]
    ss = torch.cat([x[0] for x in entries])
    wp = torch.cat([x[1] for x in entries])
    e = torch.cat([x[2] for x in entries])
    f = unpack(fields, e)
    tiles_x = np_ // BN
    tile = wp // 4
    mm = (tile // tiles_x) * BM + f["row"]
    nn = (tile % tiles_x) * BN + f["col"]
    gg = gc[ss] + f["group"]
    assert bool(((mm < m) & (nn < n)).all())
    got, _ = (torch.zeros(0, dtype=torch.int64), 0) if not e.numel() else \
        tier3_decode(key, nn, mm, gg, f["p"] * PLANES + f["q"], f["k"], thr,
                     ROWS, ms, cs, dec0, cut)
    corr = ((got - dec0[f["k"]].to(torch.int64)) << (f["p"] + f["q"]))
    if stats is not None:
        stats.update(tier3=e.numel() / (m * n * groups * PLANES * PLANES),
                     most_queued=held)

    # the noise-free sums, the counts of 8, the corrections
    acc = part.sum(0)
    x = a.reshape(mp, -1, 4)
    x = sum(x[..., i] << (8 * i) for i in range(4))
    y = x[:, 0::2] & x[:, 1::2]
    y &= y >> 16
    y &= y >> 8
    fa = y & 255                                           # [mp, G]
    fw = w.reshape(-1, 8, np_)
    fw = fw[:, 0] & fw[:, 1] & fw[:, 2] & fw[:, 3] & fw[:, 4] & fw[:, 5] & \
        fw[:, 6] & fw[:, 7]                                # [G, np]
    for c0 in range(0, fa.shape[1], 16):                   # per chunk
        fa_c = torch.nn.functional.pad(fa[:, c0:c0 + 16],
                                       (0, 16 - fa[:, c0:c0 + 16].shape[1]))
        fw_c = torch.nn.functional.pad(fw[c0:c0 + 16],
                                       (0, 0, 0, 16 - fw[c0:c0 + 16].shape[0]))
        a16 = _pack(fa_c.reshape(mp // 16, 16, 16), A16)[:, None]
        b16 = _pack(fw_c.reshape(16, np_ // 8, 8).permute(1, 0, 2), B16)[None]
        acc = acc + int(dec0[8]) * _mma(a16, b16, 0, A16, B16)
    out = torch.zeros((mp // 16, np_ // 8, 128), dtype=torch.int64)
    out[..., D_OWN.flatten()] = acc.flatten(-2)
    out = out.reshape(mp // 16, np_ // 8, 16, 8).permute(0, 2, 1, 3)
    out = out.reshape(mp, np_)
    out.index_put_((mm, nn), corr, accumulate=True)
    out = out[:m, :n] & MASK32
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


# ---------------------------------------------------------------- cases
SIGMAS = {"calibrated": (0.05, 0.0), "stress": (0.3, 0.03),
          "comparator": (0.0, 0.03), "mismatch 0.3": (0.3, 0.0)}


def _thr(kind):
    good = physics_thresholds(ROWS, "cpu")
    if kind == "calibrated":
        return good
    return torch.cat([torch.tensor([1.9]), good[:-1]])  # detuned


def _operands(kind, m, k, n, seed):
    if kind == "dense":
        return (torch.full((m, k), 255, dtype=torch.int32),
                torch.full((k, n), 255, dtype=torch.int32))
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.int32)))


def _plain(ua, uw, seed, thr, ms, cs):
    return bitplane_mac_noisy_torch(ua, uw, seed, thr, mismatch_sigma=ms or None,
                                    comparator_offset_sigma=cs or None)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small int64 ops: one intra-op thread a test worker keeps
    parallel workers from starving each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("m,k,n,sigmas,thr_kind,operands", [
    (17, 300, 40, "calibrated", "calibrated", "random"),  # a partial group
    (33, 140, 24, "calibrated", "detuned", "random"),     # a partial k-step
    (64, 100, 20, "calibrated", "calibrated", "random"),
    (17, 100, 20, "stress", "calibrated", "random"),
    (33, 72, 9, "stress", "detuned", "random"),
    (64, 40, 12, "comparator", "calibrated", "random"),
    (17, 64, 20, "calibrated", "calibrated", "dense"),    # every count 8
    (33, 36, 9, "stress", "calibrated", "dense"),
    (64, 36, 8, "comparator", "detuned", "dense")])
def test_noisy_mma_arithmetic_matches_plain(m, k, n, sigmas, thr_kind,
                                            operands):
    ms, cs = SIGMAS[sigmas]
    thr = _thr(thr_kind)
    ua, uw = _operands(operands, m, k, n, m * 1009 + k * 31 + n)
    stats = {}
    out = noisy_mma_emulation(ua, uw, 11, thr, ms, cs, stats=stats)
    assert torch.equal(out, _plain(ua, uw, 11, thr, ms, cs))
    assert 0 < stats["most_queued"] <= NQ_CAP
    need = noisy_skip_tables(thr, ROWS, ms or None, cs or None)[1]
    if operands == "dense":  # every count 8: all drawn where NEED[8]
        assert stats["tier3"] == float(need[8])
    elif (sigmas, thr_kind) == ("calibrated", "calibrated"):
        assert 0.05 < stats["tier3"] < 0.2  # counts 4-8: ~11.4%


@pytest.mark.parametrize("m,k,n,sigmas", [(17, 520, 12, "mismatch 0.3"),
                                          (33, 400, 9, "calibrated")])
def test_any_split_of_k_gives_the_same_output(m, k, n, sigmas):
    """The draws depend on the element alone: the plan's split of K (one
    k-step a block here), one split (the group field up to 15) and two
    k-steps a block give the plain version's output."""
    ms, cs = SIGMAS[sigmas]
    thr = _thr("calibrated")
    ua, uw = _operands("random", m, k, n, k)
    plain = _plain(ua, uw, 5, thr, ms, cs)
    steps = -(-(-(-k // 8)) // 4)
    for per in (None, steps, 2):
        assert torch.equal(noisy_mma_emulation(ua, uw, 5, thr, ms, cs,
                                               per_split=per), plain), per


def test_zero_sigma_equals_the_jax_reference():
    """Without a sigma nothing is drawn: the noise-free decode, equal to the
    reference's interpreted kernel."""
    rng = np.random.default_rng(2)
    ua = torch.from_numpy(rng.integers(0, 256, (33, 256)).astype(np.int32))
    uw = torch.from_numpy(rng.integers(0, 256, (256, 20)).astype(np.int32))
    thr = _thr("calibrated")
    stats = {}
    out = noisy_mma_emulation(ua, uw, 1, thr, 0.0, 0.0, stats=stats)
    assert stats["tier3"] == 0.0
    ref = np.asarray(j_bitplane_mac(jnp.asarray(ua.numpy()),
                                    jnp.asarray(uw.numpy()),
                                    jnp.asarray(thr.numpy()), bits_a=8,
                                    bits_w=8, interpret=True))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("mutation,m,k,n,sigmas,operands,per", [
    ("need_off_by_one", 17, 100, 20, "mismatch 0.3", "random", None),
    ("count8_dropped", 17, 64, 20, "calibrated", "dense", None),
    ("group_short", 17, 520, 9, "mismatch 0.3", "random", "one split")])
def test_mutations_are_caught(mutation, m, k, n, sigmas, operands, per):
    ms, cs = SIGMAS[sigmas]
    thr = _thr("calibrated")
    ua, uw = _operands(operands, m, k, n, 7)
    per = -(-(-(-k // 8)) // 4) if per else None
    plain = _plain(ua, uw, 3, thr, ms, cs)
    assert torch.equal(noisy_mma_emulation(ua, uw, 3, thr, ms, cs,
                                           per_split=per), plain)
    assert not torch.equal(noisy_mma_emulation(
        ua, uw, 3, thr, ms, cs, per_split=per, mutation=mutation), plain)


def test_append_offsets_are_an_exclusive_scan():
    """Every lane count 0..16 (five bits), including all 16 (the dense
    worst case, 512 entries a mma): the offsets number the entries 0..total
    - 1, each once."""
    g = torch.Generator().manual_seed(4)
    n = torch.cat([torch.randint(0, 17, (200, 32), generator=g),
                   torch.full((1, 32), 16), torch.zeros((1, 32),
                                                        dtype=torch.int64)])
    at, total = append_offsets(n)
    assert torch.equal(total, n.sum(-1)) and int(total.max()) == NQ_BATCH
    for row in range(n.shape[0]):
        slots = torch.cat([at[row, ln] + torch.arange(n[row, ln])
                           for ln in range(32)])
        assert torch.equal(torch.sort(slots).values,
                           torch.arange(int(total[row])))


def test_need_words_from_the_nibble_words():
    """Every word of four counts 0..8 (pad nibbles of 8 included), every
    NEED table: byte j of the NEED word is need[count j] for a real group,
    0 for a pad one; without the count-8 path a real count of 8 reads 0."""
    g = torch.Generator().manual_seed(6)
    counts = torch.randint(0, 9, (4000, 4), generator=g)
    counts[:9, 0] = torch.arange(9)
    d = sum(counts[:, j] << (4 * j) for j in range(4))
    for trial in range(40):
        need = torch.rand(9, generator=g) < 0.5
        lo = torch.tensor(sum(int(need[i]) << (8 * i) for i in range(4)))
        hi = torch.tensor(sum(int(need[4 + i]) << (8 * i) for i in range(4)))
        for real in (1, 2, 3, 4):
            n8 = (0x01010101 & ((1 << (8 * real)) - 1)) if need[8] else 0
            pad = 0x8888 & (0xFFFF << (4 * real)) if real < 4 else 0
            dd = (d & ~pad) | pad if real < 4 else d
            cnt = torch.where(torch.arange(4) < real, counts, 8)
            got = need_bytes(dd, lo, hi, torch.tensor(n8))
            want = sum((need[cnt[:, j]] & (j < real)).long() << (8 * j)
                       for j in range(4))
            assert torch.equal(got, want), (trial, real)
            no8 = need_bytes(dd, lo, hi, torch.tensor(n8), count8=False)
            want8 = sum((need[cnt[:, j]] & (cnt[:, j] < 8)).long() << (8 * j)
                        for j in range(4))
            assert torch.equal(no8, want8)


def test_entry_fields_round_trip():
    """26 bits rebuild (row, column, group, p, q, k) of a 64 x 64 tile and a
    16-group chunk; a group field one bit short loses groups 8-15."""
    g = torch.Generator().manual_seed(8)
    v = {name: torch.randint(0, 1 << width, (5000,), generator=g)
         for name, (_, width) in FIELDS.items()}
    v["k"] = v["k"] % 9
    e = pack(FIELDS, **v)
    assert int(e.max()) < 1 << 26
    back = unpack(FIELDS, e)
    assert all(torch.equal(back[name], v[name]) for name in FIELDS)
    short = dict(FIELDS, group=(10, 3), col=(13, 6), row=(19, 6))
    lost = unpack(short, pack(short, **v))["group"]
    assert not torch.equal(lost, v["group"])
    assert torch.equal(lost, v["group"] % 8)


def test_dispatch_twin_and_the_c_rule():
    """``ops.bitplane_noisy_kernel`` is ``bitplane_mac_noisy_launch``'s rule:
    the tensor-core kernel for rows 8 at 8 x 8 bits from NOISY_MMA_MIN_M
    rows up (the C constant equal to the twin's), the 8-row-tile kernel for the
    decode step and every other case; each ``*kernel = i`` follows the
    launch of ``LAUNCHED_NOISY[i]``."""
    src = (SRC / "bitplane_mac_noisy.cu").read_text()
    assert f"constexpr int NOISY_MMA_MIN_M = {NOISY_MMA_MIN_M};" in src
    assert f"constexpr int NOISY_MMA_TARGET = {NOISY_MMA_TARGET};" in src
    assert "mma_plan(M, N, K, NOISY_MMA_TARGET)" in src
    body = src[src.index('extern "C" int bitplane_mac_noisy_launch('):]
    body = body[:body.index("\n}\n")]
    assert "M >= NOISY_MMA_MIN_M" in body
    sets = re.findall(r"\*kernel = (\d+);", body)
    assert sets[0] == "0" and sorted(sets[1:]) == ["1", "2"]
    for i in (1, 2):
        before = body[:body.index(f"*kernel = {i};")]
        launched = re.findall(r"(\w+)(?:<\w+>)?<<<", before)[-1]
        assert launched == LAUNCHED_NOISY[i], (i, launched)
    assert 4 < NOISY_MMA_MIN_M <= 16  # decode (4 slots) stays; buckets move
    for m in range(1, 600):
        want = ("bitplane_mac_noisy_mma_kernel" if m >= NOISY_MMA_MIN_M
                else "bitplane_mac_noisy_kernel")
        assert bitplane_noisy_kernel(m, 8, 8, 8) == want
        assert bitplane_noisy_kernel(m, 4, 8, 8) == "bitplane_mac_noisy_kernel"
        assert bitplane_noisy_kernel(m, 8, 8, 16) == \
            "bitplane_mac_noisy_kernel"
