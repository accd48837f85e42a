"""The decomposition of ``csrc/imc_mac.cu``'s M > 16 kernel
(``imc_mac_mma_kernel``, int8 ``mma.sync`` with K split over a thread-block
cluster), emulated in int64 torch ops on the CPU and held bit for bit
against ``imc_mac_torch`` and ``imc_mac_dequant_torch``.

The kernel runs only on the card (``tests/test_torch_cuda.py``); this file
checks, step for step, what it computes:

  * the plan (``ops.imc_mac_plan``, the twin of the C ``imc_mac_plan``):
    64 x 32 output tiles whose M tiles cover every row, clusters of 1, 2, 4
    or 8 splits, launches within ~264 blocks, K-slices of whole 32-deep
    steps, staged 384 K-rows at a time, that cover every K-row once;
  * each lane's 16-byte loads of 4 K-rows x 16 columns, turned by eight
    ``prmt`` (``__byte_perm``) per 4 x 4 byte block into per-column words
    of 4 consecutive k and stored as B^T[n][k] with rows of 4 mod 8 words
    and an XOR of 16 words on the second 16 columns (stores and fragment
    reads free of bank conflicts); A's rows staged as words of 4 k; words
    past the staged steps hold garbage that must never be read;
  * the m16n8k32 ``.s8`` fragments as the kernel reads them (groupID =
    lane/4, threadID_in_group = lane%4), multiplied as the PTX ISA lays the
    A, B and C fragments out, signed products summed in int32, and the C
    fragments stored into the partial tile;
  * the cluster's reduction: each rank sums its share of the tile over every
    rank's partial, starting at its own rank, and stores it once (the int32
    sum or the float32 dequant ``(f32(acc) * sa) * sw[n]``).

Three mutations must fail, each on a named case: groupID and
threadID_in_group swapped in the kernel's B reads; one cluster rank dropped;
the K % 32 tail zero-extended instead of sign-extended.  One small shape is
also held against the JAX reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.imc_mac.ref import imc_mac_dequant_ref, imc_mac_ref
from repro_torch.kernels.imc_mac.ops import (SPLIT_MAX_M, imc_mac_dequant_torch,
                                             imc_mac_plan, imc_mac_torch)
# the split-K kernel's emulation helpers: signed bytes, seeded operands,
# packing, int32 wrap-around, the eight-prmt 4 x 4 byte transpose
from test_torch_imc_mac_split import (_byte, _operands, _pack, _wrap32,
                                      byte_transpose)

BM, BN, WARPS, THREADS = 64, 32, 4, 128
KC = 384                       # K-rows staged at once
SW = KC // 4 + 4               # words per staged row
RED = BN + 8                   # ints per row of the partial tile
TARGET, MAX_SPLITS = 264, 8
GARBAGE = 0x5A5A5A5A           # what unwritten shared memory holds here

# every M in {17, 32, 33, 64, 130}, K in {0, 4, 100, 768, 1030, 3072} and N
# in {1, 31, 129, 768, 3072} appears
SHAPES = [(17, 0, 1), (32, 4, 31), (33, 100, 129), (64, 768, 768),
          (130, 1030, 129), (64, 3072, 768), (32, 768, 3072), (17, 1030, 31),
          (33, 3072, 1), (130, 4, 768), (64, 100, 3072), (17, 768, 129),
          (32, 0, 768), (130, 768, 31)]
# the served prefills (buckets 32 and 64); (64, 768, 3072) is also the macro
# path's projection
PREFILL = [(m, k, n) for m in (32, 64)
           for k, n in ((768, 768), (768, 3072), (3072, 768))]


# ------------------------------------- m16n8k32 .s8 fragments (PTX ISA)
LANE = torch.arange(32)
G, T = LANE // 4, LANE % 4     # groupID, threadID_in_group


def isa_a(reg):
    """A (16 x 32, row): the row and first k of register ``reg`` per lane."""
    return G + 8 * (reg % 2), 4 * T + 16 * (reg // 2)


def isa_b(reg):
    """B (32 x 8, col): the first k and the column of ``reg`` per lane."""
    return 4 * T + 16 * reg, G


def isa_c(reg):
    """C/D (16 x 8, s32): the row and column of ``reg`` per lane."""
    return G + 8 * (reg // 2), 2 * T + reg % 2


def fragment_matrices(a_regs, b_regs):
    """The 16 x 32 A and 32 x 8 B of one ``mma`` from the lanes' registers
    (a_regs [..., 32, 4], b_regs [..., 32, 2] words), laid out as the ISA
    says, bytes sign-extended."""
    amat = torch.zeros(a_regs.shape[:-2] + (16, 32), dtype=torch.int64)
    for reg in range(4):
        row, k0 = isa_a(reg)
        for e in range(4):
            amat[..., row, k0 + e] = _byte(a_regs[..., reg], e, True)
    bmat = torch.zeros(b_regs.shape[:-2] + (32, 8), dtype=torch.int64)
    for reg in range(2):
        k0, col = isa_b(reg)
        for e in range(4):
            bmat[..., k0 + e, col] = _byte(b_regs[..., reg], e, True)
    return amat, bmat


# ------------------------------------------------------- the emulation
def chunks(plan, k):
    """[split] -> [(kc0, steps)]: the chunks the kernel's K loop stages."""
    out = []
    for split in range(plan.splits):
        k_begin = split * plan.k_per_split
        k_end = min(k, k_begin + plan.k_per_split)
        out.append([(kc0, -(-min(KC, k_end - kc0) // 32))
                    for kc0 in range(k_begin, k_end, KC)])
    return out


def stage_b(qw, plan, kc0, steps, n_pad):
    """B^T tiles [splits, grid_x, 32, SW] of one chunk index, as the lanes
    store them: pair p = 2q + c loads K-rows kc0 + 4q + i (i < 4) at
    columns n0 + 16c .. +15 (zeros past K and N), turns each 4 x 4 byte block
    into column words and stores column 16c + 4x + y at word q ^ 16c."""
    k, n = qw.shape
    bp = torch.zeros((k + 4 * KC, n_pad), dtype=torch.int64)
    bp[:k, :n] = qw.to(torch.int64)
    splits, gx = len(kc0), plan.grid_x
    tiles = torch.full((splits, gx, BN, SW), GARBAGE, dtype=torch.int64)
    for s in range(splits):
        if steps[s] == 0:
            continue
        pairs = 16 * steps[s]
        p = torch.arange(pairs)
        q, c = p // 2, p % 2
        rows = kc0[s] + 4 * q[:, None] + torch.arange(4)          # [P, 4]
        cols = (32 * torch.arange(gx))[:, None, None] + 16 * c[None, :, None] \
            + torch.arange(16)                                     # [gx, P, 16]
        byts = bp[rows[None, :, :, None], cols[:, :, None, :]]     # [gx,P,4,16]
        words = _pack(byts.reshape(gx, pairs, 4, 4, 4))         # [gx,P,4i,4x]
        for x in range(4):
            cw = byte_transpose(*words[..., x].unbind(-1))         # y: [gx, P]
            for y in range(4):
                tiles[s, :, 16 * c + 4 * x + y, q ^ (16 * c)] = cw[y]
    return tiles


def stage_a(qa, plan, kc0, steps):
    """A tiles [grid_z, splits, 64, SW]: rows below live16 of the tile, words
    of 4 k below 8 * steps (zeros past M and K); the rest garbage."""
    m, k = qa.shape
    ap = torch.zeros((plan.grid_z * BM, k + 4 * KC), dtype=torch.int64)
    ap[:m, :k] = qa.to(torch.int64)
    tiles = torch.full((plan.grid_z, len(kc0), BM, SW), GARBAGE,
                       dtype=torch.int64)
    for z in range(plan.grid_z):
        live16 = -(-min(BM, m - z * BM) // 16) * 16
        for s in range(len(kc0)):
            words = 8 * steps[s]
            seg = ap[z * BM:z * BM + live16, kc0[s]:kc0[s] + 4 * words]
            tiles[z, s, :live16, :words] = _pack(seg.reshape(live16, words, 4))
    return tiles


def partial_tiles(qa, qw, plan, swap_b=False, zero_tail=False):
    """Every block's partial tile [grid_z, splits, grid_x, 64, RED] after its
    K loop: the fragments read as the kernel reads them, multiplied as the
    ISA lays them out, accumulated in int32, stored as the kernel stores
    the C fragments (rows of dead warps keep their garbage)."""
    m, k = qa.shape
    gz, gy, gx = plan.grid_z, plan.splits, plan.grid_x
    acc = torch.zeros((gz, gy, gx, WARPS, 4, 32, 4), dtype=torch.int64)
    per_split = chunks(plan, k)
    tail = 32 * (k // 32)  # bytes at k >= tail lie in the K % 32 tail
    for ch in range(max(len(c) for c in per_split)):
        kc0 = [c[ch][0] if ch < len(c) else 0 for c in per_split]
        steps = [c[ch][1] if ch < len(c) else 0 for c in per_split]
        a_t = stage_a(qa, plan, kc0, steps)                        # [z,y,64,SW]
        b_t = stage_b(qw, plan, kc0, steps, gx * BN)               # [y,x,32,SW]
        smax = max(steps)
        if smax == 0:
            continue
        s_ = torch.arange(smax)
        # A registers: af = {ar0[8s+t], ar1[8s+t], ar0[8s+4+t], ar1[8s+4+t]}
        w_ = torch.arange(WARPS)[:, None, None]
        a_rows = [16 * w_ + G + 8 * (r % 2) for r in range(4)]      # [W,1,32]
        a_words = [8 * s_[:, None] + 4 * (r // 2) + T for r in range(4)]
        a_regs = torch.stack([a_t[:, :, a_rows[r], a_words[r]]
                              for r in range(4)], -1)         # [z,y,W,S,32,4]
        # B registers: row 8f+g, words (8s+t)^sw and (8s+4+t)^sw
        f_ = torch.arange(4)[:, None, None]
        gi, ti = (T, G) if swap_b else (G, T)
        b_rows = 8 * f_ + gi
        b_words = [(8 * s_[:, None] + 4 * r + ti) ^ (16 * (f_ // 2))
                   for r in range(2)]
        b_regs = torch.stack([b_t[:, :, b_rows, b_words[r]]
                              for r in range(2)], -1)         # [y,x,F,S,32,2]
        # the products, step by step; steps past a split's count are skipped
        for s in range(smax):
            amat, bmat = fragment_matrices(a_regs[:, :, :, s],
                                           b_regs[:, :, :, s])
            if zero_tail:  # the mutant: tail bytes read as unsigned
                kk = torch.tensor(kc0)[:, None] + 32 * s + torch.arange(32)
                tail_k = kk >= tail                                # [y, 32]
                amat = torch.where(tail_k[None, :, None, None, :], amat & 255,
                                   amat)
                bmat = torch.where(tail_k[:, None, None, :, None], bmat & 255,
                                   bmat)
            d = torch.einsum("zywrk,yxfkn->zyxwfrn", amat, bmat)
            live = torch.tensor([s < st for st in steps])          # [y]
            d = d * live[None, :, None, None, None, None, None]
            for reg in range(4):
                row, col = isa_c(reg)
                acc[..., reg] = _wrap32(acc[..., reg] + d[..., row, col])
    red = torch.full((gz, gy, gx, BM, RED), GARBAGE, dtype=torch.int64)
    for z in range(gz):
        for w in range(WARPS):
            if 16 * w >= m - z * BM:
                continue  # a dead warp stores nothing
            for f in range(4):  # int2 (acc[f][0..1]) at row g, (2..3) at g+8
                for reg in range(4):
                    red[z, :, :, 16 * w + G + 8 * (reg // 2),
                        8 * f + 2 * T + reg % 2] = acc[z, :, :, w, f, :, reg]
    return red


def reduce_and_flush(red, plan, m, n, drop=None, dequant=None):
    """Each rank sums the int4 units i with (i // 128) % splits == rank over
    the cluster, from rank, rank + 1, ... (mod splits), and stores the units
    below N once: int32, or the float32 dequant ``(f32(acc) * sa) * sw``."""
    gz, gy, gx = plan.grid_z, plan.splits, plan.grid_x
    out = torch.full((m, n), -(1 << 40), dtype=torch.int64)
    stores = torch.zeros((m, n), dtype=torch.int64)
    for z in range(gz):
        live = min(BM, m - z * BM)
        i = torch.arange(live * BN // 4)
        rank = (i // THREADS) % gy
        r, c4 = i // (BN // 4), 4 * (i % (BN // 4))
        cols = c4[:, None] + torch.arange(4)                       # [I, 4]
        s = torch.zeros((gx, len(i), 4), dtype=torch.int64)
        for j in range(gy):
            src = (rank + j) % gy
            keep = 1 if drop is None else (src != drop)[None, :, None]
            v = red[z, src[:, None], :, r[:, None], cols]          # [I, 4, gx]
            s = _wrap32(s + v.permute(2, 0, 1) * keep)
        for x in range(gx):
            nn = 32 * x + cols
            ok = nn < n
            rows = (z * BM + r)[:, None].expand_as(nn)
            out[rows[ok], nn[ok]] = s[x][ok]
            stores[rows[ok], nn[ok]] += 1
    assert bool((stores == 1).all()), "every output is stored exactly once"
    acc = out.to(torch.int32)
    if dequant is None:
        return acc
    sa, sw = dequant
    return acc.to(torch.float32) * sa * sw


def emulate(qa, qw, dequant=None, drop=None, **mutation):
    m, k = qa.shape
    n = qw.shape[1]
    plan = imc_mac_plan(m, n, k)
    assert plan.rows == 0
    red = partial_tiles(qa, qw, plan, **mutation)
    return reduce_and_flush(red, plan, m, n, drop=drop, dequant=dequant)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("m,k,n", SHAPES + PREFILL)
def test_plan_tiles_clusters_and_k_rows(m, k, n):
    plan = imc_mac_plan(m, n, k)
    assert m > SPLIT_MAX_M and plan.rows == 0
    assert plan.grid_x == -(-n // BN)
    assert (plan.grid_z - 1) * BM < m <= plan.grid_z * BM  # M tiles cover M
    assert plan.grid_y == plan.splits and plan.splits in (1, 2, 4, 8)
    assert plan.k_per_split % 32 == 0
    blocks = plan.grid_x * plan.grid_y * plan.grid_z
    steps = -(-k // 32)
    assert plan.splits == 1 or blocks <= TARGET
    # doubling once more would leave the target, the cluster or K's steps
    assert plan.splits == MAX_SPLITS or 2 * blocks > TARGET or \
        steps < 2 * plan.splits
    rows = [kc0 + 4 * q + i for split in chunks(plan, k)
            for kc0, st in split for q in range(8 * st) for i in range(4)
            if kc0 + 4 * q + i < k]
    assert sorted(rows) == list(range(k))
    assert all(st <= KC // 32 for split in chunks(plan, k) for _, st in split)


@pytest.mark.parametrize("m,k,n", PREFILL)
def test_prefill_launches_fill_the_card(m, k, n):
    plan = imc_mac_plan(m, n, k)
    assert 132 <= plan.grid_x * plan.grid_y * plan.grid_z <= TARGET
    assert len(chunks(plan, k)[0]) == 1  # one staging, one round trip


def test_plan_dispatch_rule():
    assert imc_mac_plan(16, 768, 768).rows == 16
    assert imc_mac_plan(17, 768, 768)[:5] == (0, 24, 8, 1, 8)
    assert imc_mac_plan(64, 3072, 768) == (0, 96, 2, 1, 2, 384)
    assert imc_mac_plan(64, 768, 3072) == (0, 24, 8, 1, 8, 384)
    assert imc_mac_plan(512, 3072, 768)[:5] == (0, 96, 1, 8, 1)


def test_bank_conflict_free_layouts():
    """B^T stores (a warp's 32 lanes: 16 quads x 2 column halves) and the
    A/B fragment reads each touch 32 distinct banks; the partial tile's
    int2 stores distinct banks per half-warp."""
    p = torch.arange(32) + 32 * 3  # any warp of pairs
    q, c = p // 2, p % 2
    for x in range(4):
        for y in range(4):
            addr = (16 * c + 4 * x + y) * SW + (q ^ (16 * c))
            assert len(set((addr % 32).tolist())) == 32
    for f in range(4):
        for r in range(2):
            addr = (8 * f + G) * SW + ((8 * 5 + 4 * r + T) ^ (16 * (f // 2)))
            assert len(set((addr % 32).tolist())) == 32
    for r in range(4):
        addr = (16 + G + 8 * (r % 2)) * SW + 8 * 2 + 4 * (r // 2) + T
        assert len(set((addr % 32).tolist())) == 32
    for half in (G < 4, G >= 4):
        addr = (G * RED + 8 + 2 * T)[half]
        words = torch.cat([addr, addr + 1]) % 32
        assert len(set(words.tolist())) == 32


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_mma_decomposition_matches_plain(m, k, n):
    qa, qw, rng = _operands(m, k, n, m * 7919 + k * 31 + n)
    assert torch.equal(emulate(qa, qw), imc_mac_torch(qa, qw))
    sa = torch.tensor(0.0123)
    sw = torch.from_numpy(rng.uniform(0.001, 0.1, n).astype(np.float32))
    out = emulate(qa, qw, dequant=(sa, sw))
    assert torch.equal(out.view(torch.int32),
                       imc_mac_dequant_torch(qa, qw, sa, sw).view(torch.int32))


@pytest.mark.parametrize("m,k,n,fill", [(33, 768, 129, (-128, -128)),
                                        (64, 1030, 31, (-128, 127)),
                                        (17, 100, 768, (127, -127)),
                                        (32, 2048, 8, (127, -127))])
def test_extreme_operands_and_deep_k(m, k, n, fill):
    qa, qw, _ = _operands(m, k, n, k + n, fill)
    out = emulate(qa, qw)
    assert torch.equal(out, imc_mac_torch(qa, qw))
    assert bool((out == fill[0] * fill[1] * k).all())


def test_matches_the_jax_reference():
    qa, qw, rng = _operands(37, 103, 41, 5)
    sa = np.float32(0.0123)
    sw = rng.uniform(0.001, 0.1, 41).astype(np.float32)
    ref = np.asarray(imc_mac_ref(jnp.asarray(qa.numpy()),
                                 jnp.asarray(qw.numpy())))
    np.testing.assert_array_equal(emulate(qa, qw).numpy(), ref)
    dq_ref = np.asarray(imc_mac_dequant_ref(
        jnp.asarray(qa.numpy()), jnp.asarray(qw.numpy()), sa,
        jnp.asarray(sw)))
    dq = emulate(qa, qw, dequant=(torch.tensor(sa), torch.from_numpy(sw)))
    np.testing.assert_array_equal(dq.numpy().view(np.int32),
                                  dq_ref.view(np.int32))


# ----------------------------------------------------------------- mutations
def test_mutation_b_map_group_and_thread_swapped_fails():
    qa, qw, _ = _operands(33, 100, 129, 1)  # case (33, 100, 129)
    assert not torch.equal(emulate(qa, qw, swap_b=True),
                           imc_mac_torch(qa, qw))


def test_mutation_dropped_cluster_rank_fails():
    qa, qw, _ = _operands(64, 768, 768, 2)  # case (64, 768, 768): 8 ranks
    plan = imc_mac_plan(64, 768, 768)
    assert plan.splits == 8
    assert not torch.equal(emulate(qa, qw, drop=plan.splits - 1),
                           imc_mac_torch(qa, qw))


def test_mutation_zero_extended_tail_fails():
    qa, qw, _ = _operands(17, 1030, 31, 3)  # case (17, 1030, 31): 6-byte tail
    assert not torch.equal(emulate(qa, qw, zero_tail=True),
                           imc_mac_torch(qa, qw))
    qa, qw, _ = _operands(17, 1024, 31, 3)  # no tail: the mutant is silent
    assert torch.equal(emulate(qa, qw, zero_tail=True), imc_mac_torch(qa, qw))
