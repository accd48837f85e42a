"""The word arithmetic of ``csrc/rbl_decode_mac.cu``, emulated in int64 torch
ops on the CPU and held bit for bit against ``rbl_decode_mac_torch``.

The kernel runs only on the card (``tests/test_torch_cuda.py``); this file
checks, step for step, what it computes:

  * the plan (``ops.rbl_decode_mac_plan``, the twin of the C
    ``rbl_decode_mac_plan``): K split over a cluster of 1-8 blocks, each
    block's groups over its K-partitions and staged in chunks that fit its
    shared memory, covering every real K-group exactly once;
  * the loads: a W row's bytes as little-endian 32-bit words of four
    columns (N padded with zeros), masked with 0x01010101 (bit 0 of each
    byte), and A's bit 0 of each byte as int32 0/1;
  * four outputs per word: a group's counts as ``sum_r wmask_r * a_bit``,
    each at most ``rows`` in its byte;
  * the decode from registers: ``c | (c >> 12)`` as prmt selector nibbles
    (byte order 0, 2, 1, 3); rows <= 8 through two table words and the sign
    bit for count 8, rows 9-32 through five 8-entry banks and a prmt tree by
    the counts' bits 3-5;
  * byte accumulation: the decoded words summed for up to floor(255/rows)
    groups, then widened into int32 (the byte order undone);
  * the meeting: a block's K-partitions and then the cluster's splits summed
    in int32, in shuffled orders.

Thresholds: calibrated, detuned ``[1.9, thr[:-1]]``, random descending and
non-monotone; operand bytes 0-255, the plain version given ``x & 1``.  Four
mutations must fail: a dropped split, a byte accumulator one group past its
widening interval, a padded group decoded, bit 1 counted.  One small shape
is also held against the JAX reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rbl_decode.ref import rbl_decode_mac_ref
from repro_torch.kernels.bitplane_mac.ops import physics_thresholds
from repro_torch.kernels.rbl_decode.ops import (physics_voltages,
                                                rbl_decode_mac_plan,
                                                rbl_decode_mac_torch)

WARPS, COLS, SM_BYTES, MAX_SPLITS = 4, 8, 45056, 8
BIT0 = 0x01010101
U32 = 0xFFFFFFFF


def _prmt(lo, hi, sel):
    """PTX prmt.b32, default mode, on int64 tensors of 32-bit values: byte n
    is byte (sel >> 4n) & 7 of {hi, lo}, or its top bit replicated when bit
    3 of that nibble is set."""
    lo, hi, sel = (torch.as_tensor(x, dtype=torch.int64) for x in (lo, hi,
                                                                   sel))
    v = (hi << 32) | lo
    out = torch.zeros(torch.broadcast_shapes(v.shape, sel.shape),
                      dtype=torch.int64)
    for n in range(4):
        s = (sel >> (4 * n)) & 15
        b = (v >> (8 * (s & 7))) & 255
        b = torch.where((s & 8) != 0, torch.where((b & 128) != 0, 255, 0), b)
        out |= b << (8 * n)
    return out


def table_words(thr, rows):
    """dec[0..39] as ten little-endian words: #{i : thr[i] >= V(k)} for
    k <= rows, zero past rows."""
    v = physics_voltages(rows, "cpu")
    dec = torch.zeros(40, dtype=torch.int64)
    dec[:rows + 1] = (v[:, None] <= thr[None, :]).sum(1)
    return [int(sum(int(dec[4 * i + b]) << (8 * b) for b in range(4)))
            for i in range(10)]


def decode8(c, t):
    """Counts <= 8 in each byte -> decoded bytes, byte order (0, 2, 1, 3)."""
    sel = c | (c >> 12)
    d8 = (t[2] & 255) * BIT0
    return _prmt(t[0], t[1], sel) | (_prmt(0x80, 0, sel) & d8)


def decode32(c, t):
    """Counts <= 32 in each byte -> decoded bytes, byte order (0, 2, 1, 3)."""
    lo = c & 0x07070707
    hi = (c >> 3) & 0x07070707
    sl, sh = lo | (lo >> 12), hi | (hi >> 12)
    s1 = 0x3210 | ((sh & 0x1111) << 2)
    s2 = 0x3210 | ((sh & 0x2222) << 1)
    s3 = 0x3210 | (sh & 0x4444)
    b01 = _prmt(_prmt(t[0], t[1], sl), _prmt(t[2], t[3], sl), s1)
    b23 = _prmt(_prmt(t[4], t[5], sl), _prmt(t[6], t[7], sl), s1)
    return _prmt(_prmt(b01, b23, s2), _prmt(t[8], t[9], sl), s3)


def unpermute(b):
    """A decoded word's bytes (order 0, 2, 1, 3) -> [..., 4] columns."""
    return torch.stack([b & 255, (b >> 16) & 255, (b >> 8) & 255,
                        (b >> 24) & 255], -1)


def wrap32(x):
    x = x & U32
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def thread_groups(plan, k, rows):
    """[split][part] -> the K-groups a thread of that K-partition decodes, in
    its order: chunk by chunk, groups part, part + parts, ... of each."""
    groups = -(-k // rows) if k > 0 else 0
    parts = (WARPS // plan.warps_m) * (32 // plan.lanes_n)
    out = []
    for y in range(plan.grid_y):
        g0 = min(groups, y * plan.groups_per_split)
        g1 = min(groups, g0 + plan.groups_per_split)
        seqs = [[] for _ in range(parts)]
        for c0 in range(g0, g1, plan.groups_per_chunk):
            c1 = min(g1, c0 + plan.groups_per_chunk)
            for p in range(parts):
                seqs[p] += list(range(c0 + p, c1, parts))
        out.append(seqs)
    return out


def emulate(a, w, thr, rows, order=None, drop=None, span_extra=0,
            padded_group=False, mask=BIT0):
    """The kernel's arithmetic on bytes a [M, K], w [K, N]: int32 [M, N].
    ``order``: the splits' summation order; the rest are mutations."""
    m, k = a.shape
    n = w.shape[1]
    plan = rbl_decode_mac_plan(m, n, k, rows)
    q = -(-n // 4)
    wp = torch.zeros((k, 4 * q), dtype=torch.int64)
    wp[:, :n] = w.to(torch.int64)
    words = (wp.reshape(k, q, 4) << torch.tensor([0, 8, 16, 24])).sum(-1)
    words = words & mask                                  # [K, Q]
    abits = a.to(torch.int64) & 1                         # [M, K]
    t = table_words(thr, rows)
    decode = decode32 if rows > 8 else decode8
    span = 255 // rows + span_extra
    partials = []
    for seqs in thread_groups(plan, k, rows):
        block = torch.zeros((m, 4 * q), dtype=torch.int64)
        for seq in seqs:
            if padded_group and seq:
                seq = seq + [-(-k // rows)]  # one group past the last
            acc = torch.zeros((m, q, 4), dtype=torch.int64)
            bacc = torch.zeros((m, q), dtype=torch.int64)
            pend = 0
            for g in seq:
                r0, r1 = g * rows, min(k, (g + 1) * rows)
                cnt = (abits[:, r0:r1] @ words[r0:r1]) & U32 if r1 > r0 \
                    else torch.zeros((m, q), dtype=torch.int64)
                if pend == span:
                    acc += unpermute(bacc)
                    bacc.zero_()
                    pend = 0
                pend += 1
                bacc = (bacc + decode(cnt, t)) & U32
            acc += unpermute(bacc)
            block = wrap32(block + acc.reshape(m, 4 * q))
        partials.append(block)
    order = range(len(partials)) if order is None else order
    out = torch.zeros((m, 4 * q), dtype=torch.int64)
    for y in order:
        if y != drop:
            out = wrap32(out + partials[y])
    return out[:, :n].to(torch.int32)


def thresholds(rows, rng):
    good = physics_thresholds(rows, "cpu")
    v = physics_voltages(rows, "cpu")
    rand = np.sort(rng.uniform(float(v[-1]), float(v[0]), rows))[::-1]
    return {"calibrated": good,
            "detuned": torch.cat([torch.tensor([1.9]), good[:-1]]),
            "random": torch.from_numpy(rand.astype(np.float32)),
            "nonmonotone": torch.from_numpy(
                rng.uniform(0.0, 2.0, rows).astype(np.float32))}


def ragged_k(rows, base):
    """The first K >= base that is a multiple of none of rows, 4 and 16."""
    k = base
    while k % rows == 0 or k % 4 == 0:
        k += 1
    return k


def operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.uint8))
    w = torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.uint8))
    return a, w, rng


# every rows in 2..32 with M cycling over {1, 4, 5, 64}, K a multiple of
# none of rows, 4 and 16, N ragged
WORD_CASES = [(rows, (1, 4, 5, 64)[rows % 4], ragged_k(rows, 9 * rows + 5),
               (5, 13, 33)[rows % 3]) for rows in range(2, 33)]


@pytest.mark.parametrize("rows,m,k,n", WORD_CASES)
def test_words_match_plain(rows, m, k, n):
    a, w, rng = operands(m, k, n, 100 * rows + m)
    plan = rbl_decode_mac_plan(m, n, k, rows)
    for name, thr in thresholds(rows, rng).items():
        order = rng.permutation(plan.grid_y)
        out = emulate(a, w, thr, rows, order=order)
        assert torch.equal(out, rbl_decode_mac_torch(a & 1, w & 1, thr,
                                                     rows=rows)), name


@pytest.mark.parametrize("m,k,n,rows", [
    (4, 768, 768, 8), (4, 3072, 768, 8), (4, 768, 3072, 8),
    (64, 768, 3072, 8), (1, 3, 1, 2), (5, 0, 7, 8), (200, 1030, 31, 32),
    (17, 3072, 129, 9), (64, 100, 1, 16), (8, 70000, 3, 3)])
def test_plan_covers_every_group_once(m, k, n, rows):
    plan = rbl_decode_mac_plan(m, n, k, rows)
    assert plan.rows_per_thread == (4 if m <= 4 else 8)
    assert plan.warps_m == (1 if m <= 8 else 4)
    assert plan.lanes_n in (8, 16, 32) and plan.grid_y in (1, 2, 4, 8)
    bm, bn = plan.rows_per_thread * plan.warps_m, COLS * plan.lanes_n
    assert plan.grid_x == -(-n // bn) and plan.grid_z == -(-m // bm)
    # a chunk's A bits (int32) and W bytes fit the block's shared memory
    cg = plan.groups_per_chunk
    assert cg >= 1 and cg * rows * (4 * bm + bn) + 16 <= SM_BYTES
    seen = sorted(g for split in thread_groups(plan, k, rows)
                  for seq in split for g in seq)
    assert seen == list(range(-(-k // rows) if k else 0))


def test_plan_at_the_users_shapes():
    """Decode (M = 4): narrow tiles and 8 splits, ~96-192 blocks; the sweep
    (M = 64): 32-row tiles, 8 splits, 192 blocks."""
    for (k, n), (ln, blocks) in {(768, 768): (8, 96), (3072, 768): (8, 96),
                                 (768, 3072): (16, 192)}.items():
        plan = rbl_decode_mac_plan(4, n, k, 8)
        assert (plan.lanes_n, plan.grid_x * plan.grid_y) == (ln, blocks)
    plan = rbl_decode_mac_plan(64, 3072, 768, 8)
    assert plan[:6] == (8, 4, 32, 12, 8, 2)
    assert plan.groups_per_split == 12


@pytest.mark.parametrize("rows", [2, 8, 9, 16, 31, 32])
def test_decode_words_equal_the_table(rows):
    """Four counts a word, every count 0..rows, against a direct lookup."""
    rng = np.random.default_rng(rows)
    dec = rng.integers(0, rows + 1, 40)
    dec[rows + 1:] = 0
    t = [int(sum(int(dec[4 * i + b]) << (8 * b) for b in range(4)))
         for i in range(10)]
    c = torch.from_numpy(rng.integers(0, rows + 1, (4096, 4)))
    c[:rows + 1, 0] = torch.arange(rows + 1)
    words = (c << torch.tensor([0, 8, 16, 24])).sum(-1)
    got = unpermute((decode32 if rows > 8 else decode8)(words, t))
    assert torch.equal(got, torch.from_numpy(dec)[c])


@pytest.mark.parametrize("rows", [2, 8, 9, 32])
def test_dense_operands_widen_exactly(rows):
    """Every count is ``rows`` (all bytes 255): the byte accumulators reach
    floor(255/rows) * rows before each widening."""
    m, k, n = 64, MAX_SPLITS * (255 // rows + 1) * rows, 8
    a = torch.full((m, k), 255, dtype=torch.uint8)
    w = torch.full((k, n), 255, dtype=torch.uint8)
    seqs = thread_groups(rbl_decode_mac_plan(m, n, k, rows), k, rows)
    assert max(len(s) for split in seqs for s in split) > 255 // rows
    thr = physics_thresholds(rows, "cpu")
    assert torch.equal(emulate(a, w, thr, rows),
                       rbl_decode_mac_torch(a & 1, w & 1, thr, rows=rows))


def test_matches_the_jax_reference():
    a, w, _ = operands(5, 103, 37, 5)
    bits = (a & 1).numpy().astype(np.int8), (w & 1).numpy().astype(np.int8)
    ref = np.asarray(rbl_decode_mac_ref(jnp.asarray(bits[0]),
                                        jnp.asarray(bits[1]), rows=8,
                                        mode="physics"))
    out = emulate(a, w, physics_thresholds(8, "cpu"), 8)
    np.testing.assert_array_equal(out.numpy(), ref)


# ----------------------------------------------------------------- mutations
def test_mutation_dropped_split_fails():
    a, w, _ = operands(4, 768, 129, 1)
    thr = physics_thresholds(8, "cpu")
    plain = rbl_decode_mac_torch(a & 1, w & 1, thr)
    assert rbl_decode_mac_plan(4, 129, 768, 8).grid_y > 1
    assert torch.equal(emulate(a, w, thr, 8), plain)
    assert not torch.equal(emulate(a, w, thr, 8, drop=3), plain)


def test_mutation_byte_accumulator_past_its_interval_fails():
    m, k, n = 64, 2048, 8
    a = torch.full((m, k), 255, dtype=torch.uint8)
    w = torch.full((k, n), 255, dtype=torch.uint8)
    thr = physics_thresholds(8, "cpu")
    plain = rbl_decode_mac_torch(a & 1, w & 1, thr)
    assert torch.equal(emulate(a, w, thr, 8), plain)
    assert not torch.equal(emulate(a, w, thr, 8, span_extra=1), plain)


def test_mutation_padded_group_decoded_fails():
    a, w, rng = operands(5, 100, 31, 2)
    thr = thresholds(8, rng)["detuned"]  # a zero count decodes to 1
    plain = rbl_decode_mac_torch(a & 1, w & 1, thr)
    assert torch.equal(emulate(a, w, thr, 8), plain)
    assert not torch.equal(emulate(a, w, thr, 8, padded_group=True), plain)


def test_mutation_bit_one_counted_fails():
    a, w, _ = operands(4, 100, 31, 3)  # bytes 0-255: bit 1 set in half
    thr = physics_thresholds(8, "cpu")
    plain = rbl_decode_mac_torch(a & 1, w & 1, thr)
    assert torch.equal(emulate(a, w, thr, 8), plain)
    assert not torch.equal(emulate(a, w, thr, 8, mask=0x03030303), plain)
