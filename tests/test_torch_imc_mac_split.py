"""The decomposition of ``csrc/imc_mac.cu``'s split-K kernel
(``imc_mac_splitk_kernel``, M <= 16), emulated in int64 torch ops on the CPU
and held bit for bit against ``imc_mac_torch`` and ``imc_mac_dequant_torch``.

The kernel runs only on the card (``tests/test_torch_cuda.py``); this file
checks, step for step, what it computes:

  * the plan (``ops.imc_mac_plan``, the twin of the C ``imc_mac_plan``):
    K-slices of whole quads (4 K-rows) for each of the block's 4 warps, at
    most 4 quads a warp, that cover every K-row exactly once, also at ragged
    K; one split at K = 0; the tensor-core kernel above M = 16;
  * each lane's 8-byte loads of 4 K-rows split into two 4 x 4 byte blocks,
    turned by eight ``prmt`` (``__byte_perm``) into per-column words of 4
    consecutive k, and one signed ``dp4a`` per row and column with the row's
    A word (bytes past K and rows past M are zeros);
  * the splits' partial sums added in int32 in a shuffled order (the
    blocks' ``atomicAdd`` into the zeroed output);
  * the dequant's flush by the last block of a column tile to arrive, under
    permuted arrival orders, rounded ``(f32(acc) * sa) * sw[n]``.

Three mutations must fail: a dropped split, the K % 4 tail word counted
twice, bytes zero-extended instead of sign-extended.  At one small shape the
emulation is also held against the JAX reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.imc_mac.ref import imc_mac_dequant_ref, imc_mac_ref
from repro_torch.kernels.imc_mac.ops import (SPLIT_MAX_M, imc_mac_dequant_torch,
                                             imc_mac_plan, imc_mac_torch)

WARPS, COLS, GMAX = 4, 8, 4
BN = 32 * COLS

# every M in {1, 3, 4, 5, 9, 16}, K in {0, 4, 100, 768, 1030, 3072} and N in
# {1, 31, 129, 768, 3072} appears
SHAPES = [(1, 0, 1), (3, 4, 31), (4, 100, 129), (5, 768, 768),
          (9, 1030, 3072), (16, 3072, 768), (4, 1030, 31), (16, 4, 1),
          (1, 3072, 129), (3, 768, 3072), (9, 100, 768), (5, 0, 31),
          (16, 1030, 129), (4, 3072, 3072)]


def _prmt(x, y, sel: int):
    """``__byte_perm(x, y, sel)`` on int64 tensors of 32-bit values."""
    v = (y << 32) | x
    out = torch.zeros_like(x)
    for n in range(4):
        out |= ((v >> (8 * ((sel >> (4 * n)) & 7))) & 255) << (8 * n)
    return out


def _byte(w, n, signed=True):
    b = (w >> (8 * n)) & 255
    return torch.where(b >= 128, b - 256, b) if signed else b


def _wrap32(x):
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def _pack(u):
    """int64 bytes [..., 4] -> little-endian 32-bit words [...]."""
    return sum((u[..., i] & 255) << (8 * i) for i in range(4))


def byte_transpose(r0, r1, r2, r3):
    """The kernel's eight prmt: rows (k_i; n_0..n_3) -> words (k_0..k_3; n_j)."""
    t0, t1 = _prmt(r0, r1, 0x5140), _prmt(r0, r1, 0x7362)
    t2, t3 = _prmt(r2, r3, 0x5140), _prmt(r2, r3, 0x7362)
    return [_prmt(t0, t2, 0x5410), _prmt(t0, t2, 0x7632),
            _prmt(t1, t3, 0x5410), _prmt(t1, t3, 0x7632)]


def split_rows(plan, k):
    """[split][warp] -> the K-rows its quads load, in the kernel's order."""
    quads = plan.k_per_split // 4
    g_n = quads // WARPS
    return [[[s * plan.k_per_split + 4 * (w * g_n + g) + i
              for g in range(g_n) for i in range(4)
              if s * plan.k_per_split + 4 * (w * g_n + g) + i < k]
             for w in range(WARPS)] for s in range(plan.splits)]


def split_partials(qa, qw, plan, sign_extend=True, tail_twice=False):
    """Each split's block sums, int32 [splits, tiles, RM, BN]: the lanes'
    loads, transposes and dp4a, the warps met in shared memory."""
    m, k = qa.shape
    n = qw.shape[1]
    rm, tiles = plan.rows, plan.grid_x
    npad = tiles * BN
    a = torch.zeros((rm, k + 4), dtype=torch.int64)
    a[:m, :k] = qa.to(torch.int64)
    b = torch.zeros((k + 4, npad), dtype=torch.int64)
    b[:k, :n] = qw.to(torch.int64)
    quads = plan.k_per_split // 4
    out = torch.zeros((plan.splits, rm, npad), dtype=torch.int64)
    for s in range(plan.splits):
        k0 = s * plan.k_per_split
        kq = k0 + 4 * torch.arange(quads)                     # [Q]
        live = (kq < k).to(torch.int64)                       # quads past K
        rows = (kq[:, None] + torch.arange(4)).clamp(max=k + 3)   # [Q, 4]
        # the lanes' words: row i of the quad, columns 4c..4c+3
        r = _pack(b[rows].reshape(quads, 4, npad // 4, 4))   # [Q, 4, N/4]
        cols = torch.stack(byte_transpose(*r.unbind(1)), -1)  # [Q, N/4, 4]
        cols = cols.reshape(quads, npad) * live[:, None]
        aw = _pack(a[:, (kq[:, None] + torch.arange(4)).clamp(max=k + 3)])
        prod = sum(_byte(aw, i, sign_extend)[:, :, None] *   # [RM, Q, N]
                   _byte(cols, i, sign_extend)[None] for i in range(4))
        acc = prod.sum(1)
        if tail_twice and k % 4:  # the mutant: the partial quad once more
            acc = acc + prod[:, (kq < k) & (kq > k - 4)].sum(1)
        out[s] = _wrap32(acc)
    return out.reshape(plan.splits, rm, tiles, BN).transpose(1, 2)


def emulate_mac(qa, qw, order, drop=None, **mutation):
    """imc_mac: the partials added into the zeroed output in ``order``."""
    m, n = qa.shape[0], qw.shape[1]
    plan = imc_mac_plan(m, n, qa.shape[1])
    parts = split_partials(qa, qw, plan, **mutation)
    acc = torch.zeros(parts.shape[1:], dtype=torch.int64)
    for s in order:
        if s != drop:
            acc = _wrap32(acc + parts[s])
    out = acc.transpose(0, 1).reshape(plan.rows, -1)[:m, :n]
    return out.to(torch.int32)


def emulate_dequant(qa, qw, sa, sw, arrivals):
    """imc_mac_dequant: blocks (split, tile) arrive in ``arrivals``; each adds
    its sums into the scratch, then the one that brings its tile's counter to
    ``splits`` flushes the tile from the scratch."""
    m, n = qa.shape[0], qw.shape[1]
    plan = imc_mac_plan(m, n, qa.shape[1])
    parts = split_partials(qa, qw, plan)
    scratch = torch.zeros(parts.shape[1:], dtype=torch.int64)
    counter = [0] * plan.grid_x
    out = torch.full((plan.rows, plan.grid_x * BN), float("nan"))
    swp = torch.zeros(plan.grid_x * BN)
    swp[:n] = sw
    flushed = 0
    for s, t in arrivals:
        scratch[t] = _wrap32(scratch[t] + parts[s, t])
        counter[t] += 1
        if counter[t] == plan.splits:
            acc = scratch[t].to(torch.int32).to(torch.float32)
            out[:, t * BN:(t + 1) * BN] = acc * sa * swp[t * BN:(t + 1) * BN]
            flushed += 1
    assert flushed == plan.grid_x, "every tile flushes exactly once"
    return out[:m, :n]


def _operands(m, k, n, seed, fill=None):
    rng = np.random.default_rng(seed)
    qa = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    if fill is not None:
        qa.fill_(fill[0])
        qw.fill_(fill[1])
    return qa, qw, rng


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plan_covers_every_k_row_once(m, k, n):
    plan = imc_mac_plan(m, n, k)
    assert plan.rows == (4 if m <= 4 else 16)
    assert plan.grid_x == -(-n // BN) and plan.grid_z == 1
    assert plan.grid_y == plan.splits >= 1
    quads = plan.k_per_split // 4
    assert plan.k_per_split % (4 * WARPS) == 0 and quads // WARPS <= GMAX
    rows = [r for split in split_rows(plan, k) for warp in split for r in warp]
    assert sorted(rows) == list(range(k))
    if k:
        assert (plan.splits - 1) * plan.k_per_split < k


def test_plan_dispatch_rule_and_decode_grids():
    assert SPLIT_MAX_M == 16
    assert imc_mac_plan(17, 768, 768).rows == 0
    assert imc_mac_plan(64, 3072, 768)[:5] == (0, 96, 2, 1, 2)
    # decode (M = 4): 144-192 blocks, one wave
    for k, n, blocks in ((768, 768, 144), (768, 3072, 192),
                         (3072, 768, 192)):
        plan = imc_mac_plan(4, n, k)
        assert plan.grid_x * plan.splits == blocks


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_split_decomposition_matches_plain(m, k, n):
    qa, qw, rng = _operands(m, k, n, m * 7919 + k * 31 + n)
    plan = imc_mac_plan(m, n, k)
    order = rng.permutation(plan.splits)
    plain = imc_mac_torch(qa, qw)
    assert torch.equal(emulate_mac(qa, qw, order), plain)
    sa = torch.tensor(0.0123)
    sw = torch.from_numpy(rng.uniform(0.001, 0.1, n).astype(np.float32))
    blocks = [(s, t) for s in range(plan.splits) for t in range(plan.grid_x)]
    for _ in range(2):
        arrivals = [blocks[i] for i in rng.permutation(len(blocks))]
        out = emulate_dequant(qa, qw, sa, sw, arrivals)
        assert torch.equal(out.view(torch.int32),
                           imc_mac_dequant_torch(qa, qw, sa, sw).view(
                               torch.int32))


@pytest.mark.parametrize("m,k,n,fill", [(4, 768, 129, (-128, -128)),
                                        (9, 1030, 31, (-128, 127)),
                                        (3, 100, 768, (127, -127)),
                                        (8, 2048, 8, (127, -127))])
def test_extreme_operands_and_deep_k(m, k, n, fill):
    qa, qw, rng = _operands(m, k, n, k + n, fill)
    order = rng.permutation(imc_mac_plan(m, n, k).splits)
    out = emulate_mac(qa, qw, order)
    assert torch.equal(out, imc_mac_torch(qa, qw))
    assert bool((out == fill[0] * fill[1] * k).all())


def test_matches_the_jax_reference():
    qa, qw, rng = _operands(5, 103, 37, 5)
    plan = imc_mac_plan(5, 37, 103)
    sa = np.float32(0.0123)
    sw = rng.uniform(0.001, 0.1, 37).astype(np.float32)
    ref = np.asarray(imc_mac_ref(jnp.asarray(qa.numpy()),
                                 jnp.asarray(qw.numpy())))
    out = emulate_mac(qa, qw, rng.permutation(plan.splits))
    np.testing.assert_array_equal(out.numpy(), ref)
    dq_ref = np.asarray(imc_mac_dequant_ref(
        jnp.asarray(qa.numpy()), jnp.asarray(qw.numpy()), sa,
        jnp.asarray(sw)))
    blocks = [(s, 0) for s in rng.permutation(plan.splits)]
    dq = emulate_dequant(qa, qw, torch.tensor(sa), torch.from_numpy(sw),
                         blocks)
    np.testing.assert_array_equal(dq.numpy().view(np.int32),
                                  dq_ref.view(np.int32))


# ----------------------------------------------------------------- mutations
def test_mutation_dropped_split_fails():
    qa, qw, _ = _operands(4, 768, 129, 1)
    plan = imc_mac_plan(4, 129, 768)
    order = list(range(plan.splits))
    assert torch.equal(emulate_mac(qa, qw, order), imc_mac_torch(qa, qw))
    assert not torch.equal(emulate_mac(qa, qw, order, drop=plan.splits - 1),
                           imc_mac_torch(qa, qw))


def test_mutation_tail_word_twice_fails():
    qa, qw, _ = _operands(5, 1030, 31, 2)  # 1030 % 4 == 2: a partial quad
    order = range(imc_mac_plan(5, 31, 1030).splits)
    assert not torch.equal(emulate_mac(qa, qw, order, tail_twice=True),
                           imc_mac_torch(qa, qw))
    qa, qw, _ = _operands(5, 1028, 31, 2)  # no tail: the mutant is silent
    order = range(imc_mac_plan(5, 31, 1028).splits)
    assert torch.equal(emulate_mac(qa, qw, order, tail_twice=True),
                       imc_mac_torch(qa, qw))


def test_mutation_zero_extended_bytes_fails():
    qa, qw, _ = _operands(4, 100, 31, 3)
    order = range(imc_mac_plan(4, 31, 100).splits)
    assert not torch.equal(emulate_mac(qa, qw, order, sign_extend=False),
                           imc_mac_torch(qa, qw))
