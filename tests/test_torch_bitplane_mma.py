"""The arithmetic of ``csrc/bitplane_mac.cu``'s tensor-core kernel
(``bitplane_mac_mma_kernel``: rows 8, 8 x 8 bits, M > 8), emulated in int64
torch ops on the CPU and held bit for bit against ``bitplane_mac_torch``
and the JAX reference's interpreted Pallas kernel.

The kernel runs only on the card (``tests/test_torch_cuda.py``); this file
checks its arithmetic, step for step, where the CPU tests run:

  * the staging: 64 x 64 output tiles, K in chunks of 128 rows (four
    k-steps of 32), zeros past M, N and the end of the block's split;
  * the fragments of ``mma.sync.m16n8k32`` (and ``m16n8k16``) with ``.u8``
    operands, lane = 4 g + t: which lane's register holds which (row, k) of
    A, (k, column) of B, and which (row, column) of the s32 output;
  * the packing: slot k of a k-step holds K-row 32 s + k, of group j =
    k / 8, one bit plane a byte, A's byte weighted alpha_j and B's beta_j,
    alpha_j beta_j = 16^j (a0/a1: alpha 16^(t/2), beta 1; a2/a3: alpha
    4 x 16^(t/2), beta 64), so one mma leaves group j's count in nibble j
    of each output word;
  * groups past ceil(K/8) (in the last k-step) get 8 in their nibble from
    the accumulator input: they decode to 0, never as dec[0];
  * the decode: the output word is the ``prmt`` selector over the table
    dec[0..7] in two words; a count of 8 (nibble 8) replicates dec[0]'s top
    bit, 0, and dec[8] times the number of groups whose count is 8 comes
    back through a second product: sum_g FA[m,g] FW[g,n], FA and FW the
    AND of a group's 8 bytes (bit p set where plane p is one in all 8
    rows), one m16n8k16 per chunk;
  * ``dp4a`` with byte weights 2^q, Horner over p from 7 down within a
    k-step, and the splits' partial sums added in shuffled order (integer
    atomics), all modulo 2^32.

Thresholds: calibrated, the detuned ``[1.9, thr[:-1]]`` (a zero count
decodes to 1: a padded group read as dec[0] shows) and a random descending
set between V(8) and V(0); operands random or all 255 (every count 8).
Three mutations of the emulation must each break a case: the pad nibbles
left out, the counts of 8 not added back, and the A weights of the two
group pairs swapped.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitplane_lanes import (A16, A32, B16, B32, D_OWN, MASK32, _dp4a, _mma,
                            _pack, _prmt)
from repro.kernels.bitplane_mac.ops import bitplane_mac as j_bitplane_mac
from repro_torch.core.rbl import rbl_voltage_physics
from repro_torch.kernels.bitplane_mac.ops import (LAUNCHED, R8_MAX_M,
                                                  bitplane_kernel,
                                                  bitplane_mac_torch,
                                                  bitplane_mma_plan,
                                                  decode_counts,
                                                  physics_thresholds)

ROWS = PLANES = 8
BM = BN = 64     # a block's output tile
STEP = 32        # K-rows of a k-step
KC = 128         # K-rows of a staged chunk


# ------------------------------------------------------------ the kernel
def mma_emulation(ua, uw, thr, *, mutation=None, seed=0):
    """The kernel's arithmetic: int32[M, N]."""
    m, k = ua.shape
    n = uw.shape[1]
    groups = -(-k // ROWS)
    steps = -(-groups // 4)
    plan = bitplane_mma_plan(m, n, k)
    mp, np_ = BM * plan.grid_y, BN * plan.grid_x
    dec = [int(v) for v in decode_counts(torch.arange(ROWS + 1.0), thr,
                                         ROWS)]
    dec_lo = torch.tensor(sum(dec[i] << (8 * i) for i in range(4)))
    dec_hi = torch.tensor(sum(dec[4 + i] << (8 * i) for i in range(4)))
    t = torch.arange(32) % 4                            # each lane's t
    # shifts of the A registers' bytes: alpha = 16^(t/2) (a0, a1),
    # 4 x 16^(t/2) (a2, a3)
    sa = torch.stack([4 * (t >> 1)] * 2 + [4 * (t >> 1) + 2] * 2, -1)
    if mutation == "alpha":  # the two group pairs' A weights swapped
        sa = torch.stack([4 * (t >> 1) + 2] * 2 + [4 * (t >> 1)] * 2, -1)

    # the operands as the blocks stage them: zeros past M, N and K (a
    # split's rows past its k_end belong to k-steps it does not run)
    a = torch.zeros((mp, STEP * steps), dtype=torch.int64)
    w = torch.zeros((STEP * steps, np_), dtype=torch.int64)
    a[:m, :k] = ua
    w[:k, :n] = uw
    # every k-step of every fragment at once: raw registers
    at = a.reshape(mp // 16, 16, steps, STEP).permute(2, 0, 1, 3)
    wt = w.reshape(steps, STEP, np_ // 8, 8).permute(0, 2, 1, 3)
    ra = _pack(at, A32)[:, :, None]                   # [S, R, 1, 32, 4]
    rb = _pack(wt, B32)[:, None]                      # [S, 1, C, 32, 2]
    real = groups - 4 * torch.arange(steps)
    pad = torch.where(real >= 4, 0,
                      0x8888 & (0xFFFF << (4 * real.clamp(1, 4))))
    if mutation == "pad":
        pad = torch.zeros_like(pad)
    pad = pad.reshape(-1, 1, 1, 1, 1)
    part = torch.zeros(ra.shape[:2] + rb.shape[2:3] + (32, 4),
                       dtype=torch.int64)
    for p in reversed(range(PLANES)):
        ap = ((ra >> p) & 0x01010101) << sa
        part = (part << 1) & MASK32
        for q in range(PLANES):
            b0 = (rb[..., 0] >> q) & 0x01010101
            b1 = ((rb[..., 1] << (6 - q)) if q <= 6 else
                  (rb[..., 1] >> (q - 6))) & 0x40404040
            d = _mma(ap, torch.stack([b0, b1], -1), pad, A32, B32)
            part = _dp4a(_prmt(dec_lo, dec_hi, d), 0x01010101 << q, part)

    parts = []
    for z in range(plan.grid_z):
        s0 = z * plan.per_split
        s1 = min(steps, s0 + plan.per_split)
        k_end = min(k, STEP * s1)
        acc = part[s0:s1].sum(0)
        # the counts of 8, one m16n8k16 per staged chunk of 16 groups
        for kc in range(STEP * s0, k_end, KC):
            ca = torch.nn.functional.pad(a[:, kc:min(kc + KC, k_end)],
                                         (0, KC - (min(kc + KC, k_end) - kc)))
            cw = torch.nn.functional.pad(w[kc:min(kc + KC, k_end)],
                                         (0, 0, 0, KC - (min(kc + KC, k_end)
                                                         - kc)))
            x = ca.reshape(mp, KC // 4, 4)
            x = sum(x[..., i] << (8 * i) for i in range(4))  # words
            y = x[:, 0::2] & x[:, 1::2]
            y &= y >> 16
            y &= y >> 8
            fa = y & 255                                  # [mp, 16]
            fw = cw.reshape(KC // 8, 8, np_)
            fw = fw[:, 0] & fw[:, 1] & fw[:, 2] & fw[:, 3] & fw[:, 4] & \
                fw[:, 5] & fw[:, 6] & fw[:, 7]             # [16, np]
            a16 = _pack(fa.reshape(mp // 16, 16, 16), A16)[:, None]
            b16 = _pack(fw.reshape(16, np_ // 8, 8).permute(1, 0, 2),
                        B16)[None]
            d8 = _mma(a16, b16, 0, A16, B16)
            if mutation != "full":
                acc = acc + dec[8] * d8
        parts.append(acc & MASK32)
    total = torch.zeros_like(parts[0])
    for i in torch.randperm(len(parts),
                            generator=torch.Generator().manual_seed(seed)):
        total = (total + parts[i]) & MASK32               # atomics, any order
    # registers back to the output: row 16 R + ..., column 8 C + ...
    out = torch.zeros((mp // 16, np_ // 8, 128), dtype=torch.int64)
    out[..., D_OWN.flatten()] = total.flatten(-2)
    out = out.reshape(mp // 16, np_ // 8, 16, 8).permute(0, 2, 1, 3)
    out = out.reshape(mp, np_)[:m, :n]
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def _thr(kind, rng):
    good = physics_thresholds(ROWS, "cpu")
    if kind == "calibrated":
        return good
    if kind == "detuned":  # every reference shifted up one level
        return torch.cat([torch.tensor([1.9]), good[:-1]])
    v0, v8 = rbl_voltage_physics(torch.tensor([0.0, 8.0]),
                                 rows=ROWS).tolist()
    draw = np.sort(rng.uniform(v8, v0, ROWS))[::-1].copy()
    return torch.from_numpy(draw).float()


def _operands(kind, m, k, n, rng):
    if kind == "all_255":
        return (torch.full((m, k), 255, dtype=torch.int32),
                torch.full((k, n), 255, dtype=torch.int32))
    return (torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.int32)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small int64 ops: one intra-op thread a test worker keeps
    parallel workers from starving each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# M in {17, 33, 64}, K in {768, 1030 (a partial group), 3072}, N never a
# multiple of the 64-column tile
SHAPES = [(17, 768, 72), (33, 1030, 40), (64, 768, 20), (17, 3072, 20),
          (64, 1030, 9), (33, 3072, 24)]
THR_KINDS = ["calibrated", "detuned", "random"]


@pytest.mark.parametrize("m,k,n,thr_kind,operands", [
    s + (kind, "random") for s in SHAPES for kind in THR_KINDS] + [
    s + (kind, "all_255") for s in ((33, 1030, 40), (17, 768, 72))
    for kind in THR_KINDS])
def test_mma_arithmetic_matches_plain(m, k, n, thr_kind, operands):
    rng = np.random.default_rng(m * 10007 + k * 101 + n)
    thr = _thr(thr_kind, rng)
    ua, uw = _operands(operands, m, k, n, rng)
    out = mma_emulation(ua, uw, thr, seed=m + k)
    plain = bitplane_mac_torch(ua, uw, thr, bits_a=8, bits_w=8, rows=ROWS)
    assert torch.equal(out, plain)
    product = (ua.double() @ uw.double()).to(torch.int32)
    if thr_kind == "calibrated":
        assert torch.equal(out, product)
    elif thr_kind == "detuned" and operands == "random":
        assert not torch.equal(out, product)  # the decode follows the table


@pytest.mark.parametrize("m,k,n,thr_kind", [
    (33, 768, 72, kind) for kind in THR_KINDS] + [
    (64, 3072, 20, kind) for kind in THR_KINDS] + [
    (17, 1030, 40, "calibrated")])
def test_mma_arithmetic_matches_jax_reference(m, k, n, thr_kind):
    """The reference's interpreted kernel pads K to its tile (256) and
    decodes the padded groups: at K = 1030 only the calibrated table, which
    decodes a zero count to 0, leaves it equal, so the detuned and random
    tables run at K = 768 and 3072."""
    rng = np.random.default_rng(m + k + n)
    thr = _thr(thr_kind, rng)
    ua, uw = _operands("random", m, k, n, rng)
    ref = np.asarray(j_bitplane_mac(jnp.asarray(ua.numpy()),
                                    jnp.asarray(uw.numpy()),
                                    jnp.asarray(thr.numpy()), bits_a=8,
                                    bits_w=8, interpret=True))
    np.testing.assert_array_equal(mma_emulation(ua, uw, thr).numpy(), ref)


@pytest.mark.parametrize("mutation,m,k,n,thr_kind,operands", [
    ("pad", 17, 1030, 40, "detuned", "random"),   # groups 129: a padded 3
    ("full", 33, 768, 20, "calibrated", "all_255"),
    ("alpha", 17, 768, 20, "calibrated", "random")])
def test_mutations_are_caught(mutation, m, k, n, thr_kind, operands):
    rng = np.random.default_rng(5)
    thr = _thr(thr_kind, rng)
    ua, uw = _operands(operands, m, k, n, rng)
    plain = bitplane_mac_torch(ua, uw, thr, bits_a=8, bits_w=8, rows=ROWS)
    assert torch.equal(mma_emulation(ua, uw, thr), plain)
    assert not torch.equal(mma_emulation(ua, uw, thr, mutation=mutation),
                           plain)


def test_fragment_maps_cover_each_register_byte_once():
    for where, size in ((A32, 512), (B32, 256), (A16, 256), (B16, 128),
                        (D_OWN, 128)):
        assert sorted(where.flatten().tolist()) == list(range(size))
    # one mma of a packed k-step: nibble j of every output is group j's count
    g = torch.Generator().manual_seed(1)
    a = torch.randint(0, 2, (16, 32), generator=g)
    w = torch.randint(0, 2, (32, 8), generator=g)
    sa = torch.tensor([0, 0, 2, 2]) + 4 * ((torch.arange(32) % 4) >> 1)[:, None]
    ra = _pack(a, A32) << sa
    rb = _pack(w, B32) << torch.tensor([0, 6])
    d = _mma(ra, rb, 0, A32, B32)
    counts = (a.reshape(16, 4, 8).permute(1, 0, 2).double() @
              w.reshape(4, 8, 8).double()).to(torch.int64)  # [group, 16, 8]
    want = sum(counts[j] << (4 * j) for j in range(4))
    assert torch.equal(d, want.flatten()[D_OWN])


def test_dispatch_twin_and_plan():
    """Which kernel takes which M (the launcher's rule), and the tensor-core
    kernel's plan covering every k-step once."""
    for m in range(1, 80):
        want = ("bitplane_mac_mma_kernel" if m > R8_MAX_M
                else "bitplane_mac_r8_kernel")
        assert bitplane_kernel(m, 8, 8, 8) == want
        assert bitplane_kernel(m, 4, 8, 8) == "bitplane_mac_kernel"
        assert bitplane_kernel(m, 8, 8, 16) == "bitplane_mac_kernel"
    assert R8_MAX_M == 8  # decode (4 slots); every prefill bucket above
    for m in (9, 16, 17, 32, 33, 64, 512):
        for k in (0, 8, 100, 768, 1030, 3072):
            for n in (1, 9, 129, 768, 3072):
                p = bitplane_mma_plan(m, n, k)
                steps = -(-(-(-k // 8)) // 4)
                assert (p.grid_x, p.grid_y) == (-(-n // BN), -(-m // BM))
                assert p.per_split >= 1 and \
                    p.grid_z * p.per_split >= steps
                assert p.grid_z == 1 or (p.grid_z - 1) * p.per_split < steps
                assert p.accumulate == int(p.grid_z > 1 or steps == 0)
                if steps and p.grid_z > 1:  # about 528 blocks, no more
                    assert p.grid_x * p.grid_y * (p.grid_z - 1) < 528


def test_launcher_reports_the_kernel_it_launched():
    """``bitplane_mac_launch`` sets ``*kernel`` right after each launch, to
    the index in ``ops.LAUNCHED`` of the kernel it launched (the wrapper
    counts ``mma_launches`` from it, not from the dispatch twin); the
    launcher's M rule is the twin's ``R8_MAX_M``."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "csrc" / "bitplane_mac.cu").read_text()
    body = src[src.index('extern "C" int bitplane_mac_launch('):]
    body = body[:body.index("\n}\n")]
    sets = re.findall(r"\*kernel = (\d+);", body)
    assert sets[0] == "0" and sorted(sets[1:]) == ["1", "2", "3"]
    for i in (1, 2, 3):
        before = body[:body.index(f"*kernel = {i};")]
        launched = re.findall(r"(\w+)(?:<\w+>)?<<<", before)[-1]
        assert launched == LAUNCHED[i], (i, launched)
    assert f"constexpr int R8_MAX_M = {R8_MAX_M};" in src
    assert "M > R8_MAX_M" in body
