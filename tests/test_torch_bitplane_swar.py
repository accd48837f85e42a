"""The word arithmetic of ``csrc/bitplane_mac.cu``'s served-case kernel
(``bitplane_mac_r8_kernel``: rows 8, 8 x 8 bits), emulated in int64 torch
ops on the CPU and held bit for bit against ``bitplane_mac_torch``.

The kernel runs only on the card (``tests/test_torch_cuda.py``); this file
checks its arithmetic, step for step, where the CPU tests run:

  * four 8-row K-groups per 32-bit word, group j's rows 0-3 in nibble j and
    rows 4-7 in nibble j + 4;
  * the SWAR count: 2-bit and 4-bit steps, then ``c = x + (x >> 16)``, which
    leaves group j's count (0..8) in nibble j;
  * the decode by ``prmt`` (PTX byte permute, default mode: a selector
    nibble's top bit replicates the selected byte's sign) from the table
    ``dec[0..7]`` packed in two words, and ``dec[8]`` through a second
    ``prmt`` of 0x80;
  * ``dp4a`` with byte weights ``2^q`` (zero for the padded bytes of the
    last word), per-p partial sums shifted by p into an int32 accumulator;
  * the staging: each group's 8 x 8 bits turned by ``transpose8`` and the
    four groups' nibbles by a 4 x 8 byte transpose of ``prmt``s, equal to
    the layout above.

Thresholds: calibrated, the detuned ``[1.9, thr[:-1]]`` (a zero count
decodes to 1, so the padded bytes must weigh nothing), and a random
descending set between V(8) and V(0); operands random or all 255 (every
count 8).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.rbl import rbl_voltage_physics
from repro_torch.kernels.bitplane_mac.ops import (bitplane_mac_torch,
                                                  decode_counts,
                                                  physics_thresholds)

ROWS = PLANES = 8
M55 = 0x55555555
M33 = 0x33333333


def _bit_position():
    """[4 groups, 8 rows] -> bit of the word: nibble j, or j + 4 for rows
    4-7."""
    j = torch.arange(4).reshape(4, 1)
    r = torch.arange(ROWS).reshape(1, ROWS)
    return (r & 3) + 4 * j + 16 * (r >> 2)


def _words(u, axis_k):
    """uint8 values -> plane words [P, ..., T] (K last), in the layout."""
    u = u.movedim(axis_k, -1).to(torch.int64)
    k = u.shape[-1]
    t = -(-k // 32)
    u = torch.nn.functional.pad(u, (0, 32 * t - k))
    bits = torch.stack([(u >> p) & 1 for p in range(PLANES)])
    bits = bits.reshape(*bits.shape[:-1], t, 4, ROWS)
    return (bits << _bit_position()).sum((-2, -1))


def _prmt(lo, hi, sel):
    """PTX prmt.b32, default mode, on int64 tensors of 32-bit values."""
    v = (hi << 32) | lo
    out = torch.zeros_like(sel)
    for n in range(4):
        s = (sel >> (4 * n)) & 15
        b = (v >> (8 * (s & 7))) & 255
        b = torch.where((s & 8) != 0, torch.where((b & 128) != 0, 255, 0), b)
        out |= b << (8 * n)
    return out


def _dp4a(a, b, c):
    for n in range(4):
        c = c + ((a >> (8 * n)) & 255) * ((b >> (8 * n)) & 255)
    return c


def swar_mac(ua, uw, thr):
    """The kernel's word arithmetic: int32[M, N]."""
    k = ua.shape[1]
    groups = -(-k // ROWS)
    a = _words(ua, 1)          # [P, M, T]
    w = _words(uw, 0)          # [P, N, T]
    t = a.shape[-1]
    dec = [int(v) for v in decode_counts(torch.arange(ROWS + 1.0), thr,
                                         ROWS)]
    lo = torch.tensor(sum(dec[i] << (8 * i) for i in range(4)))
    hi = torch.tensor(sum(dec[4 + i] << (8 * i) for i in range(4)))
    dec8 = dec[8] * 0x01010101
    real = (groups - 4 * torch.arange(t)).clamp(max=4)     # [T]
    ones = 0x01010101 & ((1 << (8 * real)) - 1)           # padded bytes: 0
    acc = torch.zeros((ua.shape[0], uw.shape[1]), dtype=torch.int64)
    for p in range(PLANES):
        ap = a[p][:, None, :]                              # [M, 1, T]
        s = torch.zeros((ua.shape[0], uw.shape[1], t), dtype=torch.int64)
        for q in range(PLANES):
            wq = w[q][None]                                # [1, N, T]
            x = (ap & wq) - ((ap >> 1) & ((wq >> 1) & M55))
            x = (x & M33) + ((x >> 2) & M33)
            c = x + (x >> 16)
            d = _prmt(lo, hi, c) | (_prmt(torch.tensor(0x80),
                                          torch.tensor(0), c) & dec8)
            s = _dp4a(d, ones << q, s)
        acc += (s << p).sum(-1)
    acc = acc & 0xFFFFFFFF
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


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


@pytest.mark.parametrize("operands", ["random", "all_255"])
@pytest.mark.parametrize("thr_kind", ["calibrated", "detuned", "random"])
@pytest.mark.parametrize("m,k,n", [(3, 8, 5), (4, 24, 31), (5, 100, 9),
                                   (4, 768, 33), (9, 1030, 7)])
def test_swar_word_arithmetic_matches_plain(m, k, n, thr_kind, operands):
    rng = np.random.default_rng(m * 10007 + k * 101 + n)
    thr = _thr(thr_kind, rng)
    if operands == "all_255":
        ua = torch.full((m, k), 255, dtype=torch.int32)
        uw = torch.full((k, n), 255, dtype=torch.int32)
    else:
        ua = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.int32))
        uw = torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.int32))
    out = swar_mac(ua, uw, thr)
    plain = bitplane_mac_torch(ua, uw, thr, bits_a=8, bits_w=8, rows=ROWS)
    assert torch.equal(out, plain)
    if thr_kind == "calibrated":
        assert torch.equal(out, (ua.double() @ uw.double()).to(torch.int32))


def _transpose8(x):
    """Hacker's Delight transpose8 on an unsigned 64-bit value (a Python
    int): byte c bit r <- byte r bit c."""
    full = (1 << 64) - 1
    for sh, mask in ((7, 0x00AA00AA00AA00AA), (14, 0x0000CCCC0000CCCC),
                     (28, 0x00000000F0F0F0F0)):
        t = (x ^ (x >> sh)) & mask
        x = (x ^ t ^ (t << sh)) & full
    return x


def _gather_word(vals):
    """The kernel's gather_word on 32 byte values: plane words [8]."""
    nib = 0x0F0F0F0F0F0F0F0F
    lo4, hi4 = [0, 0], [0, 0]
    for j in range(4):
        x = _transpose8(sum(int(vals[8 * j + r]) << (8 * r)
                            for r in range(ROWS)))
        sh = 4 * (j & 1)
        lo4[j >> 1] |= (x & nib) << sh
        hi4[j >> 1] |= ((x >> 4) & nib) << sh
    words = [0] * PLANES
    for h in range(2):
        A, B, C, D = (torch.tensor((v >> (32 * h)) & 0xFFFFFFFF)
                      for v in (lo4[0], lo4[1], hi4[0], hi4[1]))
        ab0, ab1 = _prmt(A, B, torch.tensor(0x5140)), \
            _prmt(A, B, torch.tensor(0x7362))
        cd0, cd1 = _prmt(C, D, torch.tensor(0x5140)), \
            _prmt(C, D, torch.tensor(0x7362))
        words[4 * h:4 * h + 4] = [
            int(_prmt(ab0, cd0, torch.tensor(0x5410))),
            int(_prmt(ab0, cd0, torch.tensor(0x7632))),
            int(_prmt(ab1, cd1, torch.tensor(0x5410))),
            int(_prmt(ab1, cd1, torch.tensor(0x7632)))]
    return words


@pytest.mark.parametrize("valid", [32, 29, 8, 1])
def test_staging_transposes_give_the_word_layout(valid):
    rng = np.random.default_rng(valid)
    vals = rng.integers(0, 256, 32)
    vals[valid:] = 0  # rows past K stage as zeros
    want = _words(torch.from_numpy(vals).reshape(1, 32), 1)[:, 0, 0]
    assert _gather_word(vals) == [int(v) for v in want]
