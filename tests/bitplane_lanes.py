"""Shared by the bit-plane kernels' CPU emulations (``test_torch_bitplane_mma``,
``test_torch_bitplane_noisy_mma``, ``test_torch_bitplane_noisy_skip``): the
PTX instructions they use on int64 tensors of 32-bit values, the lane maps
of ``mma.sync`` m16n8k32 / m16n8k16 with ``.u8`` operands, and the noisy
kernels' tier-3 arithmetic (the draws of the elements that a draw can
change)."""
import torch

from repro_torch.core.rbl import rbl_voltage_physics
from repro_torch.kernels.common import (U1_GRID, bits_to_uniform, box_muller,
                                        decode_counts_noisy, element_normals,
                                        philox4x32_10, radius)

MASK32 = 0xFFFFFFFF
ZMAX = radius(U1_GRID - 1)


# ------------------------------------------------------- PTX instructions
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
    """__dp4a on unsigned words: c + sum of the four byte products."""
    for n in range(4):
        c = c + ((a >> (8 * n)) & 255) * ((b >> (8 * n)) & 255)
    return c & MASK32


def _lane_maps():
    """Flat source indices (lane, register, byte) of each matrix element of
    the .u8 fragments, lane = 4 g + t (PTX ISA, mma.m16n8k32 / m16n8k16),
    and (row, column) of each output register."""
    r, k = torch.meshgrid(torch.arange(16), torch.arange(32), indexing="ij")
    a32 = ((4 * (r % 8) + (k % 16) // 4) * 4 + (r // 8) + 2 * (k // 16)) * 4 \
        + k % 4                                         # A [16, 32]
    k, c = torch.meshgrid(torch.arange(32), torch.arange(8), indexing="ij")
    b32 = ((4 * c + (k % 16) // 4) * 2 + k // 16) * 4 + k % 4  # B [32, 8]
    r, k = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
    a16 = ((4 * (r % 8) + k // 4) * 2 + r // 8) * 4 + k % 4  # A [16, 16]
    k, c = torch.meshgrid(torch.arange(16), torch.arange(8), indexing="ij")
    b16 = (4 * c + k // 4) * 4 + k % 4                  # B [16, 8]
    lane, x = torch.meshgrid(torch.arange(32), torch.arange(4), indexing="ij")
    d = ((lane // 4 + 8 * (x // 2)) * 8 + 2 * (lane % 4) + x % 2)  # [32, 4]
    return a32, b32, a16, b16, d


A32, B32, A16, B16, D_OWN = _lane_maps()


def _bytes(words):
    """[..., R] 32-bit words -> [..., R * 4] bytes, little-endian."""
    return torch.stack([(words >> (8 * b)) & 255 for b in range(4)],
                       -1).flatten(-2)


def _pack(tile, where):
    """The registers [..., 32, R] whose bytes put ``tile``'s elements where
    the map ``where`` (matrix element -> flat (lane, register, byte)) says."""
    n = where.numel()
    flat = torch.zeros(tile.shape[:-2] + (n,), dtype=torch.int64)
    flat[..., where.flatten()] = tile.flatten(-2)
    b = flat.reshape(tile.shape[:-2] + (32, n // 128, 4))
    return sum(b[..., i] << (8 * i) for i in range(4))


def _matrix(regs, where):
    """The matrix the registers [..., 32, R] hold, through ``where``."""
    return _bytes(regs).flatten(-2)[..., where]


def _mma(a_regs, b_regs, c, a_map, b_map):
    """d = a x b + c from registers: A [..., 16, k], B [..., k, 8] read off
    the lanes, the s32 product handed back by output ownership."""
    A = _matrix(a_regs, a_map).double()
    B = _matrix(b_regs, b_map).double()
    D = (A @ B).to(torch.int64) + c
    return D.flatten(-2)[..., D_OWN]                    # [..., 32, 4]


# ------------------------------------------------------- the noisy tier 3
def f32(x):
    return float(torch.tensor(float(x), dtype=torch.float32))


def tier3_decode(key, n, m, g, pair, k, thr, rows, ms, cs, dec0, cut):
    """The decodes of the elements (n, m, group g, plane pair) whose counts
    ``k`` (int64 tensors, one entry each) the tables mark NEED, as the noisy
    kernels' tier 3 computes them: with mismatch alone, the element's draw-0
    Philox words, dec0[k] below cut[k] and the full decode from it up; with
    comparator offset, V(k') and a draw only for the comparators that V(k')
    leaves undecided.  Returns (decodes int64, how many ran the full
    decode)."""
    kk = k.to(torch.float32)
    if cs:
        reach = f32(cs) * ZMAX
        if ms:
            z0 = element_normals(key, n, m, g, pair, [0])[0]
            kk = kk + (ms * torch.sqrt(kk)) * z0
        v = rbl_voltage_physics(kk, rows=rows)
        z = element_normals(key, n, m, g, pair, range(1, rows + 1))
        got = torch.zeros_like(kk, dtype=torch.int64)
        for i in range(rows):
            fires = (thr[i] - reach) >= v
            quiet = (thr[i] + reach) < v
            drawn = ~(fires | quiet)
            got += fires | (drawn & (v <= thr[i] + cs * z[i]))
        return got, k.numel()
    words = philox4x32_10((n, m, g, torch.as_tensor(pair) << 8), key)
    keep = (words[0] >> 8) < cut[k]
    z = box_muller(bits_to_uniform(words[0]), bits_to_uniform(words[1]))
    full = decode_counts_noisy(kk, thr, rows, z_mismatch=z,
                               mismatch_sigma=ms or None)
    got = torch.where(keep, dec0[k].to(torch.int64), full.to(torch.int64))
    return got, int((~keep).sum())
