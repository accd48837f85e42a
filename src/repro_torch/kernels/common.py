"""The noise stream of the noisy fabric kernel, and its noisy decode (port of
``repro/kernels/common.py``'s PRNG and ``decode_counts_noisy``).

The reference draws its in-kernel normals from the TPU's hardware PRNG when
compiled and from a murmur counter hash in interpret mode, both keyed by the
TPU grid step; the port's tiles are not the TPU's, so neither can be
reproduced.  The port draws from Philox4x32-10 (Salmon et al., SC'11, the
generator of Random123 and cuRAND), a counter-based generator with no state:
the normal of draw ``d`` of an element is a pure function of

    (seed words, element counters (n, m, group, pair), d)

so the plain version on the CPU, the plain version on the card and the CUDA
kernel (``csrc/bitplane_mac_noisy.cu``) compute one stream, bit for bit,
whatever the kernel's tiling, split-K or order.  Draw ``d`` comes from the
Philox counter ``(n, m, group, pair << 8 | d >> 1)``: words 0-1 for an even
``d``, words 2-3 for an odd one.  Draw 0 is the element's mismatch, draw
``1 + i`` the offset of comparator ``i``.

Each uniform takes the top 24 bits of a word, ``(bits >> 8) * 2^-24``, as the
reference's ``_bits_to_uniform``; each normal is the reference's Box-Muller
``sqrt(-2 log(1 - u1)) cos(2 pi u2)``.  ``log`` and ``cos`` are written here
as Cephes' float32 polynomials, one rounded float32 operation at a time (no
fused multiply-add), so every step is an IEEE operation that the CPU, PyTorch's
CUDA ops and the kernel round alike; a library ``log``/``cos`` may differ
between them by an ulp.

Integers: Philox's uint32 words are held in int64 tensors (PyTorch has no
full uint32 arithmetic on every device); its 32 x 32 -> 64-bit products are
taken in 16-bit halves so no int64 product overflows.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.rbl import rbl_voltage_physics

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
INV_2_24 = 2.0 ** -24
U1_GRID = 1 << 24  # a uniform takes the top 24 bits of a word


# ------------------------------------------------------------------ seeds
def splitmix64(x: int) -> int:
    """One step of splitmix64 (Steele et al.): a bijective 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def mix_seed(seed: int, *words: int) -> int:
    """A 64-bit seed derived from ``seed`` and the integers ``words`` (a
    call index, a tick, a slot, a plane pair) on the host: the counterpart
    of ``jax.random.fold_in``.  Different words give unrelated seeds."""
    h = splitmix64(seed & MASK64)
    for w in words:
        h = splitmix64(h ^ (w & MASK64))
    return h


def seed_words(seed: int) -> Tuple[int, int]:
    """A 64-bit seed -> the two uint32 Philox key words (low, high): the
    counterpart of the reference's ``ops.py::_key_words``."""
    seed &= MASK64
    return seed & MASK32, seed >> 32


def seed_table(seed: int, calls: int) -> np.ndarray:
    """The seed words of calls ``0 .. calls - 1`` under ``seed``: row ``n``
    is ``seed_words(mix_seed(seed, n))``, as an int32 (calls, 2) array of
    the uint32 bit patterns (the layout the noisy kernel reads)."""
    return np.array([seed_words(mix_seed(seed, n)) for n in range(calls)],
                    np.uint32).reshape(calls, 2).view(np.int32)


def seed_row(seed: int, device=None) -> torch.Tensor:
    """One seed's two words as an int32 (2,) tensor: a row of a seed
    table, for a caller that holds a Python seed."""
    w = np.asarray(seed_words(seed), dtype=np.uint32).view(np.int32)
    return torch.from_numpy(w.copy()).to(device)


def key_words(seed):
    """The two Philox key words of ``seed``: Python ints for an integer
    seed, int64 0-dim tensors (on the row's device, no copy to the host) for
    a seed-table row (an int32 (2,) tensor of uint32 bit patterns)."""
    if isinstance(seed, torch.Tensor):
        w = seed.reshape(2).to(torch.int64) & MASK32
        return w[0], w[1]
    return seed_words(int(seed))


def seed_int(seed) -> int:
    """The 64-bit seed of ``seed`` (an integer, or a seed-table row read
    back to the host)."""
    if isinstance(seed, torch.Tensor):
        lo, hi = (int(w) & MASK32 for w in seed.reshape(2).tolist())
        return lo | hi << 32
    return int(seed) & MASK64


# ----------------------------------------------------------------- philox
def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product of uint32 ``a`` (int64
    tensor) and the constant ``m``, in 16-bit halves of ``m``."""
    p_lo = a * (m & 0xFFFF)          # < 2^48
    p_hi = a * (m >> 16)             # < 2^48; a * m = p_lo + p_hi * 2^16
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (t >> 32) + (p_hi >> 16), t & MASK32


def philox4x32_10(counter: Sequence, key) -> List[torch.Tensor]:
    """Philox4x32 with 10 rounds.  ``counter``: four uint32 words, each an
    int64 tensor (broadcasting) or a Python int; ``key``: two uint32 words,
    Python ints or int64 0-dim tensors (:func:`key_words`).  Returns the
    four uint32 output words as int64 tensors."""
    c = [torch.as_tensor(w, dtype=torch.int64) for w in counter]
    k0, k1 = (w & MASK32 for w in key)
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(c[0], PHILOX_M[0])
        hi1, lo1 = _mulhilo(c[2], PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 uniforms in [0, 1) from their top 24 bits."""
    return (bits >> 8).to(torch.float32) * INV_2_24


# ----------------------------------------------------- float32 log and cos
# Cephes' logf/sinf/cosf coefficients; evaluated one rounded float32 op at a
# time.  The kernel writes the same sequence with __fmul_rn/__fadd_rn.
_SQRTH = 0.707106781186547524
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4
_SIN_P = (-1.9515295891e-4, 8.3321608736e-3, -1.6666654611e-1)
_COS_P = (2.443315711809948e-5, -1.388731625493765e-3, 4.166664568298827e-2)
_TWO_PI = 6.283185307179586


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive normal ``x`` (Cephes' logf)."""
    bits = x.to(torch.float32).view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 126                     # x = f * 2^e
    f = ((bits & 0x7FFFFF) | (126 << 23)).view(torch.float32)  # [0.5, 1)
    small = f < _SQRTH
    e = (e - small.to(torch.int32)).to(torch.float32)
    f = torch.where(small, (f + f) - 1.0, f - 1.0)
    z = f * f
    y = torch.full_like(f, _LOG_P[0])
    for p in _LOG_P[1:]:
        y = y * f + p
    y = (y * f) * z
    y = y + e * _LN2_LO
    y = y - z * 0.5
    return (f + y) + e * _LN2_HI


def cos_2pi_f32(u: torch.Tensor) -> torch.Tensor:
    """float32 ``cos(2 pi u)`` for ``u`` in [0, 1) on a 2^-24 grid: exact
    quadrant and octant reduction in turns, then Cephes' sinf/cosf
    polynomials on [0, pi/4]."""
    u = u.to(torch.float32)
    q = torch.floor(u * 4.0)              # quadrant, exact
    r = u - q * 0.25                       # [0, 1/4), exact
    hi = r > 0.125
    r = torch.where(hi, 0.25 - r, r)       # [0, 1/8], exact
    x = r * _TWO_PI
    z = x * x
    c = ((z * _COS_P[0] + _COS_P[1]) * z + _COS_P[2]) * z
    c = ((c * z) - z * 0.5) + 1.0
    s = ((z * _SIN_P[0] + _SIN_P[1]) * z + _SIN_P[2]) * z
    s = (s * x) + x
    # cos(2 pi (q/4 + r)), with cos and sin swapped past the octant
    cos_r = torch.where(hi, s, c)
    sin_r = torch.where(hi, c, s)
    qi = q.to(torch.int32)
    return torch.where(qi == 0, cos_r, torch.where(
        qi == 1, -sin_r, torch.where(qi == 2, -cos_r, sin_r)))


def radius(index: torch.Tensor) -> torch.Tensor:
    """Box-Muller's radius ``sqrt(-2 log(1 - u1))`` at the grid index
    ``index`` of ``u1`` (``u1 = index * 2^-24``, ``index`` in [0, 2^24)), with
    :func:`box_muller`'s float32 operations.  It is monotone on the grid, so
    ``radius(U1_GRID - 1)`` (5.7681074) bounds every normal of the stream
    (``|cos| <= 1``)."""
    u1 = torch.as_tensor(index, dtype=torch.int64).to(torch.float32) \
        * INV_2_24
    return torch.sqrt(log_f32(1.0 - u1) * -2.0)


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """The reference's normal, ``sqrt(-2 log(1 - u1)) cos(2 pi u2)``;
    ``1 - u1`` lies in [2^-24, 1], so the log is finite."""
    r = torch.sqrt(log_f32(1.0 - u1) * -2.0)
    return r * cos_2pi_f32(u2)


def element_normals(key: Tuple[int, int], n, m, group, pair,
                    draws: Iterable[int]) -> List[torch.Tensor]:
    """The normals of draws ``draws`` of the elements (n, m, group, pair)
    (int64 tensors or ints, broadcasting), in the kernel's stream.  Each
    Philox call serves two consecutive draws and is made once."""
    draws = list(draws)
    base = torch.as_tensor(pair, dtype=torch.int64) << 8
    words = {}
    out = []
    for d in draws:
        j = d >> 1
        if j not in words:
            words[j] = philox4x32_10((n, m, group, base | j), key)
        w = words[j]
        lo = 2 * (d & 1)
        out.append(box_muller(bits_to_uniform(w[lo]),
                              bits_to_uniform(w[lo + 1])))
    return out


# ------------------------------------------------------------ noisy decode
def decode_counts_noisy(k: torch.Tensor, thr: torch.Tensor, rows: int, *,
                        z_mismatch: Optional[torch.Tensor] = None,
                        z_comparator=None, mismatch_sigma=None,
                        comparator_offset_sigma=None) -> torch.Tensor:
    """Counts -> (+ mismatch) -> V_RBL (two-regime physics) -> comparator
    bank with offsets -> int32 decoded counts.

    The port of the reference's ``decode_counts_noisy`` with its normals
    passed in rather than drawn: ``z_mismatch`` (k's shape) feeds device
    mismatch, ``k + (sigma * sqrt(max(k, 0))) * z``; ``z_comparator[i]``
    (k's shape, for ``i < rows``: a tensor ``[rows, ...]`` or a list) feeds
    comparator ``i``'s offset, ``thr[i] + sigma_c * z_i``.  A sigma that is
    None or 0 draws nothing, as in the reference.  The count is the number
    of references ``>= V``.
    """
    k = k.to(torch.float32)
    if mismatch_sigma:
        k = k + (mismatch_sigma * torch.sqrt(torch.clamp_min(k, 0.0))) \
            * z_mismatch
    v = rbl_voltage_physics(k, rows=rows)
    dec = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for i in range(rows):
        t = thr[i]
        if comparator_offset_sigma:
            t = t + comparator_offset_sigma * z_comparator[i]
        dec += v <= t
    return dec

