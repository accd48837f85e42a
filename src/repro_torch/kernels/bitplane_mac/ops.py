"""The ``bitplane_mac`` kernels: the paper's whole bit-plane pyramid in one
launch, for the ``sim`` fabric engines (port of ``repro/kernels/bitplane_mac``;
CUDA sources ``csrc/bitplane_mac.cu`` and, with the NoiseSpec Monte-Carlo in
the kernel, ``csrc/bitplane_mac_noisy.cu``).

For every plane pair (p, q) and every ``rows``-row K-group it takes the
binary MAC count, the two-regime physics RBL voltage, the ``rows``-comparator
decode against the thresholds ``thr`` (live data: a detuned ``thr``
corrupts the result) and the ``2^(p+q)``-weighted int32 accumulation:

    out[m, n] = sum_{p,q} 2^(p+q) sum_g #{i : thr[i] >= V(count[p,q,g,m,n])}

Operands are unsigned offset-binary integers, ``u_a`` int[..., K] in
[0, 2^bits_a) and ``u_w`` int[K, N] in [0, 2^bits_w); only their low
``bits`` planes are read, as the reference's ``to_bitplanes`` reads them.
Noise-free, every integer count decodes to itself, so the result equals
``u_a @ u_w``.

:func:`bitplane_mac` dispatches by device: a CUDA tensor launches the kernel
(or raises: on a build failure, a refused launch, a wrong dtype, device or
shape); a CPU tensor takes the plain version :func:`bitplane_mac_torch`.
``bitplane_mac.launches`` counts kernel launches and nothing else.

:func:`bitplane_mac_noisy` adds device mismatch on each group count and an
offset on each comparator reference, drawn per element from the Philox
stream of :mod:`repro_torch.kernels.common` under a 64-bit ``seed``: the same
seed gives the same output, on the CPU, in the plain version on the card and
in the kernel alike (:func:`bitplane_mac_noisy_torch` is the plain version).
Its stream is not the reference's (that one is keyed by the TPU's grid
steps), so it agrees with the reference in distribution only.
``bitplane_mac_noisy.launches`` counts its launches.  It launches one of two
kernels (``csrc/bitplane_mac_noisy.cu``): for the served case at M >=
:data:`NOISY_MMA_MIN_M` (the prefill buckets and training)
``bitplane_mac_noisy_mma_kernel``, the same group counts and noise-free
decode as ``bitplane_mac_mma_kernel`` with draws only where the skip tables
say, and the 8-row-tile ``bitplane_mac_noisy_kernel`` for every other case (the
decode step, other rows and bits); :func:`bitplane_noisy_kernel` is the
rule's twin, and ``bitplane_mac_noisy.mma_launches`` counts the launches
that the C launcher reports were of the tensor-core kernel.

``bitplane_mac`` launches one of three kernels (``csrc/bitplane_mac.cu``):
the paper's served case (rows 8, 8 x 8 bits) takes ``bitplane_mac_r8_kernel``
at M <= :data:`R8_MAX_M` (decode) and ``bitplane_mac_mma_kernel``, group
counts on the int8 tensor cores, above it (the prefill buckets and
training); every other case takes ``bitplane_mac_kernel``
(:func:`bitplane_kernel` is the rule's twin).  ``bitplane_mac.launches``
counts every launch, ``bitplane_mac.mma_launches`` those that the C
launcher reports were of the tensor-core kernel.

The r8, generic and noisy (not tensor-core) kernels split K over blocks
until a launch has about ``target`` blocks (``bitplane_common.cuh``'s ``plan()``; its twin
:func:`bitplane_plan`), a runtime argument: on a CUDA tensor each wrapper
resolves it at call time with ``autotune.lookup`` (264 and 480 by default,
the measured cache, a pin), and an explicit ``geometry=`` beats the tuner.
The two tensor-core kernels plan from the shapes alone
(:func:`bitplane_mma_plan`): where they run, the wrapper looks nothing up,
and a pin, a cache entry or a ``geometry=`` is ignored.  Any plan gives the same output (split sums meet
by integer atomics).  The CPU path ignores geometry.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import constants as C
from repro_torch.core.bitserial import count_at_or_above, decoded_pyramid
from repro_torch.core.decoder import thresholds
from repro_torch.core.rbl import rbl_voltage_physics
from repro_torch.kernels import autotune, build
from repro_torch.kernels.common import (U1_GRID, decode_counts_noisy,
                                        element_normals, key_words, radius,
                                        seed_row)

MAX_ROWS = 32  # the kernel packs one K-group of one plane into a 32-bit word
_BM, _BN = 8, 32  # bitplane_common.cuh: a block's output tile
R8_MAX_M = 8  # bitplane_mac.cu: the r8 kernel's M; the tensor-core one above
_MM_BM, _MM_BN, _MM_TARGET = 64, 64, 528  # the tensor-core kernel's plan
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
# what bitplane_mac_launch reports it launched (its *kernel)
LAUNCHED = (None, "bitplane_mac_kernel", "bitplane_mac_r8_kernel",
            "bitplane_mac_mma_kernel")
_NOISY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
    [ctypes.c_void_p] + [ctypes.c_float] * 2 + [ctypes.c_int] + \
    [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
# bitplane_mac_noisy.cu: the tensor-core kernel's least M (rows 8, 8x8 bits;
# chip_smoke.py --noisy-variants: ahead of the 8-row-tile kernel at M = 9, 16, 32,
# 33, 40 and up, behind at 8 and below and at 17 and 24)
NOISY_MMA_MIN_M = 9
NOISY_MMA_TARGET = 1188  # the blocks its plan aims at (bitplane_mma_plan)
# what bitplane_mac_noisy_launch reports it launched (its *kernel)
LAUNCHED_NOISY = (None, "bitplane_mac_noisy_kernel",
                  "bitplane_mac_noisy_mma_kernel")
_PLAN_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p]
_FNS = {}


class Plan(NamedTuple):
    """A launch: the grid (column tiles, row tiles, K splits), the K-groups
    per split and whether the splits add into a zeroed output."""
    grid_x: int
    grid_y: int
    grid_z: int
    per_split: int
    accumulate: int


@functools.lru_cache(maxsize=None)
def bitplane_plan(m: int, n: int, k: int, rows: int, target: int,
                  granule: int) -> Plan:
    """The launch of an ``m x k x n`` product of ``rows``-row groups, as
    ``bitplane_common.cuh``'s ``plan()`` computes it (the C
    ``bitplane_plan``; ``chip_smoke.py`` phase 12 holds the two equal):
    8 x 32 output tiles, K's groups split until the grid has about
    ``target`` blocks, each split a multiple of ``granule`` groups (8 for
    ``bitplane_mac``, 1 for the noisy kernel)."""
    groups = -(-k // rows)
    tiles_n, tiles_m = -(-n // _BN), -(-m // _BM)
    splits = max(-(-target // (tiles_n * tiles_m)), 1)
    splits = max(min(splits, -(-groups // granule)), 1)
    per = -(-groups // splits)
    per = -(-per // granule) * granule
    splits = 1 if groups == 0 else -(-groups // per)
    return Plan(tiles_n, tiles_m, splits, per,
                int(splits > 1 or groups == 0))


def bitplane_kernel(m: int, bits_a: int, bits_w: int, rows: int) -> str:
    """The ``__global__`` function ``bitplane_mac_launch`` takes for an
    ``m``-row product: the tensor-core kernel for the served case (rows 8,
    8 x 8 bits) above ``R8_MAX_M`` rows, the r8 kernel for it at or below,
    the generic kernel for every other case."""
    if rows == 8 and bits_a == 8 and bits_w == 8:
        return ("bitplane_mac_mma_kernel" if m > R8_MAX_M
                else "bitplane_mac_r8_kernel")
    return "bitplane_mac_kernel"


def bitplane_noisy_kernel(m: int, bits_a: int, bits_w: int, rows: int) -> str:
    """The ``__global__`` function ``bitplane_mac_noisy_launch`` takes for an
    ``m``-row product: the tensor-core kernel for the served case (rows 8,
    8 x 8 bits) from ``NOISY_MMA_MIN_M`` rows up, the 8-row-tile kernel for every
    other case (the decode step among them)."""
    if rows == 8 and bits_a == 8 and bits_w == 8 and m >= NOISY_MMA_MIN_M:
        return "bitplane_mac_noisy_mma_kernel"
    return "bitplane_mac_noisy_kernel"


@functools.lru_cache(maxsize=None)
def bitplane_mma_plan(m: int, n: int, k: int,
                      target: int = _MM_TARGET) -> Plan:
    """The tensor-core kernels' launch, as ``bitplane_mma.cuh``'s
    ``mma_plan()`` computes it (the C ``bitplane_mma_plan``): 64 x 64 output
    tiles, the k-steps (32 K-rows, four 8-row groups) split until the grid
    has about ``target`` blocks (528 for ``bitplane_mac``'s kernel,
    :data:`NOISY_MMA_TARGET` for the noisy one); ``per_split`` counts
    k-steps."""
    steps = -(-(-(-k // 8)) // 4)
    tiles = -(-n // _MM_BN) * -(-m // _MM_BM)
    splits = max(min(-(-target // tiles), steps), 1)
    per = max(-(-steps // splits), 1)
    z = 1 if steps == 0 else -(-steps // per)
    return Plan(-(-n // _MM_BN), -(-m // _MM_BM), z, per,
                int(z > 1 or steps == 0))


def compiled_mma_plan(m: int, n: int, k: int) -> Plan:
    """The C ``bitplane_mma_plan`` of the built library (needs ``nvcc``)."""
    fn = _FNS.get("mma_plan")
    if fn is None:
        fn = build.load("bitplane_mac").bitplane_mma_plan
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS["mma_plan"] = fn
    out = (ctypes.c_int * 5)()
    build.check_launch("bitplane_mma_plan",
                       fn(m, n, k, ctypes.addressof(out)))
    return Plan(*out)


def compiled_plan(m: int, n: int, k: int, rows: int, target: int,
                  granule: int) -> Plan:
    """The C ``bitplane_plan`` of the built ``bitplane_mac`` library (needs
    ``nvcc``)."""
    fn = _FNS.get("plan")
    if fn is None:
        fn = build.load("bitplane_mac").bitplane_plan
        fn.argtypes, fn.restype = _PLAN_ARGTYPES, ctypes.c_int
        _FNS["plan"] = fn
    out = (ctypes.c_int * 5)()
    build.check_launch("bitplane_plan", fn(m, n, k, rows, target, granule,
                                           ctypes.addressof(out)))
    return Plan(*out)


def _target(name: str, m, n, k, bits_a, bits_w, rows, geometry, device):
    """The target of a launch: the tuner's lookup, then ``geometry``."""
    geom = autotune.lookup(name, {"m": m, "k": k, "n": n, "ba": bits_a,
                                  "bw": bits_w, "rows": rows},
                           dtype=autotune.KERNEL_DTYPES[name], device=device)
    if geometry:
        geom.update(autotune.check_geometry(name, dict(geometry),
                                            f"{name}(geometry=...)"))
    return geom["target"]


def _entry(name: str, argtypes):
    """The C entry point ``<name>_launch`` of ``csrc/<name>.cu``, its argument
    types set once, at the library's first load."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load(name), f"{name}_launch")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
    return fn


@functools.lru_cache(maxsize=None)
def physics_thresholds(rows: int, device) -> torch.Tensor:
    """The calibrated comparator references for ``rows`` (physics model),
    on ``device``; made once per (rows, device), so a call on the card
    copies nothing from the host."""
    return thresholds(rows, mode="physics").to(device)


def decode_counts(counts: torch.Tensor, thr: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """Counts -> V_RBL (two-regime physics) -> comparator decode -> counts:
    the number of references ``thr[i] >= V`` (the port of
    ``repro/kernels/common.py::decode_counts``)."""
    return count_at_or_above(rbl_voltage_physics(counts, rows=rows), thr)


def bitplane_mac_torch(u_a: torch.Tensor, u_w: torch.Tensor,
                       thr: torch.Tensor | None = None, *, bits_a: int = 8,
                       bits_w: int = 8, rows: int = C.ROWS) -> torch.Tensor:
    """Plain version: the plane-batched pyramid with the physics decode
    against ``thr`` (default: :func:`physics_thresholds`), chunked over N.

    Counts are float32 products of {0, 1} planes (exact: each is at most
    ``rows``), so the same code runs on the CPU and on the card.  Matches
    ``bitplane_mac_batched_ref`` and ``bitplane_mac_ref`` bit for bit.
    """
    if thr is None:
        thr = physics_thresholds(rows, u_a.device)
    thr = thr.to(device=u_a.device, dtype=torch.float32)
    return decoded_pyramid(u_a, u_w, bits_a=bits_a, bits_w=bits_w, rows=rows,
                           decode=lambda c, n0: decode_counts(c, thr, rows))


def _check(u_a, u_w, thr, bits_a, bits_w, rows):
    if u_w.ndim != 2 or u_a.ndim < 1 or u_a.shape[-1] != u_w.shape[0]:
        raise ValueError(f"bitplane_mac: shapes {tuple(u_a.shape)} x "
                         f"{tuple(u_w.shape)} do not contract")
    if not all(2 <= b <= 8 for b in (bits_a, bits_w)):
        raise ValueError(f"bitplane_mac: bits must be in [2, 8], got "
                         f"{bits_a} x {bits_w}")
    if not 2 <= rows <= MAX_ROWS:
        raise ValueError(f"bitplane_mac: the kernel takes rows in [2, "
                         f"{MAX_ROWS}], got {rows}")
    for name, t in (("u_a", u_a), ("u_w", u_w)):
        if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
            raise TypeError(f"bitplane_mac: {name} must hold integers, got "
                            f"{t.dtype}")
    if not thr.is_floating_point() or thr.shape != (rows,):
        raise ValueError(f"bitplane_mac: thr must be float[{rows}], got "
                         f"{thr.dtype}{list(thr.shape)}")
    if any(t.device != u_a.device for t in (u_w, thr)):
        raise ValueError(f"bitplane_mac: operands on {u_a.device}, "
                         f"{u_w.device} and {thr.device}; all must be on "
                         "one CUDA device (or all on the CPU)")


def _on_cpu(*ts) -> bool:
    return all(t is None or t.device.type == "cpu" for t in ts)


def _operands(name, u_a, u_w, thr, bits_a, bits_w, rows):
    """Checked, contiguous kernel operands: (uint8 a [M, K], uint8 w [K, N],
    float32 thr, int32 out [M, N], batch shape)."""
    if not u_a.is_cuda:
        raise ValueError(f"{name}: operands on {u_a.device} and "
                         f"{u_w.device}; all must be on one CUDA device (or "
                         "all on the CPU)")
    if thr is None:
        thr = physics_thresholds(rows, u_a.device)
    _check(u_a, u_w, thr, bits_a, bits_w, rows)
    batch = tuple(u_a.shape[:-1])
    k, n = u_w.shape
    # one byte per value: the kernel reads the bit planes out of each byte
    a = u_a.reshape(-1, k).to(torch.uint8).contiguous()
    w = u_w.to(torch.uint8).contiguous()
    t = thr.to(torch.float32).contiguous()
    out = torch.empty((a.shape[0], n), dtype=torch.int32, device=a.device)
    return a, w, t, out, batch


def bitplane_mac(u_a: torch.Tensor, u_w: torch.Tensor,
                 thr: torch.Tensor | None = None, *, bits_a: int = 8,
                 bits_w: int = 8, rows: int = C.ROWS,
                 geometry=None) -> torch.Tensor:
    """Fused full-pyramid bit-serial matmul for arbitrary shapes.

    u_a: int[..., K]; u_w: int[K, N]; leading batch dims of ``u_a`` flatten
    into M.  ``thr`` (float[rows], descending) defaults to the
    physics-model references for ``rows``.  ``geometry`` (``{"target":
    blocks}``) beats the tuner's where a target is read (not by the
    tensor-core kernel).  Returns int32[..., N].
    """
    if _on_cpu(u_a, u_w, thr):
        return bitplane_mac_torch(u_a, u_w, thr, bits_a=bits_a,
                                  bits_w=bits_w, rows=rows)
    a, w, t, out, batch = _operands("bitplane_mac", u_a, u_w, thr, bits_a,
                                    bits_w, rows)
    (m, k), n = a.shape, w.shape[1]
    if bitplane_kernel(m, bits_a, bits_w, rows) == "bitplane_mac_mma_kernel":
        target = autotune.DEFAULTS["bitplane_mac"]["target"]  # not read
    else:
        target = _target("bitplane_mac", m, n, k, bits_a, bits_w, rows,
                         geometry, a.device)
    fn = _entry("bitplane_mac", _ARGTYPES)
    stream, dev = build.stream_and_device(a)
    ran = ctypes.c_int(0)
    build.check_launch("bitplane_mac", fn(
        a.data_ptr(), w.data_ptr(), t.data_ptr(), out.data_ptr(), m, n, k,
        bits_a, bits_w, rows, target, stream, dev, ctypes.byref(ran)))
    bitplane_mac.launches += 1
    if LAUNCHED[ran.value] == "bitplane_mac_mma_kernel":
        bitplane_mac.mma_launches += 1
    return out.reshape(batch + (n,))


bitplane_mac.launches = 0
bitplane_mac.mma_launches = 0


# ------------------------------------------------------------------- noisy
def _noisy_decoder(key, thr, rows, bits_a, bits_w, m, mismatch_sigma,
                   comparator_offset_sigma):
    """``decode(counts, n0)`` for :func:`decoded_pyramid`: the physics decode
    of the chunk's counts ``[G, PA*M, PW*nc]`` with each element's normals
    drawn from the kernel's stream."""
    draws = ([0] if mismatch_sigma else []) + (
        list(range(1, rows + 1)) if comparator_offset_sigma else [])

    def decode(counts, n0):
        g = counts.shape[0]
        nc = counts.shape[2] // bits_w
        c = counts.reshape(g, bits_a, m, bits_w, nc)
        dev = counts.device

        def idx(size, dim, start=0):
            shape = [1] * 5
            shape[dim] = size
            return torch.arange(start, start + size, dtype=torch.int64,
                                device=dev).reshape(shape)

        pair = idx(bits_a, 1) * bits_w + idx(bits_w, 3)
        z = element_normals(key, idx(nc, 4, n0), idx(m, 2), idx(g, 0), pair,
                            draws) if draws else []
        z_m = z[0] if mismatch_sigma else None
        z_c = z[1:] if mismatch_sigma else z
        return decode_counts_noisy(
            c, thr, rows, z_mismatch=z_m, z_comparator=z_c,
            mismatch_sigma=mismatch_sigma,
            comparator_offset_sigma=comparator_offset_sigma)

    return decode


def bitplane_mac_noisy_torch(u_a: torch.Tensor, u_w: torch.Tensor, seed,
                             thr: torch.Tensor | None = None, *,
                             bits_a: int = 8, bits_w: int = 8,
                             rows: int = C.ROWS, mismatch_sigma=None,
                             comparator_offset_sigma=None) -> torch.Tensor:
    """Plain version of :func:`bitplane_mac_noisy`: the physics pyramid
    chunked over N, each element's normals drawn from the kernel's Philox
    stream with the kernel's counters, so it equals the kernel bit for bit.
    The same code runs on the CPU and on the card.  ``seed`` is a 64-bit
    integer or a seed-table row (its key words are read on the row's
    device, as the kernel reads them)."""
    if thr is None:
        thr = physics_thresholds(rows, u_a.device)
    thr = thr.to(device=u_a.device, dtype=torch.float32)
    m = u_a.reshape(-1, u_a.shape[-1]).shape[0]
    decode = _noisy_decoder(key_words(seed), thr, rows, bits_a, bits_w, m,
                            mismatch_sigma, comparator_offset_sigma)
    return decoded_pyramid(u_a, u_w, bits_a=bits_a, bits_w=bits_w, rows=rows,
                           decode=decode)


def bitplane_mac_noisy(u_a: torch.Tensor, u_w: torch.Tensor, seed,
                       thr: torch.Tensor | None = None, *, bits_a: int = 8,
                       bits_w: int = 8, rows: int = C.ROWS,
                       mismatch_sigma: float | None = None,
                       comparator_offset_sigma: float | None = None,
                       geometry=None) -> torch.Tensor:
    """Fused full-pyramid bit-serial matmul with the NoiseSpec Monte-Carlo
    in the kernel.

    Same operand contract as :func:`bitplane_mac`, plus ``seed`` and the
    sigmas (None or 0 draws nothing).  ``seed``'s two words key the Philox
    stream, and the kernel reads them from device memory: ``seed`` is a
    seed-table row (an int32 (2,) tensor on the operands' device, the
    uint32 words low then high, :func:`~repro_torch.kernels.common.seed_row`)
    or a 64-bit integer, which the wrapper copies to the card first (a
    CUDA graph captures a row's address, and the words written there before
    each replay key that replay's stream).  Same seed -> identical outputs.
    ``geometry`` (``{"target": blocks}``) beats the tuner's where a target
    is read (not by the tensor-core kernel).  Returns int32[..., N].
    """
    if _on_cpu(u_a, u_w, thr):
        return bitplane_mac_noisy_torch(
            u_a, u_w, seed, thr, bits_a=bits_a, bits_w=bits_w, rows=rows,
            mismatch_sigma=mismatch_sigma,
            comparator_offset_sigma=comparator_offset_sigma)
    a, w, t, out, batch = _operands("bitplane_mac_noisy", u_a, u_w, thr,
                                    bits_a, bits_w, rows)
    (m, k), n = a.shape, w.shape[1]
    if not isinstance(seed, torch.Tensor):
        seed = seed_row(seed, a.device)
    if seed.dtype != torch.int32 or seed.shape != (2,) or \
            seed.device != a.device or not seed.is_contiguous():
        raise ValueError(f"bitplane_mac_noisy: a seed row is a contiguous "
                         f"int32 (2,) tensor on {a.device}, got "
                         f"{seed.dtype}{list(seed.shape)} on {seed.device}")
    if bitplane_noisy_kernel(m, bits_a, bits_w, rows) == \
            "bitplane_mac_noisy_mma_kernel":
        target = autotune.DEFAULTS["bitplane_mac_noisy"]["target"]  # not read
    else:
        target = _target("bitplane_mac_noisy", m, n, k, bits_a, bits_w, rows,
                         geometry, a.device)
    fn = _entry("bitplane_mac_noisy", _NOISY_ARGTYPES)
    stream, dev = build.stream_and_device(a)
    ran = ctypes.c_int(0)
    build.check_launch("bitplane_mac_noisy", fn(
        a.data_ptr(), w.data_ptr(), t.data_ptr(), out.data_ptr(), m, n, k,
        bits_a, bits_w, rows, seed.data_ptr(), float(mismatch_sigma or 0.0),
        float(comparator_offset_sigma or 0.0), target, stream, dev,
        ctypes.byref(ran)))
    bitplane_mac_noisy.launches += 1
    if LAUNCHED_NOISY[ran.value] == "bitplane_mac_noisy_mma_kernel":
        bitplane_mac_noisy.mma_launches += 1
    return out.reshape(batch + (n,))


bitplane_mac_noisy.launches = 0
bitplane_mac_noisy.mma_launches = 0


# ---------------------------------------------------------- the skip tables
SKIP_PAD = 2.0 ** -20  # volts: the band test's margin on V (csrc PAD)


def _band_ends(k: torch.Tensor, rz: torch.Tensor, ms: float):
    """The float32 ends (lo, hi) of the counts ``k``'s mismatch band for
    draws ``|z| <= rz``: ``k' = k + (ms * sqrt(k)) * z`` rounds monotonically
    in z, so every k' lies in [lo, hi]."""
    if not ms > 0:
        return k, k
    d = (ms * torch.sqrt(k)) * rz
    return k - d, k + d


def _band_free(k, rz, thr, tlo, thi, rows, ms, pad):
    """Where the decode of count ``k`` is the same for every mismatch draw
    ``|z| <= rz`` and every comparator offset in [tlo - thr, thi - thr]:
    V is monotone non-increasing in k', so over the band it lies in
    [V(hi), V(lo)], and each comparator must fire (``tlo >= V(lo) + pad``)
    or stay quiet (``thi < V(hi) - pad``) over all of it.  A NaN threshold
    never fires."""
    lo, hi = _band_ends(k, rz, ms)
    vlo = rbl_voltage_physics(lo, rows=rows) + pad
    vhi = rbl_voltage_physics(hi, rows=rows) - pad
    ok = (tlo >= vlo[:, None]) | (thi < vhi[:, None]) | torch.isnan(thr)
    return ok.all(-1)


def noisy_skip_tables(thr: torch.Tensor, rows: int, mismatch_sigma=None,
                      comparator_offset_sigma=None, *, pad: float = SKIP_PAD):
    """Twin of ``csrc/bitplane_mac_noisy.cu``'s prologue, for the tests: the
    per-count tables that decide where a draw can change a decode.

    Returns ``(dec0, need, cut)`` over the counts k = 0..rows (CPU tensors):

    * ``dec0`` int32: the noise-free decode ``#{i : V(k) <= thr[i]}``;
    * ``need`` bool: some mismatch draw or comparator offset with ``|z| <=
      Z_MAX = radius(U1_GRID - 1)`` can move the decode off ``dec0[k]``
      (without a sigma, none); every other count keeps ``dec0[k]``;
    * ``cut`` int64, with mismatch alone (else None): an element whose u1
      grid index is below ``cut[k]`` keeps ``dec0[k]`` whatever its u2
      (``U1_GRID`` where ``need`` is False).  The kernel finds the same first
      index by a 32-way search; a binary search finds it here.

    The sigmas are rounded to float32, as the kernel receives them; a sigma
    <= 0 draws nothing.
    """
    thr = thr.detach().to("cpu", torch.float32)
    ms = float(torch.tensor(float(mismatch_sigma or 0.0), dtype=torch.float32))
    cs = float(torch.tensor(float(comparator_offset_sigma or 0.0),
                            dtype=torch.float32))
    k = torch.arange(rows + 1).to(torch.float32)
    zmax = radius(U1_GRID - 1)
    reach = cs * zmax if cs > 0 else torch.zeros((), dtype=torch.float32)
    tlo, thi = thr - reach, thr + reach

    def free(rz):
        return _band_free(k, rz, thr, tlo, thi, rows, ms, pad)

    v = rbl_voltage_physics(k, rows=rows)
    dec0 = (v[:, None] <= thr).sum(-1).to(torch.int32)
    need = ~free(zmax.expand(rows + 1)) & (ms > 0 or cs > 0)
    if not (ms > 0 and not cs > 0):
        return dec0, need, None
    lo = torch.zeros(rows + 1, dtype=torch.int64)
    hi = torch.full((rows + 1,), U1_GRID - 1, dtype=torch.int64)
    while bool((lo < hi).any()):  # the first index whose band is not free
        active = lo < hi
        mid = (lo + hi) // 2
        good = free(radius(mid))
        lo, hi = (torch.where(active & good, mid + 1, lo),
                  torch.where(active & ~good, mid, hi))
    return dec0, need, torch.where(need, lo, torch.tensor(U1_GRID))
