"""Bit-serial N-bit MAC over the IMC fabric (port of
``repro/core/bitserial.py``).

A multi-bit dot product decomposes into binary (bit-plane) dot products:

    a . w = sum_{p,q} 2^{p+q} sum_k a_k[p] * w_k[q]

The inner binary sum is what the SRAM macro computes: K is tiled into groups
of ``rows`` (8), each group's popcount is a MAC count in [0, rows] digitized
by the comparator decoder, and groups and planes are shift-accumulated
digitally.  Two modes:

  * exact — decode is the identity on [0, rows]; group sums telescope back
            to a plain integer matmul.
  * sim   — per-group counts go through the analog path (voltage model ->
            thermometer decode), optionally with device mismatch and
            comparator offset noise: the hardware-faithful emulation.

:func:`bitserial_matmul_unsigned` is the plane-batched engine: all
``bits_a x bits_w`` plane pairs ride the free dimensions of one G-batched
count GEMM (:func:`fused_group_counts`), the decode runs elementwise, and the
``2^(p+q)`` shift-accumulate is one weighted reduction.  Where the reference
materializes the whole ``[G, PA*M, PW*N]`` count tensor, the port walks N in
chunks of at most ``CHUNK_ELEMS`` counts (a full-width 768 -> 3072
projection at M = 16 would hold 1.2 GB at once); each output column depends
on its own chunk only, so the result is bit-identical.
:func:`bitserial_matmul_looped` is the per-plane-pair oracle.

Counts are computed as float32 products of {0, 1} planes: every partial sum
is an integer of at most ``rows``, exact in float32, and float32 products run
on the card where integer ones do not.

Noise: a noisy engine takes a 64-bit ``seed``.  Plane pair ``i = p * PW + q``
draws from its own ``torch.Generator`` seeded ``mix_seed(seed, i)`` (the
counterpart of the reference's ``fold_in(key, i)``), mismatch first, then the
comparator offsets, in the batched engine and in the loop alike, so both
draw identical noise.  Its numbers are not the reference's (``jax.random``
and ``torch`` differ from one seed); tests hand both the same normals.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import constants as C
from repro_torch.core.decoder import decode_voltage, thresholds
from repro_torch.core.montecarlo import mc_count_noise
from repro_torch.core.quant import to_bitplanes
from repro_torch.core.rbl import rbl_voltage
from repro_torch.kernels.common import mix_seed

CHUNK_ELEMS = 1 << 24  # group counts held at once by the plane-batched engine


def _pad_to_groups(x: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % rows
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    return x


def group_counts(a_bits, w_bits, rows: int = C.ROWS) -> torch.Tensor:
    """Per-group binary MAC counts for ONE bit-plane pair.

    a_bits: {0,1}[..., K] RWL activation bits; w_bits: {0,1}[K, N] stored
    bits.  Returns int32[..., G, N] counts with G = ceil(K/rows).
    """
    a = _pad_to_groups(a_bits.to(torch.float32), -1, rows)
    w = _pad_to_groups(w_bits.to(torch.float32), 0, rows)
    g = a.shape[-1] // rows
    a = a.reshape(a.shape[:-1] + (g, rows))
    w = w.reshape((g, rows) + tuple(w.shape[1:]))
    return torch.einsum("...gr,grn->...gn", a, w).to(torch.int32)


def batched_group_counts(a_planes, w_planes,
                         rows: int = C.ROWS) -> torch.Tensor:
    """Group counts for ALL plane pairs in one contraction.

    a_planes: {0,1}[PA, ..., K]; w_planes: {0,1}[PW, K, N].
    Returns int32[PA*PW, ..., G, N], pair axis ordered i = p * PW + q.
    """
    a = _pad_to_groups(a_planes.to(torch.float32), -1, rows)
    w = _pad_to_groups(w_planes.to(torch.float32), 1, rows)
    pa, pw = a.shape[0], w.shape[0]
    mid = tuple(a.shape[1:-1])
    g = a.shape[-1] // rows
    a = a.reshape(pa, -1, g, rows)
    w = w.reshape((pw, g, rows) + tuple(w.shape[2:]))
    counts = torch.einsum("pbgr,qgrn->pqbgn", a, w).to(torch.int32)
    return counts.reshape((pa * pw,) + mid + counts.shape[-2:])


def fused_group_counts(a_planes, w_planes, rows: int = C.ROWS) -> torch.Tensor:
    """All plane-pair group counts as ONE G-batched GEMM.

    a_planes: {0,1}[PA, M, K]; w_planes: {0,1}[PW, K, N].
    Returns int32[G, PA*M, PW*N]: per K-group, the (PA*M) x (PW*N) count
    matrix, every plane pair riding the GEMM's free dimensions.
    """
    return _fused_counts_f32(a_planes, w_planes, rows).to(torch.int32)


def _fused_counts_f32(a_planes, w_planes, rows: int) -> torch.Tensor:
    a = _pad_to_groups(a_planes.to(torch.float32), -1, rows)
    w = _pad_to_groups(w_planes.to(torch.float32), 1, rows)
    pa, m, k = a.shape
    pw, _, n = w.shape
    g = k // rows
    a = a.reshape(pa * m, g, rows).transpose(0, 1)  # [G, PA*M, rows]
    w = w.transpose(0, 1).reshape(g, rows, pw * n)  # [G, rows, PW*N]
    return torch.bmm(a, w)


def _decode_counts_inline(counts, *, rows: int, rbl_mode: str):
    """Noise-free analog decode without materializing the thermometer axis.

    The comparisons of ``decoder.thermometer_code`` (count = #thresholds
    >= V, references descending), accumulated over the ``rows``
    comparators.  Bit-identical to ``decode_voltage``.
    """
    v = rbl_voltage(counts.to(torch.float32), rows=rows, mode=rbl_mode)
    thr = thresholds(rows, mode=rbl_mode, device=v.device)
    return count_at_or_above(v, thr)


def count_at_or_above(v: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """int32 number of comparator references ``thr[i] >= v``, elementwise:
    the decoded count of the thermometer code ``v > thr``."""
    dec = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for i in range(thr.shape[0]):
        dec += v <= thr[i]
    return dec


def plane_pair_weights(bits_a: int, bits_w: int, device=None) -> torch.Tensor:
    """int32[bits_a * bits_w] shift weights 2^(p+q), i = p * bits_w + q."""
    p = torch.arange(bits_a, dtype=torch.int32, device=device)[:, None]
    q = torch.arange(bits_w, dtype=torch.int32, device=device)[None, :]
    return (1 << (p + q)).reshape(-1)


def pair_generator(seed: int, pair: int, device=None) -> torch.Generator:
    """The generator plane pair ``pair`` draws from under ``seed``."""
    return torch.Generator(device=device or "cpu").manual_seed(
        mix_seed(seed, pair))


def decode_group_counts(counts, *, mode: str = "exact", rows: int = C.ROWS,
                        generator: Optional[torch.Generator] = None,
                        z_mismatch: Optional[torch.Tensor] = None,
                        z_comparator: Optional[torch.Tensor] = None,
                        mismatch: bool = False, mismatch_sigma=None,
                        comparator_offset_sigma=None,
                        rbl_mode: str = "lut") -> torch.Tensor:
    """Pass group counts through the (modeled) analog decode path.

    mode="exact": identity (clipped) — the digital equivalent.
    mode="sim":   counts -> k_eff (+ mismatch) -> V_RBL -> comparators
                  (+ offset) -> counts.

    ``mismatch=True`` draws device mismatch at the paper-calibrated sigma;
    ``mismatch_sigma`` sets it explicitly (the ``NoiseSpec`` path) and
    implies mismatch.  The normals come from ``generator`` (mismatch first,
    counts' shape; then the offsets, counts' shape + (rows,)) or are passed
    in as ``z_mismatch`` / ``z_comparator``.
    """
    if mode == "exact":
        return torch.clamp(counts, 0, rows)
    if mode != "sim":
        raise ValueError(mode)
    k_eff = counts.to(torch.float32)
    mismatch = mismatch or mismatch_sigma is not None
    if generator is None and ((mismatch and z_mismatch is None) or (
            comparator_offset_sigma is not None and z_comparator is None)):
        raise ValueError("sim with noise requires a generator (or the "
                         "normals z_mismatch / z_comparator)")
    if mismatch:
        k_eff = k_eff + mc_count_noise(generator, counts.shape, counts,
                                       sigma_vk=mismatch_sigma, z=z_mismatch)
    v = rbl_voltage(k_eff, rows=rows, mode=rbl_mode)
    return decode_voltage(v, rows=rows, mode=rbl_mode,
                          comparator_offset_sigma=comparator_offset_sigma,
                          generator=generator, z=z_comparator)


def _is_noisy(mode: str, decode_kw) -> bool:
    return mode == "sim" and bool(
        decode_kw.get("mismatch") or
        decode_kw.get("mismatch_sigma") is not None or
        decode_kw.get("comparator_offset_sigma") is not None)


def decoded_pyramid(u_a, u_w, *, bits_a: int, bits_w: int, rows: int,
                    decode: Callable[[torch.Tensor, int], torch.Tensor]
                    ) -> torch.Tensor:
    """sum_{p,q} 2^(p+q) sum_g decode(count[p, q, g]) for unsigned operands.

    u_a: int[..., K]; u_w: int[K, N]; ``decode(counts, n0)`` maps the float32
    group counts ``[G, PA*M, PW*nc]`` of output columns ``[n0, n0 + nc)`` to
    int32 decoded counts, elementwise.  Walks N in chunks of at most
    ``CHUNK_ELEMS`` counts.  Returns int32[..., N].
    """
    batch = tuple(u_a.shape[:-1])
    k, n = u_a.shape[-1], u_w.shape[-1]
    a_planes = to_bitplanes(u_a.reshape(-1, k), bits_a)  # [PA, M, K]
    m = a_planes.shape[1]
    g = -(-k // rows)
    wmat = plane_pair_weights(bits_a, bits_w, u_a.device).to(
        torch.int64).reshape(bits_a, 1, bits_w, 1)
    step = max(1, CHUNK_ELEMS // max(1, g * bits_a * m * bits_w))
    out = torch.empty((m, n), dtype=torch.int32, device=u_a.device)
    for n0 in range(0, n, step):
        w_planes = to_bitplanes(u_w[:, n0:n0 + step], bits_w)  # [PW, K, nc]
        nc = w_planes.shape[-1]
        dec = decode(_fused_counts_f32(a_planes, w_planes, rows), n0)
        dec = dec.reshape(g, bits_a, m, bits_w, nc).sum(0, dtype=torch.int64)
        out[:, n0:n0 + nc] = (dec * wmat).sum((0, 2)).to(torch.int32)
    return out.reshape(batch + (n,))


def bitserial_matmul_unsigned(u_a, u_w, *, bits_a: int = 8, bits_w: int = 8,
                              rows: int = C.ROWS, mode: str = "exact",
                              seed: Optional[int] = None,
                              **decode_kw) -> torch.Tensor:
    """Unsigned bit-serial matmul — the plane-batched engine.

    u_a: int[..., K] in [0, 2^bits_a); u_w: int[K, N] likewise.
    Returns int32[..., N] == u_a @ u_w when mode="exact", and noise-free
    ``sim`` decodes every integer count to itself.  ``rbl_mode`` ("lut",
    the default, or "physics") picks the voltage model of the sim decode.

    Noisy ``sim`` (``mismatch``, ``mismatch_sigma`` or
    ``comparator_offset_sigma``) needs ``seed`` and runs the per-pair loop
    :func:`bitserial_matmul_looped`: every plane pair's counts go through
    :func:`decode_group_counts` with the pair's own generator.
    """
    if _is_noisy(mode, decode_kw):
        if seed is None:
            raise ValueError("sim with noise requires a seed")
        return bitserial_matmul_looped(u_a, u_w, bits_a=bits_a, bits_w=bits_w,
                                       rows=rows, mode=mode, seed=seed,
                                       **decode_kw)
    for name in ("mismatch", "mismatch_sigma", "comparator_offset_sigma"):
        decode_kw.pop(name, None)
    rbl_mode = decode_kw.pop("rbl_mode", "lut")
    if decode_kw:
        raise TypeError(f"unknown decode kwargs: {sorted(decode_kw)}")
    if mode == "exact":
        def decode(c, n0):
            return torch.clamp(c, 0, rows).to(torch.int32)
    elif mode == "sim":
        def decode(c, n0):
            return _decode_counts_inline(c, rows=rows, rbl_mode=rbl_mode)
    else:
        raise ValueError(mode)
    return decoded_pyramid(u_a, u_w, bits_a=bits_a, bits_w=bits_w, rows=rows,
                           decode=decode)


def bitserial_matmul_looped(u_a, u_w, *, bits_a: int = 8, bits_w: int = 8,
                            rows: int = C.ROWS, mode: str = "exact",
                            seed: Optional[int] = None,
                            **decode_kw) -> torch.Tensor:
    """Seed reference engine: one count contraction + decode per plane pair.

    Bit-identical to :func:`bitserial_matmul_unsigned` (noise draws
    included: pair ``i`` draws from :func:`pair_generator` (seed, i)); kept
    as the oracle of the batched engine and the fused kernel.
    """
    if _is_noisy(mode, decode_kw) and seed is None:
        raise ValueError("sim with noise requires a seed")
    a_planes = to_bitplanes(u_a, bits_a)  # [PA, ..., K]
    w_planes = to_bitplanes(u_w, bits_w)  # [PW, K, N]
    out = None
    for p in range(bits_a):
        for q in range(bits_w):
            kw = dict(decode_kw)
            if seed is not None:
                kw["generator"] = pair_generator(seed, p * bits_w + q,
                                                 u_a.device)
            counts = group_counts(a_planes[p], w_planes[q], rows)
            dec = decode_group_counts(counts, rows=rows, mode=mode, **kw)
            part = torch.sum(dec, dim=-2, dtype=torch.int32) << (p + q)
            out = part if out is None else out + part
    return out
