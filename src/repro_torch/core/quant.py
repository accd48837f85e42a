"""Quantization utilities for the bit-serial IMC MAC (port of
``repro/core/quant.py``).

Symmetric linear quantization to signed ``bits``-wide integers in
[-(2^{b-1}-1), 2^{b-1}-1], with per-tensor (activations, dynamic) or
per-channel (weights) scales.

:func:`quantize` reproduces the reference as its model path runs it: inside
``jax.jit`` (``fabric_matmul`` is jitted), where XLA computes it as

    m     = max(amax, eps)            in x's dtype
    scale = f32(m) * f32(1 / qmax)    kept in f32 (the division by the
                                      constant qmax becomes a multiply)
    q     = round(x / scale.to(x.dtype))   in x's dtype, half to even

So a bf16 activation divides by a bf16 scale, and its f32 dequant scale is
the unrounded product.  The int8 codes and the scales match the jitted
reference bit for bit.

Bit-plane view: signed operands use offset-binary u = q + 2^{b-1}, and the
signed product is recovered with rank-1 corrections:

  q_a . q_w = u_a . u_w - o * sum(u_w) - o * sum(u_a) + K * o^2,   o = 2^{b-1}
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Quantized(NamedTuple):
    q: torch.Tensor  # int8 signed quantized values
    scale: torch.Tensor  # broadcastable f32 scale: x ~= q * scale


def quantize(x: torch.Tensor, bits: int = 8, axis=None,
             eps: float = 1e-8) -> Quantized:
    """Symmetric quantization; ``axis`` = reduction axes for the scale
    (None -> per-tensor).  Keeps dims for broadcastable scales."""
    qmax = (1 << (bits - 1)) - 1
    ax = tuple(range(x.ndim)) if axis is None else axis
    amax = torch.amax(torch.abs(x), dim=ax, keepdim=True)
    # f32(1/qmax) as a Python float: exact in f32, and no host-to-device copy
    recip = float(np.float32(1.0) / np.float32(qmax))
    scale = torch.clamp_min(amax, eps).to(torch.float32) * recip
    q = torch.clamp(torch.round(x / scale.to(x.dtype)), -qmax, qmax)
    return Quantized(q.to(torch.int8), scale)


def to_offset_binary(q: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Signed q -> unsigned offset-binary u = q + 2^{b-1} (int32)."""
    return q.to(torch.int32) + (1 << (bits - 1))


def to_bitplanes(u: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Unsigned u -> stacked {0,1} planes, LSB first: uint8[bits, ...]."""
    u = u.to(torch.int32)
    shifts = torch.arange(bits, dtype=torch.int32, device=u.device).reshape(
        (bits,) + (1,) * u.ndim)
    return ((u[None] >> shifts) & 1).to(torch.uint8)


def from_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_bitplanes`."""
    bits = planes.shape[0]
    w = (1 << torch.arange(bits, dtype=torch.int32, device=planes.device)
         ).reshape((bits,) + (1,) * (planes.ndim - 1))
    return torch.sum(planes.to(torch.int32) * w, dim=0, dtype=torch.int32)


def signed_product_correction(u_a: torch.Tensor, u_w: torch.Tensor,
                              bits_a: int = 8, bits_w: int | None = None):
    """Rank-1 correction so that q_a.q_w is recovered from u_a.u_w.

    ``u_a``: int32[..., K] offset-binary activations at ``bits_a``,
    ``u_w``: int32[K, N] at ``bits_w`` (defaults to ``bits_a``).  Returns
    the (..., N) tensor to be SUBTRACTED from the unsigned matmul.
    """
    o_a = 1 << (bits_a - 1)
    o_w = 1 << ((bits_w if bits_w is not None else bits_a) - 1)
    k_dim = u_w.shape[0]
    col = torch.sum(u_w, dim=0, dtype=torch.int32)  # [N]
    row = torch.sum(u_a, dim=-1, keepdim=True, dtype=torch.int32)  # [..., 1]
    return o_a * col + o_w * row - k_dim * o_a * o_w
