"""Shared model utilities: norms, rope, dense layers (optionally IMC-backed)
and init helpers (port of ``repro/models/common.py``).

Models are functional: params are plain dicts of tensors, as in the
reference, so the converter from the JAX layout is a rename and an unstack.
Sharding hints and the noise-key context are not ported: the port runs one
card and noise-free specs (``exact`` and ``sim``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fabric import FabricSpec
from repro_torch.core.imc_linear import imc_linear_apply


# ---------------------------------------------------------------------- norms
def init_rmsnorm(d: int, *, device=None, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """RMSNorm in f32; the result takes ``out_dtype`` (default x's dtype)."""
    dt = out_dtype or x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * params["scale"].to(torch.float32)).to(dt)


# ----------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, d); positions: (B, S) or (S,) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    ang = positions.to(torch.float32)[..., None] * freqs  # (B, S, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    cos = cos[..., None, :]  # (B, S, 1, d/2)
    sin = sin[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- dense layers
def init_dense(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, device=None, dtype=torch.bfloat16,
               scale: float | None = None):
    """Normal(0, d_in^-1/2) weights in the reference's (d_in, d_out) layout."""
    s = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device) * s
    p = {"w": w.to(device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(params, x: torch.Tensor, *,
          spec: Optional[FabricSpec] = None) -> torch.Tensor:
    """Dense projection; routes through the IMC fabric when ``spec`` is given.

    Every projection of the model funnels through here.  Under a spec the
    weights are cast to f32 and re-quantized per column on every call, as in
    the reference; the activations quantize per tensor in their own dtype.
    """
    if spec is not None:
        y = imc_linear_apply(x, params["w"].to(torch.float32),
                             params.get("b"), spec=spec)
        return y.to(x.dtype)
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y
