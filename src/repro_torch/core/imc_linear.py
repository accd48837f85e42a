"""ImcLinear — a Linear layer executed on the modeled IMC fabric (port of
``repro/core/imc_linear.py``).

Forward: dynamic activation quant at ``bits_a`` + per-channel weights at
``bits_w`` + the spec's fabric engine, dequant, optional bias.

Backward: straight-through estimator — gradients flow as if the layer were
the underlying float matmul (standard QAT practice), so the same layer
trains and serves.  The reference's ``jax.custom_vjp`` is a
``torch.autograd.Function`` here; the spec and the noise seed take no
gradient.  The backward is two float32 matmuls: the reference has no
backward kernel, and neither has the port.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.fabric import FabricSpec, fabric_matmul


class _ImcLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, spec, seed):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = None if b is None else b.dtype
        y = fabric_matmul(x, w, spec, seed=seed)
        if b is not None:
            y = y + b
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        g2 = g.reshape(-1, g.shape[-1])
        dx = torch.einsum("...n,kn->...k", g, w.to(torch.float32)).to(x.dtype)
        dw = torch.einsum("mk,mn->kn",
                          x.reshape(-1, x.shape[-1]).to(torch.float32),
                          g2).to(w.dtype)
        db = None if ctx.b_dtype is None else \
            torch.sum(g2, dim=0).to(ctx.b_dtype)
        return dx, dw, db, None, None


def imc_linear_apply(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     spec: FabricSpec | None = None,
                     seed: Optional[int] = None) -> torch.Tensor:
    """y = fabric(x @ w) + b with STE backward, configured by ``spec``
    (f32 out); ``seed`` feeds a noisy spec (the reference's ``key=``)."""
    return _ImcLinear.apply(x, w, b,
                            spec if spec is not None else FabricSpec(), seed)


def init_imc_linear(generator: torch.Generator, d_in: int, d_out: int, *,
                    use_bias: bool = False, dtype=torch.float32,
                    scale: float | None = None) -> dict:
    """He-style init on the generator's device; params dict compatible with
    the model layers."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = (torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                     device=generator.device) * s).to(dtype)
    p = {"w": w}
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def apply_imc_linear(params: dict, x: torch.Tensor, *,
                     spec: FabricSpec | None = None,
                     seed: Optional[int] = None) -> torch.Tensor:
    return imc_linear_apply(x, params["w"], params.get("b"), spec=spec,
                            seed=seed)
