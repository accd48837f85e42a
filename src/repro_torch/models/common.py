"""Shared model utilities: norms, rope, dense layers (optionally IMC-backed)
and init helpers (port of ``repro/models/common.py``).

Models are functional: params are plain dicts of tensors, as in the
reference, so the converter from the JAX layout is a rename and an unstack.
Sharding hints are not ported: the port runs one card.

Noisy fabric specs draw from an ambient seed: inside
``with fabric_noise_seed(seed):`` each ``dense`` call under a noisy spec takes
a fresh 64-bit seed ``mix_seed(seed, call index)`` (:func:`next_fabric_seed`,
the counterpart of the reference's ``fabric_noise_key`` / ``fold_fabric_key``),
so a forward is fully seeded without threading seeds through every layer.
Given a seed table instead (an int32 (calls, 2) tensor whose row ``n`` holds
``seed_words(mix_seed(seed, n))``, :func:`~repro_torch.kernels.common
.seed_table`), call ``n`` takes row ``n``: the same seeds, read from device
memory, so a captured CUDA graph draws fresh noise on every replay.

A training forward hands each layer its own span of calls up front
(:func:`take_fabric_seeds`): a layer re-run by ``torch.utils.checkpoint`` in
the backward re-enters its span and replays the seeds of its first run.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.core.fabric import FabricSpec
from repro_torch.core.imc_linear import imc_linear_apply
from repro_torch.core.rbl import ExpF32
from repro_torch.kernels.common import mix_seed
from repro_torch.tree import tree_leaves


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


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, the reference's ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)), with XLA's CPU float32 exp (``F.softplus`` turns to the
    identity above 20 and rounds apart below it)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(ExpF32.apply(-torch.abs(x)))


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


_FABRIC_SEED = threading.local()


class fabric_noise_seed:
    """Context manager: the seed noisy FabricSpecs draw from.

    ``with fabric_noise_seed(seed): prefill(...)`` — each ``dense`` call
    under a noisy spec takes :func:`next_fabric_seed`, so one forward's
    projections draw independent noise, and the same seed replays it.
    ``seed`` is a 64-bit integer or a seed table (see the module docstring).

    ``start`` and ``stop`` make the context a span of calls ``start ..
    stop - 1`` of ``seed`` (:func:`take_fabric_seeds`); a call past
    ``stop`` raises.  Entering the context again replays the span.
    """

    def __init__(self, seed, start: int = 0, stop: Optional[int] = None):
        self.seed = seed if isinstance(seed, torch.Tensor) else int(seed)
        self.start, self.stop = start, stop

    def __enter__(self):
        self.prev = getattr(_FABRIC_SEED, "state", None)
        _FABRIC_SEED.state = {"seed": self.seed, "n": self.start,
                              "stop": self.stop}
        return self

    def __exit__(self, *exc):
        _FABRIC_SEED.state = self.prev


def next_fabric_seed():
    """A fresh seed off the ambient one: the call index mixed in on the
    host, or the table's row of that index; None outside a
    :class:`fabric_noise_seed` context."""
    st = getattr(_FABRIC_SEED, "state", None)
    if st is None:
        return None
    n, seed = st["n"], st["seed"]
    st["n"] += 1
    if st["stop"] is not None and n >= st["stop"]:
        raise IndexError(f"noisy dense call {n} lies past its span's end "
                         f"{st['stop']}")
    if isinstance(seed, torch.Tensor):
        if n >= seed.shape[0]:
            raise IndexError(f"noisy dense call {n} has no row in a seed "
                             f"table of {seed.shape[0]}")
        return seed[n]
    return mix_seed(seed, n)


def take_fabric_seeds(calls: int) -> Optional[fabric_noise_seed]:
    """The next ``calls`` seeds of the ambient context as a context of their
    own (the ambient counter moves past them), or None outside a
    :class:`fabric_noise_seed` context.  Entered, the span draws the same
    seeds as the ambient context would have, however often it is entered."""
    st = getattr(_FABRIC_SEED, "state", None)
    if st is None:
        return None
    n = st["n"]
    st["n"] += calls
    if st["stop"] is not None and st["n"] > st["stop"]:
        raise IndexError(f"a span of {calls} calls from {n} lies past its "
                         f"context's end {st['stop']}")
    return fabric_noise_seed(st["seed"], start=n, stop=n + calls)


def dense(params, x: torch.Tensor, *,
          spec: Optional[FabricSpec] = None) -> torch.Tensor:
    """Dense projection; routes through the IMC fabric when ``spec`` is given.

    Every projection of the model funnels through here.  Under a spec the
    weights are cast to f32 and re-quantized per column on every call, as in
    the reference; the activations quantize per tensor in their own dtype.
    A noisy spec takes :func:`next_fabric_seed`, and raises outside a
    :class:`fabric_noise_seed` context.
    """
    if spec is not None:
        seed = next_fabric_seed() if spec.noisy else None
        if spec.noisy and seed is None:
            raise ValueError(
                f"FabricSpec {spec.label} is noisy but no seed is available: "
                "wrap the forward in models.common.fabric_noise_seed(seed) "
                "or pass noise_seed= to prefill/decode_step")
        y = imc_linear_apply(x, params["w"].to(torch.float32),
                             params.get("b"), spec=spec, seed=seed)
        return y.to(x.dtype)
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def count_params(tree) -> int:
    """Elements over every tensor leaf of ``tree``."""
    return sum(t.numel() for t in tree_leaves(tree))
