"""Feed-forward blocks: SwiGLU / GEGLU / GELU, optionally IMC-executed (port
of ``repro/models/mlp.py``).

The reference's ``jax.nn.gelu`` is the tanh approximation (torch's
``F.gelu`` defaults to erf), and on a bf16 input it evaluates op by op in
bf16, with its constants rounded to bf16.  :func:`gelu_tanh` and
:func:`silu` write the same formulas op by op in the input's dtype, so the
activations match the reference bit for bit (``F.gelu(approximate="tanh")``
rounds once, and differs from it in about 4 of 10 bf16 outputs by an ulp).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import dense, init_dense


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, kind: str,
             *, device=None, dtype=torch.bfloat16):
    kw = dict(device=device, dtype=dtype)
    if kind in ("swiglu", "geglu"):
        return {"w_gate": init_dense(generator, d_model, d_ff, **kw),
                "w_up": init_dense(generator, d_model, d_ff, **kw),
                "w_down": init_dense(generator, d_ff, d_model, **kw)}
    if kind == "gelu":
        return {"w_up": init_dense(generator, d_model, d_ff, **kw),
                "w_down": init_dense(generator, d_ff, d_model, **kw)}
    raise ValueError(kind)


def _const(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float (a scalar operand, so no
    host-to-device copy; exact in the op's f32 arithmetic)."""
    return torch.tensor(v, dtype=dtype).item()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), op by op in x's
    dtype — ``jax.nn.gelu(x)`` as the reference computes it."""
    c = _const(math.sqrt(2 / math.pi), x.dtype)
    k = _const(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x / (1 + exp(-x)), op by op in x's dtype — ``jax.nn.silu(x)``."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def apply_mlp(params, x: torch.Tensor, kind: str, **imc) -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        g = dense(params["w_gate"], x, **imc)
        u = dense(params["w_up"], x, **imc)
        act = silu(g) if kind == "swiglu" else gelu_tanh(g)
        return dense(params["w_down"], act * u, **imc)
    u = dense(params["w_up"], x, **imc)
    return dense(params["w_down"], gelu_tanh(u), **imc)
