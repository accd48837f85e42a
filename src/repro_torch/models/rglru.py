"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
``repro/models/rglru.py``).

Block = conv1d (width 4) -> real-gated linear recurrent unit, flanked by an
input GeLU gate branch (the "recurrent block" of arXiv:2402.19427):

    r_t = sigmoid(W_a x_t)                    (recurrence gate)
    i_t = sigmoid(W_x x_t)                    (input gate)
    a_t = exp(c * softplus(L) * (-r_t))       (log-space stable; c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``w_gate_branch``, ``w_x_branch`` and ``w_out`` take the fabric; the gates
``w_a`` and ``w_i`` (with their biases) stay off it, as in the reference.
Train and prefill run the recurrence as :func:`associative_scan`, the
reference's ``jax.lax.associative_scan`` (log depth: odd/even pairs, the
scan of the reduced sequence, then the fix-up), so a 2048-token prefill is
eleven levels of tensor ops, not 2048 steps; decode is the O(1) step with
the carried ``h``.

A bucketed prefill (``true_len``, an int or a 0-dim integer tensor on x's
device, never read back) returns ``h`` at ``true_len - 1`` and the conv
state of the ``cw - 1`` conv inputs that end at ``true_len``: the state of
the reference's exact-length prefill.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.rbl import ExpF32
from repro_torch.models.common import dense, init_dense, softplus
from repro_torch.models.mlp import gelu_tanh
from repro_torch.models.ssd import float_of, causal_conv

_C = 8.0


class RgLruCache(NamedTuple):
    h: torch.Tensor  # (B, W) float32
    conv_state: torch.Tensor  # (B, cw-1, W), activations' dtype


def init_rglru(generator: torch.Generator, d_model: int, width: int,
               conv_width: int = 4, *, device=None, dtype=torch.bfloat16):
    """The reference's leaves, dtypes and shapes (``lam`` float32)."""
    kw = dict(device=device, dtype=dtype)
    gdev = generator.device
    conv_w = torch.randn((conv_width, width), generator=generator,
                         dtype=torch.float32, device=gdev) * conv_width ** -0.5
    lam = torch.rand((width,), generator=generator, dtype=torch.float32,
                     device=gdev) * 3.0 + 1.0
    return {
        "w_gate_branch": init_dense(generator, d_model, width, **kw),
        "w_x_branch": init_dense(generator, d_model, width, **kw),
        "conv_w": conv_w.to(**kw),
        "conv_b": torch.zeros((width,), **kw),
        "w_a": init_dense(generator, width, width, bias=True, **kw),
        "w_i": init_dense(generator, width, width, bias=True, **kw),
        "lam": lam.to(device),
        "w_out": init_dense(generator, width, d_model, **kw),
    }


def _sigmoid_gate(p, xc):
    """sigmoid(xc @ w + b) in float32, off the fabric, as XLA compiles the
    reference's ``sigmoid(dense(p, xc).astype(f32))``: the product rounded
    to xc's dtype, the bias added in float32 without rounding, and the
    logistic as 1 / (1 + exp(-z)) with its float32 exp."""
    ft = float_of(xc)
    z = (xc @ p["w"].to(xc.dtype)).to(ft) + p["b"].to(ft)
    return 1.0 / (1.0 + ExpF32.apply(-z))


def _gates(params, xc, xc_f32):
    """(a, b) of the recurrence h = a * h + b, float32; the gate
    projections off the fabric.  ``xc_f32`` is the conv's output before its
    last rounding, which XLA's fusion hands the input gate's product."""
    r = _sigmoid_gate(params["w_a"], xc)
    i = _sigmoid_gate(params["w_i"], xc)
    log_a = -_C * softplus(params["lam"]) * r  # <= 0
    a = ExpF32.apply(log_a)
    gated_x = i * xc_f32
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * gated_x
    return a, b


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1 (``even`` as long
    as ``odd`` or one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1)


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the affine maps ``h -> a h + b``
    composed left to right, ``(al, bl) o (ar, br) = (al ar, ar bl + br)``,
    in ``jax.lax.associative_scan``'s recursion and order of operations.
    Returns (A, H): ``H[:, t]`` is ``h_t`` from ``h_{-1} = 0``."""
    n = a.shape[1]
    if n < 2:
        return a, b
    al, bl, ar, br = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    oa, ob = associative_scan(al * ar, ar * bl + br)  # the odd elements
    if n % 2 == 0:
        pa, pb, qa, qb = oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2]
    else:
        pa, pb, qa, qb = oa, ob, a[:, 2::2], b[:, 2::2]
    ea = torch.cat([a[:, :1], pa * qa], dim=1)
    eb = torch.cat([b[:, :1], qa * pb + qb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_forward(params, x, *, h0: Optional[torch.Tensor] = None,
                  conv_state: Optional[torch.Tensor] = None, true_len=None,
                  **imc):
    """Full-sequence forward. x: (B, S, D) -> (y, RgLruCache at
    ``true_len`` (default: the sequence's end))."""
    gate = gelu_tanh(dense(params["w_gate_branch"], x, **imc))
    xb = dense(params["w_x_branch"], x, **imc)
    xc, xc_f32, conv_state = causal_conv(
        xb, params["conv_w"], params["conv_b"], conv_state, true_len,
        unrounded=True)
    a, b = _gates(params, xc, xc_f32)
    if h0 is not None:
        # the carried state folds in as a virtual step: h_t gains the
        # a-prefix times h0
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    _, h = associative_scan(a, b)
    y = dense(params["w_out"], h.to(x.dtype) * gate, **imc)
    if true_len is None:
        h_last = h[:, -1]
    else:
        last = torch.as_tensor(true_len, device=x.device).reshape(1)
        h_last = h.index_select(1, last.to(torch.int64) - 1)[:, 0]
    return y, RgLruCache(h_last, conv_state)


def rglru_decode(params, x, h, conv_state, **imc):
    """One-step decode. x: (B, 1, D); h: (B, W) float32; conv_state: (B,
    cw-1, W).  Returns (y, new RgLruCache); nothing passed in is modified."""
    gate = gelu_tanh(dense(params["w_gate_branch"], x, **imc))
    xb = dense(params["w_x_branch"], x, **imc)
    xc, xc_f32, conv_state = causal_conv(
        xb, params["conv_w"], params["conv_b"], conv_state, unrounded=True)
    a, b = _gates(params, xc, xc_f32)  # (B, 1, W)
    h = a[:, 0] * h + b[:, 0]
    y = dense(params["w_out"], h[:, None].to(x.dtype) * gate, **imc)
    return y, RgLruCache(h, conv_state)
