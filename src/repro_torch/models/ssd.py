"""Mamba2 SSD (state-space duality) block: the chunked parallel form and the
O(1) decode (port of ``repro/models/ssd.py``).

Selective SSM with a scalar decay per head (arXiv:2405.21060):

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t x_t^T        (P x N state/head)
    y_t = C_t . h_t + D_h * x_t

The chunked algorithm: an intra-chunk quadratic term (attention-like) plus
an inter-chunk state recurrence, a loop over the S / chunk chunks (the
reference's ``jax.lax.scan``).  A sequence that is not a multiple of
``chunk`` runs as one chunk, as in the reference.  The block wraps the SSM
with in_proj -> causal conv -> SiLU, a SiLU(z) gate, the gated RMSNorm
(float32 in, float32 scale) and out_proj; ``in_proj`` and ``out_proj`` take
the fabric.

A bucketed prefill (``true_len``: an int, or a 0-dim integer tensor on x's
device, never read back to the host) gives the state at ``true_len``, the
reference's exact-length prefill's: ``dt`` is 0 past it, so the decay is 1
and no input enters ``h``, and the conv state holds the ``cw - 1`` conv
inputs that end at ``true_len``.  The outputs at real positions are the
reference's.  (The reference's own bucketed prefill scans the padding into
both states.)

The exponentials are XLA's CPU float32 ``exp`` (:class:`~repro_torch.core
.rbl.ExpF32`), softplus is the reference's ``logaddexp(x, 0)``
(:func:`~repro_torch.models.common.softplus`); the sums of the einsums and
of ``cumsum`` take torch's order, not XLA's (its CPU ``cumsum`` adds in
tiles of 16), so the float32 results are held to the reference within
bounds, not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.rbl import ExpF32
from repro_torch.models.common import (dense, init_dense, init_rmsnorm,
                                       rmsnorm, softplus)
from repro_torch.models.mlp import silu


class SsdCache(NamedTuple):
    conv_state: torch.Tensor  # (B, cw-1, conv_channels), activations' dtype
    ssm_state: torch.Tensor  # (B, H, P, N) float32


def init_ssd(generator: torch.Generator, d_model: int, *, expand: int = 2,
             headdim: int = 64, state: int = 128, n_groups: int = 1,
             conv_width: int = 4, device=None, dtype=torch.bfloat16):
    """The reference's leaves, dtypes and shapes: float32 ``a_log``,
    ``d_skip``, ``dt_bias`` and norm scale; the rest in ``dtype``."""
    d_inner = expand * d_model
    heads = d_inner // headdim
    conv_ch = d_inner + 2 * n_groups * state
    gdev = generator.device
    conv_w = torch.randn((conv_width, conv_ch), generator=generator,
                         dtype=torch.float32, device=gdev) * conv_width ** -0.5
    a = torch.rand((heads,), generator=generator, dtype=torch.float32,
                   device=gdev) * 15.0 + 1.0
    return {
        "in_proj": init_dense(generator, d_model,
                              2 * d_inner + 2 * n_groups * state + heads,
                              device=device, dtype=dtype),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.log(a).to(device),
        "d_skip": torch.ones((heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((heads,), dtype=torch.float32, device=device),
        "norm": init_rmsnorm(d_inner, device=device),
        "out_proj": init_dense(generator, d_inner, d_model, device=device,
                               dtype=dtype),
    }


def _split_proj(proj, d_inner: int, n_groups: int, state: int):
    conv_ch = d_inner + 2 * n_groups * state
    return (proj[..., :d_inner], proj[..., d_inner:d_inner + conv_ch],
            proj[..., d_inner + conv_ch:])


def _state_at(xp: torch.Tensor, n: int, true_len=None) -> torch.Tensor:
    """The ``n`` rows of the padded conv input ``xp`` (``n`` rows of state,
    then the sequence) that end at sequence position ``true_len`` (default:
    the sequence's end), gathered on the device."""
    if true_len is None:
        return xp[:, xp.shape[1] - n:]
    start = torch.as_tensor(true_len, device=xp.device).reshape(1)
    idx = start.to(torch.int64) + torch.arange(n, device=xp.device)
    return xp.index_select(1, idx)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None, true_len=None,
                unrounded: bool = False):
    """Depthwise causal conv, op by op in x's dtype as the reference sums it.
    x: (B, S, C); w: (cw, C); state: (B, cw-1, C).  Returns (out, the conv
    state at ``true_len``); with ``unrounded``, (out, out_f32, state), where
    ``out_f32`` is the last addition, the bias's, in float32 without its
    rounding to x's dtype (what XLA's fusion hands a float32 consumer)."""
    cw, s = w.shape[0], x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * w[i]
    conv_state = _state_at(xp, cw - 1, true_len)
    if unrounded:
        ft = float_of(out)
        return out + b, out.to(ft) + b.to(ft), conv_state
    return out + b, conv_state


def float_of(x: torch.Tensor) -> torch.dtype:
    """The dtype the reference's float32 casts take: float32, or float64
    for a float64 witness."""
    return torch.promote_types(x.dtype, torch.float32)


def ssd_chunked(x, dt, a_neg, B, C, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (Bt, S, H, P); dt: (Bt, S, H) >= 0; a_neg: (H,) < 0; B, C: (Bt, S, G,
    N).  Returns y (Bt, S, H, P) and h_last (Bt, H, P, N), float32.
    """
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    if s % chunk != 0:
        chunk = s
    nc = s // chunk
    ft = float_of(x)

    xc = x.reshape(bt, nc, chunk, h, p).to(ft)
    dtc = dt.reshape(bt, nc, chunk, h)
    Bh = B.reshape(bt, nc, chunk, g, n).repeat_interleave(rep, dim=3).to(ft)
    Ch = C.reshape(bt, nc, chunk, g, n).repeat_interleave(rep, dim=3).to(ft)

    a = dtc * a_neg  # (bt, nc, chunk, h) <= 0
    cum = torch.cumsum(a, dim=2)

    # intra-chunk: M[b,c,h,i,j] = CB * exp(cum_i - cum_j) * dt_j, i >= j.
    # The exponent is masked, not the product: exp of the i < j entries
    # overflows, and inf * 0 would poison the backward with NaNs.
    cb = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    cum_t = cum.transpose(2, 3)  # (bt, nc, h, chunk)
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    diff = torch.where(causal, cum_t[..., :, None] - cum_t[..., None, :],
                       float("-inf"))
    m = cb * ExpF32.apply(diff) * dtc.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", m, xc)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    sdec = ExpF32.apply(cum[:, :, -1:, :] - cum)  # (bt, nc, chunk, h)
    s_chunk = torch.einsum("bcjh,bcjhn,bcjhp->bchpn", sdec * dtc, Bh, xc)

    # the inter-chunk recurrence over the chunks
    cdec = ExpF32.apply(cum[:, :, -1, :])  # (bt, nc, h)
    hprev = (x.new_zeros((bt, h, p, n), dtype=ft) if h0 is None
             else h0.to(ft))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = cdec[:, c, :, None, None] * hprev + s_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (bt, nc, h, p, n)

    y_inter = torch.einsum("bcihn,bchpn,bcih->bcihp", Ch, h_prevs,
                           ExpF32.apply(cum))
    return (y_intra + y_inter).reshape(bt, s, h, p), hprev


def _gated_out(params, y, z, x_dtype, **imc):
    """The gated RMSNorm on float32 values, then out_proj."""
    y = rmsnorm(params["norm"], y * silu(z.to(float_of(z))))
    return dense(params["out_proj"], y.to(x_dtype), **imc)


def _dt(params, dt_raw):
    return softplus(dt_raw.to(float_of(dt_raw)) + params["dt_bias"])


def ssd_forward(params, x, *, expand: int = 2, headdim: int = 64,
                state: int = 128, n_groups: int = 1, chunk: int = 128,
                cache: Optional[SsdCache] = None, true_len=None, **imc):
    """Full-sequence forward. x: (B, S, D) -> (y, SsdCache at ``true_len``
    (default: the sequence's end))."""
    bt, s, d = x.shape
    d_inner = expand * d
    heads = d_inner // headdim
    proj = dense(params["in_proj"], x, **imc)
    z, xbc, dt_raw = _split_proj(proj, d_inner, n_groups, state)
    xbc, conv_state = causal_conv(
        xbc, params["conv_w"], params["conv_b"],
        cache.conv_state if cache is not None else None, true_len)
    xbc = silu(xbc)
    xs = xbc[..., :d_inner]
    B = xbc[..., d_inner:d_inner + n_groups * state]
    C = xbc[..., d_inner + n_groups * state:]
    dt = _dt(params, dt_raw)
    if true_len is not None:  # no decay and no input past the prompt
        live = torch.arange(s, device=x.device) < true_len
        dt = torch.where(live[None, :, None], dt, 0.0)
    a_neg = -ExpF32.apply(params["a_log"])
    xh = xs.reshape(bt, s, heads, headdim)
    y, h_last = ssd_chunked(
        xh, dt, a_neg, B.reshape(bt, s, n_groups, state),
        C.reshape(bt, s, n_groups, state), chunk,
        h0=cache.ssm_state if cache is not None else None)
    y = y + params["d_skip"][None, None, :, None] * xh.to(float_of(xh))
    out = _gated_out(params, y.reshape(bt, s, d_inner), z, x.dtype, **imc)
    return out, SsdCache(conv_state, h_last)


def ssd_decode(params, x, cache: SsdCache, *, expand: int = 2,
               headdim: int = 64, state: int = 128, n_groups: int = 1,
               **imc):
    """One-token decode. x: (B, 1, D).  Returns (y, new SsdCache); the
    cache passed in is not modified."""
    bt, _, d = x.shape
    d_inner = expand * d
    heads = d_inner // headdim
    proj = dense(params["in_proj"], x, **imc)
    z, xbc, dt_raw = _split_proj(proj, d_inner, n_groups, state)
    xbc, conv_state = causal_conv(xbc, params["conv_w"], params["conv_b"],
                                  cache.conv_state)
    xbc = silu(xbc)
    xs = xbc[..., :d_inner]
    B = xbc[..., d_inner:d_inner + n_groups * state]
    C = xbc[..., d_inner + n_groups * state:]
    dt = _dt(params, dt_raw)[:, 0]  # (B, H)
    a_neg = -ExpF32.apply(params["a_log"])
    ft = float_of(xs)
    xh = xs.reshape(bt, heads, headdim).to(ft)
    rep = heads // n_groups
    Bh = B.reshape(bt, n_groups, state).repeat_interleave(rep, dim=1).to(ft)
    Ch = C.reshape(bt, n_groups, state).repeat_interleave(rep, dim=1).to(ft)
    dec = ExpF32.apply(dt * a_neg)  # (B, H)
    h = (dec[..., None, None] * cache.ssm_state
         + torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, xh))
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + \
        params["d_skip"][None, :, None] * xh
    out = _gated_out(params, y.reshape(bt, 1, d_inner), z, x.dtype, **imc)
    return out, SsdCache(conv_state, h)
