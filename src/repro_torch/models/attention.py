"""GQA attention: full-causal and sliding-window, prefill and decode (port of
``repro/models/attention.py``; the training forward comes later).

Prefill runs over query chunks against the full K/V (global layers) or a
window+chunk span (local layers); decode runs a single-token query against
the cache.  Two cache layouts:

  * :class:`AttnCache` — one ring per slot: ``k``/``v`` (B, T_alloc, KV, hd)
    roped keys, ``key_pos`` (B, T_alloc) absolute positions (-1 = empty).
    The tested oracle.
  * :class:`PagedAttnCache` — one pool per layer shared by all slots:
    ``k``/``v`` (num_blocks, block_size, KV, hd), read through a per-slot
    block table by the ``paged_attn`` kernel.

Numerics follow the reference: dots in the operands' dtype with f32
accumulation (products of bf16 values are exact in f32), softmax in f32,
masked scores at ``NEG_INF``.

Unlike the functional reference, decode writes the new K/V into the cache
tensors in place and returns the same cache object: the pools are the
largest tensors of a serving process and are never copied.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.common import apply_rope, dense, init_dense

NEG_INF = -1e30


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, *, qkv_bias: bool = False,
                   device=None, dtype=torch.bfloat16):
    kw = dict(device=device, dtype=dtype)
    return {
        "wq": init_dense(generator, d_model, n_heads * head_dim,
                         bias=qkv_bias, **kw),
        "wk": init_dense(generator, d_model, n_kv_heads * head_dim,
                         bias=qkv_bias, **kw),
        "wv": init_dense(generator, d_model, n_kv_heads * head_dim,
                         bias=qkv_bias, **kw),
        "wo": init_dense(generator, n_heads * head_dim, d_model, **kw),
    }


def _project_qkv(params, x, n_heads, n_kv_heads, head_dim, positions,
                 rope_theta, **imc):
    b, s, _ = x.shape
    q = dense(params["wq"], x, **imc).reshape(b, s, n_heads, head_dim)
    k = dense(params["wk"], x, **imc).reshape(b, s, n_kv_heads, head_dim)
    v = dense(params["wv"], x, **imc).reshape(b, s, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KV,hd); mask broadcastable to
    (B,KV,rep,Sq,Sk).  Grouped formulation (no materialized K/V repeat).

    The dots contract the operands' values with f32 accumulation, as the
    reference's ``preferred_element_type=f32`` einsums do; the softmax runs
    in f32 and its probabilities round to v's dtype before the second dot.
    Returns (B, Sq, H, hd) in q's dtype.
    """
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    qg = q.reshape(b, sq, kv, rep, hd).to(torch.float32)
    scores = torch.einsum("bqkrd,btkd->bkrqt", qg,
                          k.to(torch.float32)) * (hd ** -0.5)
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqt,btkd->bqkrd",
                       p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _chunked_causal(q, k, v, *, window: int = 0, q_chunk: int = 512):
    """Causal (optionally windowed) attention over query chunks.

    Each chunk scores against the full K/V, or, for a window shorter than
    the sequence, against the ``window + chunk`` span that covers it — the
    reference's scan, written as a loop.
    """
    b, s, h, hd = q.shape
    dev = q.device
    chunk = q_chunk if s % q_chunk == 0 else s
    nc = s // chunk
    if nc == 1:
        qp = torch.arange(s, device=dev)[:, None]
        kp = torch.arange(s, device=dev)[None, :]
        mask = kp <= qp
        if window:
            mask &= kp > qp - window
        return _sdpa(q, k, v, mask[None, None, None])
    outs = []
    span = window + chunk
    for ci in range(nc):
        q_start = ci * chunk
        qc = q[:, q_start:q_start + chunk]
        qp = (q_start + torch.arange(chunk, device=dev))[:, None]
        if window and span < s:
            k_start = min(max(q_start + chunk - span, 0), s - span)
            kc, vc = k[:, k_start:k_start + span], v[:, k_start:k_start + span]
            kp = (k_start + torch.arange(span, device=dev))[None, :]
            mask = (kp <= qp) & (kp > qp - window)
        else:
            kc, vc = k, v
            kp = torch.arange(s, device=dev)[None, :]
            mask = kp <= qp
            if window:
                mask &= kp > qp - window
        outs.append(_sdpa(qc, kc, vc, mask[None, None, None]))
    return torch.cat(outs, dim=1)


class AttnCache(NamedTuple):
    k: torch.Tensor  # (B, T_alloc, KV, hd) roped keys (bf16 or int8)
    v: torch.Tensor
    key_pos: torch.Tensor  # (B, T_alloc) int32; -1 = empty slot
    k_scale: Optional[torch.Tensor] = None  # (B, T_alloc, KV) f16 when int8
    v_scale: Optional[torch.Tensor] = None


class PagedAttnCache(NamedTuple):
    """One attention layer's paged KV pool, shared by all batch slots.

    ``k``/``v``: (num_blocks, block_size, KV, hd) — bf16, or int8 with
    per-(block, offset, KV) f16 scale pools.  Logical position ``p`` of slot
    ``b`` lives at flat pool row ``table[b, p // bs] * bs + p % bs``.
    Validity comes from ``pos`` and the table; there is no ``key_pos``.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def _kv_quant(x):
    """Per-(B,T,KV) int8 quantization of roped K/V (amax over head_dim)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(
        torch.int8)
    return q, scale.to(torch.float16)


def _kv_dequant(q, scale, dtype):
    return (q.to(torch.float32) * scale.to(torch.float32)[..., None]).to(dtype)


def attn_prefill(params, x, *, n_heads, n_kv_heads, head_dim, rope_theta,
                 window: int = 0, cache_len: int | None = None,
                 q_chunk: int = 512, kv_dtype: str = "bf16",
                 true_len=None, use_flash: bool = False, **imc):
    """Prefill: forward over the prompt AND build the decode cache.

    cache_len defaults to S for global layers, window for local layers.
    ``true_len`` (an int) marks a right-padded prompt: positions
    ``>= true_len`` get ``key_pos = -1`` so the paged scatter drops them;
    causal attention already keeps padded keys out of every valid row.
    """
    if use_flash:
        raise NotImplementedError("use_flash_kernel: the flash-attention "
                                  "prefill kernel is not ported yet")
    b, s, _ = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev)[None, :]
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim,
                           positions, rope_theta, **imc)
    out = _chunked_causal(q, k, v, window=window, q_chunk=q_chunk)
    t_alloc = cache_len if cache_len is not None else (window if window else s)
    if t_alloc <= s:  # keep the last t_alloc entries, ring-aligned so that
        # the entry for position p sits at slot p % t_alloc (decode invariant)
        shift = s % t_alloc
        ck = torch.roll(k[:, s - t_alloc:], shift, dims=1)
        cv = torch.roll(v[:, s - t_alloc:], shift, dims=1)
        cp = torch.roll(torch.arange(s - t_alloc, s, device=dev)[None].expand(
            b, t_alloc), shift, dims=1)
    else:  # roomier cache than the prompt: left-fill
        pad = t_alloc - s
        ck = torch.cat([k, k.new_zeros((b, pad) + tuple(k.shape[2:]))], dim=1)
        cv = torch.cat([v, v.new_zeros((b, pad) + tuple(v.shape[2:]))], dim=1)
        cp = torch.cat([torch.arange(s, device=dev)[None].expand(b, s),
                        torch.full((b, pad), -1, device=dev)], dim=1)
    if true_len is not None:
        cp = torch.where(cp < int(true_len), cp, -1)
    cp = cp.to(torch.int32)
    if kv_dtype == "int8":
        ck, ks = _kv_quant(ck)
        cv, vs = _kv_quant(cv)
        cache = AttnCache(ck, cv, cp, ks, vs)
    else:
        cache = AttnCache(ck.contiguous(), cv.contiguous(), cp)
    y = dense(params["wo"], out.reshape(b, s, -1), **imc)
    return y, cache


def _attn_decode_paged(params, x, cache: PagedAttnCache, pos, block_table, *,
                       n_heads, n_kv_heads, head_dim, rope_theta,
                       window: int = 0, attn_impl: str = "auto", **imc):
    """One-token decode against the shared paged pools.

    x: (B, 1, D); pos: (B,) int; block_table: (B, MB) int32, -1 = empty.
    Each row writes its new K/V at flat pool row
    ``table[pos // bs] * bs + pos % bs``; rows of inactive slots (whose table
    entry is -1) fall out of bounds and are dropped, as the reference's
    ``mode="drop"`` scatter drops them.  Attention then runs through
    :func:`repro_torch.kernels.paged_attn.ops.paged_attention`.
    """
    from repro_torch.kernels.paged_attn.ops import paged_attention

    b = x.shape[0]
    nb, bs = cache.k.shape[0], cache.k.shape[1]
    mb = block_table.shape[1]
    p = torch.as_tensor(pos, device=x.device).to(torch.int64)
    p = p.expand(b) if p.ndim == 0 else p.reshape(b)
    q, k_new, v_new = _project_qkv(params, x, n_heads, n_kv_heads, head_dim,
                                   p[:, None], rope_theta, **imc)
    tbl = torch.where(block_table < 0, nb, block_table).to(torch.int64)
    rows = torch.arange(b, device=x.device)
    # the block index clamps into the table as the reference's gather does
    # (an inactive slot's pos may run past its span; its row is all -1)
    widx = tbl[rows, torch.clamp(p // bs, 0, mb - 1)] * bs + p % bs  # (B,)
    keep = (widx >= 0) & (widx < nb * bs)

    def put(pool, new):  # pool (NB, bs, *tail); new (B, *tail)
        flat = pool.view((nb * bs,) + tuple(pool.shape[2:]))
        flat[widx[keep]] = new[keep].to(pool.dtype)

    if cache.k_scale is not None:
        kq_new, ks_new = _kv_quant(k_new)
        vq_new, vs_new = _kv_quant(v_new)
        put(cache.k, kq_new[:, 0])
        put(cache.v, vq_new[:, 0])
        put(cache.k_scale, ks_new[:, 0])
        put(cache.v_scale, vs_new[:, 0])
    else:
        put(cache.k, k_new[:, 0])
        put(cache.v, v_new[:, 0])
    out = paged_attention(q, cache.k, cache.v, block_table, p,
                          k_scale=cache.k_scale, v_scale=cache.v_scale,
                          window=window, impl=attn_impl)
    y = dense(params["wo"], out.reshape(b, 1, -1), **imc)
    return y, cache


def attn_decode(params, x, cache, pos, *, n_heads, n_kv_heads, head_dim,
                rope_theta, window: int = 0, block_table=None,
                attn_impl: str = "auto", **imc):
    """One-token decode. x: (B, 1, D); pos: int or (B,) int tensor — per-row
    positions support continuous batching.

    Ring path (``cache`` an :class:`AttnCache`): writes each row's new K/V
    into slot ``pos % T_alloc``.  Paged path (``cache`` a
    :class:`PagedAttnCache`): routes through ``block_table``.  Both update
    the cache in place and return it.
    """
    if isinstance(cache, PagedAttnCache):
        if block_table is None:
            raise ValueError("paged decode needs a block table")
        return _attn_decode_paged(params, x, cache, pos, block_table,
                                  n_heads=n_heads, n_kv_heads=n_kv_heads,
                                  head_dim=head_dim, rope_theta=rope_theta,
                                  window=window, attn_impl=attn_impl, **imc)
    b = x.shape[0]
    t_alloc = cache.k.shape[1]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    positions = (pos if pos.ndim else pos.expand(b)).reshape(b, 1)  # (B,1)
    q, k_new, v_new = _project_qkv(params, x, n_heads, n_kv_heads, head_dim,
                                   positions, rope_theta, **imc)
    rows = torch.arange(b, device=x.device)
    slot = torch.remainder(positions[:, 0], t_alloc)  # (B,) ring index
    if cache.k_scale is not None:
        kq_new, ks_new = _kv_quant(k_new)
        vq_new, vs_new = _kv_quant(v_new)
        cache.k[rows, slot] = kq_new[:, 0]
        cache.v[rows, slot] = vq_new[:, 0]
        cache.k_scale[rows, slot] = ks_new[:, 0]
        cache.v_scale[rows, slot] = vs_new[:, 0]
        k = _kv_dequant(cache.k, cache.k_scale, q.dtype)
        v = _kv_dequant(cache.v, cache.v_scale, q.dtype)
    else:
        cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
        k, v = cache.k, cache.v
    cache.key_pos[rows, slot] = positions[:, 0].to(torch.int32)
    key_pos = cache.key_pos
    valid = (key_pos >= 0) & (key_pos <= positions)  # (B,T)
    if window:
        valid &= key_pos > positions - window
    mask = valid[:, None, None, None, :]  # (B,1,1,1,T)
    out = _sdpa(q, k, v, mask)
    y = dense(params["wo"], out.reshape(b, 1, -1), **imc)
    return y, cache
