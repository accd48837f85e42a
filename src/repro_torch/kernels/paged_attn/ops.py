"""The ``paged_attn`` kernel: single-token flash decode over paged K/V pools
(port of ``repro/kernels/paged_attn``; CUDA source ``csrc/paged_attn.cu``).

:func:`paged_attention` is what the model layer calls.  It takes the serving
layout — q ``(B, 1, H, hd)``, pools ``(NB, bs, KV, hd)`` — and returns
``(B, 1, H, hd)``.  ``impl="auto"`` dispatches by device: a CUDA tensor
launches the kernel (grouped GQA, heads regrouped to ``(B, KV, rep, hd)``
with head ``h = kvh * rep + r``, so K/V are never repeated); a CPU tensor
takes the plain dense-gather version :func:`paged_decode_torch`.
``impl="cuda"`` on a CPU tensor and ``impl="torch"`` on a CUDA tensor raise.
``paged_attention.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

ATTN_IMPLS = ("auto", "torch", "cuda")
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int])


def paged_decode_torch(q, k_pool, v_pool, block_table, pos, *, k_scale=None,
                       v_scale=None, window: int = 0):
    """Plain version: dense-gather paged decode attention (post-scatter pools).

    The port of ``repro/kernels/paged_attn/ref.py::paged_decode_ref``: gather
    the full logical span through the block table, dequantize int8 pools to
    q's dtype, and run the grouped ``_sdpa``.  q: (B, 1, H, hd); pools
    (NB, bs, KV, hd); block_table (B, MB) int32 with ``-1`` sentinels;
    pos (B,) int32.  Returns (B, 1, H, hd).
    """
    from repro_torch.models.attention import _kv_dequant, _sdpa

    nb, bs = k_pool.shape[0], k_pool.shape[1]
    mb = block_table.shape[1]
    dev = k_pool.device
    positions = pos.to(torch.int64).reshape(-1, 1)  # (B, 1)
    tbl = torch.where(block_table < 0, nb, block_table).to(torch.int64)
    ctx = torch.arange(mb * bs, device=dev)
    gidx = tbl[:, ctx // bs] * bs + ctx % bs  # (B, T_ctx), OOB >= nb*bs
    valid = (ctx[None, :] <= positions) & (gidx < nb * bs)
    if window:
        valid &= ctx[None, :] > positions - window
    safe = torch.clamp_max(gidx, nb * bs - 1)
    kf = k_pool.reshape((nb * bs,) + tuple(k_pool.shape[2:]))
    vf = v_pool.reshape((nb * bs,) + tuple(v_pool.shape[2:]))
    if k_scale is not None:
        ks = k_scale.reshape(nb * bs, -1)
        vs = v_scale.reshape(nb * bs, -1)
        k = _kv_dequant(kf[safe], ks[safe], q.dtype)
        v = _kv_dequant(vf[safe], vs[safe], q.dtype)
    else:
        k, v = kf[safe], vf[safe]  # (B, T_ctx, KV, hd)
    mask = valid[:, None, None, None, :]  # (B,1,1,1,T_ctx)
    return _sdpa(q, k, v, mask)


def _launch(q, k_pool, v_pool, block_table, pos, k_scale, v_scale,
            window: int):
    b, sq, h, hd = q.shape
    nb, bs, kv, hd_k = k_pool.shape
    if sq != 1:
        raise ValueError("paged_attention: flash decode is single-token")
    if hd_k != hd or h % kv or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not fit "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if q.dtype not in _Q_CODES or k_pool.dtype not in _KV_CODES or \
            v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention: q {q.dtype}, pools {k_pool.dtype}/"
                        f"{v_pool.dtype} not supported")
    int8 = k_pool.dtype == torch.int8
    if int8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: int8 pools need k_scale and "
                         "v_scale, other pools take none")
    if not int8 and k_pool.dtype != q.dtype:
        raise TypeError(f"paged_attention: {k_pool.dtype} pools need "
                        f"{k_pool.dtype} queries, got {q.dtype}")
    if int8 and (k_scale.dtype != torch.float16 or v_scale.dtype !=
                 torch.float16 or k_scale.shape != (nb, bs, kv)
                 or v_scale.shape != (nb, bs, kv)):
        raise ValueError("paged_attention: scale pools must be f16 "
                         f"{(nb, bs, kv)}")
    tensors = [q, k_pool, v_pool, block_table, pos] + \
        ([k_scale, v_scale] if int8 else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all operands must be on one "
                         "CUDA device")
    mb = block_table.shape[1]
    if block_table.shape != (b, mb) or pos.shape != (b,):
        raise ValueError(f"paged_attention: block_table {tuple(block_table.shape)}"
                         f" / pos {tuple(pos.shape)} do not match batch {b}")
    qg = q.reshape(b, kv, h // kv, hd).contiguous()
    kp, vp = k_pool.contiguous(), v_pool.contiguous()
    tbl = block_table.to(torch.int32).contiguous()
    ps = pos.to(torch.int32).contiguous()
    ks = k_scale.contiguous() if int8 else None
    vs = v_scale.contiguous() if int8 else None
    out = torch.empty_like(qg)
    lib = build.load("paged_attn")
    fn = lib.paged_attn_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream, dev = build.stream_and_device(qg)
    rc = fn(qg.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
            tbl.data_ptr(), ps.data_ptr(), out.data_ptr(),
            b, kv, h // kv, hd, bs, mb, hd ** -0.5, int(window),
            _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], stream, dev)
    build.check_launch("paged_attn", rc)
    paged_attention.launches += 1
    return out.reshape(b, 1, h, hd)


def paged_attention(q, k_pool, v_pool, block_table, pos, *, k_scale=None,
                    v_scale=None, window: int = 0, impl: str = "auto"):
    """Paged decode attention against shared pools (post-scatter).

    q: (B, 1, H, hd); k_pool/v_pool: (NB, bs, KV, hd) bf16/f32, or int8 with
    (NB, bs, KV) f16 scale pools; block_table: (B, MB) int32 dense prefixes
    with ``-1`` sentinels; pos: (B,) int32 current positions.  Returns
    (B, 1, H, hd) in q.dtype.
    """
    if impl not in ATTN_IMPLS:
        raise ValueError(f"impl must be one of {ATTN_IMPLS}, got {impl!r}")
    on_card = q.is_cuda
    if impl == "cuda" and not on_card:
        raise ValueError("paged_attention: impl='cuda' needs CUDA tensors")
    if impl == "torch" and on_card:
        raise ValueError("paged_attention: impl='torch' (the plain version) "
                         "runs on the CPU only; use 'cuda' or 'auto' on the "
                         "card")
    if not on_card:
        return paged_decode_torch(q, k_pool, v_pool, block_table, pos,
                                  k_scale=k_scale, v_scale=v_scale,
                                  window=window)
    return _launch(q, k_pool, v_pool, block_table, pos, k_scale, v_scale,
                   window)


paged_attention.launches = 0
