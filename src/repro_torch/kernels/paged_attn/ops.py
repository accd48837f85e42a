"""The ``paged_attn`` kernel: single-token flash decode over paged K/V pools
(port of ``repro/kernels/paged_attn``; CUDA source ``csrc/paged_attn.cu``).

:func:`paged_attention` is what the model layer calls.  It takes the serving
layout — q ``(B, 1, H, hd)``, pools ``(NB, bs, KV, hd)`` — and returns
``(B, 1, H, hd)``.  ``impl="auto"`` dispatches by device: a CUDA tensor
launches the kernel (grouped GQA, heads regrouped to ``(B, KV, rep, hd)``
with head ``h = kvh * rep + r``, so K/V are never repeated); a CPU tensor
takes the plain dense-gather version :func:`paged_decode_torch`.
``impl="cuda"`` on a CPU tensor and ``impl="torch"`` on a CUDA tensor raise.

Which kernel, by fixed rules, in order:

* :func:`takes_split`: rep 1 to 8, rows of ``hd`` elements that split into
  a power of two of lanes, 1 to 32, of E elements each (E = 4 for f32, 8
  for bf16 and int8: one 16-byte load, 8 bytes for int8), and pools aligned
  to that load, take the split kernel (``paged_attn_split_launch``).
* :func:`takes_ctx_split`: rep 9 to 16, bf16 queries over bf16 or int8
  pools, ``hd % 16 == 0`` and ``hd <= 256``, a table of at most 1024
  chunks (65,536 keys), q and the pools 16-byte aligned, take the
  context-split tensor-core kernel and its merge (``paged_attn_ctx_launch``:
  two launches, over :func:`ctx_chunks` chunks of 64 keys fixed by the
  table's shape; the partials' scratch is allocated here, uninitialized).
* Every other geometry takes the staged kernel (``paged_attn_launch``):
  f32 pools at rep > 8, or at rep <= 8 past 32 lanes (f32 at hd 256); f32
  queries over int8 pools at rep > 8; rep > 16; lane groups that are not a
  power of two (hd 24); hd past 256 or not a multiple of 16, or tables
  past 65,536 keys, at rep 9-16; pointers the other kernels cannot load
  from.

Counters: ``paged_attention.launches`` counts every kernel launch and
nothing else (2 for a context-split call: the kernel and its merge);
``split_launches``, ``ctx_launches`` (the context-split kernel),
``merge_launches`` (its merge) and ``staged_launches`` those of each
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

ATTN_IMPLS = ("auto", "torch", "cuda")
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_CHUNK = {torch.float32: 4, torch.bfloat16: 8, torch.int8: 8}  # E
CTX_KEYS = 64  # keys of a context-split chunk (csrc's ctx::TK)
CTX_ROWS = 16  # rows of its m16 tile: rep <= 16 query heads (ctx::MR)
CTX_MAX_CHUNKS = 1024  # chunks a slot's table may span (ctx::MAX_CHUNKS)
# the split and staged entry points take the same arguments; the
# context-split one adds the two scratch pointers and the chunk count
_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
         + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int])
_ARGTYPES = {"paged_attn_launch": _ARGS, "paged_attn_split_launch": _ARGS,
             "paged_attn_ctx_launch": [ctypes.c_void_p] * 10
             + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 3
             + [ctypes.c_void_p, ctypes.c_int]}
_FNS = {}


def _entry(name: str):
    """The C entry point ``name``, its argument types set once, at the
    library's first load."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("paged_attn"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _FNS[name] = fn
    return fn


def takes_split(rep: int, k_pool: torch.Tensor, v_pool: torch.Tensor) -> bool:
    """The dispatch rule: does this call take the split kernel?"""
    e = _CHUNK[k_pool.dtype]
    hd = k_pool.shape[-1]
    lanes = hd // e
    align = e * k_pool.element_size()
    return (1 <= rep <= 8 and hd % e == 0 and lanes <= 32
            and lanes & (lanes - 1) == 0
            and k_pool.data_ptr() % align == 0
            and v_pool.data_ptr() % align == 0)


def takes_ctx_split(rep: int, q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, mb: int) -> bool:
    """The dispatch rule: does a call that the split kernel does not take
    take the context-split kernel?  ``mb``: the block table's width."""
    hd = k_pool.shape[-1]
    return (9 <= rep <= CTX_ROWS and q.dtype == torch.bfloat16
            and k_pool.dtype in (torch.bfloat16, torch.int8)
            and hd % 16 == 0 and hd <= 256
            and ctx_chunks(mb, k_pool.shape[1]) <= CTX_MAX_CHUNKS
            and all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)))


def ctx_chunks(mb: int, bs: int) -> int:
    """The context-split kernel's chunks a slot: ``ceil(mb * bs / 64)``,
    from the block table's shape alone, so that a graph captured at one
    ``pos`` replays at every other."""
    return -(-mb * bs // CTX_KEYS)


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
    stream, dev = build.stream_and_device(qg)
    args = (qg.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
            tbl.data_ptr(), ps.data_ptr(), out.data_ptr(),
            b, kv, h // kv, hd, bs, mb, hd ** -0.5, int(window),
            _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], stream, dev)
    rep = h // kv
    if takes_split(rep, kp, vp):
        build.check_launch("paged_attn_split",
                           _entry("paged_attn_split_launch")(*args))
        paged_attention.split_launches += 1
    elif takes_ctx_split(rep, qg, kp, vp, mb):
        c = ctx_chunks(mb, bs)
        part_acc = torch.empty((b * kv, c, CTX_ROWS, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b * kv, c, 2, CTX_ROWS), dtype=torch.float32,
                              device=q.device)
        build.check_launch("paged_attn_ctx", _entry("paged_attn_ctx_launch")(
            *args[:8], part_acc.data_ptr(), part_ml.data_ptr(),
            *args[8:14], c, *args[14:]))
        paged_attention.ctx_launches += 1
        paged_attention.merge_launches += 1
        paged_attention.launches += 1  # the merge; the kernel's below
    else:
        build.check_launch("paged_attn", _entry("paged_attn_launch")(*args))
        paged_attention.staged_launches += 1
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
paged_attention.split_launches = 0
paged_attention.ctx_launches = 0
paged_attention.merge_launches = 0
paged_attention.staged_launches = 0
