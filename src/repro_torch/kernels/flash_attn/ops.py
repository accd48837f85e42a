"""The ``flash_attn`` kernel: causal online-softmax self-attention for
prefill (port of ``repro/kernels/flash_attn``; CUDA source
``csrc/flash_attn.cu``).

:func:`flash_attention` keeps the reference's layout: q (B, S, H, hd), k/v
(B, S, KV, hd), output (B, S, H, hd) in q's dtype; causal, with an optional
sliding ``window``.  It dispatches by device: a CUDA tensor launches the
kernel (GQA by reading kv head ``h // (H // KV)``, never a repeat in device
memory), or raises on a build failure, a refused launch, a wrong dtype,
device or shape; a CPU tensor takes the plain version
:func:`flash_attention_torch`.  ``flash_attention.launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int])


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int = 0) -> torch.Tensor:
    """Plain version: dense f32 softmax under the causal (windowed) mask,
    GQA by repeating K/V (the port of ``flash_attention_ref``)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > qp - window
    p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def _launch(q, k, v, window: int) -> torch.Tensor:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: need q "
                         "(B, S, H, hd) and k/v (B, S, KV, hd)")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != hd or h % kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes one of float32 or "
                        "bfloat16 for all three")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: operands on {q.device}, "
                         f"{k.device} and {v.device}; all must be on one "
                         "CUDA device")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc)
    lib = build.load("flash_attn")
    fn = lib.flash_attn_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream, dev = build.stream_and_device(qc)
    build.check_launch("flash_attn", fn(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b, s, h,
        kv, hd, hd ** -0.5, int(window), _DTYPES[q.dtype], stream, dev))
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal self-attention.  q: (B, S, H, hd); k/v: (B, S, KV, hd).
    Returns (B, S, H, hd) in q's dtype."""
    if q.device.type == "cpu" and k.device.type == "cpu" and \
            v.device.type == "cpu":
        return flash_attention_torch(q, k, v, window=window)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: operands on {q.device}, "
                         f"{k.device} and {v.device}; all must be on one "
                         "CUDA device (or all on the CPU)")
    return _launch(q, k, v, window)


flash_attention.launches = 0
