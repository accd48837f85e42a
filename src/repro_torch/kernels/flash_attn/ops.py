"""The ``flash_attn`` kernels: causal online-softmax self-attention for
prefill (port of ``repro/kernels/flash_attn``; CUDA source
``csrc/flash_attn.cu``).

:func:`flash_attention` keeps the reference's layout: q (B, S, H, hd), k/v
(B, S, KV, hd), output (B, S, H, hd) in q's dtype; causal, with an optional
sliding ``window``.  It dispatches by device: a CUDA tensor launches a
kernel (GQA by reading kv head ``h // (H // KV)``, never a repeat in device
memory), or raises on a build failure, a refused launch, a wrong dtype,
device or shape; a CPU tensor takes the plain version
:func:`flash_attention_torch`.

Which kernel, by a fixed rule (:func:`takes_tensor_cores`): bf16 q/k/v
with ``hd % 16 == 0`` and ``hd <= 128``, or hd 256, and 16-byte aligned
pointers take the tensor-core kernel (``flash_attn_tc_launch``, 4 warps per
block; at hd 256 two warps share each 16 query rows, 32 rows a block); f32,
and bf16 at any other hd (hd 144-240, or not a multiple of 16), take the
CUDA-core kernel (``flash_attn_launch``).  Counters:
``flash_attention.launches`` counts every kernel launch and nothing else,
``tc_launches`` and ``simt_launches`` those of each kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# both entry points: q, k, v, out, B, S, H, KV, hd, scale, window, then the
# dtype (flash_attn_launch only), stream and device
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
         + [ctypes.c_float, ctypes.c_int])
_STREAM = [ctypes.c_void_p, ctypes.c_int]
_ARGTYPES = {"flash_attn_launch": _ARGS + [ctypes.c_int] + _STREAM,
             "flash_attn_tc_launch": _ARGS + _STREAM}
_FNS = {}


def _entry(name: str):
    """The C entry point ``name``, its argument types set once, at the
    library's first load."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("flash_attn"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _FNS[name] = fn
    return fn


def takes_tensor_cores(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> bool:
    """The dispatch rule: does this call take the tensor-core kernel?"""
    hd = q.shape[-1]
    return (q.dtype == torch.bfloat16 and hd % 16 == 0
            and (hd <= 128 or hd == 256)
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


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
    stream, dev = build.stream_and_device(qc)
    args = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b,
            s, h, kv, hd, hd ** -0.5, int(window))
    if takes_tensor_cores(qc, kc, vc):
        rc = _entry("flash_attn_tc_launch")(*args, stream, dev)
        build.check_launch("flash_attn_tc", rc)
        flash_attention.tc_launches += 1
    else:
        rc = _entry("flash_attn_launch")(*args, _DTYPES[q.dtype], stream, dev)
        build.check_launch("flash_attn", rc)
        flash_attention.simt_launches += 1
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
flash_attention.tc_launches = 0
flash_attention.simt_launches = 0
