"""The ``imc_mac`` kernel: int8 x int8 -> int32 GEMM for the exact fabric
engine (port of ``repro/kernels/imc_mac``; CUDA source ``csrc/imc_mac.cu``).

:func:`imc_mac` dispatches by device: a CUDA tensor launches the kernel (or
raises: on a build failure, a refused launch, a wrong dtype or shape); a CPU
tensor takes the plain version :func:`imc_mac_torch`.  No fallback hides the
kernel.  ``imc_mac.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                          ctypes.c_int]


def _flatten(qa: torch.Tensor, qw: torch.Tensor):
    if qw.ndim != 2 or qa.ndim < 1 or qa.shape[-1] != qw.shape[0]:
        raise ValueError(f"imc_mac: shapes {tuple(qa.shape)} x "
                         f"{tuple(qw.shape)} do not contract")
    batch = tuple(qa.shape[:-1])
    return batch, qa.reshape(-1, qa.shape[-1])


def imc_mac_torch(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Plain version: int[..., K] x int[K, N] -> int32[..., N].

    Multiplies in int32 on the CPU.  ``torch.matmul`` takes no integer
    operands on CUDA, so on the card it multiplies in float64, which is exact
    while |acc| < 2^53 (127 * 127 * K is far below that).
    """
    batch, a2 = _flatten(qa, qw)
    if a2.is_cuda:
        out = (a2.to(torch.float64) @ qw.to(torch.float64)).to(torch.int32)
    else:
        out = a2.to(torch.int32) @ qw.to(torch.int32)
    return out.reshape(*batch, qw.shape[1])


def imc_mac(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """int8[..., K] x int8[K, N] -> int32[..., N]; any (ragged) shape.

    Leading batch dims of ``qa`` flatten into M.  CPU tensors run
    :func:`imc_mac_torch`; CUDA tensors launch the kernel.
    """
    if qa.device.type == "cpu" and qw.device.type == "cpu":
        return imc_mac_torch(qa, qw)
    if not (qa.is_cuda and qw.is_cuda and qa.device == qw.device):
        raise ValueError(f"imc_mac: operands on {qa.device} and {qw.device}; "
                         "both must be on one CUDA device (or both on CPU)")
    if qa.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"imc_mac: needs int8 operands, got {qa.dtype} x "
                        f"{qw.dtype}")
    batch, a2 = _flatten(qa, qw)
    a2 = a2.contiguous()
    b = qw.contiguous()
    m, k = a2.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a2.device)
    lib = build.load("imc_mac")
    fn = lib.imc_mac_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream, dev = build.stream_and_device(a2)
    build.check_launch("imc_mac", fn(a2.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), m, n, k, stream, dev))
    imc_mac.launches += 1
    return out.reshape(*batch, n)


imc_mac.launches = 0
