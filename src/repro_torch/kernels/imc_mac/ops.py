"""The ``imc_mac`` kernels: int8 x int8 -> int32 GEMM for the exact fabric
engine, and the same GEMM with the per-tensor x per-channel dequant fused
into its flush (port of ``repro/kernels/imc_mac``; CUDA source
``csrc/imc_mac.cu``, two entry points).

:func:`imc_mac` and :func:`imc_mac_dequant` dispatch by device: a CUDA
tensor launches the kernel (or raises: on a build failure, a refused launch,
a wrong dtype, device or shape); a CPU tensor takes the plain version
(:func:`imc_mac_torch`, :func:`imc_mac_dequant_torch`).  No fallback hides a
kernel.  ``imc_mac.launches`` and ``imc_mac_dequant.launches`` count kernel
launches and nothing else.

Each entry has two kernels, chosen by one rule (:func:`imc_mac_plan`, the
twin of the C ``imc_mac_plan``): M <= ``SPLIT_MAX_M`` (16: decode with up to
16 slots, the bucket-16 prefill) takes the split-K kernel, written for
decode's few rows; M > 16 (the bucket-32/64 prefills) the tensor-core kernel
(int8 ``mma.sync``, K split over a thread-block cluster).  Each wrapper
counts them apart, as ``split_launches`` and ``tiled_launches`` (the M > 16
kernel); ``launches`` is their total.

The plan's tunable choices, its geometry (``sk_gmax``, ``sk_target``,
``tc_cluster``, ``tc_target``: :mod:`repro_torch.kernels.autotune`), are
runtime arguments of the C entry points.  On a CUDA tensor each wrapper
resolves them at call time with ``autotune.lookup`` (the defaults, the
measured cache, a pin), and an explicit ``geometry=`` beats the tuner
parameter by parameter; every geometry gives the same output.  The CPU path
ignores geometry.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import autotune, build

SPLIT_MAX_M = 16
_MMA_BM = 64         # the M > 16 kernel's output tile: 64 rows ...
_MMA_BN = 32         # ... by 32 columns
_SPLIT_WARPS = 4     # the split kernel's block: 4 warps on one column tile
_SPLIT_BN = 256      # its columns, 8 per lane
_GEOMETRY = ("sk_gmax", "sk_target", "tc_cluster", "tc_target")  # C order

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p,
                                                          ctypes.c_int]
_DEQUANT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int]
_PLAN_ARGTYPES = [ctypes.c_int] * 7 + [ctypes.c_void_p]
_FNS = {}


class Plan(NamedTuple):
    """A launch: ``rows`` a split-K block keeps (4 or 16; 0 for the M > 16
    tensor-core kernel), its grid, the splits of K (for M > 16 the cluster
    size, ``grid_y``) and the K-rows per split."""
    rows: int
    grid_x: int
    grid_y: int
    grid_z: int
    splits: int
    k_per_split: int


def _geometry_args(geom) -> tuple:
    """The C arguments of a geometry (None: the defaults), merged over the
    defaults and checked against the sources' bounds."""
    g = autotune.DEFAULTS["imc_mac"] if geom is None else \
        autotune.check_geometry("imc_mac", {**autotune.DEFAULTS["imc_mac"],
                                            **geom}, "imc_mac geometry")
    return tuple(g[p] for p in _GEOMETRY)


def imc_mac_plan(m: int, n: int, k: int, geom=None) -> Plan:
    """The launch of an ``m x k x n`` product under the geometry ``geom``
    (None: the defaults), as ``csrc/imc_mac.cu``'s ``imc_mac_plan`` computes
    it (``chip_smoke.py`` phases 2 and 12 hold the two together).  The split
    kernel's K-slice is a whole number of quads for each of its 4 warps, at
    most ``sk_gmax`` quads a warp, and a launch aims at ~``sk_target``
    blocks; K = 0 is one split that adds nothing.  Above M = 16: 64 x 32
    output tiles (``grid_x`` over N, ``grid_z`` over M) and the splits
    doubled, up to ``tc_cluster``, while the launch stays within
    ``tc_target`` blocks and K has a 32-deep step for each split; each
    split takes a whole number of steps."""
    return _plan(m, n, k, *_geometry_args(geom))


@functools.lru_cache(maxsize=None)
def _plan(m: int, n: int, k: int, sk_gmax: int, sk_target: int,
          tc_cluster: int, tc_target: int) -> Plan:
    if m > SPLIT_MAX_M:
        gx, gz = -(-n // _MMA_BN), -(-m // _MMA_BM)
        steps = -(-k // 32)
        splits = 1
        while (splits < tc_cluster and gx * gz * splits * 2 <= tc_target
               and steps >= 2 * splits):
            splits *= 2
        return Plan(0, gx, splits, gz, splits, 32 * -(-steps // splits))
    tiles = -(-n // _SPLIT_BN)
    quads = -(-k // 4)
    g = -(-quads * tiles // (_SPLIT_WARPS * sk_target))
    g = min(max(g, 1), sk_gmax)
    kps = 4 * _SPLIT_WARPS * g
    splits = -(-k // kps) if k > 0 else 1
    return Plan(4 if m <= 4 else 16, tiles, splits, 1, splits, kps)


def compiled_plan(m: int, n: int, k: int, geom=None) -> Plan:
    """The C ``imc_mac_plan`` of the built library under ``geom`` (needs
    ``nvcc``)."""
    out = (ctypes.c_int * 6)()
    build.check_launch("imc_mac_plan", _entry("imc_mac_plan", _PLAN_ARGTYPES)(
        m, n, k, *_geometry_args(geom), ctypes.addressof(out)))
    return Plan(*out)


def _resolve(name: str, m: int, n: int, k: int, geometry, device) -> tuple:
    """The C geometry arguments of a launch: the tuner's lookup, then the
    caller's ``geometry`` parameter by parameter."""
    geom = autotune.lookup(name, {"m": m, "k": k, "n": n},
                           dtype=autotune.KERNEL_DTYPES[name], device=device)
    if geometry:
        geom.update(autotune.check_geometry(name, dict(geometry),
                                            f"{name}(geometry=...)"))
    return tuple(geom[p] for p in _GEOMETRY)


def _entry(name: str, argtypes):
    """The C function ``name`` of ``csrc/imc_mac.cu``, its argument types
    set once, at the library's first load."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("imc_mac"), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
    return fn


def _count(wrapper, plan: Plan) -> None:
    wrapper.launches += 1
    if plan.rows:
        wrapper.split_launches += 1
    else:
        wrapper.tiled_launches += 1


def _flatten(qa: torch.Tensor, qw: torch.Tensor):
    if qw.ndim != 2 or qa.ndim < 1 or qa.shape[-1] != qw.shape[0]:
        raise ValueError(f"imc_mac: shapes {tuple(qa.shape)} x "
                         f"{tuple(qw.shape)} do not contract")
    batch = tuple(qa.shape[:-1])
    return batch, qa.reshape(math.prod(batch), qa.shape[-1])  # K may be 0


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


def imc_mac(qa: torch.Tensor, qw: torch.Tensor, *,
            geometry=None) -> torch.Tensor:
    """int8[..., K] x int8[K, N] -> int32[..., N]; any (ragged) shape.

    Leading batch dims of ``qa`` flatten into M.  CPU tensors run
    :func:`imc_mac_torch`; CUDA tensors launch the kernel under the tuned
    geometry (``geometry``: parameters that beat the tuner's).
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
    if m == 0 or n == 0:
        return out.reshape(*batch, n)
    geom = _resolve("imc_mac", m, n, k, geometry, a2.device)
    plan = _plan(m, n, k, *geom)
    stream, dev = build.stream_and_device(a2)
    build.check_launch("imc_mac", _entry("imc_mac_launch", _ARGTYPES)(
        a2.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, *geom, stream,
        dev))
    _count(imc_mac, plan)
    return out.reshape(*batch, n)


imc_mac.launches = imc_mac.split_launches = imc_mac.tiled_launches = 0


# ------------------------------------------------------------- dequant
def imc_mac_dequant_torch(qa: torch.Tensor, qw: torch.Tensor, scale_a,
                          scale_w) -> torch.Tensor:
    """Plain version: float32[..., N] = (f32(qa @ qw) * scale_a) * scale_w[n],
    rounded left to right as the reference's ``acc * sa * sw``."""
    acc = imc_mac_torch(qa, qw).to(torch.float32)
    sa = torch.as_tensor(scale_a, dtype=torch.float32, device=acc.device)
    sw = torch.as_tensor(scale_w, dtype=torch.float32, device=acc.device)
    return acc * sa.reshape(()) * sw.reshape(-1)


def imc_mac_dequant(qa: torch.Tensor, qw: torch.Tensor, scale_a,
                    scale_w, *, geometry=None) -> torch.Tensor:
    """Fused int8 GEMM + per-channel dequant -> float32[..., N].

    ``scale_a``: the per-tensor activation scale, one float32 value;
    ``scale_w``: float32[N] per-output-channel scales.  On the card both
    are float32 tensors on the operands' device (``scale_a`` is read there
    by the kernel: no host copy, no sync).  Leading batch dims of ``qa``
    flatten into M.  ``geometry`` as :func:`imc_mac`'s.
    """
    if all(not isinstance(t, torch.Tensor) or t.device.type == "cpu"
           for t in (qa, qw, scale_a, scale_w)):
        return imc_mac_dequant_torch(qa, qw, scale_a, scale_w)
    ts = (qa, qw, scale_a, scale_w)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda and
               t.device == qa.device for t in ts):
        raise ValueError("imc_mac_dequant: operands and scales must all be "
                         "tensors on one CUDA device (or all on the CPU)")
    if qa.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"imc_mac_dequant: needs int8 operands, got "
                        f"{qa.dtype} x {qw.dtype}")
    batch, a2 = _flatten(qa, qw)
    n = qw.shape[1]
    if scale_a.dtype != torch.float32 or scale_a.numel() != 1 or \
            scale_w.dtype != torch.float32 or scale_w.numel() != n:
        raise ValueError(f"imc_mac_dequant: needs a float32 scale_a of one "
                         f"value and a float32 scale_w of {n}, got "
                         f"{scale_a.dtype}{list(scale_a.shape)} and "
                         f"{scale_w.dtype}{list(scale_w.shape)}")
    a2 = a2.contiguous()
    b = qw.contiguous()
    sa = scale_a.contiguous()
    sw = scale_w.reshape(-1).contiguous()
    m, k = a2.shape
    out = torch.empty((m, n), dtype=torch.float32, device=a2.device)
    if m == 0 or n == 0:
        return out.reshape(*batch, n)
    geom = _resolve("imc_mac_dequant", m, n, k, geometry, a2.device)
    plan = _plan(m, n, k, *geom)  # the plan the C launch makes of geom
    # split K: the blocks' sums and one arrival counter per column tile,
    # zeroed by the launcher on the launch's stream
    scratch_ints = m * n + plan.grid_x if plan.rows and plan.splits > 1 \
        else 0
    scratch = torch.empty((scratch_ints,), dtype=torch.int32,
                          device=a2.device)
    stream, dev = build.stream_and_device(a2)
    build.check_launch("imc_mac_dequant", _entry(
        "imc_mac_dequant_launch", _DEQUANT_ARGTYPES)(
        a2.data_ptr(), b.data_ptr(), sa.data_ptr(), sw.data_ptr(),
        out.data_ptr(), scratch.data_ptr() if scratch_ints else None,
        scratch_ints, m, n, k, *geom, stream, dev))
    _count(imc_mac_dequant, plan)
    return out.reshape(*batch, n)


imc_mac_dequant.launches = imc_mac_dequant.split_launches = \
    imc_mac_dequant.tiled_launches = 0
