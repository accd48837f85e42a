"""The ``rbl_decode_mac`` kernel: the grouped binary MAC with the analog RBL
decode in the loop, for one bit-plane pair (port of
``repro/kernels/rbl_decode``; CUDA source ``csrc/rbl_decode_mac.cu``).

    out[m, n] = sum_g #{i : thr[i] >= V(count[g, m, n])}

with ``count`` the binary MAC count of each ``rows``-row K-group, ``V`` the
two-regime physics RBL voltage and ``thr`` the comparator references (live
data: a detuned ``thr`` corrupts the result, the paper's §IV-C threshold
re-tuning study).  Under the calibrated ``thr`` every count decodes to
itself and the result is the integer product ``a_bits @ w_bits``.

Operands are {0,1} (int8 or uint8).  The kernel counts bit 0 of each byte;
the plain version raises on any other value, the kernel's wrapper does not
read values back to check.  Only the real ``ceil(K/rows)`` groups are
decoded (a zero-padded partial last group is real and decoded); the
reference also decodes the groups of its K padding to 256, which under a
detuned ``thr`` with ``dec(0) != 0`` adds ``dec(0)`` per padded group.

:func:`rbl_decode_mac` dispatches by device: a CUDA tensor launches the
kernel (or raises: on a build failure, a refused launch, a wrong dtype,
device or shape, a ``thr`` that is not float32[rows]); a CPU tensor takes the
plain version :func:`rbl_decode_mac_torch`.  ``rbl_decode_mac.launches``
counts kernel launches and nothing else.

The kernel's launch (rows a thread keeps, tile, K split over a thread-block
cluster) follows one rule, :func:`rbl_decode_mac_plan`, the twin of the C
``rbl_decode_mac_plan`` (``chip_smoke.py`` phases 4c and 12 hold the two
equal).  Its geometry (``cluster``, the splits at most, and ``target``, the
blocks a launch aims at) is a runtime argument: on a CUDA tensor the wrapper
resolves it at call time with ``autotune.lookup`` (8 and 264 by default, the
measured cache, a pin), and an explicit ``geometry=`` beats the tuner.  Every
geometry gives the same output.  The CPU path ignores geometry.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import constants as C
from repro_torch.core.bitserial import group_counts
from repro_torch.core.rbl import rbl_voltage_physics
from repro_torch.kernels import autotune, build
from repro_torch.kernels.bitplane_mac.ops import (MAX_ROWS, decode_counts,
                                                  physics_thresholds)

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p,
                                                          ctypes.c_int]
_PLAN_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BYTES = (torch.int8, torch.uint8)
_COLS = 8          # columns a lane keeps: 8 bytes of a W row
_WAVE = 132        # SMs of an H100
_SM_BYTES = 45056  # a block's shared bytes for a chunk of A's bits and W
_FNS = {}


class Plan(NamedTuple):
    """A launch: the output rows a thread keeps (4 or 8), the warps along M
    (1 or 4; the others split K), the lanes along N (8, 16 or 32; the others
    split K), the grid (column tiles, K splits = the cluster size, row
    tiles), the K-groups per split and per staging of A and W."""
    rows_per_thread: int
    warps_m: int
    lanes_n: int
    grid_x: int
    grid_y: int
    grid_z: int
    groups_per_split: int
    groups_per_chunk: int


def _geometry_args(geom) -> tuple:
    """(cluster, target) of a geometry (None: the defaults), merged over the
    defaults and checked against the source's bounds."""
    g = autotune.DEFAULTS["rbl_decode_mac"] if geom is None else \
        autotune.check_geometry(
            "rbl_decode_mac", {**autotune.DEFAULTS["rbl_decode_mac"], **geom},
            "rbl_decode_mac geometry")
    return g["cluster"], g["target"]


def rbl_decode_mac_plan(m: int, n: int, k: int, rows: int,
                        geom=None) -> Plan:
    """The launch of an ``m x k x n`` product of ``rows``-row groups under
    the geometry ``geom`` (None: the defaults), as
    ``csrc/rbl_decode_mac.cu``'s ``rbl_decode_mac_plan`` computes it.  M <= 4
    keeps 4 rows a thread and M 5-8 keeps 8, with the 4 warps on K; above 8
    the warps take 8 rows each of a 32-row tile.  Tiles are 8 columns a lane:
    256 columns, narrowed to 128 or 64 (M <= 8) until the tiles at
    ``cluster`` splits fill the 132 SMs.  The splits double, up to
    ``cluster``, while the launch stays within ``target`` blocks and each
    split has two groups; K = 0 is one split."""
    return _plan(m, n, k, rows, *_geometry_args(geom))


@functools.lru_cache(maxsize=None)
def _plan(m: int, n: int, k: int, rows: int, cluster: int,
          target: int) -> Plan:
    groups = -(-k // rows) if k > 0 else 0
    rm = 4 if m <= 4 else 8
    wm = 1 if m <= 8 else 4
    gz = -(-m // (rm * wm))
    ln = 32
    while wm == 1 and ln > 8 and \
            -(-n // (_COLS * ln)) * gz * cluster < _WAVE:
        ln //= 2
    gx = -(-n // (_COLS * ln))
    splits = 1
    while splits < cluster and gx * gz * splits * 2 <= target and \
            groups >= 2 * splits:
        splits *= 2
    return Plan(rm, wm, ln, gx, splits, gz, -(-groups // splits),
                (_SM_BYTES - 16) // (rows * (4 * rm * wm + _COLS * ln)))


@functools.lru_cache(maxsize=None)
def physics_voltages(rows: int, device) -> torch.Tensor:
    """float32[rows + 1]: the physics RBL voltage V(k) of every count k, as
    the plain version computes it (``rbl_voltage_physics``, elementwise), on
    ``device``; made once per (rows, device).  The kernel decodes each count
    against the live ``thr`` with it."""
    return rbl_voltage_physics(torch.arange(rows + 1, dtype=torch.float32,
                                            device=device), rows=rows)


def compiled_plan(m: int, n: int, k: int, rows: int, geom=None) -> Plan:
    """The C ``rbl_decode_mac_plan`` of the built library under ``geom``
    (needs ``nvcc``)."""
    out = (ctypes.c_int * 8)()
    build.check_launch("rbl_decode_mac_plan", _entry(
        "rbl_decode_mac_plan", _PLAN_ARGTYPES)(
        m, n, k, rows, *_geometry_args(geom), ctypes.addressof(out)))
    return Plan(*out)


def _entry(name: str, argtypes):
    """The C function ``name`` of ``csrc/rbl_decode_mac.cu``, its argument
    types set once, at the library's first load."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("rbl_decode_mac"), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(a_bits, w_bits, thr, rows):
    if w_bits.ndim != 2 or a_bits.ndim < 1 or \
            a_bits.shape[-1] != w_bits.shape[0]:
        raise ValueError(f"rbl_decode_mac: shapes {tuple(a_bits.shape)} x "
                         f"{tuple(w_bits.shape)} do not contract")
    if not 2 <= rows <= MAX_ROWS:
        raise ValueError(f"rbl_decode_mac: rows must be in [2, {MAX_ROWS}], "
                         f"got {rows}")
    if thr.dtype != torch.float32 or thr.shape != (rows,):
        raise ValueError(f"rbl_decode_mac: thr must be float32[{rows}], got "
                         f"{thr.dtype}{list(thr.shape)}")
    if any(t.device != a_bits.device for t in (w_bits, thr)):
        raise ValueError(f"rbl_decode_mac: operands on {a_bits.device}, "
                         f"{w_bits.device} and {thr.device}; all must be on "
                         "one CUDA device (or all on the CPU)")


def rbl_decode_mac_torch(a_bits: torch.Tensor, w_bits: torch.Tensor,
                         thr: torch.Tensor | None = None, *,
                         rows: int = C.ROWS) -> torch.Tensor:
    """Plain version: ``group_counts`` -> physics voltage -> the number of
    references ``thr[i] >= V`` per group, summed over the real groups.
    Returns int32[..., N].  Runs on the CPU and on the card alike."""
    if thr is None:
        thr = physics_thresholds(rows, a_bits.device)
    _check(a_bits, w_bits, thr, rows)
    for name, t in (("a_bits", a_bits), ("w_bits", w_bits)):
        if not bool(((t == 0) | (t == 1)).all()):
            raise ValueError(f"rbl_decode_mac: {name} must hold {{0, 1}}")
    counts = group_counts(a_bits, w_bits, rows)  # [..., G, N]
    return torch.sum(decode_counts(counts, thr, rows), dim=-2,
                     dtype=torch.int32)


def rbl_decode_mac(a_bits: torch.Tensor, w_bits: torch.Tensor,
                   thr: torch.Tensor | None = None, *,
                   rows: int = C.ROWS, geometry=None) -> torch.Tensor:
    """Grouped analog-decode binary MAC for arbitrary shapes.

    a_bits: {0,1}[..., K]; w_bits: {0,1}[K, N]; leading batch dims of
    ``a_bits`` flatten into M.  ``thr`` (float32[rows], descending) defaults
    to the physics-model references for ``rows`` (re-tunable, §IV-C).
    ``geometry`` (``cluster``, ``target``) beats the tuner's.  Returns
    int32[..., N].
    """
    if all(t is None or t.device.type == "cpu" for t in (a_bits, w_bits,
                                                         thr)):
        return rbl_decode_mac_torch(a_bits, w_bits, thr, rows=rows)
    if not a_bits.is_cuda:
        raise ValueError(f"rbl_decode_mac: operands on {a_bits.device} and "
                         f"{w_bits.device}; all must be on one CUDA device "
                         "(or all on the CPU)")
    if thr is None:
        thr = physics_thresholds(rows, a_bits.device)
    _check(a_bits, w_bits, thr, rows)
    if a_bits.dtype not in _BYTES or w_bits.dtype not in _BYTES:
        raise TypeError(f"rbl_decode_mac: needs int8 or uint8 {{0, 1}} "
                        f"operands, got {a_bits.dtype} x {w_bits.dtype}")
    batch = tuple(a_bits.shape[:-1])
    k, n = w_bits.shape
    a = a_bits.reshape(-1, k).contiguous()
    w = w_bits.contiguous()
    t = thr.contiguous()
    m = a.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out.reshape(batch + (n,))
    geom = autotune.lookup("rbl_decode_mac", {"m": m, "k": k, "n": n,
                                              "rows": rows},
                           dtype=autotune.KERNEL_DTYPES["rbl_decode_mac"],
                           device=a.device)
    if geometry:
        geom.update(autotune.check_geometry(
            "rbl_decode_mac", dict(geometry), "rbl_decode_mac(geometry=...)"))
    stream, dev = build.stream_and_device(a)
    build.check_launch("rbl_decode_mac", _entry(
        "rbl_decode_mac_launch", _ARGTYPES)(
        a.data_ptr(), w.data_ptr(), t.data_ptr(),
        physics_voltages(rows, a.device).data_ptr(), out.data_ptr(), m, n, k,
        rows, geom["cluster"], geom["target"], stream, dev))
    rbl_decode_mac.launches += 1
    return out.reshape(batch + (n,))


rbl_decode_mac.launches = 0
