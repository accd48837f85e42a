"""FabricSpec + fabric_matmul: the typed entry point to the IMC fabric
(port of ``repro/core/fabric.py``, exact mode).

A :class:`FabricSpec` is a frozen, hashable value object that determines how a
GEMM executes on the modeled fabric: precision ``bits_a`` x ``bits_w``,
geometry ``rows`` x ``cols``, fidelity ``mode`` ("exact" int GEMM or "sim"
bit-plane pyramid), engine ``backend`` and optional ``noise``.  The fields
and their validation are the reference's.

The backend words are ``auto | torch | cuda``:

  * ``cuda``  — the hand-written int8 GEMM kernel (:mod:`repro_torch.kernels
    .imc_mac`); a CPU tensor raises.
  * ``torch`` — the kernel's plain PyTorch version; a CUDA tensor raises (the
    plain version never stands in for the kernel on the card).
  * ``auto``  — ``cuda`` for a tensor on the card, ``torch`` for one on the
    CPU.

Only the exact engines are ported.  A ``sim`` or noisy spec raises "not
ported yet" when its engine is resolved, never falls back.  The ``Fabric``
facade, MAC-derived logic and the cost model come in a later slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import constants as C
from repro_torch.core.quant import quantize

MODES = ("exact", "sim")
BACKENDS = ("auto", "torch", "cuda")


# ------------------------------------------------------------------- specs
@dataclass(frozen=True)
class NoiseSpec:
    """Analog non-idealities of the sim path (both optional).

    mismatch_sigma          — voltage-referred device mismatch on the
                              effective MAC count (the paper-calibrated value
                              is ``constants.MC_SIGMA_VK``).
    comparator_offset_sigma — input-referred comparator offset (V) on the
                              thermometer decode references.
    """

    mismatch_sigma: Optional[float] = None
    comparator_offset_sigma: Optional[float] = None

    def __post_init__(self):
        for name in ("mismatch_sigma", "comparator_offset_sigma"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ValueError(f"NoiseSpec.{name} must be >= 0, got {v}")

    @property
    def enabled(self) -> bool:
        return (self.mismatch_sigma is not None
                or self.comparator_offset_sigma is not None)

    @classmethod
    def calibrated(cls) -> "NoiseSpec":
        """Device mismatch at the paper-calibrated sigma (Fig 6 / §IV-C)."""
        return cls(mismatch_sigma=C.MC_SIGMA_VK)


@dataclass(frozen=True)
class FabricSpec:
    """Complete, hashable description of one IMC fabric configuration."""

    bits_a: int = 8
    bits_w: int = 8
    rows: int = C.ROWS
    cols: int = C.COLS
    mode: str = "exact"  # exact | sim
    backend: str = "auto"  # auto | torch | cuda
    noise: Optional[NoiseSpec] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        for name in ("bits_a", "bits_w"):
            b = getattr(self, name)
            if not 2 <= b <= 8:
                raise ValueError(f"{name} must be in [2, 8] (int8 storage), "
                                 f"got {b}")
        if self.rows < 2 or self.cols < 1:
            raise ValueError(f"invalid geometry {self.rows}x{self.cols}")
        # an all-off NoiseSpec is canonicalized to None (one "no noise" value)
        if self.noise is not None and not self.noise.enabled:
            object.__setattr__(self, "noise", None)
        if self.noisy and self.mode != "sim":
            raise ValueError(
                "noise is only meaningful on the analog sim path; use "
                "mode='sim' (exact mode is the noise-free digital equivalent)")

    # -------------------------------------------------------------- derived
    @property
    def noisy(self) -> bool:
        return self.noise is not None

    def resolve_backend(self, device: torch.device) -> str:
        """Concrete engine for tensors on ``device``; raises on a mismatch."""
        want = "cuda" if device.type == "cuda" else "torch"
        if self.backend == "auto":
            return want
        if self.backend != want:
            raise ValueError(
                f"backend={self.backend!r} cannot run a tensor on "
                f"{device.type}: 'cuda' needs a CUDA tensor and 'torch' (the "
                "plain version) runs only on the CPU")
        return self.backend

    def replace(self, **kw) -> "FabricSpec":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------- registry
# (mode, backend, noisy) -> engine(qa, qw, spec) -> int32 accumulator
# qa: int8[..., K] signed quantized activations; qw: int8[K, N] weights.
_ENGINES: Dict[Tuple[str, str, bool], Callable] = {}


def register_engine(mode: str, backend: str, noisy: bool):
    def deco(fn):
        _ENGINES[(mode, backend, noisy)] = fn
        return fn
    return deco


def check_ported(spec: FabricSpec) -> None:
    """Raise up front for a spec whose engines this slice has not ported."""
    if spec.mode != "exact" or spec.noisy:
        raise NotImplementedError(
            f"fabric mode {spec.mode!r}{' with noise' if spec.noisy else ''} "
            "is not ported yet: repro_torch runs mode='exact' only")


def resolve_engine(spec: FabricSpec, device: torch.device) -> Callable:
    """Engine for a spec on ``device``; raises on unsupported combos."""
    check_ported(spec)
    return _ENGINES[(spec.mode, spec.resolve_backend(device), spec.noisy)]


@register_engine("exact", "torch", False)
def _exact_torch(qa, qw, spec):
    from repro_torch.kernels.imc_mac.ops import imc_mac_torch

    return imc_mac_torch(qa, qw)


@register_engine("exact", "cuda", False)
def _exact_cuda(qa, qw, spec):
    from repro_torch.kernels.imc_mac.ops import imc_mac

    return imc_mac(qa, qw)


# ------------------------------------------------------------------ matmul
def fabric_matmul(x: torch.Tensor, w: torch.Tensor,
                  spec: FabricSpec = FabricSpec()) -> torch.Tensor:
    """y[..., N] ~= x[..., K] @ w[K, N] through the fabric described by spec.

    Activations quantize per tensor (dynamic, in ``x``'s dtype) at
    ``bits_a``; weights per output channel at ``bits_w``.  The dequant runs
    in the reference's order, ``acc.f32 * scale_a * scale_w``, left to
    right.
    """
    engine = resolve_engine(spec, x.device)
    qx = quantize(x, spec.bits_a, axis=None)
    qw = quantize(w, spec.bits_w, axis=0)  # per-column (output channel)
    acc = engine(qx.q, qw.q, spec)
    return acc.to(torch.float32) * qx.scale * qw.scale.reshape(
        (1,) * (acc.ndim - 1) + (-1,))
