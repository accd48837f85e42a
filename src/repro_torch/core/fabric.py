"""FabricSpec + fabric_matmul: the typed entry point to the IMC fabric
(port of ``repro/core/fabric.py``).

A :class:`FabricSpec` is a frozen, hashable value object that determines how a
GEMM executes on the modeled fabric: precision ``bits_a`` x ``bits_w``,
geometry ``rows`` x ``cols``, fidelity ``mode`` ("exact" int GEMM or "sim"
bit-plane pyramid), engine ``backend`` and optional ``noise``.  The fields
and their validation are the reference's.

The backend words are ``auto | torch | cuda``:

  * ``cuda``  — the hand-written kernels: ``imc_mac`` (int8 GEMM) for
    ``exact``, ``bitplane_mac`` (the bit-plane pyramid with the physics
    decode in the kernel) for ``sim``, ``bitplane_mac_noisy`` (the same with
    the NoiseSpec Monte-Carlo in the kernel) for noisy ``sim``; a CPU tensor
    raises.
  * ``torch`` — plain PyTorch: ``imc_mac``'s plain version for ``exact``,
    the bit-serial engine with the Table I (LUT) decode for ``sim``, noisy
    or not, as the reference's ``jnp`` engines; a CUDA tensor raises (the
    plain version never stands in for a kernel on the card).
  * ``auto``  — ``cuda`` for a tensor on the card, ``torch`` for one on the
    CPU.

Noise-free, both ``sim`` engines decode every integer count to itself, so
``sim`` equals ``exact`` bit for bit.  Under noise the two are different
models, as in the reference: ``sim/torch+noise`` decodes with the LUT
voltage (the reference's ``_sim_jnp_noisy``), ``sim/cuda+noise`` with the
physics voltage and thresholds (its ``_sim_pallas_noisy``).  A noisy spec
needs a 64-bit ``seed`` per call; the same seed gives the same result.

The :class:`Fabric` facade bundles the four things you do with a macro, on
one device (the card unless ``device="cpu"`` is asked for):

    fab = Fabric(FabricSpec(mode="sim", noise=NoiseSpec(mismatch_sigma=0.05)))
    y   = fab.matmul(x, w, seed=7)           # quant -> fabric GEMM -> dequant
    y   = fab.linear(params, x, seed=7)      # Linear layer, STE backward
    c   = fab.logic(a, b, "XOR")             # MAC-derived bitwise logic
    rep = fab.cost(x.shape, w.shape)         # energy/latency FabricReport
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.core.bitserial import (bitserial_matmul_unsigned,
                                        decode_group_counts)
from repro_torch.core.energy import FabricReport
from repro_torch.core.logic import OPS, add_nbit, logic_from_count, logic_word
from repro_torch.core.quant import (quantize, signed_product_correction,
                                    to_offset_binary)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.common import mix_seed, seed_int

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

    @property
    def label(self) -> str:
        """Short row label for logs: e.g. ``sim/cuda`` (``auto`` reads as the
        engine a tensor on the default device would take)."""
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        s = f"{self.mode}/{self.resolve_backend(dev)}"
        return s + "+noise" if self.noisy else s

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
# (mode, backend, noisy) -> engine(qa, qw, spec, seed) -> int32 accumulator
# qa: int8[..., K] signed quantized activations; qw: int8[K, N] weights;
# seed: the call's noise seed, a 64-bit integer or a seed-table row (None
# for a noise-free spec).
_ENGINES: Dict[Tuple[str, str, bool], Callable] = {}


def register_engine(mode: str, backend: str, noisy: bool):
    def deco(fn):
        _ENGINES[(mode, backend, noisy)] = fn
        return fn
    return deco


def resolve_engine(spec: FabricSpec, device: torch.device) -> Callable:
    """Engine for a spec on ``device``; raises on unsupported combos."""
    return _ENGINES[(spec.mode, spec.resolve_backend(device), spec.noisy)]


def int_matmul(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """int8[..., K] x int8[K, N] -> int32[..., N]: the ``imc_mac`` kernel
    for CUDA tensors, its plain version for CPU tensors."""
    from repro_torch.kernels.imc_mac.ops import imc_mac

    return imc_mac(qa, qw)


@register_engine("exact", "torch", False)
def _exact_torch(qa, qw, spec, seed):
    from repro_torch.kernels.imc_mac.ops import imc_mac_torch

    return imc_mac_torch(qa, qw)


@register_engine("exact", "cuda", False)
def _exact_cuda(qa, qw, spec, seed):
    from repro_torch.kernels.imc_mac.ops import imc_mac

    return imc_mac(qa, qw)


def _sim_correction(qa, qw, spec):
    u_a = to_offset_binary(qa, spec.bits_a)
    u_w = to_offset_binary(qw, spec.bits_w)
    return u_a, u_w, signed_product_correction(u_a, u_w, spec.bits_a,
                                               spec.bits_w)


@register_engine("sim", "torch", False)
def _sim_torch(qa, qw, spec, seed):
    u_a, u_w, corr = _sim_correction(qa, qw, spec)
    uu = bitserial_matmul_unsigned(u_a, u_w, bits_a=spec.bits_a,
                                   bits_w=spec.bits_w, rows=spec.rows,
                                   mode="sim")
    return uu - corr


@register_engine("sim", "torch", True)
def _sim_torch_noisy(qa, qw, spec, seed):
    u_a, u_w, corr = _sim_correction(qa, qw, spec)
    # the per-pair torch.Generators take a host seed: a seed-table row is
    # read back (this engine runs on the CPU only)
    uu = bitserial_matmul_unsigned(
        u_a, u_w, bits_a=spec.bits_a, bits_w=spec.bits_w, rows=spec.rows,
        mode="sim", seed=seed_int(seed),
        mismatch_sigma=spec.noise.mismatch_sigma,
        comparator_offset_sigma=spec.noise.comparator_offset_sigma)
    return uu - corr


@register_engine("sim", "cuda", False)
def _sim_cuda(qa, qw, spec, seed):
    from repro_torch.kernels.bitplane_mac.ops import bitplane_mac

    u_a, u_w, corr = _sim_correction(qa, qw, spec)
    uu = bitplane_mac(u_a, u_w, bits_a=spec.bits_a, bits_w=spec.bits_w,
                      rows=spec.rows)
    return uu - corr


@register_engine("sim", "cuda", True)
def _sim_cuda_noisy(qa, qw, spec, seed):
    from repro_torch.kernels.bitplane_mac.ops import bitplane_mac_noisy

    u_a, u_w, corr = _sim_correction(qa, qw, spec)
    uu = bitplane_mac_noisy(
        u_a, u_w, seed, bits_a=spec.bits_a, bits_w=spec.bits_w,
        rows=spec.rows, mismatch_sigma=spec.noise.mismatch_sigma,
        comparator_offset_sigma=spec.noise.comparator_offset_sigma)
    return uu - corr


# ------------------------------------------------------------------ matmul
def fabric_matmul(x: torch.Tensor, w: torch.Tensor,
                  spec: FabricSpec = FabricSpec(), *,
                  seed: Optional[int] = None) -> torch.Tensor:
    """y[..., N] ~= x[..., K] @ w[K, N] through the fabric described by spec.

    Activations quantize per tensor (dynamic, in ``x``'s dtype) at
    ``bits_a``; weights per output channel at ``bits_w``.  The dequant runs
    in the reference's order, ``acc.f32 * scale_a * scale_w``, left to
    right.  ``seed`` is required iff ``spec.noisy``: a 64-bit integer, or
    a seed-table row (an int32 (2,) tensor of the seed's two uint32 words,
    :func:`~repro_torch.kernels.common.seed_row`), which the noisy kernel
    reads from device memory.
    """
    if spec.noisy and seed is None:
        raise ValueError(f"spec {spec.label} is noisy: pass seed=")
    engine = resolve_engine(spec, x.device)
    qx = quantize(x, spec.bits_a, axis=None)
    qw = quantize(w, spec.bits_w, axis=0)  # per-column (output channel)
    acc = engine(qx.q, qw.q, spec, seed)
    return acc.to(torch.float32) * qx.scale * qw.scale.reshape(
        (1,) * (acc.ndim - 1) + (-1,))


# ------------------------------------------------------------------ facade
class Fabric:
    """All four faces of the macro — GEMM, layer, logic, cost — on one spec
    and one device.

    ``device`` resolves through :func:`repro_torch.device.resolve_device`:
    None means the card, and raises without one.  The engine is resolved
    up front, so a spec the device cannot run raises here.  Operands (numpy
    arrays, Python numbers or tensors) are moved to the fabric's device.
    """

    def __init__(self, spec: FabricSpec = FabricSpec(),
                 device: DeviceLike = None):
        self.spec = spec
        self.device = resolve_device(device)
        self._engine = resolve_engine(spec, self.device)

    def __repr__(self):
        return f"Fabric({self.spec!r}, device={str(self.device)!r})"

    def _t(self, x) -> torch.Tensor:
        """``x`` on the fabric's device; a float64 array becomes float32, as
        the reference's ``jnp.asarray`` makes it."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if x.dtype == np.float64:
                x = x.astype(np.float32)
        return torch.as_tensor(x, device=self.device)

    def _words(self, x) -> torch.Tensor:
        """Packed words as int64 (numpy's unsigned types included)."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x).astype(np.int64)
        return self._t(x).to(torch.int64)

    def matmul(self, x, w, *, seed: Optional[int] = None) -> torch.Tensor:
        """Quantize -> fabric GEMM -> dequant.  See :func:`fabric_matmul`."""
        return fabric_matmul(self._t(x), self._t(w), self.spec, seed=seed)

    def linear(self, params, x, *, seed: Optional[int] = None
               ) -> torch.Tensor:
        """Linear layer on the fabric: params {"w": (K,N)[, "b": (N,)]}.

        Straight-through estimator backward (the gradients of the float
        matmul), so the same layer trains and serves.
        """
        from repro_torch.core.imc_linear import imc_linear_apply

        b = params.get("b")
        return imc_linear_apply(self._t(x), self._t(params["w"]),
                                None if b is None else self._t(b),
                                spec=self.spec, seed=seed)

    def _count_decode(self, seed: Optional[int]):
        """counts -> counts through the spec's decode path.

        Under a noisy spec, evaluation ``n`` of the returned closure draws
        from its own generator seeded ``mix_seed(seed, n)`` (the reference
        folds ``n`` into its key), so multi-evaluation word ops (ripple-carry
        stages) draw independent noise per MAC activation.
        """
        if self.spec.noisy and seed is None:
            raise ValueError(f"spec {self.spec.label} is noisy: pass seed=")
        n = [0]

        def decode(count):
            kw = {}
            if self.spec.noisy:
                gen = torch.Generator(device=self.device).manual_seed(
                    mix_seed(seed, n[0]))
                kw = dict(generator=gen,
                          mismatch_sigma=self.spec.noise.mismatch_sigma,
                          comparator_offset_sigma=(
                              self.spec.noise.comparator_offset_sigma))
                n[0] += 1
            return decode_group_counts(count, mode=self.spec.mode,
                                       rows=self.spec.rows, **kw)

        return decode

    def logic(self, a, b, op: str, *, seed: Optional[int] = None
              ) -> torch.Tensor:
        """MAC-derived bitwise logic (paper §III-B..E, Table II).

        ``a``, ``b``: {0,1} values (any shape, broadcastable).  The
        2-operand MAC count goes through the spec's decode path (exact clip,
        or the analog voltage + comparator model for ``mode="sim"``, with
        the spec's noise under ``seed``), then the Boolean function is read
        off the count.  Returns uint8.
        """
        op = op.upper()
        if op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {op!r}")
        count = self._t(a).to(torch.int32) + self._t(b).to(torch.int32)
        dec = self._count_decode(seed)(count)
        return logic_from_count(dec, m=2)[op]

    def logic_word(self, a, b, op: str, *, bits: int = 8,
                   seed: Optional[int] = None) -> torch.Tensor:
        """Bitwise ``op`` over packed ``bits``-wide words (paper §III).

        8 columns evaluate in parallel per macro activation, so a uint8 word
        is one MAC cycle; every column's count runs through the spec's
        decode path (``seed`` required iff noisy).
        """
        return logic_word(self._words(a), self._words(b), op, bits=bits,
                          decode=self._count_decode(seed))

    def add_nbit(self, a, b, *, bits: int = 8, seed: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ripple-carry word addition from 1-bit MAC adders (paper §III-E).

        Returns ``(sum mod 2**bits, carry_out)``; each half-adder stage is a
        separate seeded MAC evaluation under a noisy spec.
        """
        return add_nbit(self._words(a), self._words(b), bits=bits,
                        decode=self._count_decode(seed))

    def cost(self, x_shape, w_shape, *, n_macros: int = 1,
             schedule: str = "weight_stationary") -> FabricReport:
        """Energy/latency projection of ``matmul(x, w)`` on this fabric."""
        from repro_torch.core.imc_matmul import imc_matmul_cost

        return imc_matmul_cost(x_shape, w_shape, spec=self.spec,
                               n_macros=n_macros, schedule=schedule)


# --------------------------------------------------------------------- CLI
def add_fabric_cli(ap) -> None:
    """Attach the FabricSpec flags to an argparse parser (launchers' edge)."""
    ap.add_argument("--imc", "--imc-mode", dest="imc", default=None,
                    choices=("off",) + MODES,
                    help="route every projection through the IMC fabric")
    ap.add_argument("--imc-bits", type=int, default=8,
                    help="activation precision (bits_a)")
    ap.add_argument("--imc-bits-w", type=int, default=0,
                    help="weight precision (0 -> same as --imc-bits)")
    ap.add_argument("--imc-backend", default="auto", choices=BACKENDS)
    ap.add_argument("--imc-mismatch-sigma", "--imc-noise-sigma",
                    dest="imc_mismatch_sigma", type=float, default=None,
                    help="device mismatch sigma (sim only; seeded per call)")
    ap.add_argument("--imc-comparator-sigma", type=float, default=None,
                    help="comparator offset sigma in V (sim only; seeded)")


def fabric_from_cli(args) -> Optional[FabricSpec]:
    """FabricSpec from the add_fabric_cli flags; None when --imc is off/unset."""
    if args.imc in (None, "off"):
        return None
    noise = None
    if args.imc_mismatch_sigma is not None or \
            args.imc_comparator_sigma is not None:
        noise = NoiseSpec(mismatch_sigma=args.imc_mismatch_sigma,
                          comparator_offset_sigma=args.imc_comparator_sigma)
    return FabricSpec(bits_a=args.imc_bits,
                      bits_w=args.imc_bits_w or args.imc_bits,
                      mode=args.imc, backend=args.imc_backend, noise=noise)


def apply_fabric_cli(args, cfg):
    """Shared launcher edge: fold the --imc* flags into a ModelConfig.

    Returns ``cfg`` unchanged when ``--imc`` wasn't given; ``--imc off``
    turns the fabric off.  A noisy spec draws its noise from the server's
    ``noise_seed`` (the launchers pass ``--seed``).
    """
    if args.imc is None:
        return cfg
    spec = fabric_from_cli(args)
    # the typed field is the one source of truth: clear the legacy channel
    return dataclasses.replace(cfg, fabric=spec, imc_mode="off")
