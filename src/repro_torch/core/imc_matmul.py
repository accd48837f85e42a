"""IMC matmul entry point — a thin spec-typed wrapper over the fabric (port of
``repro/core/imc_matmul.py``).

The implementation lives in :mod:`repro_torch.core.fabric`: a frozen,
hashable :class:`~repro_torch.core.fabric.FabricSpec` names the precision,
geometry, fidelity, backend and noise of the fabric, and
:func:`~repro_torch.core.fabric.fabric_matmul` dispatches it:

    y = imc_matmul(x, w, FabricSpec(mode="sim"))
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import constants as C
from repro_torch.core.energy import FabricReport, fabric_matmul_cost
from repro_torch.core.fabric import FabricSpec, fabric_matmul, int_matmul
from repro_torch.core.quant import Quantized, quantize

__all__ = ["imc_matmul", "imc_matmul_cost", "quantize_weight", "int_matmul"]


def imc_matmul(x: torch.Tensor, w: torch.Tensor,
               spec: FabricSpec | None = None, *,
               seed: Optional[int] = None) -> torch.Tensor:
    """IMC GEMM: y[..., N] ~= x[..., K] @ w[K, N] through the 8T SRAM fabric.

    ``spec`` defaults to the exact digital-equivalent fabric; ``seed`` is
    required iff ``spec.noisy``.
    """
    return fabric_matmul(x, w, spec if spec is not None else FabricSpec(),
                         seed=seed)


def imc_matmul_cost(x_shape, w_shape, *, spec: FabricSpec | None = None,
                    bits: int = 8, rows: int = C.ROWS, cols: int = C.COLS,
                    n_macros: int = 1,
                    schedule: str = "weight_stationary") -> FabricReport:
    """Hardware cost projection for an imc_matmul call (energy/latency model).

    With ``spec`` given, its precision and geometry are used (the numbers of
    ``Fabric(spec).cost``); the loose ``bits``/``rows``/``cols`` kwargs
    remain for cost-model sweeps that have no fabric in hand.
    """
    *batch, k = x_shape
    m = 1
    for b in batch:
        m *= b
    bits_a = bits_w = bits
    if spec is not None:
        bits_a, bits_w, rows, cols = spec.bits_a, spec.bits_w, spec.rows, \
            spec.cols
    return fabric_matmul_cost(m, k, w_shape[-1], bits_a=bits_a,
                              bits_w=bits_w, rows=rows, cols=cols,
                              n_macros=n_macros, schedule=schedule)


def quantize_weight(w: torch.Tensor, bits: int = 8) -> Quantized:
    """Static (load-time) weight quantization for ImcLinear."""
    return quantize(w, bits, axis=0)
