"""ImcLinear forward — a Linear layer executed on the modeled IMC fabric
(port of ``repro/core/imc_linear.py``, serving half).

Dynamic activation quant at ``bits_a`` + per-channel weights at ``bits_w`` +
the spec's fabric engine, dequant, optional bias.  The straight-through
backward of the reference (``_bwd``) comes with the training slice; the
serving path runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fabric import FabricSpec, fabric_matmul


def imc_linear_apply(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     spec: FabricSpec | None = None,
                     seed: Optional[int] = None) -> torch.Tensor:
    """y = fabric(x @ w) + b, configured by ``spec`` (f32 out); ``seed``
    feeds a noisy spec (the reference's ``key=``)."""
    y = fabric_matmul(x, w, spec if spec is not None else FabricSpec(),
                      seed=seed)
    if b is not None:
        y = y + b
    return y
