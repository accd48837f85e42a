"""MAC decoder: comparator bank -> thermometer code -> digital MAC count
(port of ``repro/core/decoder.py``).

The paper's decoder uses one comparator per MAC level; thresholds sit
between adjacent RBL levels.  Comparator i outputs 1 while V_RBL is ABOVE
its threshold, so count k produces the thermometer codes of Table I
(k=0 -> 11111111, k=8 -> 00000000) and ``count = rows - popcount(code)``.

``comparator_offset_sigma`` models input-referred comparator offset: each
reference moves by ``sigma * z`` per element and comparator, with ``z``
drawn from a ``torch.Generator`` or passed in (shape ``v.shape + (rows,)``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import constants as C
from repro_torch.core.montecarlo import randn
from repro_torch.core.rbl import level_voltages


def thresholds(rows: int = C.ROWS, *, mode: str = "lut",
               t_eval: float = C.T_EVAL_S, device=None) -> torch.Tensor:
    """Comparator references: midpoints between adjacent count levels.

    Returned descending: thr[i] separates count i (above) from i+1 (below).
    """
    lv = level_voltages(rows, mode=mode, t_eval=t_eval, device=device)
    return 0.5 * (lv[:-1] + lv[1:])


def thermometer_code(v_rbl, *, rows: int = C.ROWS, mode: str = "lut",
                     t_eval: float = C.T_EVAL_S, comparator_offset_sigma=None,
                     generator: Optional[torch.Generator] = None,
                     z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Comparator bank output: uint8 bits, bit i = (V_RBL > thr[i]).

    Shape: v_rbl.shape + (rows,).  Under ``comparator_offset_sigma`` the
    references are ``thr + sigma * z`` (``z`` from ``generator`` unless
    given).
    """
    v = torch.as_tensor(v_rbl, dtype=torch.float32)[..., None]
    thr = thresholds(rows, mode=mode, t_eval=t_eval, device=v.device)
    if comparator_offset_sigma is not None:
        if z is None:
            if generator is None:
                raise ValueError("comparator noise requires a generator or z")
            z = randn(generator, v.shape[:-1] + (rows,), v.device)
        thr = thr + comparator_offset_sigma * z
    return (v > thr).to(torch.uint8)


def code_to_count(code) -> torch.Tensor:
    """Thermometer code -> MAC count: rows - popcount(code)."""
    code = torch.as_tensor(code)
    return code.shape[-1] - torch.sum(code.to(torch.int32), dim=-1,
                                      dtype=torch.int32)


def decode_voltage(v_rbl, *, rows: int = C.ROWS, mode: str = "lut",
                   t_eval: float = C.T_EVAL_S, comparator_offset_sigma=None,
                   generator: Optional[torch.Generator] = None,
                   z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full analog-to-digital decode: V_RBL -> MAC count (int32)."""
    code = thermometer_code(v_rbl, rows=rows, mode=mode, t_eval=t_eval,
                            comparator_offset_sigma=comparator_offset_sigma,
                            generator=generator, z=z)
    return code_to_count(code)
