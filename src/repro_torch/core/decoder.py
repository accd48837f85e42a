"""MAC decoder: comparator bank -> thermometer code -> digital MAC count
(port of ``repro/core/decoder.py``, noise-free).

The paper's decoder uses one comparator per MAC level; thresholds sit
between adjacent RBL levels.  Comparator i outputs 1 while V_RBL is ABOVE
its threshold, so count k produces the thermometer codes of Table I
(k=0 -> 11111111, k=8 -> 00000000) and ``count = rows - popcount(code)``.

Comparator offset noise (``comparator_offset_sigma``) comes with the noisy
slice of the port and raises "not ported yet" here.
"""
from __future__ import annotations

import torch

from repro_torch.core import constants as C
from repro_torch.core.rbl import level_voltages


def _no_offset_noise(comparator_offset_sigma) -> None:
    if comparator_offset_sigma is not None:
        raise NotImplementedError("comparator_offset_sigma: the noisy decode "
                                  "is not ported yet")


def thresholds(rows: int = C.ROWS, *, mode: str = "lut",
               t_eval: float = C.T_EVAL_S, device=None) -> torch.Tensor:
    """Comparator references: midpoints between adjacent count levels.

    Returned descending: thr[i] separates count i (above) from i+1 (below).
    """
    lv = level_voltages(rows, mode=mode, t_eval=t_eval, device=device)
    return 0.5 * (lv[:-1] + lv[1:])


def thermometer_code(v_rbl, *, rows: int = C.ROWS, mode: str = "lut",
                     t_eval: float = C.T_EVAL_S,
                     comparator_offset_sigma=None) -> torch.Tensor:
    """Comparator bank output: uint8 bits, bit i = (V_RBL > thr[i]).

    Shape: v_rbl.shape + (rows,).
    """
    _no_offset_noise(comparator_offset_sigma)
    v = torch.as_tensor(v_rbl, dtype=torch.float32)[..., None]
    thr = thresholds(rows, mode=mode, t_eval=t_eval, device=v.device)
    return (v > thr).to(torch.uint8)


def code_to_count(code) -> torch.Tensor:
    """Thermometer code -> MAC count: rows - popcount(code)."""
    code = torch.as_tensor(code)
    return code.shape[-1] - torch.sum(code.to(torch.int32), dim=-1,
                                      dtype=torch.int32)


def decode_voltage(v_rbl, *, rows: int = C.ROWS, mode: str = "lut",
                   t_eval: float = C.T_EVAL_S,
                   comparator_offset_sigma=None) -> torch.Tensor:
    """Full analog-to-digital decode: V_RBL -> MAC count (int32)."""
    code = thermometer_code(v_rbl, rows=rows, mode=mode, t_eval=t_eval,
                            comparator_offset_sigma=comparator_offset_sigma)
    return code_to_count(code)
