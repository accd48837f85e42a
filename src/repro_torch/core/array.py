"""Behavioral model of the 8x8 (RxC) 8T SRAM IMC array (port of
``repro/core/array.py``).

Functional-state design, as in the reference: the array contents are a plain
``uint8[rows, cols]`` tensor (node Q of each cell), and every operation
returns new tensors; none changes its arguments.

Operations mirror the paper's peripheral circuitry:
  * ``write_row``   — write driver + row decoder (one row per write cycle)
  * ``read_bit``    — normal memory read through the decoupled read port
                      (single RWL active; count in {0,1} IS the stored bit —
                      no read disturbance, the 8T advantage)
  * ``mac``         — multi-row evaluation: pre-charge, assert RWL pattern,
                      charge-share, comparator decode (full analog path)
  * ``logic2``      — two-row evaluation interpreted as AND/OR/XOR/... per
                      column (8 columns -> bitwise 8-bit logic, Table II)

Comparator offsets draw from a ``torch.Generator`` where the reference takes
a ``jax.random`` key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.core import constants as C
from repro_torch.core.decoder import code_to_count, thermometer_code
from repro_torch.core.energy import mac_energy_fj
from repro_torch.core.logic import logic_from_count
from repro_torch.core.rbl import rbl_voltage
from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class ArraySpec:
    rows: int = C.ROWS
    cols: int = C.COLS
    mode: str = "lut"  # "lut" (canonical 8x8) | "physics" (any geometry)
    t_eval: float = C.T_EVAL_S

    def __post_init__(self):
        if self.mode == "lut" and self.rows != C.ROWS:
            raise ValueError("lut mode requires 8 rows")


class MacResult(NamedTuple):
    counts: torch.Tensor  # int32[cols]   decoded MAC counts
    volts: torch.Tensor  # float32[cols] analog RBL voltages
    codes: torch.Tensor  # uint8[cols, rows] thermometer codes
    energy_fj: torch.Tensor  # float32[cols] per-column RBL energy (Table III)


def empty_state(spec: ArraySpec = ArraySpec(),
                device: DeviceLike = None) -> torch.Tensor:
    """A cleared array on ``device`` (default: the card, as every entry
    point of the port; pass ``"cpu"`` for the CPU)."""
    return torch.zeros((spec.rows, spec.cols), dtype=torch.uint8,
                       device=resolve_device(device))


def write_row(state: torch.Tensor, row: int, bits) -> torch.Tensor:
    """One write cycle: drive BL/BLbar on ``row`` with ``bits``
    (uint8[cols]).  Returns the new state; ``state`` is left as it was."""
    out = state.clone()
    out[row] = torch.as_tensor(bits, dtype=torch.uint8, device=state.device)
    return out


def write(state: torch.Tensor, bits) -> torch.Tensor:
    """Load a full operand matrix (rows x cols) over ``rows`` write cycles."""
    return torch.as_tensor(bits, dtype=torch.uint8,
                           device=state.device).reshape(state.shape).clone()


def mac(state: torch.Tensor, rwl, spec: ArraySpec = ArraySpec(), *,
        k_noise: Optional[torch.Tensor] = None, comparator_offset_sigma=None,
        generator: Optional[torch.Generator] = None) -> MacResult:
    """Full analog MAC path for one evaluation.

    ``rwl``: uint8[rows] word-line activation pattern (operand A bits).
    ``k_noise``: optional float[cols] additive mismatch on the effective
    count (from :mod:`repro_torch.core.montecarlo`).  Comparator offsets
    (``comparator_offset_sigma``) draw from ``generator``.
    """
    rwl = torch.as_tensor(rwl, device=state.device).to(torch.int32)
    # int[cols]: true MAC counts (no integer matmul on the card)
    k = torch.sum(rwl[:, None] * state.to(torch.int32), dim=0,
                  dtype=torch.int32)
    k_eff = k.to(torch.float32)
    if k_noise is not None:
        k_eff = k_eff + k_noise
    v = rbl_voltage(k_eff, rows=spec.rows, t_eval=spec.t_eval, mode=spec.mode)
    codes = thermometer_code(v, rows=spec.rows, mode=spec.mode,
                             t_eval=spec.t_eval,
                             comparator_offset_sigma=comparator_offset_sigma,
                             generator=generator)
    counts = code_to_count(codes)
    return MacResult(counts, v, codes, mac_energy_fj(counts))


def read_bit(state: torch.Tensor, row: int,
             spec: ArraySpec = ArraySpec()) -> torch.Tensor:
    """Normal SRAM read via the read port: count of a single-RWL
    evaluation."""
    rwl = torch.zeros((spec.rows,), dtype=torch.uint8, device=state.device)
    rwl[row] = 1
    return mac(state, rwl, spec).counts.to(torch.uint8)


def logic2(state: torch.Tensor, row_a: int, row_b: int,
           spec: ArraySpec = ArraySpec(), **noise):
    """Two-row evaluation -> all MAC-derived logic ops, bitwise per column.

    Returns (dict op -> uint8[cols], MacResult).
    """
    rwl = torch.zeros((spec.rows,), dtype=torch.uint8, device=state.device)
    rwl[row_a] = 1
    rwl[row_b] = 1
    res = mac(state, rwl, spec, **noise)
    return logic_from_count(res.counts, m=2), res
