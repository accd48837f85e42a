"""Energy / latency / throughput model of the IMC macro and fabric (port of
``repro/core/energy.py``).

Calibrated to the paper:
  * Table III  — per-evaluation RBL energy vs MAC count (LUT, exact), plus a
                 quadratic-in-dV fit (<=0.31 fJ abs residual) for fractional /
                 extrapolated counts.
  * Table IV   — 1-bit logic energies (== E(count) of the producing MAC).
  * Fig 5      — 7 ns cycle; 8 write + 1 precharge/eval cycles = 63 ns per
                 cold operation; 0.7 ns evaluation window; 15.8 Mops/s.

The fabric model projects a full (M,K,N) bit-plane matmul onto a sea of RxC
macros — the paper's §III-F scalability argument made quantitative.  Two
scheduling modes:
  * ``cold``              — every evaluation pays the full 9-cycle op (the
                            paper's reported throughput number)
  * ``weight_stationary`` — operand B loaded once, then one precharge+eval
                            cycle per evaluation (the natural DNN mapping)

Tensors compute in float32, op by op in the reference's order, so the LUT
and the fit match it bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import constants as C
from repro_torch.core.rbl import rbl_voltage_physics


# ------------------------------------------------------------------ energy
def mac_energy_fj(count, *, exact: bool = True) -> torch.Tensor:
    """RBL energy (fJ) of one evaluation with MAC count ``count``.

    ``exact=True`` uses the Table III LUT (integer counts, linear interp for
    fractional); ``exact=False`` uses the quadratic dV fit through the
    physics voltage (any geometry).
    """
    count = torch.as_tensor(count)
    if exact:
        k = torch.clamp(count.to(torch.float32), 0.0, float(C.ROWS))
        lut = torch.as_tensor(C.E_MAC_TABLE_FJ, dtype=torch.float32,
                              device=k.device)
        lo = torch.clamp(torch.floor(k).to(torch.int64), 0, C.ROWS - 1)
        frac = k - lo.to(torch.float32)
        return lut[lo] * (1.0 - frac) + lut[lo + 1] * frac
    return energy_from_voltage_fj(rbl_voltage_physics(count))


def energy_from_voltage_fj(v_rbl) -> torch.Tensor:
    """Quadratic fit E(dV) — usable straight from an analog voltage."""
    dv = C.VDD - torch.as_tensor(v_rbl).to(torch.float32)
    return C.E_FIT_E0 + C.E_FIT_A * dv + C.E_FIT_B * dv * dv


def logic_energy_fj(op: str) -> float:
    """Table IV: energy of a 1-bit logic op (it IS a 2-row MAC evaluation)."""
    key = op.upper()
    if key in C.E_LOGIC_FJ:
        return C.E_LOGIC_FJ[key]
    # the remaining ops share their complement's evaluation (same count)
    alias = {"NAND": "AND", "OR": "NOR", "XNOR": "XOR"}
    return C.E_LOGIC_FJ[alias[key]]


# ------------------------------------------------------------------ timing
@dataclass(frozen=True)
class Timing:
    t_cycle_s: float = C.T_CYCLE_S
    n_write_cycles: int = C.N_WRITE_CYCLES
    n_pre_eval_cycles: int = C.N_PRE_EVAL_CYCLES

    @property
    def t_op_s(self) -> float:  # complete cold operation (Fig 5): 63 ns
        return (self.n_write_cycles + self.n_pre_eval_cycles) * self.t_cycle_s

    @property
    def throughput_ops(self) -> float:  # ~15.87 Mops/s
        return 1.0 / self.t_op_s

    @property
    def f_clk_hz(self) -> float:
        return 1.0 / self.t_cycle_s

    @property
    def t_eval_s(self) -> float:  # MAC latency (paper: 0.7 ns)
        return C.T_EVAL_S


# ------------------------------------------------------------------ fabric
@dataclass(frozen=True)
class FabricReport:
    evaluations: int  # total macro evaluations
    array_ops: int  # macro-op slots (each yields `cols` results)
    weight_load_cycles: int
    latency_s: float
    energy_j: float
    energy_fj_per_mac: float
    macs: int  # useful 1-bit MACs performed
    tops_per_w: float  # 1-bit-MAC ops/s/W equivalent


def fabric_matmul_cost(m: int, k: int, n: int, *, bits_a: int = 8,
                       bits_w: int = 8, rows: int = C.ROWS,
                       cols: int = C.COLS, n_macros: int = 1,
                       schedule: str = "weight_stationary",
                       mean_count: float | None = None) -> FabricReport:
    """Project an (M,K) x (K,N) bit-plane matmul onto a fabric of macros.

    One evaluation processes one (m-row-index, k-group, weight-plane,
    activation-plane) against ``cols`` output columns.  ``mean_count`` is the
    expected MAC count per evaluation (defaults to the random-bit expectation
    rows/4, i.e. bit-density 1/2 on both operands).
    """
    groups = -(-k // rows)
    col_tiles = -(-n // cols)
    evaluations = m * groups * bits_a * bits_w * col_tiles
    weight_loads = groups * bits_w * col_tiles * rows  # write cycles
    timing = Timing()
    if schedule == "cold":
        t_per_eval = timing.t_op_s
        load_cycles = evaluations * timing.n_write_cycles
    elif schedule == "weight_stationary":
        t_per_eval = timing.n_pre_eval_cycles * timing.t_cycle_s
        load_cycles = weight_loads
    else:
        raise ValueError(schedule)
    latency = (evaluations * t_per_eval + load_cycles * timing.t_cycle_s *
               (0 if schedule == "cold" else 1)) / max(n_macros, 1)
    if mean_count is None:
        mean_count = rows / 4.0  # E[sum of 8 Bernoulli(1/4)] for random bits
    e_eval_fj = float(mac_energy_fj(torch.tensor(mean_count,
                                                 dtype=torch.float32)))
    energy_j = evaluations * cols * e_eval_fj * 1e-15
    macs = m * k * n * bits_a * bits_w  # 1-bit MAC equivalents
    power_w = energy_j / latency if latency > 0 else float("inf")
    tops_w = (macs / latency) / power_w / 1e12 if power_w > 0 else 0.0
    return FabricReport(evaluations, evaluations, weight_loads, latency,
                        energy_j, e_eval_fj, macs, tops_w)
