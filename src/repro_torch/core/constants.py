"""Paper-calibrated constants for the 8T SRAM IMC architecture.

All table values are transcribed from the paper (90 nm CMOS, 1.8 V):
  Table I   — RBL voltage vs MAC count (8 rows, C_RBL = 200 fF, t_eval = 0.7 ns)
  Table III — RBL energy vs MAC count (fJ per 8-operand MAC evaluation)
  Table IV  — 1-bit logic energies (fJ)
  Fig 5     — timing: 7 ns cycle (142.85 MHz), 8 write cycles + precharge +
              0.7 ns evaluation window = 63 ns per complete operation
  Fig 6     — Monte-Carlo (k=8, 200 samples): mean 437 fJ, sigma 48.72 fJ

Physics-fit constants (two-regime discharge, fitted offline to Table I,
rmse 12.4 mV) let the model extrapolate to row counts != 8 (paper §III-F).
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- paper tables
ROWS = 8
COLS = 8
VDD = 1.8  # V supply / RBL pre-charge
C_RBL = 200e-15  # F, RBL load capacitance (paper §IV-A)

# Table I: RBL voltage (V) for MAC count k = 0..8.
V_RBL_TABLE = np.array(
    [1.758, 1.528, 1.308, 1.096, 0.895, 0.712, 0.552, 0.418, 0.310]
)

# Table III: RBL energy (fJ) for 8-operand MAC with count k = 0..8.
E_MAC_TABLE_FJ = np.array(
    [5.369, 119.3, 212.7, 288.5, 347.9, 391.6, 421.5, 440.7, 452.2]
)

# Table IV: 1-bit logic energies (fJ) == E(k) of the MAC count each op produces.
E_LOGIC_FJ = {"AND": 212.7, "CARRY": 212.7, "NOR": 5.369, "XOR": 119.3, "SUM": 119.3}

# Fig 5 timing model.
F_CLK_HZ = 142.85e6
T_CYCLE_S = 7e-9  # 1 / 142.85 MHz
T_EVAL_S = 0.7e-9  # RWL activation (evaluation) window
N_WRITE_CYCLES = 8  # operand-B load
N_PRE_EVAL_CYCLES = 1  # pre-charge + evaluate
T_OP_S = (N_WRITE_CYCLES + N_PRE_EVAL_CYCLES) * T_CYCLE_S  # 63 ns
THROUGHPUT_OPS = 1.0 / T_OP_S  # ~15.87 M ops/s (paper: 15.8)
ENERGY_PER_BIT_FJ = E_MAC_TABLE_FJ[-1] / 8.0  # 56.5 fJ/bit (paper: 56.56)

# Fig 6 Monte-Carlo statistics at k = 8.
MC_MEAN_FJ = 437.0
MC_STD_FJ = 48.72
MC_SAMPLES = 200

# ------------------------------------------------- physics fit (dev-calibrated)
# Two-regime discharge: per-active-cell linear drop U_LIN while V > VD_SAT
# (velocity-saturated read stack), exponential (triode / RC) below.
V0_LEAK = float(V_RBL_TABLE[0])  # 1.758 V: pre-charge minus leakage droop
U_LIN = 0.216845  # V of linear drop per active cell per 0.7 ns window
VD_SAT = 0.865014  # V, regime boundary

# Energy fit E(dV) = E0 + A*dV + B*dV^2 with dV = VDD - V_RBL (fJ; dev-fitted,
# max abs residual 0.31 fJ against Table III).
E_FIT_E0 = -16.744077
E_FIT_A = 540.201964
E_FIT_B = -151.403517

# Monte-Carlo mismatch calibration: E = E(0) + sum_i g_i * dE_i with
# dE_i = E(i) - E(i-1) (per-discharge-path charge increments) and
# g_i ~ N(MU_G, SIGMA_G). Closed form:
#   std  = SIGMA_G * sqrt(sum dE_i^2)          -> SIGMA_G from paper sigma
#   mean = E(0) + MU_G * sum dE_i              -> MU_G from paper mean
_DE = np.diff(E_MAC_TABLE_FJ)
MC_SIGMA_G = MC_STD_FJ / float(np.sqrt(np.sum(_DE**2)))
MC_MU_G = (MC_MEAN_FJ - float(E_MAC_TABLE_FJ[0])) / float(np.sum(_DE))

# Voltage-referred mismatch, expressed as count-equivalent noise per active
# path.  Distinct from the (much larger) energy-referred spread: the paper
# states level ordering and 100-250 mV spacing are preserved across mismatch
# and corners (§III-F, §IV-C), i.e. decode errors are rare.  0.05 counts/path
# ~= 10 mV at the 200 mV level spacing — consistent with that claim while
# still letting robustness studies flip marginal codes occasionally.
MC_SIGMA_VK = 0.05

# ------------------------------------------------------------- TPU v5e targets
TPU_PEAK_FLOPS_BF16 = 197e12  # per chip
TPU_HBM_BW = 819e9  # B/s per chip
TPU_ICI_BW = 50e9  # B/s per link
