"""Read-bit-line (RBL) charge-sharing discharge model (port of
``repro/core/rbl.py``).

The paper's MAC primitive: k active cells (stored bit AND RWL both 1) each
open a discharge path from the pre-charged RBL.  After the 0.7 ns evaluation
window the RBL voltage is a monotone-decreasing function of k (Table I).

Two interchangeable models:
  * ``mode="lut"``     — exact Table I values (canonical, 8 rows only), with
                         piecewise-linear interpolation for fractional
                         "effective k".
  * ``mode="physics"`` — two-regime discharge fitted to Table I: a
                         constant-current drop of ``U_LIN`` volts per active
                         cell while V > VD_SAT, then exponential decay.
                         Extrapolates to any row count (paper §III-F).

Everything computes in float32, op by op in the reference's order, with the
Python constants rounded to float32 where they meet a tensor (as JAX's weak
typing rounds them).  The exponential is :func:`exp_f32`, the reference's own
float32 ``exp`` as XLA evaluates it on the CPU, so the physics levels and
thresholds match the reference bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import constants as C


# XLA's CPU float32 exp: Cephes' range reduction and degree-5 polynomial,
# every multiply-add fused.
_LOG2E = 1.44269504088896341
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` as a fused multiply-add computes it: the product
    of two float32 values is exact in float64, so only the sum rounds."""
    f32, f64 = torch.float32, torch.float64

    def wide(v):
        if isinstance(v, torch.Tensor):
            return v.to(f64)
        return float(torch.tensor(v, dtype=f32))  # the f32 constant, exactly

    return (wide(a) * wide(b) + wide(c)).to(f32)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp, bit for bit as the reference computes it on the CPU.

    XLA's CPU backend evaluates ``jnp.exp`` in float32 with Cephes'
    algorithm (n = round(x log2 e), a = x - n ln 2 in two parts, e^a by a
    polynomial, times 2^n), its multiply-adds fused.  ``torch.exp`` is
    correctly rounded more often, and differs from it in about one value in
    ten by one ulp.
    """
    x = torch.clamp(x.to(torch.float32), -88.8, 88.8)
    n = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    a = _fma(n, -_LN2_HI, x)
    a = _fma(n, -_LN2_LO, a)
    z = _fma(a, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = _fma(z, a, p)
    z = _fma(z, a * a, a)
    z = 1.0 + z
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return z * pow2


class ExpF32(torch.autograd.Function):
    """:func:`exp_f32` forward, d/dx e^x = e^x backward (``ExpF32.apply``);
    a float64 input (a float64 witness of the model) takes ``torch.exp``."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(x) if x.dtype == torch.float64 else exp_f32(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def _f32(k, device=None) -> torch.Tensor:
    return torch.as_tensor(k, dtype=torch.float32, device=device)


def rbl_voltage_physics(k, *, rows: int = C.ROWS,
                        t_eval: float = C.T_EVAL_S) -> torch.Tensor:
    """Two-regime discharge model.  ``k`` may be fractional.

    The per-cell linear drop scales as (8/rows) with the bit-line
    capacitance, and linearly with the evaluation window.
    """
    k = _f32(k)
    u = C.U_LIN * (C.ROWS / rows) * (t_eval / C.T_EVAL_S)
    x = k * u  # total discharge "budget" in volts
    lin = C.V0_LEAK - x
    x_tri = torch.clamp_min(x - (C.V0_LEAK - C.VD_SAT), 0.0)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the quotient's rounding
    tri = C.VD_SAT * exp_f32(-x_tri / _f32(C.VD_SAT, k.device))
    return torch.where(lin >= C.VD_SAT, lin, tri)


def rbl_voltage_lut(k) -> torch.Tensor:
    """Exact Table I voltages; piecewise-linear in fractional k, clipped to
    [0, 8]."""
    k = torch.clamp(_f32(k), 0.0, float(C.ROWS))
    lut = _f32(C.V_RBL_TABLE, k.device)
    lo = torch.clamp(torch.floor(k).to(torch.int64), 0, C.ROWS - 1)
    frac = k - lo.to(torch.float32)
    return lut[lo] * (1.0 - frac) + lut[lo + 1] * frac


def rbl_voltage(k, *, rows: int = C.ROWS, t_eval: float = C.T_EVAL_S,
                mode: str = "lut") -> torch.Tensor:
    """RBL voltage after evaluation for MAC count ``k`` (broadcasting)."""
    if mode == "lut":
        if rows != C.ROWS or t_eval != C.T_EVAL_S:
            raise ValueError("LUT mode is calibrated for 8 rows / 0.7 ns; "
                             "use mode='physics' for other geometries")
        return rbl_voltage_lut(k)
    if mode == "physics":
        return rbl_voltage_physics(k, rows=rows, t_eval=t_eval)
    raise ValueError(f"unknown rbl mode: {mode!r}")


def level_voltages(rows: int = C.ROWS, *, mode: str = "lut",
                   t_eval: float = C.T_EVAL_S, device=None) -> torch.Tensor:
    """Voltages for every possible count 0..rows (decoder calibration)."""
    ks = torch.arange(rows + 1, dtype=torch.float32, device=device)
    return rbl_voltage(ks, rows=rows, t_eval=t_eval, mode=mode)
