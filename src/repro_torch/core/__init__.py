"""Core library: the paper's 8T SRAM IMC architecture in PyTorch (port of
``repro/core``), with the reference's exports under the same names.

Layers (bottom-up):
  constants   — paper tables + calibrated fit constants
  rbl         — charge-sharing RBL discharge model (LUT + physics fit)
  decoder     — comparator bank / thermometer decode
  logic       — MAC-derived AND/NAND, OR/NOR, XOR/XNOR, 1-bit and n-bit ADD
  array       — behavioral RxC macro (write/read/mac/logic2)
  energy      — energy/latency/throughput + fabric projection model
  montecarlo  — device-mismatch MC (Fig 6)
  quant       — int8 symmetric quant + offset-binary bit-planes
  bitserial   — grouped bit-plane MAC with analog decode in the loop
  fabric      — FabricSpec/NoiseSpec + Fabric facade + engine registry
  imc_matmul  — spec-typed entry point over fabric_matmul (+ cost sweeps)
  imc_linear  — Linear on the IMC fabric (STE backward)
"""
from repro_torch.core import constants
from repro_torch.core.array import (ArraySpec, MacResult, empty_state, logic2,
                                    mac, read_bit, write, write_row)
from repro_torch.core.decoder import (code_to_count, decode_voltage,
                                      thermometer_code, thresholds)
from repro_torch.core.energy import (FabricReport, Timing, fabric_matmul_cost,
                                     logic_energy_fj, mac_energy_fj)
from repro_torch.core.fabric import (Fabric, FabricSpec, NoiseSpec,
                                     fabric_matmul)
from repro_torch.core.imc_linear import (apply_imc_linear, imc_linear_apply,
                                         init_imc_linear)
from repro_torch.core.imc_matmul import imc_matmul, imc_matmul_cost
from repro_torch.core.logic import add_1bit, logic_from_count
from repro_torch.core.montecarlo import mc_energy_fj, mc_stats
from repro_torch.core.rbl import level_voltages, rbl_voltage

__all__ = [
    "constants", "ArraySpec", "MacResult", "empty_state", "write", "write_row",
    "read_bit", "mac", "logic2", "thresholds", "thermometer_code",
    "code_to_count", "decode_voltage", "logic_from_count", "add_1bit",
    "mac_energy_fj", "logic_energy_fj", "Timing", "fabric_matmul_cost",
    "mc_energy_fj", "mc_stats", "rbl_voltage", "level_voltages",
    "Fabric", "FabricSpec", "NoiseSpec", "FabricReport", "fabric_matmul",
    "imc_matmul", "imc_matmul_cost", "init_imc_linear", "apply_imc_linear",
    "imc_linear_apply",
]
