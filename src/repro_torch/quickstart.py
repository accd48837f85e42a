"""Quickstart: the paper's 8x8 8T SRAM IMC array, end to end, in the
PyTorch port (port of ``examples/quickstart.py``).

Walks the full Fig-5 pipeline — operand load (8 write cycles), pre-charge,
multi-row evaluation, comparator decode — then derives every logic function
of Table II from single MAC evaluations, and finishes with the production
entry point: ONE typed :class:`FabricSpec` per fabric configuration, driven
through the :class:`Fabric` facade (exact digital-equivalent, ``sim``,
seeded noisy ``sim`` and 4x8-bit precision side by side).

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (ArraySpec, Fabric, FabricSpec, NoiseSpec,
                              Timing, empty_state, logic2, mac, mac_energy_fj,
                              write_row)
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    spec = ArraySpec()  # 8x8, Table-I calibrated
    print(f"device: {dev}")

    # ---- 1. store operand B (one row per 7 ns write cycle, Fig 5) ---------
    print("== MAC: A . B over 8 rows of one column ==")
    rng = np.random.default_rng(0)
    b_bits = rng.integers(0, 2, size=(8, 8)).astype(np.uint8)
    state = empty_state(spec, dev)
    for r in range(8):
        state = write_row(state, r, b_bits[r])

    # ---- 2. pre-charge + assert RWLs with operand A (0.7 ns window) -------
    a_bits = rng.integers(0, 2, size=8).astype(np.uint8)
    res = mac(state, a_bits, spec)
    expected = a_bits.astype(int) @ b_bits
    counts, volts = res.counts.cpu(), res.volts.cpu()
    codes, energy = res.codes.cpu(), res.energy_fj.cpu()
    for col in range(8):
        code = "".join(str(int(b)) for b in codes[col])
        print(f" col{col}: count={int(counts[col])} (true {expected[col]}) "
              f"V_RBL={float(volts[col]):.3f}V code={code} "
              f"E={float(energy[col]):.1f}fJ")
    assert np.array_equal(counts.numpy(), expected)

    t = Timing()
    print(f" timing: op={t.t_op_s * 1e9:.0f}ns (9 x 7ns cycles) "
          f"eval={t.t_eval_s * 1e9:.1f}ns "
          f"throughput={t.throughput_ops / 1e6:.1f}Mops/s")

    # ---- 3. MAC-derived logic (Table II): 8-bit bitwise ops, one evaluation
    print("\n== MAC-derived logic: 8-bit bitwise ops from ONE evaluation ==")
    wa = rng.integers(0, 2, size=8).astype(np.uint8)
    wb = rng.integers(0, 2, size=8).astype(np.uint8)
    state = write_row(write_row(empty_state(spec, dev), 0, wa), 1, wb)
    out, _ = logic2(state, 0, 1, spec)
    print(f" A     = {wa}\n B     = {wb}")
    for op in ("AND", "NAND", "OR", "NOR", "XOR", "XNOR", "SUM", "CARRY"):
        print(f" {op:5s} = {out[op].cpu().numpy()}")
    assert np.array_equal(out["AND"].cpu().numpy(), wa & wb)
    assert np.array_equal(out["XOR"].cpu().numpy(), wa ^ wb)

    # ---- 4. N-bit MAC through the Fabric facade: one spec per configuration
    print("\n== FabricSpec: exact / sim / noisy sim / 4x8-bit, side by side ==")
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)).to(dev)
    ref = x @ w
    specs = [
        # digital equivalent: int8 GEMM (the imc_mac kernel on the card)
        FabricSpec(mode="exact"),
        # hardware-faithful sim: the bit-plane pyramid with the analog
        # decode (the bitplane_mac kernel on the card)
        FabricSpec(mode="sim"),
        # seeded analog non-idealities: device mismatch at the calibrated
        # sigma (bitplane_mac_noisy on the card, the bit-serial engine with
        # the Table I decode on the CPU)
        FabricSpec(mode="sim", noise=NoiseSpec.calibrated()),
        # reconfigurable precision: 4-bit activations x 8-bit weights
        FabricSpec(bits_a=4, bits_w=8, mode="sim"),
    ]
    for s in specs:
        fab = Fabric(s, dev)
        y = fab.matmul(x, w, seed=0 if s.noisy else None)
        rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
        print(f" {s.label:16s} ({s.bits_a}x{s.bits_w}b) rel err {rel:.4f}")

    # the same spec prices the op on the modeled hardware...
    rep = Fabric(specs[0], dev).cost(tuple(x.shape), tuple(w.shape))
    print(f" cost[{specs[0].label}]: {rep.evaluations} evaluations, "
          f"E={rep.energy_j * 1e12:.2f}pJ, {rep.tops_per_w:.2f} TOPS/W-1b")
    # ...and drives the MAC-derived logic of section 3 (exact == analog)
    fab_sim = Fabric(FabricSpec(mode="sim"), dev)
    xor = fab_sim.logic(wa, wb, "XOR").cpu().numpy()
    assert np.array_equal(xor, wa ^ wb)
    print(f" fabric logic XOR through the analog decode: {xor}")
    # word level: packed uint8 operands, 8 columns per MAC activation (§III)
    pa, pb = np.uint8(0xC5), np.uint8(0x3A)
    nand = int(fab_sim.logic_word(pa, pb, "NAND"))
    tot, carry = fab_sim.add_nbit(pa, pb)
    assert nand == (~(pa & pb)) & 0xFF
    assert int(tot) == (int(pa) + int(pb)) & 0xFF
    print(f" word logic: 0x{pa:02X} NAND 0x{pb:02X} = 0x{nand:02X}; "
          f"ripple-carry add -> 0x{int(tot):02X} carry {int(carry)}")
    print(f" energy model: count=8 eval costs "
          f"{float(mac_energy_fj(8)):.1f} fJ (paper Table III: 452.2 fJ)")
    print("\nquickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
