"""The paper's macro model in the port (``repro_torch.core``: ``logic``,
``energy``, ``array``) against the JAX reference on the same numpy inputs.

Mirrors ``tests/test_core_paper.py`` (Tables I-IV, Fig 5, the array model)
and ``tests/test_logic_word.py`` (word logic, ripple-carry addition).  Every
comparison is bit-exact: the logic and the array are integer, the LUTs and
the energy fit are float32 computed op by op in the reference's order (the
fit goes through the physics voltage, whose exponential is ``exp_f32``, the
reference's own float32 ``exp``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import array as jarray
from repro.core import energy as jenergy
from repro.core import logic as jlogic
from repro.core.decoder import decode_voltage as j_decode_voltage
from repro.core.decoder import thermometer_code as j_thermometer_code
from repro.core.rbl import rbl_voltage as j_rbl_voltage
from repro_torch.core import array as tarray
from repro_torch.core import constants as C
from repro_torch.core import energy as tenergy
from repro_torch.core import logic as tlogic
from repro_torch.core.decoder import decode_voltage, thermometer_code
from repro_torch.core.rbl import rbl_voltage

CPU = "cpu"


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _same(port, ref):
    """Bit-exact: equal values and, for floats, equal float32 bits."""
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if np.issubdtype(r.dtype, np.floating):
        np.testing.assert_array_equal(p.astype(np.float32).view(np.int32),
                                      r.astype(np.float32).view(np.int32))
    else:
        np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64))


# ----------------------------------------------------------------- Table I
@pytest.mark.parametrize("mode,rows", [("lut", 8), ("physics", 8),
                                       ("physics", 16)])
def test_table1_voltages_codes_and_decode(mode, rows):
    ks = np.arange(rows + 1)
    v = rbl_voltage(torch.from_numpy(ks), rows=rows, mode=mode)
    jv = j_rbl_voltage(jnp.asarray(ks), rows=rows, mode=mode)
    _same(v, jv)
    assert np.all(np.diff(_np(v)) < 0)
    codes = thermometer_code(v, rows=rows, mode=mode)
    _same(codes, j_thermometer_code(jv, rows=rows, mode=mode))
    assert [int(c.sum()) for c in codes] == list(range(rows, -1, -1))
    _same(decode_voltage(v, rows=rows, mode=mode), ks)
    if mode == "lut":
        np.testing.assert_allclose(_np(v), C.V_RBL_TABLE, atol=1e-6)


# ---------------------------------------------------------------- Table II
def test_table2_logic_and_adder():
    counts = np.array([0, 1, 1, 2])
    out = tlogic.logic_from_count(torch.from_numpy(counts))
    ref = jlogic.logic_from_count(jnp.asarray(counts))
    assert set(out) == set(ref) == set(tlogic.OPS)
    for op in tlogic.OPS:
        assert out[op].dtype == torch.uint8
        _same(out[op], ref[op])
    np.testing.assert_array_equal(_np(out["XOR"]), [0, 1, 1, 0])
    for p, r in zip(tlogic.add_1bit(torch.from_numpy(counts)),
                    jlogic.add_1bit(jnp.asarray(counts))):
        _same(p, r)
    _same(tlogic.truth_table_counts(), jlogic.truth_table_counts())
    # m-operand evaluations read the same way
    many = np.arange(9)
    for op in tlogic.OPS:
        _same(tlogic.logic_from_count(torch.from_numpy(many), m=8)[op],
              jlogic.logic_from_count(jnp.asarray(many), m=8)[op])


# --------------------------------------------------------------- Table III
def test_table3_energy_lut_bit_exact():
    counts = np.concatenate([np.arange(9), [-1.0, 0.25, 2.5, 7.75, 9.0]])
    counts = counts.astype(np.float32)
    e = tenergy.mac_energy_fj(torch.from_numpy(counts))
    _same(e, jenergy.mac_energy_fj(jnp.asarray(counts)))
    np.testing.assert_allclose(_np(e)[:9], C.E_MAC_TABLE_FJ, atol=1e-4)
    assert np.all(np.diff(_np(e)[:9]) > 0)
    _same(tenergy.mac_energy_fj(torch.arange(9)),
          jenergy.mac_energy_fj(jnp.arange(9)))


def test_table3_energy_fit_bit_exact():
    counts = np.linspace(0, 8, 33).astype(np.float32)
    e = tenergy.mac_energy_fj(torch.from_numpy(counts), exact=False)
    _same(e, jenergy.mac_energy_fj(jnp.asarray(counts), exact=False))
    np.testing.assert_allclose(_np(e)[::4], C.E_MAC_TABLE_FJ, atol=12.0)
    v = np.linspace(0.3, 1.8, 17).astype(np.float32)
    _same(tenergy.energy_from_voltage_fj(torch.from_numpy(v)),
          jenergy.energy_from_voltage_fj(jnp.asarray(v)))


# ---------------------------------------------------------------- Table IV
def test_table4_logic_energies():
    for op in tlogic.OPS:
        assert tenergy.logic_energy_fj(op) == jenergy.logic_energy_fj(op)
        assert tenergy.logic_energy_fj(op.lower()) == \
            jenergy.logic_energy_fj(op)
    assert tenergy.logic_energy_fj("AND") == pytest.approx(212.7)
    assert abs(C.ENERGY_PER_BIT_FJ - 56.56) < 0.06


# -------------------------------------------------------------- Fig 5 timing
def test_fig5_timing_model():
    t, jt = tenergy.Timing(), jenergy.Timing()
    for f in ("t_op_s", "throughput_ops", "f_clk_hz", "t_eval_s",
              "t_cycle_s", "n_write_cycles", "n_pre_eval_cycles"):
        assert getattr(t, f) == getattr(jt, f), f
    assert t.t_op_s == pytest.approx(63e-9)
    assert t.throughput_ops == pytest.approx(15.87e6, rel=0.01)


@pytest.mark.parametrize("mkn,kw", [
    ((4, 768, 768), {}),
    ((64, 768, 3072), dict(schedule="cold")),
    ((7, 100, 37), dict(bits_a=4, bits_w=8, n_macros=16)),
    ((3, 160, 9), dict(rows=16, cols=4)),
    ((5, 64, 8), dict(mean_count=2.75)),
    ((1, 1, 1), dict(bits_a=2, bits_w=2, schedule="cold", mean_count=8.0))])
def test_fabric_matmul_cost_fields(mkn, kw):
    rep = tenergy.fabric_matmul_cost(*mkn, **kw)
    ref = jenergy.fabric_matmul_cost(*mkn, **kw)
    assert type(rep).__name__ == type(ref).__name__ == "FabricReport"
    assert list(rep.__dataclass_fields__) == list(ref.__dataclass_fields__)
    for f in ref.__dataclass_fields__:
        assert getattr(rep, f) == getattr(ref, f), f
    with pytest.raises(ValueError):
        tenergy.fabric_matmul_cost(*mkn, schedule="lazy")


# ------------------------------------------------------------- array behavior
def _load(rng):
    return rng.integers(0, 2, size=(8, 8)).astype(np.uint8)


def test_array_write_read_is_functional():
    rng = np.random.default_rng(0)
    bits = _load(rng)
    state = tarray.write(tarray.empty_state(device=CPU), bits)
    jstate = jarray.write(jarray.empty_state(), bits)
    _same(state, jstate)
    for r in range(8):
        _same(tarray.read_bit(state, r), jarray.read_bit(jstate, r))
    cleared = tarray.empty_state(device=CPU)
    before = cleared.clone()
    rows = [tarray.write_row(cleared, r, np.eye(8, dtype=np.uint8)[r])
            for r in range(8)]
    assert torch.equal(cleared, before), "write_row changed its argument"
    state = tarray.empty_state(device=CPU)
    for r in range(8):  # 8 write cycles, as in Fig 5
        state = tarray.write_row(state, r, np.eye(8, dtype=np.uint8)[r])
    _same(state, np.eye(8, dtype=np.uint8))
    assert rows[3][3, 3] == 1 and int(rows[3].sum()) == 1


@pytest.mark.parametrize("spec_kw", [{}, dict(mode="physics"),
                                     dict(mode="physics", rows=16)])
def test_array_mac_full_path(spec_kw):
    spec, jspec = tarray.ArraySpec(**spec_kw), jarray.ArraySpec(**spec_kw)
    rng = np.random.default_rng(3)
    for _ in range(10):
        b = rng.integers(0, 2, size=(spec.rows, 8)).astype(np.uint8)
        a = rng.integers(0, 2, size=spec.rows).astype(np.uint8)
        res = tarray.mac(tarray.write(tarray.empty_state(spec, CPU), b), a,
                         spec)
        ref = jarray.mac(jarray.write(jarray.empty_state(jspec), b), a, jspec)
        assert res._fields == ref._fields
        for p, r in zip(res, ref):
            _same(p, r)
        _same(res.counts, (a[None].astype(int) @ b)[0])
    full = tarray.write(tarray.empty_state(device=CPU), np.ones((8, 8)))
    res = tarray.mac(full, np.ones(8, np.uint8))
    np.testing.assert_allclose(_np(res.volts), np.full(8, 0.310), atol=1e-6)
    np.testing.assert_allclose(_np(res.energy_fj), np.full(8, 452.2),
                               atol=1e-3)


def test_array_mac_with_count_noise_handed_in():
    """The same mismatch values give the same decode (the reference draws
    them from a key, the port from a generator)."""
    rng = np.random.default_rng(4)
    b, a = _load(rng), rng.integers(0, 2, size=8).astype(np.uint8)
    k_noise = rng.normal(scale=0.6, size=8).astype(np.float32)
    res = tarray.mac(tarray.write(tarray.empty_state(device=CPU), b), a,
                     k_noise=torch.from_numpy(k_noise))
    ref = jarray.mac(jarray.write(jarray.empty_state(), b), a,
                     k_noise=jnp.asarray(k_noise))
    for p, r in zip(res, ref):
        _same(p, r)


def test_array_logic2_and_comparator_offsets():
    rng = np.random.default_rng(7)
    wa = rng.integers(0, 2, size=8).astype(np.uint8)
    wb = rng.integers(0, 2, size=8).astype(np.uint8)
    state = tarray.write_row(tarray.write_row(
        tarray.empty_state(device=CPU), 0, wa), 1, wb)
    jstate = jarray.write_row(jarray.write_row(jarray.empty_state(), 0, wa),
                              1, wb)
    out, res = tarray.logic2(state, 0, 1)
    jout, jres = jarray.logic2(jstate, 0, 1)
    for op in tlogic.OPS:
        _same(out[op], jout[op])
    for p, r in zip(res, jres):
        _same(p, r)
    np.testing.assert_array_equal(_np(out["XOR"]), wa ^ wb)
    # a 10 mV comparator offset never misdecodes (levels 100-250 mV apart)
    gen = torch.Generator().manual_seed(2)
    noisy, _ = tarray.logic2(state, 0, 1, comparator_offset_sigma=0.010,
                             generator=gen)
    for op in tlogic.OPS:
        _same(noisy[op], jout[op])
    with pytest.raises(ValueError, match="generator"):
        tarray.logic2(state, 0, 1, comparator_offset_sigma=0.010)


def test_array_spec_validation_and_device():
    with pytest.raises(ValueError):
        tarray.ArraySpec(rows=16, mode="lut")
    tarray.ArraySpec(rows=16, mode="physics")
    assert tarray.empty_state(device=CPU).shape == (8, 8)
    assert tarray.empty_state(tarray.ArraySpec(rows=16, cols=4,
                                               mode="physics"),
                              CPU).shape == (16, 4)


# ------------------------------------------------------------- word level
REF = {
    "AND": lambda a, b: a & b,
    "NAND": lambda a, b: ~(a & b),
    "OR": lambda a, b: a | b,
    "NOR": lambda a, b: ~(a | b),
    "XOR": lambda a, b: a ^ b,
    "XNOR": lambda a, b: ~(a ^ b),
}


def _words(bits, seed, shape=(5, 7)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << bits, size=shape).astype(np.int64)
            for _ in range(2)]


def test_pack_unpack_roundtrip_and_types():
    a, _ = _words(8, 0)
    planes = tlogic.unpack_word(torch.from_numpy(a), 8)
    assert planes.shape == a.shape + (8,) and planes.dtype == torch.uint8
    _same(planes, jlogic.unpack_word(jnp.asarray(a), 8))
    packed = tlogic.pack_word(planes)
    assert packed.dtype == torch.uint8
    _same(packed, a)
    w24, _ = _words(24, 1)
    p24 = tlogic.pack_word(tlogic.unpack_word(torch.from_numpy(w24), 24))
    assert p24.dtype == torch.int32
    _same(p24, w24)
    assert tlogic.word_dtype(32) == torch.int64


@pytest.mark.parametrize("bits", [4, 8, 12, 16, 24])
@pytest.mark.parametrize("op", tlogic.WORD_OPS)
def test_logic_word_matches_reference(op, bits):
    a, b = _words(bits, bits)
    got = tlogic.logic_word(torch.from_numpy(a), torch.from_numpy(b), op,
                            bits=bits)
    ref = jlogic.logic_word(jnp.asarray(a, jnp.int32),
                            jnp.asarray(b, jnp.int32), op, bits=bits)
    _same(got, ref)
    _same(got, REF[op](a, b) & ((1 << bits) - 1))


def test_logic_word_rejects_non_word_ops():
    a, b = _words(8, 0)
    with pytest.raises(ValueError):
        tlogic.logic_word(torch.from_numpy(a), torch.from_numpy(b), "SUM")


@pytest.mark.parametrize("bits", [4, 8, 12])
def test_add_nbit_matches_reference(bits):
    a, b = _words(bits, 10 + bits)
    s, c = tlogic.add_nbit(torch.from_numpy(a), torch.from_numpy(b),
                           bits=bits)
    js, jc = jlogic.add_nbit(jnp.asarray(a, jnp.int32),
                             jnp.asarray(b, jnp.int32), bits=bits)
    _same(s, js)
    _same(c, jc)
    assert c.dtype == torch.uint8
    ref = a + b
    _same(s, ref & ((1 << bits) - 1))
    _same(c, ref >> bits)


def test_word_ops_route_counts_through_decode():
    """``decode`` sees every column's count: a decode that reads every count
    as 2 turns AND into all ones, in the port as in the reference."""
    a, b = _words(8, 3)
    got = tlogic.logic_word(torch.from_numpy(a), torch.from_numpy(b), "AND",
                            decode=lambda c: torch.full_like(c, 2))
    ref = jlogic.logic_word(jnp.asarray(a, jnp.int32),
                            jnp.asarray(b, jnp.int32), "AND",
                            decode=lambda c: jnp.full_like(c, 2))
    _same(got, ref)
    _same(got, np.full(a.shape, 255))
