"""The port's analog core (``repro_torch.core.rbl``, ``.decoder``,
``.bitserial``) and the noise-free ``sim`` fabric against the JAX reference.

Inputs come from numpy with a fixed seed and go into both packages.
Compared:

  * ``rbl_voltage`` (LUT and physics, rows 8 and 16, fractional k) within
    one float32 ulp (measured: 0, because the port evaluates exp as XLA's
    CPU backend does, see ``exp_f32``);
  * level voltages, ``thresholds``, ``thermometer_code`` and
    ``decode_voltage``: bit for bit;
  * group counts and both bit-serial engines (plane-batched and looped) at
    bits 2, 4, 6 and 8, asymmetric 4x8, ragged K and 16-row groups, in
    ``exact`` and noise-free ``sim``: bit for bit;
  * ``fabric_matmul`` in ``sim`` against the reference's ``sim``/``jnp``
    engine: bit for bit, and bit-identical to the port's own ``exact``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitserial as jb
from repro.core import decoder as jd
from repro.core import fabric as jfab
from repro.core import rbl as jr
from repro.core.quant import to_bitplanes as j_planes
from repro_torch.convert import to_torch
from repro_torch.core import bitserial as tb
from repro_torch.core import decoder as td
from repro_torch.core import fabric as tfab
from repro_torch.core import rbl as tr
from repro_torch.core.quant import to_bitplanes as t_planes

GEOMETRIES = [(8, "lut"), (8, "physics"), (16, "physics")]


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64)
                             - b.view(np.int32).astype(np.int64))))


@pytest.mark.parametrize("rows,mode", GEOMETRIES)
def test_rbl_voltage_within_one_ulp(rows, mode):
    rng = np.random.default_rng(rows)
    ks = np.concatenate([np.linspace(0, rows, 8 * rows + 1),
                         rng.uniform(-1, rows + 1, 500)]).astype(np.float32)
    ref = jr.rbl_voltage(jnp.asarray(ks), rows=rows, mode=mode)
    out = tr.rbl_voltage(torch.from_numpy(ks), rows=rows, mode=mode)
    assert out.dtype == torch.float32
    assert _ulps(ref, out.numpy()) <= 1


def test_rbl_lut_refuses_other_geometries():
    with pytest.raises(ValueError, match="physics"):
        tr.rbl_voltage(1.0, rows=16, mode="lut")
    with pytest.raises(ValueError):
        tr.rbl_voltage(1.0, mode="spice")


def test_exp_f32_is_the_reference_exp():
    x = np.random.default_rng(0).uniform(-30, 10, 200_000).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.exp(jnp.asarray(x))),
                                  tr.exp_f32(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("rows,mode", GEOMETRIES + [(5, "physics")])
def test_levels_and_thresholds_bit_exact(rows, mode):
    np.testing.assert_array_equal(
        np.asarray(jr.level_voltages(rows, mode=mode)),
        tr.level_voltages(rows, mode=mode).numpy())
    np.testing.assert_array_equal(np.asarray(jd.thresholds(rows, mode=mode)),
                                  td.thresholds(rows, mode=mode).numpy())


@pytest.mark.parametrize("rows,mode", GEOMETRIES)
def test_decode_voltage_bit_exact(rows, mode):
    rng = np.random.default_rng(10 + rows)
    v = rng.uniform(0.0, 1.9, (40, 9)).astype(np.float32)
    # the levels themselves decode to their counts
    levels = np.asarray(jr.level_voltages(rows, mode=mode))
    v = np.concatenate([v.reshape(-1), levels]).astype(np.float32)
    for jf, tf in ((jd.thermometer_code, td.thermometer_code),
                   (jd.decode_voltage, td.decode_voltage)):
        np.testing.assert_array_equal(
            np.asarray(jf(jnp.asarray(v), rows=rows, mode=mode)),
            tf(torch.from_numpy(v), rows=rows, mode=mode).numpy())
    dec = td.decode_voltage(torch.from_numpy(levels), rows=rows, mode=mode)
    assert dec.tolist() == list(range(rows + 1))
    with pytest.raises(ValueError, match="generator"):
        td.decode_voltage(torch.from_numpy(v), comparator_offset_sigma=0.01)


def _unsigned(bits_a, bits_w, m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << bits_a, (m, k)).astype(np.int32),
            rng.integers(0, 1 << bits_w, (k, n)).astype(np.int32))


@pytest.mark.parametrize("rows", [8, 16])
def test_group_counts_bit_exact(rows):
    ua, uw = _unsigned(4, 4, 3, 37, 6, seed=rows)
    ja, jw = j_planes(jnp.asarray(ua), 4), j_planes(jnp.asarray(uw), 4)
    ta, tw = t_planes(torch.from_numpy(ua), 4), t_planes(
        torch.from_numpy(uw), 4)
    np.testing.assert_array_equal(
        np.asarray(jb.group_counts(ja[1], jw[2], rows)),
        tb.group_counts(ta[1], tw[2], rows).numpy())
    np.testing.assert_array_equal(
        np.asarray(jb.batched_group_counts(ja, jw, rows)),
        tb.batched_group_counts(ta, tw, rows).numpy())
    np.testing.assert_array_equal(
        np.asarray(jb.fused_group_counts(ja, jw, rows)),
        tb.fused_group_counts(ta, tw, rows).numpy())
    assert tb.plane_pair_weights(3, 2).tolist() == \
        np.asarray(jb.plane_pair_weights(3, 2)).tolist()


ENGINE_CASES = [  # bits_a, bits_w, m, k, n, rows, rbl_mode
    (2, 2, 4, 16, 5, 8, "lut"), (4, 4, 5, 37, 9, 8, "lut"),
    (6, 6, 3, 21, 7, 8, "physics"), (8, 8, 5, 40, 6, 8, "lut"),
    (4, 8, 3, 29, 5, 8, "lut"), (8, 4, 2, 64, 3, 8, "physics"),
    (4, 4, 3, 45, 6, 16, "physics"), (8, 8, 2, 50, 4, 16, "physics")]


@pytest.mark.parametrize("mode", ["exact", "sim"])
@pytest.mark.parametrize("case", ENGINE_CASES,
                         ids=lambda c: "{}x{}-k{}-rows{}-{}".format(
                             c[0], c[1], c[3], c[5], c[6]))
def test_bitserial_engines_bit_exact(case, mode):
    bits_a, bits_w, m, k, n, rows, rbl_mode = case
    ua, uw = _unsigned(bits_a, bits_w, m, k, n, seed=bits_a * 10 + k)
    kw = dict(bits_a=bits_a, bits_w=bits_w, rows=rows, mode=mode)
    if mode == "sim":
        kw["rbl_mode"] = rbl_mode
    ja, jw = jnp.asarray(ua), jnp.asarray(uw)
    ta, tw = torch.from_numpy(ua), torch.from_numpy(uw)
    batched = tb.bitserial_matmul_unsigned(ta, tw, **kw)
    looped = tb.bitserial_matmul_looped(ta, tw, **kw)
    assert batched.dtype == torch.int32
    np.testing.assert_array_equal(
        np.asarray(jb.bitserial_matmul_unsigned(ja, jw, **kw)),
        batched.numpy())
    np.testing.assert_array_equal(
        np.asarray(jb.bitserial_matmul_looped(ja, jw, **kw)), looped.numpy())
    np.testing.assert_array_equal(batched.numpy(), ua @ uw)


def test_chunked_engine_is_bit_identical(monkeypatch):
    """The N-chunked engine gives the unchunked result at any chunk size."""
    ua, uw = _unsigned(8, 8, 5, 40, 33, seed=3)
    ta, tw = torch.from_numpy(ua), torch.from_numpy(uw)
    whole = tb.bitserial_matmul_unsigned(ta, tw, mode="sim")
    for chunk in (1, 500, 4000):
        monkeypatch.setattr(tb, "CHUNK_ELEMS", chunk)
        assert torch.equal(tb.bitserial_matmul_unsigned(ta, tw, mode="sim"),
                           whole)
    np.testing.assert_array_equal(whole.numpy(), ua @ uw)


def test_batch_dims_and_noise_not_ported():
    rng = np.random.default_rng(70)
    ua = rng.integers(0, 16, (2, 3, 40)).astype(np.int32)
    uw = rng.integers(0, 16, (40, 6)).astype(np.int32)
    out = tb.bitserial_matmul_unsigned(torch.from_numpy(ua),
                                       torch.from_numpy(uw), bits_a=4,
                                       bits_w=4, mode="sim")
    assert out.shape == (2, 3, 6)
    np.testing.assert_array_equal(out.numpy(), ua @ uw)
    for kw in (dict(mismatch=True), dict(mismatch_sigma=0.05),
               dict(comparator_offset_sigma=0.02)):
        with pytest.raises(ValueError, match="requires a seed"):
            tb.bitserial_matmul_unsigned(torch.from_numpy(ua),
                                         torch.from_numpy(uw), bits_a=4,
                                         bits_w=4, mode="sim", **kw)
        noisy = tb.bitserial_matmul_unsigned(
            torch.from_numpy(ua), torch.from_numpy(uw), bits_a=4, bits_w=4,
            mode="sim", seed=1, **kw)
        assert noisy.shape == (2, 3, 6)
    with pytest.raises(TypeError, match="unknown"):
        tb.bitserial_matmul_unsigned(torch.from_numpy(ua),
                                     torch.from_numpy(uw), mode="sim",
                                     key=0)


@pytest.mark.parametrize("bits_a,bits_w", [(8, 8), (4, 4), (2, 2), (4, 8),
                                           (8, 3)])
def test_sim_fabric_matmul_bit_exact(bits_a, bits_w):
    rng = np.random.default_rng(bits_a * 10 + bits_w)
    x = jnp.asarray(rng.standard_normal((2, 5, 96)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((96, 40)) * 0.1, jnp.float32)
    ref = jfab.fabric_matmul(x, w, jfab.FabricSpec(
        bits_a=bits_a, bits_w=bits_w, mode="sim", backend="jnp"))
    xt, wt = to_torch(np.asarray(x)), to_torch(np.asarray(w))
    spec = tfab.FabricSpec(bits_a=bits_a, bits_w=bits_w, mode="sim")
    out = tfab.fabric_matmul(xt, wt, spec)
    assert out.dtype == torch.float32 and out.shape == (2, 5, 40)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    exact = tfab.fabric_matmul(xt, wt, spec.replace(mode="exact"))
    assert torch.equal(out, exact)
    assert spec.label == "sim/torch"
