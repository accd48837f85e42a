"""The ``Fabric`` facade of the port (``repro_torch.core.fabric.Fabric``),
``imc_linear``'s straight-through backward, ``imc_matmul`` and the
quickstart, against the JAX reference on the same numpy inputs.

Noise-free, every face is bit-exact against ``repro.core.fabric.Fabric``:
``matmul``, ``logic``, ``logic_word``, ``add_nbit`` in ``exact`` and
``sim``, and ``linear``'s forward.  The STE gradients are float32 matmuls
summed in another order than XLA's: within 1e-5 relative.  Noisy logic draws
from ``torch.Generator``s where the reference folds ``jax.random`` keys, so
it is held statistically: the AND flip rate of 4,096 all-ones pairs at
mismatch sigma 0.5 lies within 5 binomial sigma of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfab
from repro.core import imc_linear as jlin
from repro.core.imc_matmul import imc_matmul as j_imc_matmul
from repro.core.imc_matmul import imc_matmul_cost as j_imc_matmul_cost
from repro.core.imc_matmul import int_matmul as j_int_matmul
from repro.core.imc_matmul import quantize_weight as j_quantize_weight
from repro_torch import quickstart
from repro_torch.core import fabric as tfab
from repro_torch.core import imc_linear as tlin
from repro_torch.core.imc_matmul import (imc_matmul, imc_matmul_cost,
                                         int_matmul, quantize_weight)
from repro_torch.core.logic import OPS, WORD_OPS

CPU = "cpu"
SPECS = [dict(mode="exact"), dict(mode="sim"),
         dict(mode="sim", bits_a=4, bits_w=8)]


def _pair(kw):
    return tfab.Fabric(tfab.FabricSpec(**kw), CPU), \
        jfab.Fabric(jfab.FabricSpec(**kw))


def _eq(port, ref):
    p = port.detach().cpu().numpy()
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if np.issubdtype(r.dtype, np.floating):
        np.testing.assert_array_equal(p.view(np.int32),
                                      r.astype(np.float32).view(np.int32))
    else:
        np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64))


@pytest.mark.parametrize("kw", SPECS)
def test_matmul_bit_exact(kw):
    fab, jf = _pair(kw)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 24)) * 0.1).astype(np.float32)
    _eq(fab.matmul(x, w), jf.matmul(jnp.asarray(x), jnp.asarray(w)))
    _eq(imc_matmul(torch.from_numpy(x), torch.from_numpy(w), fab.spec),
        j_imc_matmul(jnp.asarray(x), jnp.asarray(w), jf.spec))


@pytest.mark.parametrize("kw", SPECS[:2])
def test_logic_ops_bit_exact(kw):
    fab, jf = _pair(kw)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, size=(4, 9)).astype(np.uint8)
    b = rng.integers(0, 2, size=(4, 9)).astype(np.uint8)
    for op in OPS:
        got = fab.logic(a, b, op)
        assert got.dtype == torch.uint8
        _eq(got, jf.logic(a, b, op))
    with pytest.raises(ValueError, match="op must be"):
        fab.logic(a, b, "NOT")


@pytest.mark.parametrize("kw", SPECS[:2])
@pytest.mark.parametrize("bits", [8, 12])
def test_word_logic_and_adder_bit_exact(kw, bits):
    fab, jf = _pair(kw)
    rng = np.random.default_rng(bits)
    dt = np.uint8 if bits <= 8 else np.uint16
    a = rng.integers(0, 1 << bits, size=(5, 7)).astype(dt)
    b = rng.integers(0, 1 << bits, size=(5, 7)).astype(dt)
    for op in WORD_OPS:
        _eq(fab.logic_word(a, b, op, bits=bits),
            jf.logic_word(a, b, op, bits=bits))
    s, c = fab.add_nbit(a, b, bits=bits)
    js, jc = jf.add_nbit(a, b, bits=bits)
    _eq(s, js)
    _eq(c, jc)
    ref = a.astype(int) + b.astype(int)
    np.testing.assert_array_equal(s.numpy(), ref & ((1 << bits) - 1))
    np.testing.assert_array_equal(c.numpy(), ref >> bits)


def test_noisy_logic_flip_rate_seeds_and_missing_seed():
    fab = tfab.Fabric(tfab.FabricSpec(mode="sim", noise=tfab.NoiseSpec(
        mismatch_sigma=0.5)), CPU)
    jf = jfab.Fabric(jfab.FabricSpec(mode="sim", noise=jfab.NoiseSpec(
        mismatch_sigma=0.5)))
    n = 4096
    ones = np.ones(n, np.uint8)
    got = fab.logic(ones, ones, "AND", seed=3)
    ref = np.asarray(jf.logic(ones, ones, "AND", key=jax.random.key(3)))
    p_ref = 1.0 - ref.mean()
    p_port = 1.0 - got.numpy().mean()
    sigma = np.sqrt(p_ref * (1 - p_ref) / n)
    assert 0.2 < p_ref < 0.8, p_ref  # sigma 0.5 flips a real share
    assert abs(p_port - p_ref) <= 5 * sigma, (p_port, p_ref, sigma)
    assert torch.equal(got, fab.logic(ones, ones, "AND", seed=3))
    assert not torch.equal(got, fab.logic(ones, ones, "AND", seed=4))
    a = np.random.default_rng(2).integers(0, 256, size=(64,)).astype(np.uint8)
    w1 = fab.logic_word(a, a, "XOR", seed=5)
    assert torch.equal(w1, fab.logic_word(a, a, "XOR", seed=5))
    s1, c1 = fab.add_nbit(a, a, seed=5)
    s2, c2 = fab.add_nbit(a, a, seed=5)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)
    for call in (lambda: fab.logic(ones, ones, "AND"),
                 lambda: fab.logic_word(a, a, "XOR"),
                 lambda: fab.add_nbit(a, a),
                 lambda: fab.matmul(np.ones((2, 8), np.float32),
                                    np.ones((8, 4), np.float32))):
        with pytest.raises(ValueError, match="noisy: pass seed="):
            call()


def test_linear_forward_and_ste_gradients():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 48)).astype(np.float32)
    w = (rng.normal(size=(48, 16)) * 0.2).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    gy = rng.normal(size=(2, 3, 16)).astype(np.float32)
    for kw in SPECS[:2]:
        fab, jf = _pair(kw)
        tx, tw, tb = (torch.tensor(v, requires_grad=True) for v in (x, w, b))
        y = fab.linear({"w": tw, "b": tb}, tx)
        jy = jf.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                       jnp.asarray(x))
        _eq(y, jy)
        (y * torch.from_numpy(gy)).sum().backward()

        def loss(p, xx):
            return jnp.sum(jf.linear(p, xx) * gy)

        gp, gx = jax.grad(loss, argnums=(0, 1))(
            {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
        for t, r in ((tx, gx), (tw, gp["w"]), (tb, gp["b"])):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                       rtol=1e-5, atol=1e-5 * np.abs(
                                           np.asarray(r)).max())
        # STE: the gradients are the float matmul's
        tx2, tw2 = (torch.tensor(v, requires_grad=True) for v in (x, w))
        ((tx2 @ tw2) * torch.from_numpy(gy)).sum().backward()
        torch.testing.assert_close(tx.grad, tx2.grad, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(tw.grad, tw2.grad, rtol=1e-5, atol=1e-6)
    # no bias: the layer takes and returns no bias gradient
    tw = torch.tensor(w, requires_grad=True)
    y = tlin.imc_linear_apply(torch.from_numpy(x), tw)
    y.sum().backward()
    assert tw.grad.shape == w.shape


def test_init_and_apply_imc_linear():
    gen = torch.Generator().manual_seed(0)
    p = tlin.init_imc_linear(gen, 32, 12)
    assert set(p) == {"w"} and p["w"].shape == (32, 12)
    assert p["w"].dtype == torch.float32
    jp = jlin.init_imc_linear(jax.random.key(0), 32, 12, use_bias=True,
                              dtype=jnp.bfloat16)
    p = tlin.init_imc_linear(gen, 32, 12, use_bias=True,
                             dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert p["w"].dtype == torch.bfloat16 and bool((p["b"] == 0).all())
    # the default scale is 1/sqrt(d_in): a He-style spread
    big = tlin.init_imc_linear(gen, 400, 300)["w"]
    assert abs(float(big.std()) - 1 / 20) < 0.002
    x = np.random.default_rng(5).normal(size=(4, 32)).astype(np.float32)
    spec = tfab.FabricSpec(mode="sim")
    y = tlin.apply_imc_linear(p, torch.from_numpy(x).bfloat16(), spec=spec)
    jy = jlin.apply_imc_linear(
        {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) for k, v in
         p.items()}, jnp.asarray(x, jnp.bfloat16),
        spec=jfab.FabricSpec(mode="sim"))
    _eq(y, jy)


@pytest.mark.parametrize("kw", SPECS)
def test_cost_and_imc_matmul_cost(kw):
    fab, jf = _pair(kw)
    for xs, ws, extra in (((4, 768), (768, 3072), {}),
                          ((2, 3, 100), (100, 37),
                           dict(n_macros=8, schedule="cold"))):
        rep, ref = fab.cost(xs, ws, **extra), jf.cost(xs, ws, **extra)
        assert rep.__dict__ == ref.__dict__
        assert imc_matmul_cost(xs, ws, spec=fab.spec, **extra).__dict__ \
            == ref.__dict__
    assert imc_matmul_cost((4, 64), (64, 8), bits=4, rows=16).__dict__ \
        == j_imc_matmul_cost((4, 64), (64, 8), bits=4, rows=16).__dict__


def test_quantize_weight_and_int_matmul():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(40, 12)).astype(np.float32)
    q = quantize_weight(torch.from_numpy(w), bits=6)
    # the port mirrors quantize as XLA compiles it (its model path is
    # jitted): the scale is amax * f32(1/qmax), eager JAX divides by qmax
    jq = jax.jit(lambda v: j_quantize_weight(v, bits=6))(jnp.asarray(w))
    _eq(q.q, jq.q)
    _eq(q.scale, jq.scale)
    qa = rng.integers(-127, 128, size=(3, 40)).astype(np.int8)
    _eq(int_matmul(torch.from_numpy(qa), q.q),
        j_int_matmul(jnp.asarray(qa), jq.q))


def test_device_rule_and_engine_resolved_up_front(monkeypatch):
    """The facade and the quickstart run on the card unless the CPU is
    asked for; without a card they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfab.Fabric(tfab.FabricSpec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfab.Fabric(tfab.FabricSpec(backend="cuda"), CPU)
    fab = tfab.Fabric(tfab.FabricSpec(mode="sim"), CPU)
    assert fab.device == torch.device("cpu") and "sim" in repr(fab)


def test_quickstart_runs_on_the_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "quickstart OK" in out and "sim/torch+noise" in out
