"""The port's core layer (``repro_torch.core``) against the JAX reference.

Integer paths are held bit for bit: constants, quantization (codes AND
scales, at 2..8 bits, as the reference's jitted model path computes them),
the offset-binary helpers, and the exact ``fabric_matmul`` including
asymmetric ``bits_a != bits_w``.  Inputs come from numpy with a fixed seed
and are handed to both packages.  Also here: the spec vocabulary, the
"not ported yet" guard for sim/noisy specs, and the rule that the port
imports neither ``jax`` nor ``repro``.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constants as jC
from repro.core import fabric as jfab
from repro.core import quant as jq
from repro_torch.convert import to_torch
from repro_torch.core import constants as tC
from repro_torch.core import fabric as tfab
from repro_torch.core import quant as tq


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_constants_equal_reference():
    names = [n for n in dir(jC) if n.isupper()]
    assert names and names == [n for n in dir(tC) if n.isupper()]
    for n in names:
        a, b = getattr(jC, n), getattr(tC, n)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=n)
        else:
            assert a == b, n


@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("case", ["bf16_tensor", "f32_column"])
def test_quantize_bit_exact(bits, case):
    rng = np.random.default_rng(bits)
    if case == "bf16_tensor":  # activations: per tensor, in bf16
        x = jnp.asarray(rng.standard_normal((3, 7, 64)) * 0.3, jnp.bfloat16)
        axis = None
    else:  # weights: per output column, in f32
        x = jnp.asarray(rng.standard_normal((64, 40)) * 0.05, jnp.float32)
        axis = 0
    ref = jax.jit(lambda v: jq.quantize(v, bits, axis=axis))(x)
    out = tq.quantize(to_torch(np.asarray(x)), bits, axis=axis)
    assert out.q.dtype == torch.int8 and out.scale.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ref.q), out.q.numpy())
    np.testing.assert_array_equal(np.asarray(ref.scale), out.scale.numpy())


def test_offset_binary_helpers_bit_exact():
    rng = np.random.default_rng(0)
    for ba, bw in ((8, 8), (4, 6), (2, 8)):
        qa = rng.integers(-(2 ** (ba - 1) - 1), 2 ** (ba - 1), (5, 24))
        qw = rng.integers(-(2 ** (bw - 1) - 1), 2 ** (bw - 1), (24, 9))
        ua_j = jq.to_offset_binary(jnp.asarray(qa, jnp.int8), ba)
        uw_j = jq.to_offset_binary(jnp.asarray(qw, jnp.int8), bw)
        ua_t = tq.to_offset_binary(torch.tensor(qa, dtype=torch.int8), ba)
        uw_t = tq.to_offset_binary(torch.tensor(qw, dtype=torch.int8), bw)
        np.testing.assert_array_equal(np.asarray(ua_j), ua_t.numpy())
        planes_j = jq.to_bitplanes(ua_j, ba)
        planes_t = tq.to_bitplanes(ua_t, ba)
        np.testing.assert_array_equal(np.asarray(planes_j), planes_t.numpy())
        np.testing.assert_array_equal(np.asarray(jq.from_bitplanes(planes_j)),
                                      tq.from_bitplanes(planes_t).numpy())
        corr_j = jq.signed_product_correction(ua_j, uw_j, ba, bw)
        corr_t = tq.signed_product_correction(ua_t, uw_t, ba, bw)
        np.testing.assert_array_equal(np.asarray(corr_j), corr_t.numpy())
        # the correction recovers the signed product from the unsigned one
        np.testing.assert_array_equal(
            (ua_t @ uw_t - corr_t).numpy(), qa @ qw)


@pytest.mark.parametrize("bits_a,bits_w", [(8, 8), (4, 4), (2, 2), (8, 3),
                                           (5, 8)])
def test_exact_fabric_matmul_bit_exact(bits_a, bits_w):
    rng = np.random.default_rng(bits_a * 10 + bits_w)
    x = jnp.asarray(rng.standard_normal((2, 5, 96)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((96, 40)) * 0.1, jnp.float32)
    ref = jfab.fabric_matmul(x, w, jfab.FabricSpec(bits_a=bits_a,
                                                   bits_w=bits_w))
    out = tfab.fabric_matmul(to_torch(np.asarray(x)), to_torch(np.asarray(w)),
                             tfab.FabricSpec(bits_a=bits_a, bits_w=bits_w))
    assert out.dtype == torch.float32 and out.shape == (2, 5, 40)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_spec_fields_validation_and_backends():
    spec = tfab.FabricSpec()
    assert [f for f in spec.__dataclass_fields__] == \
        [f for f in jfab.FabricSpec().__dataclass_fields__]
    for bad in (dict(mode="analog"), dict(backend="pallas"), dict(bits_a=9),
                dict(rows=1), dict(noise=tfab.NoiseSpec(mismatch_sigma=0.1))):
        with pytest.raises(ValueError):
            tfab.FabricSpec(**bad)
    with pytest.raises(ValueError):
        tfab.NoiseSpec(mismatch_sigma=-1.0)
    assert tfab.FabricSpec(mode="sim", noise=tfab.NoiseSpec()).noise is None
    assert tfab.NoiseSpec.calibrated().mismatch_sigma == jC.MC_SIGMA_VK
    cpu = torch.device("cpu")
    assert spec.resolve_backend(cpu) == "torch"
    assert spec.replace(backend="torch").resolve_backend(cpu) == "torch"
    assert spec.resolve_backend(torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="CUDA tensor"):
        spec.replace(backend="cuda").resolve_backend(cpu)
    with pytest.raises(ValueError, match="plain version"):
        spec.replace(backend="torch").resolve_backend(torch.device("cuda"))
    x = torch.zeros((2, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfab.fabric_matmul(x, torch.zeros((8, 4)), spec.replace(backend="cuda"))
    for unported in (tfab.FabricSpec(mode="sim"),
                     tfab.FabricSpec(mode="sim",
                                     noise=tfab.NoiseSpec.calibrated())):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            tfab.fabric_matmul(x, torch.zeros((8, 4)), unported)


def test_port_imports_neither_jax_nor_repro():
    """Import every module of the port in a fresh interpreter; neither
    ``jax`` nor the reference package may appear in ``sys.modules``."""
    code = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "repro" or k.startswith("repro."))
print(len(mods), bad)
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_mods = int(res.stdout.split()[0])
    assert n_mods >= 20, res.stdout
