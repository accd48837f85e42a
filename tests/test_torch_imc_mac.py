"""The ``imc_mac`` kernel module (``repro_torch.kernels.imc_mac``).

On the CPU the wrapper runs the plain version, which must equal the JAX
reference bit for bit (integer accumulation is exact): against
``imc_mac_ref`` at model-like and ragged shapes, and against the Pallas
kernel in interpret mode on tiny shapes, including the deep-K int32 case of
``tests/test_kernels.py``.  The CUDA kernel itself runs only on a card; its
tests are in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.imc_mac.ops import imc_mac as pallas_imc_mac
from repro.kernels.imc_mac.ref import imc_mac_ref
from repro_torch.kernels.imc_mac.ops import imc_mac, imc_mac_torch


def _ints(rng, shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("m,k,n", [(4, 768, 768), (16, 768, 3072),
                                   (4, 3072, 768), (7, 100, 37), (1, 5, 3)])
def test_plain_matches_reference(m, k, n):
    rng = np.random.default_rng(m + k + n)
    qa, qw = _ints(rng, (m, k)), _ints(rng, (k, n))
    ref = np.asarray(imc_mac_ref(jnp.asarray(qa), jnp.asarray(qw)))
    out = imc_mac_torch(torch.from_numpy(qa), torch.from_numpy(qw))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(ref, out.numpy())


@pytest.mark.parametrize("shape_a,n", [((2, 3, 40), 24), ((9, 130), 7)])
def test_wrapper_on_cpu_matches_pallas_interpret(shape_a, n):
    """Batch dims flatten into M; ragged shapes need no padding."""
    rng = np.random.default_rng(1)
    qa, qw = _ints(rng, shape_a), _ints(rng, (shape_a[-1], n))
    ref = np.asarray(pallas_imc_mac(jnp.asarray(qa), jnp.asarray(qw),
                                    interpret=True))
    before = imc_mac.launches
    out = imc_mac(torch.from_numpy(qa), torch.from_numpy(qw))
    assert imc_mac.launches == before, "a CPU tensor launches no kernel"
    assert out.shape == shape_a[:-1] + (n,)
    np.testing.assert_array_equal(ref, out.numpy())


def test_int32_accumulation_no_overflow():
    # |acc| = 127*127*2048 ~ 3.3e7 < 2^31, as in tests/test_kernels.py
    qa = np.full((8, 2048), 127, np.int8)
    qw = np.full((2048, 8), -127, np.int8)
    ref = np.asarray(pallas_imc_mac(jnp.asarray(qa), jnp.asarray(qw),
                                    interpret=True))
    out = imc_mac(torch.from_numpy(qa), torch.from_numpy(qw)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, np.full((8, 8), -127 * 127 * 2048))


def test_wrapper_rejects_bad_operands():
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="contract"):
        imc_mac(a, torch.zeros((9, 4), dtype=torch.int8))
