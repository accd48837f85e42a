"""The ``rbl_decode_mac`` kernel module (``repro_torch.kernels.rbl_decode``).

On the CPU the wrapper runs the plain version, which must equal the JAX
reference bit for bit: the Pallas kernel in interpret mode and its oracle
``rbl_decode_mac_ref`` (``rbl_voltage(mode="physics")`` ->
``decode_voltage``), at the shapes of ``tests/test_kernels.py`` and rows 16.
Under the calibrated thresholds it equals the integer product; under a
detuned ``thr`` it differs from the reference by exactly the padded groups
that the reference decodes and the port does not.  The CUDA kernel runs only
on a card; its tests are in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decoder import thresholds as j_thresholds
from repro.kernels.rbl_decode.ops import rbl_decode_mac as pallas_rbl_decode
from repro.kernels.rbl_decode.ref import rbl_decode_mac_ref
from repro_torch.kernels.bitplane_mac.ops import (decode_counts,
                                                  physics_thresholds)
from repro_torch.kernels.rbl_decode.ops import (rbl_decode_mac,
                                                rbl_decode_mac_torch)

REF_BK = 256  # the reference wrapper's K tile: it pads K to a multiple


def _bits(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, size=(m, k)).astype(np.int8),
            rng.integers(0, 2, size=(k, n)).astype(np.int8))


@pytest.mark.parametrize("m,k,n,rows", [(16, 64, 8, 8), (50, 70, 30, 8),
                                        (128, 256, 128, 8),
                                        (24, 160, 8, 16)])
def test_plain_matches_reference(m, k, n, rows):
    a, w = _bits(m, k, n, m + k + n)
    ref = np.asarray(pallas_rbl_decode(jnp.asarray(a), jnp.asarray(w),
                                       rows=rows, interpret=True))
    oracle = np.asarray(rbl_decode_mac_ref(jnp.asarray(a), jnp.asarray(w),
                                           rows=rows, mode="physics"))
    before = rbl_decode_mac.launches
    out = rbl_decode_mac(torch.from_numpy(a), torch.from_numpy(w), rows=rows)
    assert rbl_decode_mac.launches == before, "a CPU tensor launches nothing"
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), oracle)
    # calibrated: every count decodes to itself
    np.testing.assert_array_equal(out.numpy(),
                                  a.astype(np.int32) @ w.astype(np.int32))


@pytest.mark.parametrize("m,k,n,rows", [(16, 64, 8, 8), (5, 20, 7, 8),
                                        (6, 50, 9, 16)])
def test_detuned_thresholds_pin_padded_groups(m, k, n, rows):
    """``[1.9, thr[:-1]]`` reads every count one level high, and dec(0) =
    1.  The reference decodes the groups of its K padding to 256 as well:
    it exceeds the port by (ceil(K/256)*256 - ceil(K/rows)*rows)/rows x
    dec(0) in every element."""
    a, w = _bits(m, k, n, 7 + k)
    good = np.asarray(j_thresholds(rows, mode="physics"))
    detuned = np.concatenate([[1.9], good[:-1]]).astype(np.float32)
    ref = np.asarray(pallas_rbl_decode(jnp.asarray(a), jnp.asarray(w),
                                       jnp.asarray(detuned), rows=rows,
                                       interpret=True))
    out = rbl_decode_mac(torch.from_numpy(a), torch.from_numpy(w),
                         torch.from_numpy(detuned), rows=rows).numpy()
    dec0 = int(decode_counts(torch.zeros(()), torch.from_numpy(detuned),
                             rows))
    assert dec0 == 1
    padded = (-(-k // REF_BK) * REF_BK - (-(-k // rows)) * rows) // rows
    np.testing.assert_array_equal(ref - out, np.full((m, n), padded * dec0))
    calibrated = rbl_decode_mac(torch.from_numpy(a), torch.from_numpy(w),
                                rows=rows).numpy()
    assert np.all(out != calibrated), "the detuned decode must differ"
    # the port's own oracle: decode of the real groups only
    real = -(-k // rows)
    counts = np.zeros((m, real, n), np.int64)
    ap = np.pad(a, ((0, 0), (0, real * rows - k)))
    wp = np.pad(w, ((0, real * rows - k), (0, 0)))
    for g in range(real):
        sl = slice(g * rows, (g + 1) * rows)
        counts[:, g] = ap[:, sl].astype(np.int64) @ wp[sl].astype(np.int64)
    dec = decode_counts(torch.from_numpy(counts), torch.from_numpy(detuned),
                        rows).numpy()
    np.testing.assert_array_equal(out, dec.sum(1))


def test_wrapper_batch_dims_and_default_thresholds():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 2, size=(2, 3, 40)).astype(np.uint8))
    w = torch.from_numpy(rng.integers(0, 2, size=(40, 6)).astype(np.uint8))
    out = rbl_decode_mac(a, w)
    assert out.shape == (2, 3, 6)
    assert torch.equal(out, rbl_decode_mac(a, w, physics_thresholds(8, "cpu")))
    assert torch.equal(out.reshape(6, 6),
                       a.reshape(6, 40).int() @ w.int())


def test_wrapper_rejects_bad_operands():
    a = torch.ones((4, 16), dtype=torch.int8)
    w = torch.ones((16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="do not contract"):
        rbl_decode_mac(a, w[:8])
    with pytest.raises(ValueError, match="rows"):
        rbl_decode_mac(a, w, rows=64)
    with pytest.raises(ValueError, match="float32"):
        rbl_decode_mac(a, w, physics_thresholds(8, "cpu").double())
    with pytest.raises(ValueError, match="float32"):
        rbl_decode_mac(a, w, physics_thresholds(16, "cpu"))
    with pytest.raises(ValueError, match="0, 1"):
        rbl_decode_mac(a * 2, w)
    with pytest.raises(ValueError, match="0, 1"):
        rbl_decode_mac_torch(a, -w)
