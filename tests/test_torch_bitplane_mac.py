"""The ``bitplane_mac`` module (``repro_torch.kernels.bitplane_mac``) against
the JAX reference, on the CPU.

The CUDA kernel runs on the card only (``tests/test_torch_cuda.py``); here
its plain version ``bitplane_mac_torch`` — what the public ``bitplane_mac``
runs for CPU tensors — is held bit for bit against:

  * both JAX oracles, ``bitplane_mac_ref`` (per-plane-pair loop) and
    ``bitplane_mac_batched_ref`` (plane-batched), on the shapes of
    ``tests/test_bitplane_mac.py`` and a multi-block ragged one;
  * the JAX Pallas kernel itself, run as its own tests run it
    (``interpret=True``), at 2x2 bits with calibrated and detuned comparator
    references.

The detuned references (``[1.9, thr[:-1]]``) make a zero count decode to 1.
The reference's noise-free kernel pads K to its tile ``bk`` and decodes the
padded groups; the port decodes only the real ``ceil(K/rows)`` groups (a
zero-padded partial last group included).  So at K a multiple of ``bk`` the
two agree bit for bit, and at K = 20 the reference exceeds the port by
exactly (bk/8 - 3) padded groups x dec[0] x sum_{p,q} 2^(p+q) = 9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decoder import thresholds as j_thresholds
from repro.kernels.bitplane_mac.ops import _resolve_geometry
from repro.kernels.bitplane_mac.ops import bitplane_mac as j_bitplane_mac
from repro.kernels.bitplane_mac.ref import (bitplane_mac_batched_ref,
                                            bitplane_mac_ref)
from repro_torch.core.rbl import rbl_voltage_physics
from repro_torch.kernels.bitplane_mac.ops import (bitplane_mac,
                                                  bitplane_mac_torch,
                                                  decode_counts,
                                                  physics_thresholds)


def _unsigned(bits, m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << bits, (m, k)).astype(np.int32),
            rng.integers(0, 1 << bits, (k, n)).astype(np.int32))


def _thr(detuned: bool):
    good = np.asarray(j_thresholds(8, mode="physics"))
    if detuned:  # every reference shifted up one level (paper §IV-C)
        return np.concatenate([[1.9], good[:-1]]).astype(np.float32)
    return good


@pytest.mark.parametrize("bits,m,k,n", [(4, 8, 16, 8), (8, 16, 24, 8),
                                        (6, 5, 40, 12), (4, 140, 300, 135)])
def test_plain_matches_both_refs(bits, m, k, n):
    ua, uw = _unsigned(bits, m, k, n, seed=bits * 1000 + m)
    out = bitplane_mac_torch(torch.from_numpy(ua), torch.from_numpy(uw),
                             bits_a=bits, bits_w=bits)
    assert out.dtype == torch.int32
    for ref in (bitplane_mac_ref, bitplane_mac_batched_ref):
        np.testing.assert_array_equal(
            np.asarray(ref(jnp.asarray(ua), jnp.asarray(uw), bits_a=bits,
                           bits_w=bits)), out.numpy())
    np.testing.assert_array_equal(out.numpy(), ua @ uw)


@pytest.mark.parametrize("bits_a,bits_w,rows", [(4, 8, 8), (3, 5, 16)])
def test_plain_matches_refs_asymmetric_and_rows16(bits_a, bits_w, rows):
    rng = np.random.default_rng(rows)
    ua = rng.integers(0, 1 << bits_a, (5, 45)).astype(np.int32)
    uw = rng.integers(0, 1 << bits_w, (45, 7)).astype(np.int32)
    out = bitplane_mac_torch(torch.from_numpy(ua), torch.from_numpy(uw),
                             bits_a=bits_a, bits_w=bits_w, rows=rows)
    for ref in (bitplane_mac_ref, bitplane_mac_batched_ref):
        np.testing.assert_array_equal(
            np.asarray(ref(jnp.asarray(ua), jnp.asarray(uw), bits_a=bits_a,
                           bits_w=bits_w, rows=rows)), out.numpy())


def test_batch_dims_and_cpu_dispatch():
    rng = np.random.default_rng(70)
    ua = rng.integers(0, 16, (2, 3, 40)).astype(np.int32)
    uw = rng.integers(0, 16, (40, 6)).astype(np.int32)
    before = bitplane_mac.launches
    out = bitplane_mac(torch.from_numpy(ua), torch.from_numpy(uw), bits_a=4,
                       bits_w=4)
    assert bitplane_mac.launches == before, "a CPU tensor launches nothing"
    assert out.shape == (2, 3, 6)
    np.testing.assert_array_equal(out.numpy().reshape(6, 6),
                                  ua.reshape(6, 40) @ uw)


def test_default_thresholds_and_decode_table():
    np.testing.assert_array_equal(physics_thresholds(16, "cpu").numpy(),
                                  np.asarray(j_thresholds(16,
                                                          mode="physics")))
    counts = torch.arange(9, dtype=torch.float32)
    thr = physics_thresholds(8, "cpu")
    assert decode_counts(counts, thr, 8).tolist() == list(range(9))
    detuned = torch.from_numpy(_thr(True))
    assert decode_counts(counts, detuned, 8).tolist() == \
        list(range(1, 9)) + [8], "a detuned bank decodes k as k + 1"


@pytest.mark.parametrize("detuned", [False, True],
                         ids=["calibrated", "detuned"])
def test_matches_interpreted_kernel_without_padded_groups(detuned):
    """K = 256 is a multiple of the kernel's tile, so no padded groups."""
    ua, uw = _unsigned(2, 8, 256, 8, seed=11)
    thr = _thr(detuned)
    bk = _resolve_geometry(8, 256, 8, 2, 2, None, None, None, True)["bk"]
    assert 256 % bk == 0
    ref = j_bitplane_mac(jnp.asarray(ua), jnp.asarray(uw), jnp.asarray(thr),
                         bits_a=2, bits_w=2, interpret=True)
    out = bitplane_mac_torch(torch.from_numpy(ua), torch.from_numpy(uw),
                             torch.from_numpy(thr), bits_a=2, bits_w=2)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    if detuned:
        assert not np.array_equal(out.numpy(), ua @ uw)
    else:
        np.testing.assert_array_equal(out.numpy(), ua @ uw)


def test_matches_interpreted_kernel_at_ragged_k():
    """K = 20: calibrated, both agree; detuned, the reference decodes its
    (bk/8 - 3) zero-padded groups as dec[0] = 1 each, the port does not."""
    ua, uw = _unsigned(2, 8, 20, 8, seed=12)
    outs = {}
    for detuned in (False, True):
        thr = _thr(detuned)
        ref = np.asarray(j_bitplane_mac(jnp.asarray(ua), jnp.asarray(uw),
                                        jnp.asarray(thr), bits_a=2, bits_w=2,
                                        interpret=True))
        out = bitplane_mac_torch(torch.from_numpy(ua), torch.from_numpy(uw),
                                 torch.from_numpy(thr), bits_a=2,
                                 bits_w=2).numpy()
        outs[detuned] = out
        if not detuned:
            np.testing.assert_array_equal(ref, out)
            continue
        bk = _resolve_geometry(8, 20, 8, 2, 2, None, None, None, True)["bk"]
        dec0 = int((torch.from_numpy(thr) >= rbl_voltage_physics(
            0.0, rows=8)).sum())
        assert dec0 == 1
        pair_weights = sum(1 << (p + q) for p in range(2) for q in range(2))
        np.testing.assert_array_equal(
            ref - out, np.full((8, 8), (bk // 8 - 3) * dec0 * pair_weights))
    assert not np.array_equal(outs[True], outs[False])
