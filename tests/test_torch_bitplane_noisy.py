"""The noisy ``bitplane_mac`` module (``repro_torch.kernels.bitplane_mac``:
``bitplane_mac_noisy`` and its plain version ``bitplane_mac_noisy_torch``)
against the JAX reference, on the CPU.

The CUDA kernel runs on the card only (``tests/test_torch_cuda.py`` holds it
bit for bit against the plain version there); here the plain version — what
``bitplane_mac_noisy`` runs for CPU tensors — is held against the
reference's noisy Pallas kernel, run as its own tests run it (interpret
mode).  The two draw from different streams (the reference's is keyed by
its TPU grid steps), so the comparison is statistical, with the criteria of
``tests/test_bitplane_noise.py`` at its stress sigmas (mismatch 0.3,
comparator offset 0.03): over 2,048 iid trials the deviation from the exact
product has its mean within 0.15 s, its std ratio in (0.85, 1.15) and its
10/25/50/75/90th percentiles within 0.15 s; under detuned thresholds the
error rate lies within 0.03 of the reference kernel's and of an
independent numpy Monte-Carlo of the same noise model.

Exact properties are asserted exactly: the same seed gives the same output,
two seeds differ, sigma 0 equals the noise-free ``bitplane_mac``, the
stream does not depend on how N is chunked (as the kernel's draws do not
depend on its tiles or split-K), padded K-groups draw no noise, and plane
pairs, K-groups and rows draw independent noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decoder import thresholds as j_thresholds
from repro.core.rbl import rbl_voltage as j_rbl_voltage
from repro.kernels.bitplane_mac.ops import \
    bitplane_mac_noisy as j_bitplane_mac_noisy
from repro_torch.core import bitserial
from repro_torch.kernels import build
from repro_torch.kernels.bitplane_mac.ops import (bitplane_mac,
                                                  bitplane_mac_noisy,
                                                  bitplane_mac_noisy_torch,
                                                  physics_thresholds)

SIGMAS = dict(mismatch_sigma=0.3, comparator_offset_sigma=0.03)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small tensor ops; beside the suite's other
    parallel workers, PyTorch's intra-op thread pool oversubscribes the
    cores and each op waits on its threads.  One thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trials(bits=4, m=256, k=64, n=8, seed=0):
    """Replicated-row operands: every output row is an iid noise trial."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 1 << bits, size=(1, k)).astype(np.int32)
    ua = np.repeat(row, m, axis=0)
    uw = rng.integers(0, 1 << bits, size=(k, n)).astype(np.int32)
    return ua, uw, ua @ uw


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("sigmas", [SIGMAS, dict(mismatch_sigma=0.3),
                                    dict(comparator_offset_sigma=0.03)],
                         ids=["both", "mismatch", "comparator"])
def test_moments_and_quantiles_match_reference_kernel(sigmas):
    ua, uw, exact = _trials()
    out = bitplane_mac_noisy_torch(_t(ua), _t(uw), 0, bits_a=4, bits_w=4,
                                   **sigmas).numpy()
    ref = np.asarray(j_bitplane_mac_noisy(
        jnp.asarray(ua), jnp.asarray(uw), jax.random.key(1), bits_a=4,
        bits_w=4, interpret=True, **sigmas))
    dk, dj = (out - exact).ravel(), (ref - exact).ravel()
    s = dj.std()
    assert s > 0  # the noise must flip decodes at these sigmas
    assert abs(dk.mean() - dj.mean()) < 0.15 * s
    assert 0.85 < dk.std() / s < 1.15
    for q in (10, 25, 50, 75, 90):
        assert abs(np.percentile(dk, q) - np.percentile(dj, q)) < 0.15 * s


def test_detuned_threshold_error_rate_band():
    """One plane pair, one group: the output IS the decoded count, so the
    error rate under detuned references must land within 0.03 of the
    reference kernel's and of a numpy Monte-Carlo of the noise model."""
    rows, m, n, k_true = 8, 256, 128, 4
    a = np.zeros((m, rows), np.int32)
    a[:, :k_true] = 1
    uw = np.ones((rows, n), np.int32)
    good = np.asarray(j_thresholds(rows, mode="physics"))
    ms, cs = 0.2, 0.02
    rng = np.random.default_rng(12345)
    samples = 200_000
    k_eff = k_true + ms * np.sqrt(k_true) * rng.standard_normal(samples)
    v = np.asarray(j_rbl_voltage(jnp.asarray(k_eff, jnp.float32), rows=rows,
                                 mode="physics"))
    for detune in (0.0, 0.4 * 0.216845):  # centred / 0.4-level corner shift
        thr = (good + detune).astype(np.float32)
        out = bitplane_mac_noisy_torch(_t(a), _t(uw), 3, _t(thr), bits_a=1,
                                       bits_w=1, mismatch_sigma=ms,
                                       comparator_offset_sigma=cs).numpy()
        ref = np.asarray(j_bitplane_mac_noisy(
            jnp.asarray(a), jnp.asarray(uw), jax.random.key(3),
            jnp.asarray(thr), bits_a=1, bits_w=1, mismatch_sigma=ms,
            comparator_offset_sigma=cs, interpret=True))
        dec = (v[:, None] <= (thr[None, :] + cs * rng.standard_normal(
            (samples, rows)))).sum(1)
        err_mc = float((dec != k_true).mean())
        err_port = float((out != k_true).mean())
        err_ref = float((ref != k_true).mean())
        assert err_mc > 0.05  # the regime is genuinely noisy
        assert abs(err_port - err_mc) < 0.03, (detune, err_port, err_mc)
        assert abs(err_port - err_ref) < 0.03, (detune, err_port, err_ref)


def test_same_seed_identical_other_seed_differs_zero_sigma_exact():
    ua, uw, exact = _trials(m=32)
    ta, tw = _t(ua), _t(uw)
    y1 = bitplane_mac_noisy(ta, tw, 0, bits_a=4, bits_w=4, **SIGMAS)
    y2 = bitplane_mac_noisy(ta, tw, 0, bits_a=4, bits_w=4, **SIGMAS)
    y3 = bitplane_mac_noisy(ta, tw, 1, bits_a=4, bits_w=4, **SIGMAS)
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    for sig in (dict(), dict(mismatch_sigma=0.0, comparator_offset_sigma=0.0),
                dict(mismatch_sigma=None, comparator_offset_sigma=0.0)):
        z = bitplane_mac_noisy(ta, tw, 5, bits_a=4, bits_w=4, **sig)
        assert torch.equal(z, bitplane_mac(ta, tw, bits_a=4, bits_w=4))
        np.testing.assert_array_equal(z.numpy(), exact)


def test_cpu_dispatch_batch_dims_and_chunking(monkeypatch):
    """A CPU tensor launches nothing; leading dims flatten into M; and the
    stream is a function of the element alone, so chunking N differently
    (as the kernel tiles and splits differently) changes no bit."""
    rng = np.random.default_rng(70)
    ua = _t(rng.integers(0, 256, (2, 3, 50)).astype(np.int32))
    uw = _t(rng.integers(0, 256, (50, 37)).astype(np.int32))
    before = bitplane_mac_noisy.launches
    out = bitplane_mac_noisy(ua, uw, 9, **SIGMAS)
    assert bitplane_mac_noisy.launches == before
    assert out.shape == (2, 3, 37) and out.dtype == torch.int32
    flat = bitplane_mac_noisy_torch(ua.reshape(6, 50), uw, 9, **SIGMAS)
    assert torch.equal(out.reshape(6, 37), flat)
    for chunk in (1, 700, 5000):
        monkeypatch.setattr(bitserial, "CHUNK_ELEMS", chunk)
        assert torch.equal(bitplane_mac_noisy_torch(ua, uw, 9, **SIGMAS), out)
    # a column's noise does not depend on how many columns follow it
    assert torch.equal(bitplane_mac_noisy_torch(ua, uw[:, :20], 9, **SIGMAS),
                       out[..., :20])


def test_rows16_and_ragged_k_padding_draws_no_noise():
    """Ragged K: only the real ceil(K/rows) groups decode, so a zero-count
    padded group never flips under comparator offset; at K = rows the result
    is a single group's decoded count, bounded by rows."""
    rows = 16
    a = np.zeros((64, rows), np.int32)
    a[:, :6] = 1
    uw = np.ones((rows, 16), np.int32)
    out = bitplane_mac_noisy_torch(_t(a), _t(uw), 2, bits_a=1, bits_w=1,
                                   rows=rows, comparator_offset_sigma=0.05)
    assert bool((out >= 0).all() and (out <= rows).all())
    # K = 20: the second group holds 4 real rows of zeros and 12 pads
    a2 = np.zeros((64, 20), np.int32)
    a2[:, :6] = 1
    uw2 = np.ones((20, 16), np.int32)
    out2 = bitplane_mac_noisy_torch(_t(a2), _t(uw2), 2, bits_a=1, bits_w=1,
                                    rows=rows, comparator_offset_sigma=0.05)
    assert abs(float((out2 - 6).float().mean()) -
               float((out - 6).float().mean())) < 0.5


@pytest.mark.parametrize("case", ["rows", "k_groups", "plane_pairs"])
def test_noise_independent_across_elements(case):
    rows = 8
    if case == "rows":  # identical rows must not draw identical noise
        ua, uw, exact = _trials(bits=4, m=64, k=64, n=8)
        out = bitplane_mac_noisy_torch(_t(ua), _t(uw), 0, bits_a=4, bits_w=4,
                                       **SIGMAS).numpy()
        assert np.unique(out, axis=0).shape[0] > 1
        return
    if case == "k_groups":  # two identical groups: deviations not all even
        half = np.zeros((64, rows), np.int32)
        half[:, :4] = 1
        ua = np.concatenate([half, half], axis=1)
        uw = np.ones((2 * rows, 64), np.int32)
        out = bitplane_mac_noisy_torch(_t(ua), _t(uw), 4, bits_a=1, bits_w=1,
                                       mismatch_sigma=0.4,
                                       comparator_offset_sigma=0.05).numpy()
        assert np.any((out - 8) % 2 != 0)
        return
    # value 3 = bits 11: both planes see the same counts; shared noise
    # would make every deviation a multiple of 3
    a = np.zeros((64, rows), np.int32)
    a[:, :4] = 3
    uw = np.ones((rows, 64), np.int32)
    out = bitplane_mac_noisy_torch(_t(a), _t(uw), 6, bits_a=2, bits_w=1,
                                   mismatch_sigma=0.4,
                                   comparator_offset_sigma=0.05).numpy()
    assert np.any((out - a @ uw) % 3 != 0)


def test_defaults_and_operand_errors():
    t = physics_thresholds(8, "cpu")
    ua = torch.zeros((2, 8), dtype=torch.int32)
    uw = torch.zeros((8, 3), dtype=torch.int32)
    assert torch.equal(bitplane_mac_noisy(ua, uw, 0, t, mismatch_sigma=0.3),
                       bitplane_mac_noisy(ua, uw, 0, mismatch_sigma=0.3))
    with pytest.raises(ValueError, match="one CUDA device"):
        bitplane_mac_noisy(ua, uw.to("meta"), 0)


def test_build_target_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edited header under ``csrc/`` must change the library's name, so a
    stale cached library is never loaded."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    names = {n: build._target(n)[1].name for n in build.KERNELS}
    assert len(set(names.values())) == len(build.KERNELS)
    header = tmp_path / "bitplane_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._target(n)[1].name for n in build.KERNELS}
    for n in build.KERNELS:  # every target covers every header
        assert after[n] != names[n], n
    src = tmp_path / "imc_mac.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build._target("imc_mac")[1].name != after["imc_mac"]
    assert build._target("paged_attn")[1].name == after["paged_attn"]
