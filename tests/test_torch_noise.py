"""The port's noise: the Philox stream (``repro_torch.kernels.common``), the
noisy decoders, ``core/montecarlo.py``, the noisy ``sim`` engines and the
seeds threaded through the model and the Server, against the JAX reference
on the CPU.

Bit for bit where the same normals can be handed to both packages:

  * Philox4x32-10 against Random123's known-answer vectors (Salmon et al.,
    SC'11; ``kat_vectors`` of Random123 1.09, ``philox4x32 10`` lines);
  * the physics noisy decode (``decode_counts_noisy``) against the
    reference's, which is given a sampler returning the port's normals in
    its draw order (mismatch first, then one per comparator);
  * the LUT noisy decode (``decode_group_counts``, ``thermometer_code``) and
    ``mc_count_noise`` against the reference's, which draw from a jax key;
    the test draws the reference's own normals from that key (mirroring
    ``bitserial.py``'s split) and passes them to the port as ``z``.

Statistically where the streams must differ (``jax.random`` is not the
port's generator): the criteria and sigmas of
``tests/test_bitplane_noise.py`` (mismatch 0.3, comparator offset 0.03;
engine level: mean of the deviation within 0.15 s, std ratio in
(0.85, 1.15), the 10/25/50/75/90th percentiles within 0.15 s, over 2,048
trials; fabric level: 0.25 s and (0.75, 1.33)).  Seeds: the same seed gives
the same result, another seed another, and ``NoiseSpec(0, 0)`` the
noise-free result bit for bit, at engine, model and Server level.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.core import bitserial as jbs
from repro.core import decoder as jdec
from repro.core import montecarlo as jmc
from repro.core.fabric import FabricSpec as JSpec
from repro.core.fabric import NoiseSpec as JNoise
from repro.core.fabric import fabric_matmul as j_fabric_matmul
from repro.kernels import common as jkc
from repro.models import model as jm
from repro.models.common import fabric_noise_key
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import params_from_jax
from repro_torch.core import bitserial as tbs
from repro_torch.core import constants as tC
from repro_torch.core import decoder as tdec
from repro_torch.core import montecarlo as tmc
from repro_torch.core.fabric import FabricSpec, NoiseSpec, fabric_matmul
from repro_torch.kernels import common as tkc
from repro_torch.launch.server import Request, Server
from repro_torch.models import model as tm
from repro_torch.models.common import dense, fabric_noise_seed
from repro_torch.telemetry import Registry

SIGMAS = dict(mismatch_sigma=0.3, comparator_offset_sigma=0.03)
M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many small tensor ops; beside the suite's other
    parallel workers, PyTorch's intra-op thread pool oversubscribes the
    cores and each op waits on its threads.  One thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ philox
@pytest.mark.parametrize("counter,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answer_vectors(counter, key, expect):
    out = tkc.philox4x32_10(counter, key)
    assert tuple(int(w) for w in out) == expect
    # broadcast over tensors: the same words element by element
    c = [torch.tensor([w, w], dtype=torch.int64) for w in counter]
    for got, want in zip(tkc.philox4x32_10(c, key), expect):
        assert got.tolist() == [want, want]


def test_uniform_and_normal_stream():
    """Uniforms are the top 24 bits; every one of the 2^24 values of u1
    gives a finite radius; log and cos within 1e-6 of float64 (the normal
    is a noise model: a few float32 ulps are immaterial)."""
    bits = torch.tensor([0, 255, 256, M32], dtype=torch.int64)
    assert tkc.bits_to_uniform(bits).tolist() == [
        0.0, 0.0, 2.0 ** -24, 1.0 - 2.0 ** -24]
    u = torch.arange(1 << 24, dtype=torch.int64).to(torch.float32) * 2.0 ** -24
    r = torch.sqrt(tkc.log_f32(1.0 - u) * -2.0)
    assert bool(torch.isfinite(r).all()) and float(r.min()) == 0.0
    sub = u[::4099].double().numpy()
    np.testing.assert_allclose(tkc.log_f32(1.0 - u[::4099]).double().numpy(),
                               np.log(1.0 - sub), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tkc.cos_2pi_f32(u[::4099]).double().numpy(),
                               np.cos(2 * np.pi * sub), rtol=0, atol=1e-6)
    z = tkc.element_normals(tkc.seed_words(7), torch.arange(50_000), 0, 0, 0,
                            range(2))
    for zi in z:
        assert abs(float(zi.mean())) < 0.02 and abs(float(zi.std()) - 1) < 0.02
    assert abs(float(torch.corrcoef(torch.stack(z))[0, 1])) < 0.02


def test_seed_words_and_mix_seed():
    assert tkc.seed_words(0) == (0, 0)
    assert tkc.seed_words((5 << 32) | 9) == (9, 5)
    assert tkc.seed_words(-1) == (M32, M32)
    seeds = {tkc.mix_seed(3, t, s) for t in range(50) for s in range(4)}
    assert len(seeds) == 200 and all(0 <= s < 1 << 64 for s in seeds)
    assert tkc.mix_seed(3, 1, 2) == tkc.mix_seed(3, 1, 2) != \
        tkc.mix_seed(4, 1, 2)


# ------------------------------------------------------ decoders, bit-exact
@pytest.mark.parametrize("ms,cs", [(0.3, None), (None, 0.03), (0.3, 0.03),
                                   (0.05, 0.01)])
@pytest.mark.parametrize("rows", [8, 16])
def test_physics_noisy_decode_bit_exact(ms, cs, rows):
    rng = np.random.default_rng(rows)
    k = rng.integers(0, rows + 1, (40, 33)).astype(np.float32)
    k[:5] += rng.uniform(-0.5, 0.5, (5, 33)).astype(np.float32)
    thr = np.asarray(jdec.thresholds(rows, mode="physics"))
    z_m = rng.standard_normal(k.shape).astype(np.float32)
    z_c = rng.standard_normal((rows,) + k.shape).astype(np.float32)
    draws = ([z_m] if ms else []) + (list(z_c) if cs else [])
    it = iter(draws)

    def normal(shape):  # the reference's sampler: the port's normals
        z = next(it)
        assert z.shape == tuple(shape)
        return jnp.asarray(z)

    ref = jkc.decode_counts_noisy(jnp.asarray(k), jnp.asarray(thr)[None],
                                  rows, normal, mismatch_sigma=ms,
                                  comparator_offset_sigma=cs)
    out = tkc.decode_counts_noisy(
        torch.from_numpy(k), torch.from_numpy(thr), rows,
        z_mismatch=torch.from_numpy(z_m), z_comparator=torch.from_numpy(z_c),
        mismatch_sigma=ms, comparator_offset_sigma=cs)
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int32),
                                  out.numpy())
    assert next(it, None) is None  # the reference drew every normal
    if ms == 0.3:  # the stress sigma flips decodes
        assert (out.numpy() != k.round()).any()


def _reference_normals(key, shape, rows, mismatch, comparator):
    """The normals the reference's decode_group_counts draws from ``key``
    (bitserial.py: split for mismatch, then the offsets)."""
    z_m = z_c = None
    if mismatch:
        key, nkey = jax.random.split(key)
        z_m = np.asarray(jax.random.normal(nkey, shape))
    if comparator:
        z_c = np.asarray(jax.random.normal(key, shape + (rows,), jnp.float32))
    return z_m, z_c


@pytest.mark.parametrize("kw", [
    dict(mismatch_sigma=0.3), dict(comparator_offset_sigma=0.03),
    dict(mismatch_sigma=0.3, comparator_offset_sigma=0.03),
    dict(mismatch=True), dict(mismatch_sigma=0.3, rbl_mode="physics"),
    dict(mismatch_sigma=0.2, comparator_offset_sigma=0.02, rows=16,
         rbl_mode="physics")], ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_lut_noisy_decode_group_counts_bit_exact(kw):
    kw = dict(kw)
    rows = kw.pop("rows", 8)
    rng = np.random.default_rng(rows + len(kw))
    counts = rng.integers(0, rows + 1, (6, 5, 7)).astype(np.int32)
    key = jax.random.key(3)
    ref = jbs.decode_group_counts(jnp.asarray(counts), mode="sim", rows=rows,
                                  key=key, **kw)
    mismatch = kw.get("mismatch") or kw.get("mismatch_sigma") is not None
    z_m, z_c = _reference_normals(key, counts.shape, rows, mismatch,
                                  "comparator_offset_sigma" in kw)
    out = tbs.decode_group_counts(
        torch.from_numpy(counts), mode="sim", rows=rows,
        z_mismatch=None if z_m is None else torch.from_numpy(z_m),
        z_comparator=None if z_c is None else torch.from_numpy(z_c), **kw)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    with pytest.raises(ValueError, match="generator"):
        tbs.decode_group_counts(torch.from_numpy(counts), mode="sim",
                                rows=rows, **kw)


def test_comparator_offset_thermometer_and_count_noise_bit_exact():
    rng = np.random.default_rng(9)
    v = rng.uniform(0.0, 1.9, (30, 4)).astype(np.float32)
    key = jax.random.key(11)
    z = np.asarray(jax.random.normal(key, v.shape + (8,), jnp.float32))
    for jf, tf in ((jdec.thermometer_code, tdec.thermometer_code),
                   (jdec.decode_voltage, tdec.decode_voltage)):
        ref = jf(jnp.asarray(v), comparator_offset_sigma=0.05, key=key)
        out = tf(torch.from_numpy(v), comparator_offset_sigma=0.05,
                 z=torch.from_numpy(z))
        np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    k = rng.integers(0, 9, (50,)).astype(np.float32)
    zk = np.asarray(jax.random.normal(key, k.shape))
    for sigma in (None, 0.3):
        ref = jmc.mc_count_noise(key, k.shape, jnp.asarray(k), sigma_vk=sigma)
        out = tmc.mc_count_noise(None, k.shape, torch.from_numpy(k),
                                 sigma_vk=sigma, z=torch.from_numpy(zk))
        np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_montecarlo_energy_model():
    """Same formula as the reference (bit for bit on the same gains) and
    the paper's Fig 6 moments: 437 fJ, 48.72 fJ, within 3% at 20k samples
    (the sampling error of a std at n=20k is 0.5%)."""
    g = torch.Generator().manual_seed(0)
    gains = tmc.sample_path_gains(g, (7, 8))
    assert gains.shape == (7, 8) and bool((gains >= 0).all())
    g2 = torch.Generator().manual_seed(0)
    z = torch.randn((7, 8), generator=g2)
    np.testing.assert_array_equal(gains.numpy(), np.maximum(
        np.float32(tC.MC_MU_G) + np.float32(tC.MC_SIGMA_G) * z.numpy(),
        np.float32(0.0)))
    mean, std = tmc.mc_stats(torch.Generator().manual_seed(1),
                             n_samples=20_000)
    jmean, jstd = jmc.mc_stats(jax.random.key(1), n_samples=20_000)
    for ours, ref, paper in ((mean, jmean, tC.MC_MEAN_FJ),
                             (std, jstd, tC.MC_STD_FJ)):
        assert abs(float(ours) - paper) < 0.03 * paper
        assert abs(float(ours) - float(ref)) < 0.03 * paper
    e = tmc.mc_energy_fj(torch.Generator().manual_seed(2), 3, 5)
    assert e.shape == (5,) and bool(torch.isfinite(e).all())


# ------------------------------------------------------- engines, statistics
def _trials(bits=4, m=256, k=64, n=8, seed=0):
    """Replicated-row operands: every output row is an iid noise trial."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 1 << bits, size=(1, k)).astype(np.int32)
    ua = np.repeat(row, m, axis=0)
    uw = rng.integers(0, 1 << bits, size=(k, n)).astype(np.int32)
    return ua, uw, ua @ uw


def assert_same_distribution(dk, dj, *, mean_tol=0.15, std_band=(0.85, 1.15),
                             quantiles=True):
    s = dj.std()
    assert s > 0, "the noise must flip decodes at these sigmas"
    assert abs(dk.mean() - dj.mean()) < mean_tol * s, (dk.mean(), dj.mean(), s)
    assert std_band[0] < dk.std() / s < std_band[1], (dk.std(), s)
    if quantiles:
        for q in (10, 25, 50, 75, 90):
            assert abs(np.percentile(dk, q) - np.percentile(dj, q)) \
                < mean_tol * s, q


def test_lut_engine_moments_match_reference():
    ua, uw, exact = _trials()
    out = tbs.bitserial_matmul_unsigned(
        torch.from_numpy(ua), torch.from_numpy(uw), bits_a=4, bits_w=4,
        mode="sim", seed=0, **SIGMAS)
    ref = jbs.bitserial_matmul_unsigned(
        jnp.asarray(ua), jnp.asarray(uw), bits_a=4, bits_w=4, mode="sim",
        key=jax.random.key(1), **SIGMAS)
    assert_same_distribution((out.numpy() - exact).ravel(),
                             (np.asarray(ref) - exact).ravel())


def test_noisy_engine_equals_its_loop_and_needs_a_seed():
    rng = np.random.default_rng(5)
    ua = torch.from_numpy(rng.integers(0, 16, (2, 3, 40)).astype(np.int32))
    uw = torch.from_numpy(rng.integers(0, 16, (40, 6)).astype(np.int32))
    kw = dict(bits_a=4, bits_w=4, mode="sim", **SIGMAS)
    out = tbs.bitserial_matmul_unsigned(ua, uw, seed=4, **kw)
    assert out.shape == (2, 3, 6)
    assert torch.equal(out, tbs.bitserial_matmul_looped(ua, uw, seed=4, **kw))
    assert not torch.equal(out, tbs.bitserial_matmul_unsigned(ua, uw, seed=5,
                                                              **kw))
    zero = tbs.bitserial_matmul_unsigned(ua, uw, seed=4, bits_a=4, bits_w=4,
                                         mode="sim", mismatch_sigma=0.0,
                                         comparator_offset_sigma=0.0)
    assert torch.equal(zero, ua @ uw)
    for f in (tbs.bitserial_matmul_unsigned, tbs.bitserial_matmul_looped):
        with pytest.raises(ValueError, match="seed"):
            f(ua, uw, **kw)


def _fabric_inputs(seed=7):
    rng = np.random.default_rng(seed)
    row = rng.normal(size=(1, 64)).astype(np.float32)
    return np.repeat(row, 128, axis=0), rng.normal(size=(64, 8)).astype(
        np.float32)


def test_torch_fabric_moments_match_reference_jnp_fabric():
    """``sim/torch+noise`` against ``_sim_jnp_noisy`` through quantize ->
    noisy GEMM -> dequant (the bounds of the reference's fabric test)."""
    x, w = _fabric_inputs()
    noise = NoiseSpec(**SIGMAS)
    spec = FabricSpec(mode="sim", noise=noise)
    assert spec.label == "sim/torch+noise"
    yt = fabric_matmul(torch.from_numpy(x), torch.from_numpy(w), spec,
                       seed=0).numpy()
    et = fabric_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       FabricSpec()).numpy()
    yj = np.asarray(j_fabric_matmul(
        jnp.asarray(x), jnp.asarray(w),
        JSpec(mode="sim", backend="jnp", noise=JNoise(**SIGMAS)),
        key=jax.random.key(1)))
    ej = np.asarray(j_fabric_matmul(jnp.asarray(x), jnp.asarray(w), JSpec()))
    np.testing.assert_array_equal(et, ej)
    assert_same_distribution((yt - et).ravel(), (yj - ej).ravel(),
                             mean_tol=0.25, std_band=(0.75, 1.33),
                             quantiles=False)


@pytest.mark.parametrize("backend", ["torch", "cuda-engine"])
def test_fabric_seeds_and_zero_sigma(backend):
    """Same seed identical, another seed different, NoiseSpec(0, 0) equal to
    the noise-free ``sim`` bit for bit; ``cuda-engine`` calls the
    ``sim/cuda+noise`` engine function on CPU tensors (its wrapper then runs
    the plain version of the kernel)."""
    from repro_torch.core import fabric as tfab

    x, w = (torch.from_numpy(a) for a in _fabric_inputs(3))
    x = x[:4]

    def run(noise, seed):
        spec = FabricSpec(mode="sim", noise=noise)
        if backend == "torch":
            return fabric_matmul(x, w, spec, seed=seed)
        engine = tfab._sim_cuda_noisy if spec.noisy else tfab._sim_cuda
        return engine(torch.round(x * 20).to(torch.int8),
                      torch.round(w * 20).to(torch.int8), spec, seed)

    noisy = NoiseSpec(**SIGMAS)
    a = run(noisy, 11)
    assert torch.equal(a, run(noisy, 11))
    assert not torch.equal(a, run(noisy, 12))
    clean = run(None, None)
    assert torch.equal(run(NoiseSpec(0.0, 0.0), 5), clean)
    assert not torch.equal(a, clean)
    with pytest.raises(ValueError, match="pass seed="):
        fabric_matmul(x, w, FabricSpec(mode="sim", noise=noisy))


# ------------------------------------------------------------ model, server
def _model(seed=0):
    jc = jreduce(jget("imc-paper-110m"), n_layers=2)
    tc = treduce(tget("imc-paper-110m"), n_layers=2)
    jp = jm.init_params(jax.random.key(seed), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, tc, jp, tp


def _noisy(cfg, spec_cls, noise, **kw):
    return dataclasses.replace(cfg, fabric=spec_cls(mode="sim", noise=noise,
                                                    **kw))


@pytest.fixture(scope="module")
def model():
    return _model()


def _tokens(cfg, n=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n))


def test_model_prefill_seeds_and_zero_sigma(model):
    _, tc, _, tp = model
    toks = torch.from_numpy(_tokens(tc)).to(torch.int32)
    batch = {"tokens": toks}
    noisy = _noisy(tc, FabricSpec, NoiseSpec(**SIGMAS))
    with torch.inference_mode():
        a, _ = tm.prefill(tp, batch, noisy, noise_seed=1)
        b, _ = tm.prefill(tp, batch, noisy, noise_seed=1)
        c, _ = tm.prefill(tp, batch, noisy, noise_seed=2)
        clean, _ = tm.prefill(tp, batch, _noisy(tc, FabricSpec, None))
        zero, _ = tm.prefill(tp, batch, _noisy(tc, FabricSpec,
                                               NoiseSpec(0.0, 0.0)),
                             noise_seed=3)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert torch.equal(zero, clean) and not torch.equal(a, clean)
        with pytest.raises(ValueError, match="fabric_noise_seed"):
            tm.prefill(tp, batch, noisy)
    # each dense call takes a fresh seed off the ambient one
    x = torch.randn((3, 64), generator=torch.Generator().manual_seed(0))
    p = {"w": torch.randn((64, 32), generator=torch.Generator().manual_seed(1))}
    spec = FabricSpec(mode="sim", noise=NoiseSpec(**SIGMAS))
    with fabric_noise_seed(5):
        y1, y2 = dense(p, x, spec=spec), dense(p, x, spec=spec)
    with fabric_noise_seed(5):
        y3 = dense(p, x, spec=spec)
    assert torch.equal(y1, y3) and not torch.equal(y1, y2)


def test_model_noise_matches_reference_in_distribution(model):
    """Relative L2 distance of the noisy prefill logits from the clean ones,
    averaged over 6 seeds: the port's ``sim/torch+noise`` and the
    reference's ``sim/jnp+noise`` (``forward_logits`` under
    ``fabric_noise_key``) model the same noise, so the two means agree
    within a factor of 1.35 (seed-to-seed spread of one mean: ~10%,
    measured in both packages)."""
    jc, tc, jp, tp = model
    noise = dict(mismatch_sigma=0.1)
    jn = _noisy(jc, JSpec, JNoise(**noise), backend="jnp")
    tn = _noisy(tc, FabricSpec, NoiseSpec(**noise))
    toks = _tokens(tc, n=12, seed=1)
    jclean = np.asarray(jm.forward_logits(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)},
        dataclasses.replace(jc, fabric=JSpec(mode="sim", backend="jnp"))))

    @jax.jit
    def j_noisy(p, t, key):
        with fabric_noise_key(key):
            return jm.forward_logits(p, {"tokens": t}, jn)

    batch = {"tokens": torch.from_numpy(toks).to(torch.int32)}
    with torch.inference_mode():
        tclean = tm.forward_logits(tp, batch, _noisy(tc, FabricSpec, None))
        np.testing.assert_array_equal(tclean.numpy(), jclean)
        dt = [float((tm.forward_logits(tp, batch, tn, noise_seed=s) - tclean)
                    .norm() / tclean.norm()) for s in range(6)]
    dj = [float(np.linalg.norm(np.asarray(j_noisy(
        jp, jnp.asarray(toks, jnp.int32), jax.random.key(s))) - jclean)
        / np.linalg.norm(jclean)) for s in range(6)]
    assert min(dt) > 0 and min(dj) > 0
    ratio = np.mean(dt) / np.mean(dj)
    assert 1 / 1.35 < ratio < 1.35, (dt, dj)


def _serve(cfg, params, noise_seed, lengths=(7, 16, 5), max_new=4):
    server = Server(cfg, params, slots=2, block_size=8, buckets=(16,),
                    max_seq_len=16 + max_new, registry=Registry(),
                    device="cpu", noise_seed=noise_seed)
    rng = np.random.default_rng(0)
    handles = [server.submit(Request(
        rng.integers(0, cfg.vocab_size, n).astype(np.int32),
        max_new_tokens=max_new)) for n in lengths]
    server.drain()
    assert all(h.done and len(h.tokens) == max_new for h in handles)
    server.alloc.check()
    return [h.tokens for h in handles]


def test_server_noise_seed_replays_streams(model):
    _, tc, _, tp = model
    noisy = _noisy(tc, FabricSpec, NoiseSpec(**SIGMAS))
    a = _serve(noisy, tp, noise_seed=7)
    assert a == _serve(noisy, tp, noise_seed=7)
    assert a != _serve(noisy, tp, noise_seed=8)
    clean = _serve(_noisy(tc, FabricSpec, None), tp, noise_seed=7)
    assert _serve(_noisy(tc, FabricSpec, NoiseSpec(0.0, 0.0)), tp,
                  noise_seed=9) == clean
