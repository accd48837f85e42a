"""The port's training path (``repro_torch`` loss, STE backward, AdamW step,
Engine train step and trainer) against the JAX reference on the CPU.

Reduced ``imc-paper-110m`` (GELU, untied head) and reduced ``qwen2.5-3b``
(GQA, QKV bias with random values, tied embeddings), two layers, batch 2 x
seq 32 (two query chunks of 16, so the chunk remat runs), on batches of the
reference's own stream.  The reference runs
``jax.jit(jax.value_and_grad(repro.models.model.loss_fn))``; its params and
optimizer state cross through ``convert.py``.

Tolerances, from what was measured:

  * the loss: 1e-4 relative (measured 0 under ``exact`` and ``sim``, where
    every projection is an integer product, and 6.5e-5 with the fabric off,
    where the projections are bf16 matmuls of two libraries);
  * every gradient leaf: 2e-2 relative L2, bf16 and f32 leaves alike
    (measured max 1.1e-2 on bf16 leaves and 1.4e-2 on the f32 norm scales).
    The reference's jitted backward keeps some bf16 intermediates in f32
    (XLA fuses and elides bf16 round trips, e.g. through the GELU's
    derivative); the port rounds each op.  Both sit farther from a float64
    gradient of the same model than from each other (``chip_smoke.py``
    phase 8c reads it at full width), so the f32 leaves, reduced from bf16
    cotangents, cannot be held to 1e-3.  The one exception is a K bias: its
    exact gradient is zero (a bias on every key shifts each query's scores
    by one constant, which softmax ignores), so both packages return
    rounding noise; it is held to 2e-2 of the Q bias gradient's norm.
  * one AdamW step: m within 2e-2 relative L2 (measured 1.3e-2), v
    (quadratic in the gradient) within 4e-2 (measured 1.5e-2), the params
    and f32 masters within 5e-3 (measured 2.7e-3: Adam's first step moves
    each element by about lr whatever its gradient's size, so where a tiny
    gradient's sign differs the two masters part by 2 lr).

Eight steps of ``train()``'s 8-step schedule track the reference's, step
by step and on a held batch, within 2e-3 relative (measured 1.1e-3).

Also, bit for bit on the port alone: remat on equals remat off (noisy
``sim`` included); the noisy step replays under one seed and differs across
steps; ``train`` resumed after a ``fail_at`` drill equals the uninterrupted
run.  The file pins one intra-op thread (parallel test workers running tiny
models starve each other's threads otherwise).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.core.fabric import FabricSpec as JSpec
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticStream as JStream
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as jm
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import adamw_state_from_jax, params_from_jax
from repro_torch.core.fabric import FabricSpec as TSpec
from repro_torch.core.fabric import NoiseSpec
from repro_torch.launch import steps
from repro_torch.launch.engine import Engine
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train, train_fleet
from repro_torch.models import attention as tatt
from repro_torch.models import model as tm
from repro_torch.optim.adamw import AdamWConfig, init_adamw
from repro_torch.runtime.fault_tolerance import InjectedFailure
from repro_torch.telemetry import Registry
from repro_torch.tree import tree_leaves

LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-2
STEP_RTOL = 5e-3  # params and masters after one AdamW step
B, S = 2, 32
NOISE = NoiseSpec(mismatch_sigma=0.3)  # flips decodes at these widths
FABRICS = {
    "off": (None, None),
    "exact": (JSpec(), TSpec()),
    # noise-free sim at 2x2 bits (4 plane pairs) keeps the reference's jnp
    # engine quick; 8x8 is held in tests/test_torch_model.py's forwards
    "sim": (JSpec(mode="sim", backend="jnp", bits_a=2, bits_w=2),
            TSpec(mode="sim", bits_a=2, bits_w=2)),
}
NOISY = TSpec(mode="sim", bits_a=2, bits_w=2, noise=NOISE)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}/{i}")
    else:
        yield pre, tree


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / a.norm())


def _configs(arch, fabric):
    jspec, tspec = FABRICS[fabric]
    jc = dataclasses.replace(jreduce(jget(arch), n_layers=2), fabric=jspec)
    tc = dataclasses.replace(treduce(tget(arch), n_layers=2), fabric=tspec)
    return jc, tc


def _params(jc, tc):
    jp = jm.init_params(jax.random.key(0), jc)
    rng = np.random.default_rng(0)

    def fill_bias(path, leaf):  # zero-init biases -> random, in both trees
        if path[-1].key == "b":
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.1,
                               leaf.dtype)
        return leaf

    jp = jax.tree_util.tree_map_with_path(fill_bias, jp)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tc)


def _batch(jc, step=0, seq=S):
    """The reference's own stream, as numpy, for both packages."""
    b = JStream(JDataConfig(jc.vocab_size, seq, B, seed=3)).batch(step)
    nb = {k: np.asarray(v) for k, v in b.items()}
    return nb, {k: torch.from_numpy(v.copy()) for k, v in nb.items()}


def _check_grads(jgrads, tgrads, tc):
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads), tc)
    ref_paths = dict(_paths(ref))
    for path, g in _paths(tgrads):
        a = ref_paths[path]
        if path.endswith("attn/wk/b"):  # zero in exact arithmetic
            qn = ref_paths[path.replace("wk/b", "wq/b")].double().norm()
            assert float((a.double() - g.double()).norm()) \
                <= GRAD_RTOL * float(qn), path
            continue
        assert _rel(a, g) <= GRAD_RTOL, (path, _rel(a, g))


# ------------------------------------------------------ loss and gradients
@pytest.mark.parametrize("fabric", list(FABRICS))
@pytest.mark.parametrize("arch", ["imc-paper-110m", "qwen2.5-3b"])
def test_loss_and_grads_match_reference(arch, fabric):
    jc, tc = _configs(arch, fabric)
    jp, tp = _params(jc, tc)
    nb, tb = _batch(jc)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, jc), has_aux=True))(jp, nb)
    tl, tmet, tg = tm.loss_and_grads(tp, tb, tc)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert float(tmet["ce"]) == float(tl) == float(tmet["loss"])
    for p, g in zip(tree_leaves(tp), tree_leaves(tg)):
        assert g.dtype == p.dtype and g.shape == p.shape
    _check_grads(jg, tg, tc)


@pytest.mark.parametrize("arch", ["imc-paper-110m", "qwen2.5-3b"])
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` (the exact fabric) against the reference's
    jitted one, from identical params and optimizer state (the reference's
    ``init_adamw`` carried across by ``adamw_state_from_jax``)."""
    jc, tc = _configs(arch, "exact")
    jp, tp = _params(jc, tc)
    nb, tb = _batch(jc)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstate = jadamw.init_adamw(jp)
    jnew, jopt, jmet = jax.jit(jmake_train_step(
        jc, jadamw.AdamWConfig(**kw)))(jp, jstate, nb, None)
    tstate = adamw_state_from_jax(jax.tree.map(np.asarray, jstate), tc)
    tnew, topt, tmet = steps.make_train_step(tc, AdamWConfig(**kw))(
        tp, tstate, tb)
    assert set(tmet) == {"loss", "ce", "grad_norm", "lr"}
    for k in ("loss", "ce", "lr"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= \
            LOSS_RTOL * abs(float(jmet[k]))
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) \
        <= GRAD_RTOL * float(jmet["grad_norm"])
    assert int(topt.step) == int(jopt.step) == 1
    for jt, tt, tol in ((jnew, tnew, STEP_RTOL), (jopt.m, topt.m, GRAD_RTOL),
                        (jopt.v, topt.v, 2 * GRAD_RTOL),
                        (jopt.master, topt.master, STEP_RTOL)):
        ref = dict(_paths(params_from_jax(jax.tree.map(np.asarray, jt), tc)))
        for path, t in _paths(tt):
            if path.endswith("attn/wk/b"):
                continue  # its gradient is rounding noise (module docstring),
                # and Adam's first step moves it by +-lr by that noise's sign
            assert t.dtype == ref[path].dtype, path
            assert _rel(ref[path], t) <= tol, (path, _rel(ref[path], t))
    # every new param is param_dtype (bf16), norm scales included
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(tnew))


def test_eight_steps_track_reference():
    """Eight steps along ``train()``'s 8-step schedule (lr 1e-3, warmup 1),
    the exact fabric, on the reference's batches from identical state: each
    step's loss and a held batch's (the stream's step 10**6, never trained
    on) after each step stay within 2e-3 relative of the reference's
    (measured 1.1e-3: the two packages' bf16 roundings part their params a
    little more each step).  ``pytest -s`` prints both trajectories."""
    jc, tc = _configs("imc-paper-110m", "exact")
    jp, tp = _params(jc, tc)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=8)
    jstep = jax.jit(jmake_train_step(jc, jadamw.AdamWConfig(**kw)))
    jloss = jax.jit(lambda p, b: jm.loss_fn(p, b, jc)[0])
    jstate = jadamw.init_adamw(jp)
    tstate = adamw_state_from_jax(jax.tree.map(np.asarray, jstate), tc)
    tstep = steps.make_train_step(tc, AdamWConfig(**kw))
    hn, ht = _batch(jc, 10**6)
    ref = {"loss": [], "held": [float(jloss(jp, hn))]}
    port = {"loss": [], "held": [float(tm.loss_fn(tp, ht, tc)[0])]}
    for s in range(8):
        nb, tb = _batch(jc, s)
        jp, jstate, jmet = jstep(jp, jstate, nb, None)
        tp, tstate, tmet = tstep(tp, tstate, tb)
        ref["loss"].append(float(jmet["loss"]))
        port["loss"].append(float(tmet["loss"]))
        ref["held"].append(float(jloss(jp, hn)))
        port["held"].append(float(tm.loss_fn(tp, ht, tc)[0]))
    for k in ("loss", "held"):
        print(f"{k}: reference {ref[k]}\n{k}: port      {port[k]}")
        for r, t in zip(ref[k], port[k]):
            assert abs(t - r) <= 2e-3 * abs(r), (k, ref[k], port[k])


# --------------------------------------------------- the port against itself
@pytest.mark.parametrize("fabric", ["exact", "noisy"])
def test_remat_equals_no_remat_bit_for_bit(fabric):
    """Layer remat (and the attention chunks' and CE's checkpoints) change
    nothing: a noisy layer recomputed in the backward replays its seeds."""
    tc = treduce(tget("imc-paper-110m"), n_layers=2,
                 fabric=TSpec() if fabric == "exact" else NOISY)
    tp = tm.init_params(tc, device="cpu", seed=1)
    _, tb = _batch(tc)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tc, remat=remat, chunk_remat=remat)
        out[remat] = tm.loss_and_grads(tp, tb, cfg, noise_seed=11)
    (l1, _, g1), (l0, _, g0) = out[True], out[False]
    assert torch.equal(l1, l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)


def test_noisy_train_step_replays_and_differs():
    tc = treduce(tget("imc-paper-110m"), n_layers=2, fabric=NOISY)
    clean = dataclasses.replace(tc, fabric=TSpec(mode="sim", bits_a=2,
                                                 bits_w=2))
    tp = tm.init_params(tc, device="cpu", seed=1)
    _, tb = _batch(tc)
    eng = Engine("cpu", noise_seed=5, registry=Registry())
    step = eng.train_step(tc, AdamWConfig(lr=1e-3))
    state = init_adamw(tp)
    runs = [step(tp, state, tb, eng.noise_seed(s)) for s in (0, 0, 1)]
    (p0, o0, m0), (p1, o1, m1), (p2, _, m2) = runs
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(tree_leaves((p0, o0)), tree_leaves((p1, o1))):
        assert torch.equal(a, b)
    assert float(m2["loss"]) != float(m0["loss"])
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(p0), tree_leaves(p2)))
    loss_clean = float(tm.loss_fn(tp, tb, clean)[0])
    assert float(m0["loss"]) != loss_clean
    with pytest.raises(ValueError, match="seed"):
        step(tp, state, tb, None)


def test_attn_forward_flash_raises_under_grad():
    """``use_flash=True``: the forward without grad is the flash path (its
    plain version on the CPU, within the bf16 flash bound of the chunked
    path); recording a gradient through it raises."""
    tc = treduce(tget("imc-paper-110m"))
    tp = tm.init_params(tc, device="cpu", seed=2)
    attn = tp["blocks"]["layers"][0]["attn"]
    x = torch.randn(B, S, tc.d_model, generator=torch.Generator().manual_seed(
        0)).to(torch.bfloat16)
    kw = dict(n_heads=tc.n_heads, n_kv_heads=tc.n_kv_heads, head_dim=tc.hd,
              rope_theta=tc.rope_theta, q_chunk=tc.q_chunk)
    with torch.no_grad():
        flash = tatt.attn_forward(attn, x, use_flash=True, **kw)
        dense = tatt.attn_forward(attn, x, use_flash=False, **kw)
    assert float((flash.float() - dense.float()).abs().max()) <= 2e-2
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tatt.attn_forward(attn, xg, use_flash=True, **kw)
    _, tb = _batch(tc)
    with pytest.raises(RuntimeError, match="no backward"):
        tm.loss_and_grads(tp, tb, dataclasses.replace(tc,
                                                      use_flash_kernel=True))
    # forward_logits runs the training forward without grad: flash is fine
    with torch.no_grad():
        logits = tm.forward_logits(tp, tb, dataclasses.replace(
            tc, use_flash_kernel=True))
    assert logits.shape == (B, S, tc.vocab_size)


# ----------------------------------------------------------- engine, trainer
def test_engine_train_step_cache():
    """Mirrors ``tests/test_engine.py``: one step per (cfg, opt_cfg)."""
    tc = treduce(tget("imc-paper-110m"), fabric=TSpec())
    reg = Registry()
    eng = Engine("cpu", registry=reg)
    t1 = eng.train_step(tc, AdamWConfig(lr=1e-3))
    assert eng.train_step(tc, AdamWConfig(lr=1e-3)) is t1
    assert eng.train_step(tc, AdamWConfig(lr=2e-3)) is not t1
    assert eng.stats.compiles == 2 and eng.stats.hits == 1
    assert reg.counter("engine.compiles").value == 2
    assert reg.counter("engine.cache_hits").value == 1
    tp = tm.init_params(tc, device="cpu")
    _, tb = _batch(tc, seq=16)
    _, opt, met = t1(tp, init_adamw(tp), tb, eng.noise_seed(0))
    assert int(opt.step) == 1 and np.isfinite(float(met["loss"]))
    assert reg.histogram("engine.step_s.train").count == 1


def test_train_resumes_bit_for_bit(tmp_path):
    """``train`` with a ``fail_at`` drill raises; called again on the same
    checkpoint root it resumes from the latest committed step and ends
    where the uninterrupted run ends, params and optimizer state bit for
    bit (``ckpt_every=2``: the crash at step 3 resumes from step 1)."""
    tc = treduce(tget("imc-paper-110m"), n_layers=2, fabric=TSpec())
    kw = dict(steps=6, global_batch=B, seq_len=S, ckpt_every=2, lr=1e-3,
              seed=3, device="cpu")
    whole, hist = train(tc, ckpt_root=str(tmp_path / "whole"), **kw)
    with pytest.raises(InjectedFailure):
        train(tc, ckpt_root=str(tmp_path / "drill"), fail_at={3}, **kw)
    resumed, hist2 = train(tc, ckpt_root=str(tmp_path / "drill"), **kw)
    assert len(hist) == 6 and len(hist2) == 4  # steps 2..5 after the resume
    assert [m["loss"] for m in hist[2:]] == [m["loss"] for m in hist2]
    assert int(resumed[1].step) == 6
    for a, b in zip(tree_leaves(whole), tree_leaves(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_trainer_entry_points(capsys, tmp_path):
    """``python -m repro_torch.launch.train`` and ``train_tiny_lm`` on the
    CPU; the loss falls; a fleet whose devices are not named asks for the
    card (no fallback to the CPU; ``tests/test_torch_fleet.py`` runs the
    fleet over CPU hosts)."""
    train_main(["--arch", "imc-paper-110m", "--reduce", "--device", "cpu",
                "--steps", "3", "--batch", "2", "--seq", "16"])
    assert "final loss" in capsys.readouterr().out
    from repro_torch import train_tiny_lm

    assert train_tiny_lm.main(["--small", "--device", "cpu", "--steps",
                               "12", "--batch", "4", "--seq", "32"]) == 0
    assert "train_tiny_lm OK" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(["--reduce", "--device", "cpu", "--fleet-hosts", "2"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_fleet(treduce(tget("imc-paper-110m")), n_hosts=2, steps=1,
                        global_batch=2, seq_len=16, ckpt_root=str(tmp_path))
