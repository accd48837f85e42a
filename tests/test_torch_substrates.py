"""The port's training substrates against ``tests/test_substrates.py`` and the
reference: the data pipeline, AdamW, checkpoints, the fault-tolerant loop,
gradient compression, elastic planning and the straggler policy, case for
case, then held against ``repro`` where the two must agree:

  * the drift transform on the same base tokens: equal to the reference's
    formula (``jnp``), bit for bit;
  * ``lr_schedule`` and ``adamw_update`` on the same numpy params and
    grads, f32 and bf16 params, over several steps: the f32 state within 2
    float32 ulps relative or 4 ulps of its leaf's largest magnitude (XLA
    fuses the moment updates into FMAs, see ``F32_ULPS_OF_MAX``), and the
    params within one ulp of their dtype;
  * checkpoints: the port reads the reference's files and the reference
    reads the port's (same layout, leaf order, bf16 as uint16).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticStream as JStream
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, latest_step,
                                               restore, save)
from repro_torch.convert import to_torch
from repro_torch.data.pipeline import (DataConfig, SyntheticStream,
                                       batch_for_shape, drift_tokens,
                                       validate_determinism)
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     init_adamw, lr_schedule)
from repro_torch.runtime.compression import (compress, decompress,
                                             init_compression)
from repro_torch.runtime.elastic import (plan_for_fleet, plan_mesh,
                                         shrink_after_failure)
from repro_torch.runtime.fault_tolerance import (FaultTolerantLoop,
                                                 InjectedFailure)
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.telemetry import get_registry
from repro_torch.tree import tree_leaves, tree_map

F32_RTOL = 2.4e-7  # two float32 ulps at 1
# XLA contracts the moments' b * m + (1 - b) * g into fused multiply-adds,
# and m's two terms can cancel: the f32 state is also allowed 4 ulps of its
# leaf's largest magnitude (measured max 1.3 ulps)
F32_ULPS_OF_MAX = 4 * 2.0 ** -23


# ------------------------------------------------------------------- data
def test_data_determinism_and_sharding():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8)
    assert validate_determinism(cfg)
    s = SyntheticStream(cfg)
    full = s.batch(3, 0, 1)
    parts = [s.batch(3, i, 4) for i in range(4)]
    assert parts[0]["tokens"].shape == (2, 16)
    # different shards differ; same shard reproduces
    assert not np.array_equal(parts[0]["tokens"], parts[1]["tokens"])
    np.testing.assert_array_equal(s.batch(3, 1, 4)["tokens"],
                                  parts[1]["tokens"])
    # labels are the shifted stream (learnable next-token signal)
    assert full["labels"].shape == (8, 16)
    np.testing.assert_array_equal(full["tokens"][:, 1:],
                                  full["labels"][:, :-1])
    assert full["tokens"].dtype == np.int32
    assert 0 <= full["tokens"].min() and full["tokens"].max() < 1000
    # random access: another step, another seed -> other tokens
    assert not np.array_equal(s.batch(4)["tokens"], full["tokens"])
    other = SyntheticStream(DataConfig(1000, 16, 8, seed=1)).batch(3)
    assert not np.array_equal(other["tokens"], full["tokens"])


def test_data_rejects_bad_shard_counts():
    s = SyntheticStream(DataConfig(100, 8, 8))
    with pytest.raises(ValueError):
        s.batch(0, 0, 3)


def test_drift_transform_matches_reference_formula():
    """The same base tokens through the port's drift and the reference's
    formula (``SyntheticStream.batch``'s jnp lines) give the same stream."""
    rng = np.random.default_rng(0)
    for vocab, shape in ((1000, (4, 17)), (7, (3, 40)), (32000, (2, 513))):
        base = rng.integers(0, vocab, shape, dtype=np.int32)
        jb = jnp.asarray(base)
        drift = jnp.cumsum(jb % 7, axis=1) % vocab
        ref = np.asarray((jb + drift) % vocab)
        np.testing.assert_array_equal(drift_tokens(base, vocab), ref)


def test_batch_for_shape_and_frontend_stub():
    class Shape:
        seq_len, global_batch = 12, 3

    class Cfg:
        vocab_size, frontend, frontend_dim = 50, "none", 0

    b = batch_for_shape(Cfg, Shape, seed=2)
    assert b["tokens"].shape == (3, 12) and b["labels"].shape == (3, 12)
    # the frontend stub: embeddings in place of tokens, bf16 values, and the
    # same labels as the token stream of the same seed and step
    stream = SyntheticStream(DataConfig(50, 12, 3, frontend_dim=8))
    e = stream.batch(4)
    assert set(e) == {"embeddings", "labels"}
    assert e["embeddings"].shape == (3, 12, 8)
    assert e["embeddings"].dtype == np.float32
    as_bf16 = torch.from_numpy(e["embeddings"]).to(torch.bfloat16).float()
    np.testing.assert_array_equal(as_bf16.numpy(), e["embeddings"])
    assert 0.8 < float(np.std(e["embeddings"])) < 1.2
    np.testing.assert_array_equal(
        e["labels"], SyntheticStream(DataConfig(50, 12, 3)).batch(4)["labels"])


# ------------------------------------------------------------------ optim
def test_adamw_descends_quadratic():
    w = {"w": torch.tensor([3.0, -2.0])}
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                      weight_decay=0.0, grad_clip=10.0)
    state = init_adamw(w)
    for _ in range(100):
        g = {"w": 2 * state.master["w"]}  # d/dw ||w||^2
        w, state, metrics = adamw_update(g, state, cfg,
                                         param_dtype=torch.float32)
    assert float(state.master["w"].abs().max()) < 0.3
    assert np.isfinite(float(metrics["grad_norm"]))


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 1e-6
    assert lrs[100] == pytest.approx(0.1, rel=1e-3)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))  # decay
    ref = [float(jadamw.lr_schedule(jadamw.AdamWConfig(
        lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
        jnp.int32(s))) for s in range(101)]
    np.testing.assert_allclose(lrs, ref, rtol=F32_RTOL, atol=0)


def test_adamw_bf16_params_fp32_master():
    w = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = init_adamw(w)
    assert state.master["w"].dtype == torch.float32
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    new_w, state, _ = adamw_update({"w": torch.ones((4,),
                                                    dtype=torch.bfloat16)},
                                   state, AdamWConfig())
    assert new_w["w"].dtype == torch.bfloat16
    assert int(state.step) == 1


def test_adamw_master_never_aliases_f32_param():
    p = {"w": torch.ones(3)}
    state = init_adamw(p)
    assert state.master["w"].data_ptr() != p["w"].data_ptr()
    adamw_update({"w": torch.ones(3)}, state, AdamWConfig())
    assert torch.equal(p["w"], torch.ones(3)), "the update wrote a param"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Five updates from the same params on the same numpy grads, clipping
    active (grad_clip 0.5), warmup then decay, weight decay on."""
    rng = np.random.default_rng(3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 2, 4)}}
    jparams = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s), jdt), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda p: np.asarray(
        rng.standard_normal(p.shape) * 0.3, np.float32), jparams)
        for _ in range(5)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, grad_clip=0.5)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), AdamWConfig(**kw)
    jstate = jadamw.init_adamw(jparams)
    tstate = init_adamw(tree_map(to_torch, jax.tree.map(np.asarray,
                                                        jparams)))
    for g in grads:
        jp, jstate, jm = jadamw.adamw_update(
            jax.tree.map(jnp.asarray, g), jstate, jcfg, param_dtype=jdt)
        tp, tstate, tm = adamw_update(tree_map(torch.from_numpy, g),
                                      tstate, tcfg,
                                      param_dtype=getattr(torch, dtype))
        assert int(tstate.step) == int(jstate.step)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=F32_RTOL)
        for jt, tt in ((jstate.master, tstate.master), (jstate.m, tstate.m),
                       (jstate.v, tstate.v)):
            for a, b in zip(jax.tree.leaves(jt), tree_leaves(tt)):
                a = np.asarray(a)
                np.testing.assert_allclose(
                    b.numpy(), a, rtol=F32_RTOL,
                    atol=F32_ULPS_OF_MAX * np.abs(a).max())
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            ref = to_torch(np.asarray(a)).float()
            ulp = 2.0 ** -7 if dtype == "bfloat16" else F32_RTOL
            torch.testing.assert_close(b.float(), ref, rtol=ulp, atol=0)


# ------------------------------------------------------------- checkpoint
def _tree():
    return {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16) * 1.5,
                  "d": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def test_checkpoint_roundtrip(tmp_path):
    root = str(tmp_path / "ckpt")
    t = _tree()
    save(root, 5, t)
    out, step = restore(root, _zeros_like(t))
    assert step == 5
    for a, b in zip(tree_leaves(t), tree_leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_gc_and_latest(tmp_path):
    root = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4):
        save(root, s, _tree(), keep_last=2)
    assert latest_step(root) == 4
    kept = sorted(os.listdir(root))
    assert len([k for k in kept if k.startswith("step_")]) == 2


def test_checkpoint_async(tmp_path):
    root = str(tmp_path / "ckpt")
    ck = AsyncCheckpointer(root)
    ck.save_async(1, _tree())
    ck.wait()
    assert latest_step(root) == 1


def test_checkpoint_ignores_uncommitted(tmp_path):
    root = str(tmp_path / "ckpt")
    save(root, 1, _tree())
    # fake a torn checkpoint at a later step
    os.makedirs(os.path.join(root, "step_000000002"))
    assert latest_step(root) == 1


def test_checkpoint_layout_matches_reference(tmp_path):
    """One directory layout: the reference restores the port's checkpoint
    and the port the reference's, bit for bit (bf16 as its uint16 view)."""
    t = _tree()
    jt = {"a": jnp.arange(10, dtype=jnp.float32),
          "b": {"c": jnp.ones((3, 3), jnp.bfloat16) * 1.5,
                "d": jnp.int32(7)}}
    port_root, ref_root = str(tmp_path / "port"), str(tmp_path / "ref")
    path = save(port_root, 3, t)
    assert os.path.basename(path) == "step_000000003"
    assert sorted(os.listdir(path)) == ["COMMITTED", "meta.json",
                                        "shard_00000.npz"]
    with np.load(os.path.join(path, "shard_00000.npz")) as z:
        assert z["leaf_1"].dtype == np.uint16  # b/c, bf16
    out, step = jckpt.restore(port_root, jax.tree.map(jnp.zeros_like, jt))
    assert step == 3
    for a, b in zip(jax.tree.leaves(out), tree_leaves(t)):
        assert torch.equal(to_torch(np.asarray(a)), b)
    jckpt.save(ref_root, 4, jt)
    back, step = restore(ref_root, _zeros_like(t))
    assert step == 4
    for a, b in zip(tree_leaves(back), tree_leaves(t)):
        assert torch.equal(a, b)


# --------------------------------------------------------- fault tolerance
def test_fault_tolerant_restart_bit_exact(tmp_path):
    root = str(tmp_path / "ft")
    stream = SyntheticStream(DataConfig(97, 8, 4))

    def step_fn(state, batch, step):
        return {"w": state["w"] + int(batch["tokens"].sum()) % 13,
                "n": state["n"] + 1}

    def batch_fn(step):
        return stream.batch(step)

    init = {"w": torch.tensor(0.0), "n": torch.tensor(0, dtype=torch.int32)}
    reg = get_registry()
    failures = reg.counter("fault.failures").value
    resumes = reg.counter("fault.resumes").value

    # uninterrupted reference
    ref = FaultTolerantLoop(root + "_ref", step_fn, batch_fn,
                            ckpt_every=3).run(init, 10)
    # crash at step 7, then restart
    loop = FaultTolerantLoop(root, step_fn, batch_fn, ckpt_every=3,
                             fail_at={7})
    with pytest.raises(InjectedFailure):
        loop.run(init, 10)
    out = loop.run(init, 10)  # resumes from latest committed step
    assert int(out["n"]) == 10
    assert float(out["w"]) == float(ref["w"])
    assert reg.counter("fault.failures").value == failures + 1
    assert reg.counter("fault.resumes").value == resumes + 1


# -------------------------------------------------------------- compression
def test_compression_error_feedback_converges():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=512).astype(np.float32))}
    state = init_compression(g)
    acc_plain = torch.zeros(512)
    acc_comp = torch.zeros(512)
    for _ in range(50):
        (q, s), state = compress(g, state)
        acc_comp = acc_comp + decompress(q, s)["w"]
        acc_plain = acc_plain + g["w"]
    rel = float((acc_comp - acc_plain).norm() / acc_plain.norm())
    assert rel < 0.01  # error feedback keeps the accumulated sum unbiased


def test_compression_bytes_ratio():
    g = {"w": torch.zeros((1024,), dtype=torch.float32)}
    (q, s), _ = compress(g, init_compression(g))
    assert q["w"].dtype == torch.int8  # 4x fewer bytes than f32 on the wire


# ------------------------------------------------------------------ elastic
def test_elastic_plans():
    p = plan_mesh(512, model_parallel=16, base_batch=256)
    assert p.shape == (2, 16, 16) and p.axes == ("pod", "data", "model")
    p2 = shrink_after_failure(p, lost_devices=256, model_parallel=16)
    assert p2.n_devices == 256 and p2.shape == (16, 16)
    # per-replica batch preserved
    assert p2.global_batch * 2 == p.global_batch
    with pytest.raises(ValueError):
        plan_mesh(8, model_parallel=16, base_batch=64)
    assert plan_for_fleet(4, 8, model_parallel=2, base_batch=32).shape \
        == (16, 2)


# ---------------------------------------------------------------- straggler
def test_straggler_detection_and_swap():
    mon = StragglerMonitor()
    for step in range(6):
        times = {h: 1.0 for h in range(8)}
        times[3] = 3.0  # persistent straggler
        mon.record_step(times)
    assert 3 in mon.swaps
    mon.replace_host(3)
    assert 3 not in mon.hosts
    # healthy fleet: no swaps
    mon2 = StragglerMonitor()
    for _ in range(6):
        assert mon2.record_step({h: 1.0 + 0.01 * h for h in range(8)}) == []


def test_adamw_state_is_a_checkpointable_tree(tmp_path):
    """The trainer's state, (params, AdamWState), round-trips through a
    checkpoint with its NamedTuple and the step counter intact."""
    params = {"w": torch.randn(4, 3).to(torch.bfloat16),
              "n": {"scale": torch.ones(3)}}
    _, state, _ = adamw_update(tree_map(torch.ones_like, params),
                               init_adamw(params), AdamWConfig())
    root = str(tmp_path / "ckpt")
    save(root, 0, (params, state))
    like = (tree_map(torch.zeros_like, params),
            AdamWState(torch.zeros((), dtype=torch.int32),
                       *(tree_map(torch.zeros_like, t)
                         for t in (state.master, state.m, state.v))))
    (p2, s2), _ = restore(root, like)
    assert isinstance(s2, AdamWState) and int(s2.step) == 1
    for a, b in zip(tree_leaves((params, state)), tree_leaves((p2, s2))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_stream_shapes_match_port():
    """Same config, same shapes and dtypes (the streams themselves differ:
    threefry there, Philox here)."""
    j = JStream(JDataConfig(300, 24, 6, seed=4)).batch(2, 1, 3)
    t = SyntheticStream(DataConfig(300, 24, 6, seed=4)).batch(2, 1, 3)
    for k in ("tokens", "labels"):
        assert np.asarray(j[k]).shape == t[k].shape
        assert np.asarray(j[k]).dtype == t[k].dtype
