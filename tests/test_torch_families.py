"""The seven attention-only families of the port against the JAX reference
on the CPU: gemma3-12b (5 local : 1 global, GEGLU, post-norms, hd 256 at
full width), deepseek-coder-33b, qwen2-72b (QKV bias), the MoE configs
qwen3-moe-30b-a3b and dbrx-132b, and the modality stubs
llava-next-mistral-7b (vision, sliding window) and musicgen-large (audio,
GELU), each at ``reduce_config`` widths (d_model 64, 4 heads over 2 KV
heads, hd 16, window 16, 4 experts top-2), one pattern period deep and at
least two layers, with the ``exact`` fabric.  The reference's params come
from its own ``init_params`` (biases randomised) and cross through
``params_from_jax``; batches come from the reference's own stream (frontend
embeddings included).

Compared, the reference jitted:

  * ``forward_logits``: within ``LOGIT_RTOL`` of the logits' largest
    magnitude (measured 0 on the dense and frontend configs, where every
    projection is an integer product; the MoE configs' experts are bf16
    matmuls of two libraries);
  * ``loss_and_grads``: the bounds of ``tests/test_torch_train.py`` (loss
    1e-4 relative, every gradient leaf 2e-2 relative L2; a leaf the loss
    does not read, the frontend configs' token embedding, is zero in both),
    the MoE auxiliary losses within 1e-4 relative;
  * a bucket-32 prefill of two ragged prompts (5 and 21 tokens: the longer
    one passes the reduced window of 16) from tokens or, for the frontends,
    from embeddings, merged into paged pools, then three lockstep decode
    steps of tokens through the block tables: the prefill and decode logits
    within ``LOGIT_RTOL``, the pools within ``POOL_ATOL``.

gemma3's pattern period is six blocks, and the reference runs a period as
one body of its ``jax.lax.scan``, which XLA compiles as one computation:
between blocks of one period it keeps some bf16 values in float32 (excess
precision), where the port, like the reference between periods, rounds
them.  Six blocks as one period part from the port several times farther
than the same six as one-block periods, and the exact fabric, which
requantizes every projection, widens the gap (measured on gemma3: 4.3e-2
of the largest |logit| in the forward).  So gemma3 itself is held to
``FUSED`` bounds, and its two block kinds, each as a one-block period of
two layers ("gemma3-12b:local", "gemma3-12b:attn": GEGLU, post-norms,
window, hd 16 at these widths), to the others' bounds in their forwards,
prefill and decode.

The file pins one intra-op thread.
"""
import dataclasses
import functools

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
from repro.models import kv_cache as jkv
from repro.models import model as jm
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import layers_from_groups, params_from_jax, to_torch
from repro_torch.core.fabric import FabricSpec as TSpec
from repro_torch.models import kv_cache as tkv
from repro_torch.models import model as tm
from repro_torch.models.common import count_params

FAMILIES = ("gemma3-12b", "deepseek-coder-33b", "qwen2-72b",
            "qwen3-moe-30b-a3b", "dbrx-132b", "llava-next-mistral-7b",
            "musicgen-large")
PERIOD1 = ("gemma3-12b:local", "gemma3-12b:attn")  # forwards only
LOGIT_RTOL = 1e-2
POOL_ATOL = 2 ** -6  # one bf16 ulp at |k|, |v| ~ 2
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-2
AUX_RTOL = 1e-4
# gemma3's six-block period (module docstring): logits within 6e-2 and
# pools within 1e-1 of their largest magnitude, the loss 3e-4 relative,
# gradient leaves 1.2e-1 relative L2 (measured 4.3e-2, 5.4e-2 in the sixth
# layer, 1.35e-4 and 8.2e-2)
FUSED = {"logit": 6e-2, "loss": 3e-4, "grad": 1.2e-1, "pool": 1e-1}
B, S = 2, 32
SLOTS, NB, BS, MB, BUCKET = 3, 16, 8, 5, 32
LENGTHS = (5, 21)  # slot 2 stays inactive


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(family):
    """The reduced configs of ``family``: an arch name, or ``arch:kind``
    for that arch with the one block kind as its period."""
    name, _, kind = family.partition(":")
    kw = {"pattern": (kind,)} if kind else {}
    base = jreduce(jget(name), **kw)
    kw["n_layers"] = max(2, base.n_layers)
    jc = dataclasses.replace(jreduce(jget(name), **kw), fabric=JSpec())
    tc = dataclasses.replace(treduce(tget(name), **kw), fabric=TSpec())
    return jc, tc


def _tol(jc, what: str) -> float:
    if len(jc.pattern) > 1:
        return FUSED[what]
    return {"logit": LOGIT_RTOL, "loss": LOSS_RTOL, "grad": GRAD_RTOL,
            "pool": POOL_ATOL}[what]


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


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}/{i}")
    else:
        yield pre, tree


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(ref, out, rtol, what):
    ref, out = _f32(ref), out.float().numpy()
    err = float(np.max(np.abs(ref - out)))
    assert err <= rtol * float(np.max(np.abs(ref))), (what, err)


@functools.lru_cache(maxsize=None)
def _family(name):
    jc, tc = _configs(name)
    jp, tp = _params(jc, tc)
    return jc, tc, jp, tp


@pytest.mark.parametrize("name", FAMILIES)
def test_configs_and_params_are_the_references(name):
    jc, tc, jp, tp = _family(name)
    full_j, full_t = jget(jc.name[:-len("-smoke")]), \
        tget(tc.name[:-len("-smoke")])
    skip = ("attn_impl", "fabric")  # each package's own words and types
    assert {k: v for k, v in dataclasses.asdict(full_t).items()
            if k not in skip} == {k: v for k, v in dataclasses.asdict(
                full_j).items() if k not in skip}
    assert full_t.n_params() == full_j.n_params()
    assert full_t.n_active_params() == full_j.n_active_params()
    assert count_params(tp) == sum(x.size for x in jax.tree.leaves(jp))
    assert count_params(tm.init_params(tc, device="cpu")) == count_params(tp)
    for (path, a), (_, b) in zip(
            _paths(params_from_jax(jax.tree.map(np.asarray, jp), tc)),
            _paths(tm.init_params(tc, device="cpu"))):
        assert a.dtype == b.dtype and a.shape == b.shape, path


@pytest.mark.parametrize("name", FAMILIES + PERIOD1)
def test_forward_logits(name):
    jc, tc, jp, tp = _family(name)
    nb, tb = _batch(jc)
    nb.pop("labels")
    tb.pop("labels")
    ref = jax.jit(lambda p, b: jm.forward_logits(p, b, jc))(jp, nb)
    out = tm.forward_logits(tp, tb, tc)
    assert out.shape == (B, S, jc.vocab_size)
    _close(ref, out, _tol(jc, "logit"), "forward logits")


def _batch(jc):
    """The reference's own stream, as numpy, for both packages."""
    fd = jc.frontend_dim if jc.frontend != "none" else 0
    b = JStream(JDataConfig(jc.vocab_size, S, B, seed=3,
                            frontend_dim=fd)).batch(0)
    nb = {k: np.asarray(v) for k, v in b.items()}
    return nb, {k: to_torch(v) for k, v in nb.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads(name):
    jc, tc, jp, tp = _family(name)
    nb, tb = _batch(jc)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, jc), has_aux=True))(jp, nb)
    tl, tmet, tg = tm.loss_and_grads(tp, tb, tc)
    assert abs(float(tl) - float(jl)) <= _tol(jc, "loss") * abs(float(jl))
    assert set(tmet) == set(jmet)
    for k in jmet:
        tol = AUX_RTOL if k.endswith("_loss") else _tol(jc, "loss")
        assert abs(float(tmet[k]) - float(jmet[k])) <= \
            tol * abs(float(jmet[k])), k
    ref = dict(_paths(params_from_jax(jax.tree.map(np.asarray, jg), tc)))
    params = dict(_paths(tp))
    for path, g in _paths(tg):
        a = ref[path].double()
        assert g.dtype == params[path].dtype and g.shape == a.shape, path
        if path.endswith("attn/wk/b"):  # zero in exact arithmetic
            qn = ref[path.replace("wk/b", "wq/b")].double().norm()
            assert float((a - g.double()).norm()) <= \
                _tol(jc, "grad") * float(qn)
            continue
        if float(a.norm()) == 0:  # a leaf the loss does not read
            assert not g.any(), path
            continue
        rel = float((a - g.double()).norm() / a.norm())
        assert rel <= _tol(jc, "grad"), (path, rel)


def _prompt_batch(jc, rng, n):
    """A right-padded bucket of one prompt: tokens, or for a frontend its
    embeddings (bf16 values)."""
    if jc.frontend != "none":
        x = np.zeros((1, BUCKET, jc.frontend_dim), np.float32)
        x[0, :n] = rng.standard_normal((n, jc.frontend_dim))
        emb = np.asarray(jnp.asarray(x, jnp.bfloat16))
        return {"embeddings": emb}
    toks = np.zeros((1, BUCKET), np.int32)
    toks[0, :n] = rng.integers(0, jc.vocab_size, n)
    return {"tokens": toks}


@pytest.mark.parametrize("name", FAMILIES + PERIOD1)
def test_prefill_and_paged_decode(name):
    jc, tc, jp, tp = _family(name)
    rng = np.random.default_rng(1)
    j_prefill = jax.jit(lambda p, b: jm.prefill(p, b, jc))
    j_decode = jax.jit(lambda p, c, t, bt: jm.decode_step(p, c, t, jc,
                                                          block_table=bt))
    alloc = jkv.BlockAllocator(NB, BS, SLOTS, max_blocks_per_slot=MB)
    jcache = tcache = None
    with torch.inference_mode():
        for slot, n in enumerate(LENGTHS):
            nb = _prompt_batch(jc, rng, n)
            alloc.alloc(slot, alloc.blocks_for(n + 4))
            jl, j1 = j_prefill(jp, dict(
                {k: jnp.asarray(v) for k, v in nb.items()},
                length=jnp.asarray(n, jnp.int32)))
            tl, t1 = tm.prefill(tp, dict(
                {k: to_torch(v) for k, v in nb.items()}, length=n), tc)
            _close(jl, tl, _tol(jc, "logit"), f"prefill logits, slot {slot}")
            if jcache is None:
                jcache = jkv.init_paged_cache(j1, SLOTS, NB, BS)
                tcache = tkv.init_paged_cache(t1, SLOTS, NB, BS)
            row = alloc.table_row(slot)
            jcache = jkv.merge_prefill_cache(jcache, j1, jnp.asarray(row),
                                             jnp.asarray(slot, jnp.int32))
            tkv.merge_prefill_cache(tcache, t1, torch.from_numpy(row), slot)
        tbl = alloc.table()
        active = len(LENGTHS)
        for _ in range(3):
            tok = rng.integers(0, jc.vocab_size, (SLOTS, 1)).astype(np.int32)
            jl, jcache = j_decode(jp, jcache, jnp.asarray(tok),
                                  jnp.asarray(tbl))
            tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok), tc,
                                        block_table=torch.from_numpy(tbl))
            _close(np.asarray(jl)[:active], tl[:active], _tol(jc, "logit"),
                   "decode logits")
    for a, b in zip(layers_from_groups(jcache.groups, jcache.tail, jc),
                    tcache.layers):
        for fa, fb in zip(a, b):
            if fa is not None:
                ref = _f32(fa)
                err = float(np.max(np.abs(ref - fb.float().numpy())))
                scale = float(np.max(np.abs(ref))) if len(jc.pattern) > 1 \
                    else 1.0
                assert err <= _tol(jc, "pool") * scale, err
    np.testing.assert_array_equal(np.asarray(jcache.pos), tcache.pos.numpy())
