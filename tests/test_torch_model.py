"""The port's model path (``repro_torch.models``) against the JAX reference.

Reduced ``imc-paper-110m`` (GELU, MHA -> GQA when reduced, untied head) and
reduced ``qwen2.5-3b`` (SwiGLU, GQA, QKV bias, tied embeddings), two layers
each, with the fabric off and in exact mode.  The reference's params come
from its own ``init_params`` and cross through ``params_from_jax``; biases
get random values so the bias path is exercised.  Compared, with the
reference called directly (``repro.models.model`` / ``repro.models
.kv_cache``; its Engine does not run on the installed jax):

  * ``prefill`` logits at a right-padded bucket (``length``) and the ring
    caches: bit-identical on the CPU (tolerance 0; measured max error 0.0).
  * paged ``decode_step`` over pools built by ``init_paged_cache`` /
    ``merge_prefill_cache``: pools bit-identical; logits within
    ``DECODE_ATOL`` = 1e-2, below one bf16 ulp at the logits' magnitude
    (measured max error 9.8e-4 on imc-paper exact, 0 elsewhere: an f32
    reassociation in the reference's compiled attention can move one int8
    code of a later projection).
  * greedy tokens, wherever the reference's top-2 margin exceeds
    ``DECODE_ATOL``.

In the paper's ``sim`` fabric (the bit-plane pyramid with the analog
decode; reference engine ``sim``/``jnp``): prefill logits and caches
bit-identical to the reference, and to the port's own ``exact`` (the
noise-free decode is exact).  With ``use_flash_kernel=True`` (the reference
runs its Pallas flash kernel in interpret mode): prefill logits within the
reference's own bound for the flash path, relative L2 error below 0.02
(``tests/test_flash_attn.py::test_flash_path_end_to_end_model``).

Also: the host-side ``BlockAllocator`` copy behaves exactly as the
reference's under a random schedule.
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
from repro.models import kv_cache as jkv
from repro.models import model as jm
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import layers_from_groups, params_from_jax
from repro_torch.core.fabric import FabricSpec as TSpec
from repro_torch.models import kv_cache as tkv
from repro_torch.models import model as tm

DECODE_ATOL = 1e-2
SLOTS, NB, BS, MB, BUCKET = 3, 12, 8, 4, 16
LENGTHS = (5, 11)  # slot 2 stays inactive


def _configs(name, fabric):
    jc = dataclasses.replace(jreduce(jget(name), n_layers=2),
                             fabric=JSpec() if fabric else None)
    tc = dataclasses.replace(treduce(tget(name), n_layers=2),
                             fabric=TSpec() if fabric else None)
    return jc, tc


def _sim_configs(name, **kw):
    jc = dataclasses.replace(jreduce(jget(name), n_layers=2),
                             fabric=JSpec(mode="sim", backend="jnp"), **kw)
    tc = dataclasses.replace(treduce(tget(name), n_layers=2),
                             fabric=TSpec(mode="sim"), **kw)
    return jc, tc


def _prefill_both(jc, tc, jp, tp, n, seed):
    toks = np.zeros((1, BUCKET), np.int32)
    toks[0, :n] = np.random.default_rng(seed).integers(0, jc.vocab_size, n)
    jl, j1 = jax.jit(lambda p, b: jm.prefill(p, b, jc))(
        jp, {"tokens": jnp.asarray(toks), "length": jnp.asarray(n, jnp.int32)})
    with torch.inference_mode():
        tl, t1 = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "length": n}, tc)
    return (np.asarray(jl), j1), (tl, t1), toks


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


def _f32(a):
    return np.asarray(a.astype(jnp.float32) if hasattr(a, "astype") else a)


def _tn(t):
    return t.float().numpy()


@pytest.fixture(scope="module", params=[
    ("imc-paper-110m", False), ("imc-paper-110m", True),
    ("qwen2.5-3b", False), ("qwen2.5-3b", True)],
    ids=lambda p: f"{p[0]}-{'exact' if p[1] else 'nofabric'}")
def served(request):
    """Prefill two ragged prompts into paged pools, then three lockstep
    decode steps, in both packages; returns everything to compare."""
    name, fabric = request.param
    jc, tc = _configs(name, fabric)
    jp, tp = _params(jc, tc)
    rng = np.random.default_rng(1)
    j_prefill = jax.jit(lambda p, b: jm.prefill(p, b, jc))
    j_decode = jax.jit(lambda p, c, t, bt: jm.decode_step(p, c, t, jc,
                                                          block_table=bt))
    alloc = jkv.BlockAllocator(NB, BS, SLOTS, max_blocks_per_slot=MB)
    out = {"cfg": (jc, tc), "prefill": [], "decode": []}
    jcache = tcache = None
    with torch.inference_mode():
        for slot, n in enumerate(LENGTHS):
            toks = np.zeros((1, BUCKET), np.int32)
            toks[0, :n] = rng.integers(0, jc.vocab_size, n)
            alloc.alloc(slot, alloc.blocks_for(n + 6))
            jl, j1 = j_prefill(jp, {"tokens": jnp.asarray(toks),
                                    "length": jnp.asarray(n, jnp.int32)})
            tl, t1 = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                     "length": n}, tc)
            out["prefill"].append((jl, tl, j1, t1))
            if jcache is None:
                jcache = jkv.init_paged_cache(j1, SLOTS, NB, BS)
                tcache = tkv.init_paged_cache(t1, SLOTS, NB, BS)
            row = alloc.table_row(slot)
            jcache = jkv.merge_prefill_cache(jcache, j1, jnp.asarray(row),
                                             jnp.asarray(slot, jnp.int32))
            tkv.merge_prefill_cache(tcache, t1, torch.from_numpy(row), slot)
        tbl = alloc.table()
        for _ in range(3):
            tok = rng.integers(0, jc.vocab_size, (SLOTS, 1)).astype(np.int32)
            jl, jcache = j_decode(jp, jcache, jnp.asarray(tok),
                                  jnp.asarray(tbl))
            tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok), tc,
                                        block_table=torch.from_numpy(tbl))
            out["decode"].append((np.asarray(jl), tl.numpy()))
    out["caches"] = (jcache, tcache)
    return out


def test_prefill_logits_and_ring_caches_bit_exact(served):
    jc, _ = served["cfg"]
    for jl, tl, j1, t1 in served["prefill"]:
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        for a, b in zip(layers_from_groups(j1.groups, j1.tail, jc), t1.layers):
            for fa, fb in zip(a, b):
                if fa is not None:
                    np.testing.assert_array_equal(_f32(fa), _tn(fb))
        assert int(j1.pos) == int(t1.pos)


def test_paged_decode_pools_and_logits(served):
    jc, _ = served["cfg"]
    jcache, tcache = served["caches"]
    for a, b in zip(layers_from_groups(jcache.groups, jcache.tail, jc),
                    tcache.layers):
        for fa, fb in zip(a, b):
            if fa is not None:
                np.testing.assert_array_equal(_f32(fa), _tn(fb))
    np.testing.assert_array_equal(np.asarray(jcache.pos), tcache.pos.numpy())
    active = len(LENGTHS)
    err = max(np.max(np.abs(jl[:active] - tl[:active]))
              for jl, tl in served["decode"])
    assert err <= DECODE_ATOL, err


def test_greedy_tokens_agree_where_the_margin_allows(served):
    rows = [(jl, tl) for jl, tl, _, _ in served["prefill"]]
    rows += [(jl[None, i], tl[None, i]) for jl, tl in served["decode"]
             for i in range(len(LENGTHS))]
    checked = 0
    for jl, tl in rows:
        jl, tl = np.asarray(jl)[0], np.asarray(tl)[0]
        top2 = np.sort(jl)[-2:]
        if top2[1] - top2[0] > DECODE_ATOL:
            assert int(np.argmax(jl)) == int(np.argmax(tl))
            checked += 1
    assert checked >= len(rows) // 2


def test_forward_logits_matches_reference():
    jc, tc = _configs("qwen2.5-3b", True)
    jp, tp = _params(jc, tc)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 16))
    ref = jm.forward_logits(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    out = tm.forward_logits(tp, {"tokens": torch.from_numpy(toks)}, tc)
    assert out.shape == (2, 16, jc.vocab_size)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


@pytest.mark.parametrize("name", ["imc-paper-110m", "qwen2.5-3b"])
def test_sim_prefill_logits_and_caches_bit_exact(name):
    jc, tc = _sim_configs(name)
    jp, tp = _params(jc, tc)
    (jl, j1), (tl, t1), toks = _prefill_both(jc, tc, jp, tp, 11, seed=4)
    np.testing.assert_array_equal(jl, tl.numpy())
    for a, b in zip(layers_from_groups(j1.groups, j1.tail, jc), t1.layers):
        for fa, fb in zip(a, b):
            if fa is not None:
                np.testing.assert_array_equal(_f32(fa), _tn(fb))
    exact = dataclasses.replace(tc, fabric=TSpec())
    with torch.inference_mode():
        el, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                "length": 11}, exact)
    assert torch.equal(tl, el), "noise-free sim must equal exact"


@pytest.mark.parametrize("name", ["imc-paper-110m", "qwen2.5-3b"])
def test_flash_prefill_logits_within_reference_bound(name):
    jc, tc = _sim_configs(name, use_flash_kernel=True)
    jp, tp = _params(jc, tc)
    (jl, _), (tl, _), _ = _prefill_both(jc, tc, jp, tp, 13, seed=5)
    tl = tl.numpy()
    rel = np.linalg.norm(jl - tl) / np.linalg.norm(jl)
    assert rel < 0.02, rel
    assert int(np.argmax(jl)) == int(np.argmax(tl))


def test_block_allocator_matches_reference_under_random_schedule():
    rng = np.random.default_rng(3)
    ja = jkv.BlockAllocator(8, 4, 3, max_blocks_per_slot=4)
    ta = tkv.BlockAllocator(8, 4, 3, max_blocks_per_slot=4)
    for _ in range(300):
        op = rng.choice(["alloc", "append", "release"])
        slot, n, reserve = (int(v) for v in rng.integers(0, [3, 4, 3]))
        results = []
        for a, exc in ((ja, jkv.OutOfBlocks), (ta, tkv.OutOfBlocks)):
            try:
                if op == "alloc":
                    results.append(a.alloc(slot, n, reserve=reserve))
                elif op == "append":
                    results.append(a.append(slot))
                else:
                    results.append(a.release(slot))
            except exc as e:
                results.append(("OutOfBlocks", str(e)))
            a.check()
        assert results[0] == results[1], op
        np.testing.assert_array_equal(ja.table(), ta.table())
        assert (ja.num_free, ja.available) == (ta.num_free, ta.available)
