"""The recurrent families of the port against the JAX reference on the CPU:
Mamba2's SSD block (``mamba2-370m``: attention-free, no MLP) and Griffin's
RG-LRU block beside local attention (``recurrentgemma-9b``: a (rglru,
rglru, local) period and a two-block tail), at ``reduce_config`` widths
(d_model 64, SSD heads of 16 with a state of 16 and chunks of 8, an LRU
width of 32, 4 heads over 1 KV head, window 16), with the ``exact`` fabric
unless a test says otherwise.  The reference's params come from its own
``init_params`` (biases randomised) and cross through ``params_from_jax``.

Bounds, each measured and stated beside its constant:

  * the SSD scan and the blocks' float32 states: within ``F32_RTOL`` of the
    largest magnitude (the einsums' and ``cumsum``'s orders of summation
    are torch's, not XLA's; XLA's CPU ``cumsum`` adds in tiles of 16);
  * block outputs, logits and pools: ``LOGIT_RTOL`` of the largest
    magnitude; loss 1e-4 relative, gradient leaves 2e-2 relative L2 (the
    bounds of ``tests/test_torch_train.py``);
  * recurrentgemma's three-block period is one body of the reference's
    ``jax.lax.scan``, which XLA compiles as one computation and which keeps
    some bf16 values in float32 between its blocks (as gemma3's period does,
    ``tests/test_torch_families.py``), so the whole config is held to
    ``FUSED`` bounds, and each of its block kinds as a one-block period of
    two layers ("recurrentgemma-9b:rglru", "recurrentgemma-9b:local") to
    the tight ones (the local kind in the forward only: its attention is
    the attention families' own, held in ``tests/test_torch_families.py``).

A bucketed prefill in the port gives the state at the prompt's length: with
the fabric off (the ``exact`` fabric quantizes each projection's input per
tensor, padding rows included, so a bucket is no exact-length prefill
there), the port's bucketed state equals the reference's exact-length
state within ``STATE_RTOL``, and the reference's own bucketed state, which
has scanned the padding, is pinned to differ from it.

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
from repro.models import rglru as jrglru
from repro.models import ssd as jssd
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import layers_from_groups, params_from_jax, to_torch
from repro_torch.core.fabric import FabricSpec as TSpec
from repro_torch.launch.server import Request, Server
from repro_torch.models import kv_cache as tkv
from repro_torch.models import model as tm
from repro_torch.models import rglru as trglru
from repro_torch.models import ssd as tssd
from repro_torch.models.common import count_params
from repro_torch.models.transformer import dense_calls
from repro_torch.optim.adamw import clip_by_global_norm
from repro_torch.telemetry import Registry
from repro_torch.tree import tree_leaves, tree_map

NAMES = ("mamba2-370m", "recurrentgemma-9b")
PERIOD1 = ("recurrentgemma-9b:rglru", "recurrentgemma-9b:local")
F32_RTOL = 1e-5  # float32 results: measured <= 7.6e-7 of the largest
LOGIT_RTOL = 1e-2  # as tests/test_torch_families.py
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-2
# an RG-LRU block's gradient leaves: XLA keeps some bf16 values of its
# backward in float32 where the port rounds each op, and the gate's
# sqrt(1 - a^2) and the scan compound it (measured 2.37e-2 in conv_w, every
# other leaf <= 1.96e-2)
RGLRU_GRAD_RTOL = 3e-2
# recurrentgemma's fused three-block period (module docstring), under the
# exact fabric: measured 8.3e-2 and 6.3e-2 of the largest |logit| in the
# forward and prefill logits, 3.1e-4 in the loss, 1.26e-1 in a leaf; with
# the fabric off, 1.2e-2 after a bucketed prefill and states 1.4e-2
# relative L2 from the exact-length ones
FUSED = {"logit": 1.2e-1, "loss": 5e-4, "grad": 1.5e-1, "pool": 1e-1,
         "state": 5e-2}
# relative L2 of a state: the port's bucketed prefill against the
# reference's exact-length one (measured <= 7.7e-7), and the least distance
# of the reference's bucketed state from it (measured >= 0.92)
STATE_RTOL = 1e-5
PADDING_MOVES = 0.1
B, S = 2, 32
SLOTS, NB, BS, MB = 3, 16, 8, 5
LENGTHS = (5, 21)  # slot 2 stays inactive
BUCKET, PROMPT = 16, 11  # the bucketed prefill against exact length
SERVE_LENGTHS = (7, 16, 33, 12, 5)
MAX_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(family, fabric=True):
    """The reduced configs of ``family``: an arch name, or ``arch:kind``
    for that arch with the one block kind as its period and no tail."""
    name, _, kind = family.partition(":")
    kw = {"pattern": (kind,), "tail": ()} if kind else {}
    base = jreduce(jget(name), **kw)
    kw["n_layers"] = max(2, base.n_layers)
    jc, tc = jreduce(jget(name), **kw), treduce(tget(name), **kw)
    if fabric:
        jc = dataclasses.replace(jc, fabric=JSpec())
        tc = dataclasses.replace(tc, fabric=TSpec())
    return jc, tc


def _tol(jc, what: str) -> float:
    if len(jc.pattern) > 1:
        return FUSED[what]
    if what == "grad" and "rglru" in jc.pattern:
        return RGLRU_GRAD_RTOL
    return {"logit": LOGIT_RTOL, "loss": LOSS_RTOL, "grad": GRAD_RTOL,
            "pool": LOGIT_RTOL, "state": STATE_RTOL}[what]


def _params(jc, tc):
    jp = jm.init_params(jax.random.key(0), jc)
    rng = np.random.default_rng(0)

    def fill_bias(path, leaf):  # zero-init biases -> random, in both trees
        if path[-1].key in ("b", "conv_b", "dt_bias"):
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.1,
                               leaf.dtype)
        return leaf

    jp = jax.tree_util.tree_map_with_path(fill_bias, jp)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tc)


@functools.lru_cache(maxsize=None)
def _family(name, fabric=True):
    jc, tc = _configs(name, fabric)
    jp, tp = _params(jc, tc)
    return jc, tc, jp, tp


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


def _err(ref, out) -> float:
    """Largest error of ``out`` relative to ``ref``'s largest magnitude."""
    ref, out = _f32(ref), out.float().numpy()
    return float(np.max(np.abs(ref - out))) / max(float(np.max(np.abs(ref))),
                                                  1e-30)


def _rel_l2(ref, out) -> float:
    ref, out = _f32(ref).astype(np.float64), np.asarray(out, np.float64)
    return float(np.linalg.norm(ref - out) / max(np.linalg.norm(ref), 1e-30))


def _close(ref, out, rtol, what):
    err = _err(ref, out)
    assert err <= rtol, (what, err)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("name", NAMES)
def test_configs_and_params_are_the_references(name):
    jc, tc, jp, tp = _family(name)
    full_j, full_t = jget(name), tget(name)
    skip = ("attn_impl", "fabric")  # each package's own words and types
    assert {k: v for k, v in dataclasses.asdict(full_t).items()
            if k not in skip} == {k: v for k, v in dataclasses.asdict(
                full_j).items() if k not in skip}
    assert full_t.n_params() == full_j.n_params()
    assert count_params(tp) == sum(x.size for x in jax.tree.leaves(jp))
    fresh = tm.init_params(tc, device="cpu")
    assert count_params(fresh) == count_params(tp)
    for (path, a), (_, b) in zip(_paths(tp), _paths(fresh)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
    # the gates of an RG-LRU block stay off the fabric: 2 calls a mamba2
    # layer, 3 + the GEGLU's 3 an rglru layer, 4 + 3 a local one
    want = {"mamba2-370m": 2 * tc.n_layers,
            "recurrentgemma-9b": 4 * 6 + 7}[name]
    assert dense_calls(tc) == want


# ------------------------------------------------------------ SSD scan
def _scan_inputs(rng, s, h0):
    bt, h, p, g, n = 2, 4, 8, 2, 16
    f32 = np.float32
    x = rng.standard_normal((bt, s, h, p)).astype(f32)
    dt = rng.uniform(0.01, 0.5, (bt, s, h)).astype(f32)
    a_neg = -rng.uniform(0.5, 4.0, (h,)).astype(f32)
    Bm = rng.standard_normal((bt, s, g, n)).astype(f32)
    Cm = rng.standard_normal((bt, s, g, n)).astype(f32)
    hi = rng.standard_normal((bt, h, p, n)).astype(f32) if h0 else None
    return x, dt, a_neg, Bm, Cm, hi


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(24, 24), (24, 8), (20, 8)])
def test_ssd_chunked_matches_reference(s, chunk, h0):
    """One chunk, three chunks (the inter-chunk recurrence), and 20 % 8 != 0
    (the fallback to one chunk); with and without a carried state."""
    args = _scan_inputs(np.random.default_rng(s + chunk + h0), s, h0)
    jy, jh = jax.jit(lambda *a: jssd._ssd_chunked(*a[:5], chunk, h0=a[5]))(
        *args)
    ty, th = tssd.ssd_chunked(*[None if a is None else torch.from_numpy(a)
                                for a in args[:5]], chunk,
                              h0=None if args[5] is None
                              else torch.from_numpy(args[5]))
    assert ty.dtype == th.dtype == torch.float32
    _close(jy, ty, F32_RTOL, "y")
    _close(jh, th, F32_RTOL, "h_last")


# ------------------------------------------------------------ the blocks
def _block_params(name, kind):
    jc, tc, jp, tp = _family(name)
    i = list(jc.pattern).index(kind)
    return jc, jax.tree.map(lambda a: a[0], jp["blocks"]["groups"][i]), \
        tp["blocks"]["layers"][i]


def _x(rng, b, s, d):
    x = jnp.asarray(rng.standard_normal((b, s, d)), jnp.bfloat16)
    return x, to_torch(np.asarray(x))


def test_ssd_forward_and_decode_match_reference():
    jc, jp, tp = _block_params("mamba2-370m", "ssd")
    kw = dict(expand=jc.ssm_expand, headdim=jc.ssm_headdim,
              state=jc.ssm_state)
    jx, tx = _x(np.random.default_rng(5), B, S, jc.d_model)
    jy, jcache = jax.jit(lambda p, x: jssd.ssd_forward(
        p, x, chunk=jc.ssd_chunk, spec=jc.imc_fabric, **kw))(jp["ssd"], jx)
    ty, tcache = tssd.ssd_forward(tp["ssd"], tx, chunk=jc.ssd_chunk,
                                  spec=TSpec(), **kw)
    _close(jy, ty, LOGIT_RTOL, "forward")
    assert tcache.conv_state.dtype == torch.bfloat16
    assert tcache.ssm_state.dtype == torch.float32
    _close(jcache.conv_state, tcache.conv_state, 0.0, "conv state")
    _close(jcache.ssm_state, tcache.ssm_state, F32_RTOL, "ssm state")
    jd, tdx = _x(np.random.default_rng(6), B, 1, jc.d_model)
    jy, jnew = jax.jit(lambda p, x, c: jssd.ssd_decode(
        p, x, c, spec=jc.imc_fabric, **kw))(jp["ssd"], jd, jcache)
    ty, tnew = tssd.ssd_decode(tp["ssd"], tdx, tcache, spec=TSpec(), **kw)
    _close(jy, ty, LOGIT_RTOL, "decode")
    _close(jnew.conv_state, tnew.conv_state, 0.0, "conv state")
    _close(jnew.ssm_state, tnew.ssm_state, F32_RTOL, "ssm state")


def test_rglru_forward_and_decode_match_reference():
    jc, jp, tp = _block_params("recurrentgemma-9b", "rglru")
    jx, tx = _x(np.random.default_rng(7), B, S, jc.d_model)
    h0 = np.random.default_rng(8).standard_normal(
        (B, jc.lru_w)).astype(np.float32)
    for carried in (None, h0):  # the carried state's virtual first step
        jy, (jh, jcs) = jax.jit(lambda p, x, h: jrglru.rglru_forward(
            p, x, h0=h, spec=jc.imc_fabric))(jp["rglru"], jx, carried)
        ty, (th, tcs) = trglru.rglru_forward(
            tp["rglru"], tx, spec=TSpec(),
            h0=None if carried is None else torch.from_numpy(carried))
        _close(jy, ty, LOGIT_RTOL, "forward")
        _close(jh, th, F32_RTOL, "h")
        _close(jcs, tcs, 0.0, "conv state")
    jd, tdx = _x(np.random.default_rng(9), B, 1, jc.d_model)
    jy, (jh2, jcs2) = jax.jit(lambda p, x, h, c: jrglru.rglru_decode(
        p, x, h, c, spec=jc.imc_fabric))(jp["rglru"], jd, jh, jcs)
    ty, (th2, tcs2) = trglru.rglru_decode(tp["rglru"], tdx, th, tcs,
                                          spec=TSpec())
    _close(jy, ty, LOGIT_RTOL, "decode")
    _close(jh2, th2, F32_RTOL, "h")
    _close(jcs2, tcs2, 0.0, "conv state")
    assert th2.dtype == torch.float32 and tcs2.dtype == torch.bfloat16


def test_associative_scan_is_the_recurrence():
    """The log-depth scan against the step-by-step recurrence, at lengths
    1 to 33 (odd and even at every level of the recursion)."""
    rng = np.random.default_rng(10)
    for n in range(1, 34):
        a = torch.from_numpy(rng.uniform(0, 1, (2, n, 3)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((2, n, 3)).astype(
            np.float32))
        _, h = trglru.associative_scan(a, b)
        want, hs = torch.zeros(2, 3), []
        for t in range(n):
            want = a[:, t] * want + b[:, t]
            hs.append(want)
        torch.testing.assert_close(h, torch.stack(hs, 1), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------- prefill, then decode
@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_equals_forward(name):
    """The port with the fabric off: the forward's logits at the last three
    positions equal a prefill of the rest and three decode steps."""
    _, tc, _, tp = _family(name, False)
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, tc.vocab_size, (B, 12)).astype(np.int32))
    full = tm.forward_logits(tp, {"tokens": toks}, tc)
    with torch.inference_mode():
        logits, cache = tm.prefill(tp, {"tokens": toks[:, :9]}, tc,
                                   max_new_tokens=3)
        steps = [logits]
        for t in range(9, 11):
            logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], tc)
            steps.append(logits)
    for i, got in enumerate(steps):
        ref = full[:, 8 + i]
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= LOGIT_RTOL, (i, err)


# ------------------------------------------------- the state at true_len
def _states(layers):
    """The recurrent layers' states, float32 numpy, in layer order."""
    out = []
    for layer in layers:
        if len(layer) == 2:  # (h, conv) or SsdCache(conv, ssm)
            out.extend(_f32(t) if not isinstance(t, torch.Tensor)
                       else t.float().numpy() for t in layer)
    return out


def _bucketed(name):
    """The reference's exact-length prefill, its bucketed prefill and the
    port's bucketed prefill of one prompt (fabric off)."""
    jc, tc, jp, tp = _family(name, False)
    toks = np.zeros((1, BUCKET), np.int32)
    toks[0, :PROMPT] = np.random.default_rng(12).integers(
        0, jc.vocab_size, PROMPT)
    pre = jax.jit(lambda p, b: jm.prefill(p, b, jc))
    exact = pre(jp, {"tokens": toks[:, :PROMPT]})
    ref_bucket = pre(jp, {"tokens": toks,
                          "length": jnp.asarray(PROMPT, jnp.int32)})
    with torch.inference_mode():
        port = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                               "length": torch.tensor(PROMPT)}, tc)
    layers = [layers_from_groups(c.groups, c.tail, jc)
              for c in (exact[1], ref_bucket[1])]
    return jc, tc, jp, tp, exact, layers, port


@pytest.mark.parametrize("name", NAMES + PERIOD1[:1])
def test_bucketed_prefill_state_is_the_exact_length_state(name):
    jc, tc, jp, tp, exact, (want, _), (logits, cache) = _bucketed(name)
    _close(exact[0], logits, _tol(jc, "logit"), "last logits")
    for ref, got in zip(_states(want), _states(cache.layers)):
        assert _rel_l2(ref, got) <= _tol(jc, "state"), _rel_l2(ref, got)
    # the next decode step from either state (unpaged)
    tok = np.array([[7]], np.int32)
    jl, _ = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, jc))(
        jp, exact[1], jnp.asarray(tok))
    with torch.inference_mode():  # position 11 lies inside the ring
        tl, _ = tm.decode_step(tp, cache, torch.from_numpy(tok), tc)
    _close(jl, tl, _tol(jc, "logit"), "next step")


@pytest.mark.parametrize("name", NAMES + PERIOD1[:1])
def test_reference_bucketed_state_absorbs_the_padding(name):
    """Pinned: the reference's own bucketed prefill scans the padding into
    every recurrent and conv state (its ``_mix`` hands ``true_len`` to
    attention only), so its state at the bucket's end differs from the
    exact-length state the port returns; the last logits agree."""
    _, _, _, _, exact, (want, ref_bucket), _ = _bucketed(name)
    dists = [_rel_l2(a, b) for a, b in zip(_states(want),
                                           _states(ref_bucket))]
    assert dists and min(dists) >= PADDING_MOVES, dists


# ------------------------------------------------- the whole model
def _batch(jc):
    b = JStream(JDataConfig(jc.vocab_size, S, B, seed=3)).batch(0)
    nb = {k: np.asarray(v) for k, v in b.items()}
    return nb, {k: to_torch(v) for k, v in nb.items()}


@pytest.mark.parametrize("name", NAMES + PERIOD1)
def test_forward_logits(name):
    jc, tc, jp, tp = _family(name)
    nb, tb = _batch(jc)
    nb.pop("labels")
    tb.pop("labels")
    ref = jax.jit(lambda p, b: jm.forward_logits(p, b, jc))(jp, nb)
    out = tm.forward_logits(tp, tb, tc)
    assert out.shape == (B, S, jc.vocab_size)
    _close(ref, out, _tol(jc, "logit"), "forward logits")


@pytest.mark.parametrize("name", NAMES + PERIOD1[:1])
def test_loss_and_grads(name):
    jc, tc, jp, tp = _family(name)
    nb, tb = _batch(jc)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, jc), has_aux=True))(jp, nb)
    tl, _, tg = tm.loss_and_grads(tp, tb, tc)
    assert abs(float(tl) - float(jl)) <= _tol(jc, "loss") * abs(float(jl))
    ref = dict(_paths(params_from_jax(jax.tree.map(np.asarray, jg), tc)))
    params = dict(_paths(tp))
    for path, g in _paths(tg):
        a = ref[path].double()
        assert g.dtype == params[path].dtype and g.shape == a.shape, path
        if float(a.norm()) == 0:
            assert not g.any(), path
            continue
        rel = float((a - g.double()).norm() / a.norm())
        assert rel <= _tol(jc, "grad"), (path, rel)


@pytest.mark.parametrize("name", NAMES + PERIOD1[:1])
def test_prefill_and_paged_decode(name):
    """Prompts of 5 and 21 tokens prefilled at their own lengths (through
    the ``length`` path, so both packages compute the same thing under the
    exact fabric), merged into paged pools beside the per-slot recurrent
    state, then three lockstep decode steps through the block tables."""
    jc, tc, jp, tp = _family(name)
    rng = np.random.default_rng(1)
    j_prefill = jax.jit(lambda p, b: jm.prefill(p, b, jc))
    j_decode = jax.jit(lambda p, c, t, bt: jm.decode_step(p, c, t, jc,
                                                          block_table=bt))
    alloc = jkv.BlockAllocator(NB, BS, SLOTS, max_blocks_per_slot=MB)
    jcache = tcache = None
    with torch.inference_mode():
        for slot, n in enumerate(LENGTHS):
            toks = rng.integers(0, jc.vocab_size, (1, n)).astype(np.int32)
            alloc.alloc(slot, alloc.blocks_for(n + 4))
            jl, j1 = j_prefill(jp, {"tokens": jnp.asarray(toks),
                                    "length": jnp.asarray(n, jnp.int32)})
            tl, t1 = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                     "length": n}, tc)
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
        assert type(b).__name__ in ("PagedAttnCache", "RgLruCache",
                                    "SsdCache")
        for fa, fb in zip(a, b):
            if fa is not None:  # the active slots' rows (or the pools)
                ref = _f32(fa)
                got = fb.float().numpy()
                if type(b).__name__ != "PagedAttnCache":
                    ref, got = ref[:active], got[:active]
                _close(ref, torch.from_numpy(got), _tol(jc, "pool"), "state")
    np.testing.assert_array_equal(np.asarray(jcache.pos), tcache.pos.numpy())


# ------------------------------------------------- the Server
def _serve(tc, tp, prompts, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("buckets", (16, 48))
    kw.setdefault("max_seq_len", 48 + MAX_NEW)
    server = Server(tc, tp, device="cpu", registry=Registry(), **kw)
    handles = [server.submit(Request(p, max_new_tokens=MAX_NEW))
               for p in prompts]
    server.drain()
    assert all(h.done and len(h.tokens) == MAX_NEW for h in handles)
    server.alloc.check()
    return server, [h.tokens for h in handles]


def _prompts(tc, lengths):
    rng = np.random.default_rng(0)
    return [rng.integers(0, tc.vocab_size, n).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("name", NAMES)
def test_server_mixed_batch_equals_each_request_alone(name):
    """Fabric off (the ``exact`` fabric quantizes a decode batch per tensor,
    so its slots meet there): the paged Server's mixed traffic, admitted and
    retired around the per-slot recurrent state, gives each request the
    stream it gets served alone; uniform 16-token prompts give the same
    streams through ``kv="ring"``."""
    _, tc, _, tp = _family(name, False)
    prompts = _prompts(tc, SERVE_LENGTHS)
    _, mixed = _serve(tc, tp, prompts)
    for p, got in zip(prompts, mixed):
        assert got == _serve(tc, tp, [p], slots=1)[1][0], len(p)
    uniform = _prompts(tc, (16, 16, 16))
    _, ring = _serve(tc, tp, uniform, kv="ring", slots=2)
    assert ring == _serve(tc, tp, uniform)[1]


@pytest.mark.parametrize("name", NAMES)
def test_server_fault_requeue_replays_identical_streams(name):
    """A crash at decode tick 1 re-prefills the in-flight requests from
    scratch, which rebuilds their recurrent state: the same streams."""
    _, tc, _, tp = _family(name)
    prompts = _prompts(tc, (7, 16, 33))
    _, baseline = _serve(tc, tp, prompts)
    crashed, streams = _serve(tc, tp, prompts, fail_at=(1,))
    assert crashed.recoveries == 1
    assert streams == baseline


# ------------------------------------------------- AdamW's clipping
def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(13)
    grads = {"a": rng.standard_normal((7, 5)).astype(np.float32),
             "b": [rng.standard_normal((11,)).astype(np.float32) * 3]}
    for max_norm in (0.5, 100.0):  # clipping, and none
        jg, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                            max_norm)
        tg, tn = clip_by_global_norm(tree_map(torch.from_numpy, grads),
                                     max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=F32_RTOL)
        for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=F32_RTOL)
