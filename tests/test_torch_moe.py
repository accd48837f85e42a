"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference (``repro.models.moe.apply_moe``) on the CPU.

Given equal router logits (the reference's router ``dense`` is patched to
return them, the port's routing is fed the same array), the routing is held
bit for bit: the softmax probabilities, ``gate_idx`` (``jax.lax.top_k``,
captured), the slot table (read from the reference's gathered expert
inputs: each token's row carries its index) and the gate table (read
through the float32 combine's gated rows, ``expert_out * gate``), drops
included, and exact ties.  The combine is held bit for bit with k = 4
contributions per token in bf16 (so the order of the adds shows), on the
reference's own expert outputs.  Then the whole layer, both packages on the
same weights and inputs (the reference jitted): ``y`` within one bf16 ulp
of its magnitude (``Y_ATOL``; the expert GEMMs are bf16 matmuls of two
libraries), the auxiliary losses within 1e-5 relative.

The file pins one intra-op thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.convert import tree_to_torch
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

Y_ATOL = 2 ** -7  # one bf16 ulp at |y| ~ 1
AUX_RTOL = 1e-5


def _index_rows(t: int, d: int) -> np.ndarray:
    """Token rows that name their token: row t holds t // 64 + 1 and
    t % 64 + 1 in its first two entries (exact in bf16); the padding row of
    zeros names none."""
    x = np.zeros((t, d), np.float32)
    x[:, 0] = np.arange(t) // 64 + 1
    x[:, 1] = np.arange(t) % 64 + 1
    return x


def _table_from_rows(rows: np.ndarray, t: int) -> np.ndarray:
    """The slot table from the gathered rows (zeros -> the sentinel t)."""
    a, b = rows[:, 0].astype(np.int64), rows[:, 1].astype(np.int64)
    return np.where(a == 0, t, (a - 1) * 64 + (b - 1))


def _params(rng, d, f, e, kind="swiglu"):
    p = {"router": {"w": rng.standard_normal((d, e)).astype(np.float32)},
         "w_up": rng.standard_normal((e, d, f)).astype(np.float32) * d ** -.5,
         "w_down": rng.standard_normal((e, f, d)).astype(np.float32) * f ** -.5}
    if kind != "gelu":
        p["w_gate"] = (rng.standard_normal((e, d, f)).astype(np.float32)
                       * d ** -.5)
    return {k: (v if k == "router" else
                np.asarray(jnp.asarray(v, jnp.bfloat16)))
            for k, v in p.items()}


def _reference(monkeypatch, params, x, logits, *, e, k, cap=None,
               combine=jnp.bfloat16, kind="swiglu"):
    """The reference's layer, eagerly, with its router returning ``logits``;
    returns (y, aux, top_k's operand and outputs, every ``shard_hint``
    value by call)."""
    rec = {"hints": []}
    top_k = jax.lax.top_k

    def recorded_top_k(operand, kk):
        out = top_k(operand, kk)
        rec["top_k"] = (operand,) + tuple(out)
        return out

    monkeypatch.setattr(jmoe, "dense", lambda p, v: jnp.asarray(logits))
    monkeypatch.setattr(jax.lax, "top_k", recorded_top_k)
    monkeypatch.setattr(jmoe, "shard_hint",
                        lambda v, name: rec["hints"].append((name, v)) or v)
    if cap is not None:
        monkeypatch.setattr(jmoe, "moe_capacity", lambda *a: cap)
    y, aux = jmoe.apply_moe(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x, jnp.bfloat16)[None], n_experts=e,
                            top_k=k, combine_dtype=combine, kind=kind)
    return y, aux, rec


def _ties(rng, t, e):
    """Logits drawn from three values: whole rows of equal probabilities."""
    return rng.integers(0, 3, (t, e)).astype(np.float32)


def _skewed(rng, t, e):
    """Logits that send most tokens to experts 0 and 1 (they overflow)."""
    x = rng.standard_normal((t, e)).astype(np.float32)
    x[:, :2] += 4.0
    return x


# (tokens, experts, top_k, capacity or None for moe_capacity's, logits)
CASES = {
    "e4k2": (24, 4, 2, None, lambda r, t, e: r.standard_normal(
        (t, e)).astype(np.float32)),
    "e16k4-ties": (40, 16, 4, None, _ties),
    "e8k4-cap3": (24, 8, 4, 3, lambda r, t, e: r.standard_normal(
        (t, e)).astype(np.float32)),
    "e8k2-skew-overflow": (320, 8, 2, None, _skewed),
    "e128k8": (16, 128, 8, None, lambda r, t, e: 3 * r.standard_normal(
        (t, e)).astype(np.float32)),
    "e64k8-ties-cap5": (12, 64, 8, 5, _ties),
}


@pytest.mark.parametrize("combine", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_routing_and_combine_bit_exact(monkeypatch, case, combine):
    t, e, k, cap, make_logits = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    d, f = 8, 16
    logits = make_logits(rng, t, e)
    params = _params(rng, d, f, e)
    x = _index_rows(t, d)
    jdt = jnp.bfloat16 if combine == "bf16" else jnp.float32
    tdt = torch.bfloat16 if combine == "bf16" else torch.float32
    _, _, rec = _reference(monkeypatch, params, x, logits, e=e, k=k, cap=cap,
                           combine=jdt)
    hints = rec["hints"]
    names = [n for n, _ in hints]
    assert names == ["tokens", "expert_flat", "expert", "expert",
                     "expert_flat", "tokens"], names
    j_probs, j_vals, j_idx = (np.asarray(a) for a in rec["top_k"])
    j_table = _table_from_rows(np.asarray(hints[1][1], np.float32), t)
    j_out, j_contrib, j_y = (hints[i][1] for i in (3, 4, 5))
    c = cap if cap is not None else jmoe.moe_capacity(t, e, k, 1.25)

    probs = tmoe.router_probs(torch.from_numpy(logits))
    np.testing.assert_array_equal(probs.numpy(), j_probs)
    r = tmoe.route(probs, k, c)
    np.testing.assert_array_equal(r.gate_idx.numpy(), j_idx)
    np.testing.assert_array_equal(r.table.numpy(), j_table)
    if case.endswith("overflow") or "cap" in case:  # something dropped
        assert (r.addr == e * c).any()
        assert int((r.table < t).sum()) < t * k
    if "ties" in case:  # equal probabilities among the chosen
        assert (j_vals[:, :-1] == j_vals[:, 1:]).any()
    out = tree_to_torch(np.asarray(j_out.astype(jnp.float32))).to(
        torch.bfloat16)
    contrib = tmoe.contributions(out, r.gate_table, tdt)
    np.testing.assert_array_equal(contrib.float().numpy(),
                                  np.asarray(j_contrib.astype(jnp.float32)))
    y = tmoe.combine(contrib, r.addr)
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(j_y.astype(jnp.float32))[:t])


def test_combine_order_matters_here(monkeypatch):
    """The bf16 combine's inputs of the e16k4 case: adding each token's
    four rows in another order (reversed) changes some sums, so the bit
    equality above fixes the order."""
    t, e, k, _, make_logits = CASES["e16k4-ties"]
    rng = np.random.default_rng(5)
    logits = make_logits(rng, t, e)
    params = _params(rng, 8, 16, e)
    _, _, rec = _reference(monkeypatch, params, _index_rows(t, 8), logits,
                           e=e, k=k)
    r = tmoe.route(tmoe.router_probs(torch.from_numpy(logits)), k,
                   jmoe.moe_capacity(t, e, k, 1.25))
    contrib = tree_to_torch(np.asarray(
        rec["hints"][4][1].astype(jnp.float32))).to(torch.bfloat16)
    y = tmoe.combine(contrib, r.addr)
    flipped = tmoe.combine(contrib, r.addr.flip(1))
    assert torch.equal(y.float(), torch.from_numpy(np.array(
        rec["hints"][5][1].astype(jnp.float32))[:t]))
    assert not torch.equal(y, flipped)


def test_ties_resolve_to_the_lower_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.2, 0.3, 0.2]])
    vals, idx = tmoe.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(idx.numpy(), [[0, 1], [1, 3], [0, 2]])
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n", [4, 16, 31, 32, 64, 128, 256])
def test_xla_sum_order(n):
    """The softmax's denominator: XLA's CPU sum over the last dim, bit for
    bit."""
    x = np.random.default_rng(n).standard_normal((512, n)).astype(
        np.float32) ** 2
    ref = np.asarray(jax.jit(lambda a: jnp.sum(a, -1))(jnp.asarray(x)))
    np.testing.assert_array_equal(tmoe.xla_sum(torch.from_numpy(x)).numpy(),
                                  ref)


@pytest.mark.parametrize("kind,e,k,t", [("swiglu", 4, 2, 48),
                                        ("swiglu", 16, 4, 40),
                                        ("gelu", 8, 2, 32)])
def test_apply_moe_within_bounds(kind, e, k, t):
    """The whole layer on the same weights and inputs, the reference
    jitted: y within ``Y_ATOL``, aux within ``AUX_RTOL``."""
    rng = np.random.default_rng(e * 100 + k)
    d, f = 32, 48
    params = _params(rng, d, f, e, kind)
    params["router"]["w"] *= 0.3
    x = rng.standard_normal((2, t // 2, d)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jy, jaux = jax.jit(lambda p, v: jmoe.apply_moe(
        p, v, n_experts=e, top_k=k, kind=kind))(
            jax.tree.map(jnp.asarray, params), jx)
    ty, taux = tmoe.apply_moe(tree_to_torch(params),
                              tree_to_torch(np.asarray(jx)), n_experts=e,
                              top_k=k, kind=kind)
    assert ty.dtype == torch.bfloat16 and ty.shape == (2, t // 2, d)
    err = np.max(np.abs(np.asarray(jy.astype(jnp.float32))
                        - ty.float().numpy()))
    assert err <= Y_ATOL * max(1.0, float(np.max(np.abs(np.asarray(
        jy.astype(jnp.float32)))))), err
    for name in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=AUX_RTOL)


def test_moe_capacity_is_the_reference():
    for args in [(4, 128, 8, 1.25), (64, 128, 8, 1.25), (16, 16, 4, 1.25),
                 (2048, 16, 4, 1.25), (3, 4, 2, 0.5), (1000, 8, 2, 2.0)]:
        assert tmoe.moe_capacity(*args) == jmoe.moe_capacity(*args)
    assert tmoe.moe_capacity(4, 128, 8, 1.25) == 8  # qwen3-moe decode
    assert tmoe.moe_capacity(64, 128, 8, 1.25) == 128  # bucket 64


def test_no_host_sync_ops():
    """The layer's source calls none of the ops whose output shape comes
    from the data (a host sync on the card)."""
    import inspect

    src = inspect.getsource(tmoe).split('"""', 2)[2]  # past the docstring
    src = "\n".join(line.split("#")[0] for line in src.splitlines())
    for bad in ("bincount", ".item(", "nonzero", "masked_select",
                "torch.unique", ".tolist("):
        assert bad not in src, bad
