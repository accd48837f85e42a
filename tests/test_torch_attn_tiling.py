"""The decompositions of the two Hopper attention kernels, emulated in
plain torch on the CPU (no card needed).

``csrc/flash_attn.cu``'s tensor-core kernel (bf16, hd % 16 == 0, hd <= 128):
each warp owns 16 query rows; key tiles of 32 are skipped when they lie
wholly past the warp's last row or wholly left of its window; scores,
masks and the online softmax stay in f32; P.V is two bf16 products,
``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``, into one f32 accumulator.

``csrc/paged_attn.cu``'s split kernel: one block per (slot, kv head) of 4
warps; warp w walks table blocks w, w + 4, ...; inside a warp, groups of
``L = hd / E`` lanes (E elements of one 16-byte load, 8 bytes for int8)
each take rows g, g + G, ... (``G = 32 / L``) of a table block, one
online-softmax state per group; the groups merge by a butterfly, then the
warps through shared memory, by the log-sum-exp rule: weight
``exp(m - M)`` for a split that saw a key, 0 for an empty one (m = -inf,
l = 0), and ``acc / max(sum(weight * l), 1e-30)``.

At hd 256 the tensor-core flash kernel puts two warps on each 16 query
rows: each computes the whole S tile (Q read from shared memory at each k16
step) and keeps the online softmax and the output of its half of hd; the
pair's m and l are equal, so the halves need no exchange.

``csrc/paged_attn.cu``'s context-split kernel (rep 9-16, bf16 queries over
bf16 or int8 pools, hd 256 served): a slot's span is cut into
``ctx_chunks(MB, bs)`` chunks of 64 keys, fixed by the table's shape and
never by pos; a chunk with no visible key writes the empty partial
(m = -inf, l = 0; its acc is never read, emulated here as NaN); otherwise
the rep query heads are one m16 tile, zero-padded past rep, S = Q K^T is the
sum of four warps' partials over the 16-dim groups w, w + 4, ... of hd,
taken in one order; int8 scales: k_scale on each score column, v_scale on
P's column before the P_hi + P_lo split, l summing P before it; one pass of
softmax per chunk; the merge launch combines a slot's partials by the
log-sum-exp rule, skipping l = 0.

Both are held against the plain versions the card kernels are held to
(``flash_attention_torch``, ``paged_decode_torch``) and against the JAX
package (the Pallas flash kernel run with ``interpret=True``, as
``tests/test_torch_flash_attn.py`` runs it, and ``paged_decode_ref``) at
the card bounds: flash bf16 2e-2; paged f32 5e-6, bf16 1.6e-2, int8 1e-2.
Inputs come from numpy under fixed seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ops import flash_attention as j_flash
from repro.kernels.paged_attn.ref import paged_decode_ref
from repro_torch.convert import to_torch
from repro_torch.kernels.flash_attn.ops import flash_attention_torch
from repro_torch.kernels.paged_attn.ops import (CTX_KEYS, CTX_ROWS,
                                                ctx_chunks,
                                                paged_decode_torch)
from repro_torch.models.attention import _kv_quant

NEG_INF = -1e30
FLASH_ATOL = 2e-2
PAGED_ATOL = {"f32": 5e-6, "bf16": 1.6e-2, "int8": 1e-2}
BQ, BK = 16, 32  # query rows per warp, keys per tile
WARPS = 4  # warps per paged block
CHUNK = {torch.float32: 4, torch.bfloat16: 8, torch.int8: 8}  # E


# ------------------------------------------------------------ flash_attn
def flash_tiles(q, k, v, *, window=0, p_mode="split"):
    """The tensor-core kernel's arithmetic.  q (B, S, H, hd), k/v
    (B, S, KV, hd), bf16.  ``p_mode``: "split" (the kernel: P_hi + P_lo),
    "f32" (P kept in f32) or "hi" (P rounded to bf16 alone).  Returns the
    f32 output before its cast to bf16, and the key tiles each warp ran.
    At hd 256 (the instance ``<256, 2, 2>``) each 16-row group is a pair of
    warps, each over its half of the output's columns (:func:`_warp_pair`).
    """
    if q.shape[-1] == 256:
        return _warp_pair(q, k, v, window=window, p_mode=p_mode)
    return _flash_warp(q, k, v, window=window, p_mode=p_mode)


def _warp_pair(q, k, v, *, window, p_mode):
    """hd 256: warp ``half`` of each pair computes the whole S tile from the
    full q and k (its own online softmax) and P.V against its 128 columns
    of v.  The two warps' m and l must be equal, bit for bit: the pair
    exchanges nothing."""
    hd = q.shape[-1]
    outs, stats, tiles = [], [], None
    for half in range(2):
        cols = slice(half * hd // 2, (half + 1) * hd // 2)
        out, tiles, ml = _flash_warp(q, k, v, window=window, p_mode=p_mode,
                                     v_cols=cols)
        outs.append(out)
        stats.append(ml)
    for a, b in zip(*stats):
        assert torch.equal(a, b), "the pair's softmax statistics differ"
    return torch.cat(outs, dim=-1), tiles


def _flash_warp(q, k, v, *, window, p_mode, v_cols=None):
    """One warp's arithmetic (``v_cols``: the output columns it keeps, all
    of them when None); returns its output, the key tiles it ran and, with
    ``v_cols``, each row tile's final (m, l)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    scale = hd ** -0.5
    ml = []
    if v_cols is not None:
        v = v[..., v_cols]
    # (B, H, S, hd) in f32; bf16 values are exact in f32
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    od = vf.shape[-1]  # the output columns this warp keeps
    out = torch.zeros((b, h, s, od))
    tiles = {}
    for q0 in range(0, s, BQ):
        rows = torch.arange(q0, q0 + BQ)
        qt = torch.zeros((b, h, BQ, hd))  # rows past S load as zeros
        qt[:, :, :min(BQ, s - q0)] = qf[:, :, q0:q0 + BQ]
        m = torch.full((b, h, BQ), NEG_INF)
        l = torch.zeros((b, h, BQ))
        acc = torch.zeros((b, h, BQ, od))
        k_hi = min(s, q0 + BQ)
        k_lo = max(0, q0 - window + 1) if window else 0
        ran = []
        for j0 in range(0, s, BK):
            if j0 >= k_hi or j0 + BK <= k_lo:
                continue  # wholly past the last row or left of the window
            ran.append(j0)
            keys = torch.arange(j0, j0 + BK)
            kt = torch.zeros((b, h, BK, hd))
            vt = torch.zeros((b, h, BK, od))
            n = min(BK, s - j0)
            kt[:, :, :n] = kf[:, :, j0:j0 + n]
            vt[:, :, :n] = vf[:, :, j0:j0 + n]
            sc = (qt @ kt.transpose(-1, -2)) * scale
            mask = (keys[None] <= rows[:, None]) & (keys < s)[None]
            if window:
                mask &= keys[None] > rows[:, None] - window
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
            l = alpha * l + p.sum(-1)
            if p_mode == "f32":
                pv = p @ vt
            else:
                p_hi = p.to(torch.bfloat16).float()
                pv = p_hi @ vt
                if p_mode == "split":
                    pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vt
            acc = alpha[..., None] * acc + pv
            m = m_new
        tiles[q0] = ran
        ml += [m, l]
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, :, q0:q0 + BQ] = o[:, :, :min(BQ, s - q0)]
    if v_cols is None:
        return out.transpose(1, 2), tiles
    return out.transpose(1, 2), tiles, ml


FLASH_CASES = [  # b, s, h, kv, hd, window: tests/test_torch_flash_attn.py's
    (2, 8, 4, 2, 32, 0), (2, 40, 4, 2, 32, 0), (1, 37, 8, 1, 16, 0),
    (1, 64, 8, 2, 64, 16), (2, 128, 4, 4, 32, 0), (1, 160, 4, 2, 32, 16),
    # and S in {1, 15, 17, 130}, hd 128
    (1, 1, 4, 2, 64, 0), (1, 15, 4, 4, 64, 0), (2, 17, 4, 1, 64, 16),
    (1, 130, 4, 2, 128, 0), (1, 130, 4, 4, 128, 40), (1, 64, 12, 12, 64, 0),
    # hd 256, the warp pairs: gemma3-12b's rep 2 and recurrentgemma-9b's
    # rep 16 (and rep 12), windows across tiles and rows past S
    (1, 64, 16, 8, 256, 0), (1, 100, 16, 1, 256, 0), (2, 17, 12, 1, 256, 16),
    (1, 130, 16, 1, 256, 40)]


def _flash_inputs(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.standard_normal((b, s, n, hd)),
                             jnp.bfloat16) for n in (h, kv, kv))


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "b{}-s{}-h{}-kv{}-hd{}-w{}".format(*c))
def test_flash_tiles_match_plain_and_reference(case):
    b, s, h, kv, hd, window = case
    jq, jk, jv = _flash_inputs(b, s, h, kv, hd, seed=s + hd + window)
    q, k, v = (to_torch(np.asarray(a)) for a in (jq, jk, jv))
    out, _ = flash_tiles(q, k, v, window=window)
    out = out.to(torch.bfloat16).float()
    plain = flash_attention_torch(q, k, v, window=window).float()
    ref = np.asarray(j_flash(jq, jk, jv, window=window, interpret=True),
                     np.float32)
    assert bool(torch.isfinite(out).all())
    assert (out - plain).abs().max().item() <= FLASH_ATOL
    np.testing.assert_allclose(out.numpy(), ref, atol=FLASH_ATOL,
                               rtol=FLASH_ATOL)


@pytest.mark.parametrize("h", [12, 16], ids=["rep12", "rep16"])
def test_flash_hd256_past_a_window_of_2048(h):
    """recurrentgemma-9b's prefill geometry past its window: S 2100 under
    window 2048 at rep 12 and 16, hd 256, against the plain version (the
    interpreted Pallas kernel at this length takes minutes); the last row
    tile skips key tile 0 (keys 0-31 < 2099 - 2048 + 1)."""
    q, k, v = (to_torch(np.asarray(a)) for a in _flash_inputs(
        1, 2100, h, 1, 256, seed=h))
    out, tiles = flash_tiles(q, k, v, window=2048)
    out = out.to(torch.bfloat16).float()
    plain = flash_attention_torch(q, k, v, window=2048).float()
    assert bool(torch.isfinite(out).all())
    assert (out - plain).abs().max().item() <= FLASH_ATOL
    assert tiles[2096][0] == 32 and tiles[0] == [0]


def test_flash_tile_skipping():
    """At S = 64 the warp of rows 0-15 runs only key tile 0; with a window
    of 16 the warp of rows 48-63 skips tile 0 (keys 0-31 < 48 - 16 + 1)."""
    q, k, v = (torch.zeros((1, 64, 1, 16), dtype=torch.bfloat16)
               for _ in range(3))
    _, tiles = flash_tiles(q, k, v)
    assert tiles == {0: [0], 16: [0], 32: [0, 32], 48: [0, 32]}
    _, tiles = flash_tiles(q, k, v, window=16)
    assert tiles == {0: [0], 16: [0], 32: [0, 32], 48: [32]}


def test_flash_two_term_p_keeps_f32_accuracy():
    """Why P is split: before the cast to bf16, the two-term product stays
    within 1e-5 of the f32-P product; rounding P alone to bf16 lands at
    least 10x further away."""
    q, k, v = (to_torch(np.asarray(a)) for a in _flash_inputs(
        1, 130, 4, 2, 128, seed=3))
    exact, _ = flash_tiles(q, k, v, p_mode="f32")
    split, _ = flash_tiles(q, k, v, p_mode="split")
    hi, _ = flash_tiles(q, k, v, p_mode="hi")
    e_split = (split - exact).abs().max().item()
    e_hi = (hi - exact).abs().max().item()
    assert e_split <= 1e-5, e_split
    assert e_hi >= 10 * e_split, (e_hi, e_split)


# ------------------------------------------------------------ paged_attn
def _merge(a, b, empty_rule=True):
    """Merge two online-softmax states (m, l, acc) by the log-sum-exp rule;
    a state that saw no key (l = 0, m = -inf) weighs 0."""
    (ma, la, acca), (mb, lb, accb) = a, b
    m = torch.maximum(ma, mb)
    ea, eb = torch.exp(ma - m), torch.exp(mb - m)
    if empty_rule:
        ea = torch.where(la > 0, ea, 0.0)
        eb = torch.where(lb > 0, eb, 0.0)
    return (m, ea * la + eb * lb, ea[:, None] * acca + eb[:, None] * accb)


def _tree(states, empty_rule):
    """The butterfly over xor distances 1, 2, 4, ...: (0,1), (2,3), then
    their merges."""
    while len(states) > 1:
        states = [_merge(states[i], states[i + 1], empty_rule)
                  for i in range(0, len(states), 2)]
    return states[0]


def paged_splits(q, k_pool, v_pool, tbl, pos, *, k_scale=None, v_scale=None,
                 window=0, empty_rule=True):
    """The split kernel's arithmetic.  q (B, 1, H, hd); pools
    (NB, bs, KV, hd); tbl (B, MB) with -1 sentinels; pos (B,).  Returns
    (B, 1, H, hd) in q's dtype."""
    b_, _, h, hd = q.shape
    nb, bs, kv, _ = k_pool.shape
    rep, mb = h // kv, tbl.shape[1]
    lanes = hd // CHUNK[k_pool.dtype]  # lanes per key row
    groups = 32 // lanes
    assert lanes * CHUNK[k_pool.dtype] == hd and groups * lanes == 32
    scale = hd ** -0.5
    kf = k_pool.reshape(nb * bs, kv, hd).float()
    vf = v_pool.reshape(nb * bs, kv, hd).float()
    if k_scale is not None:  # int8 rows dequantize in f32
        kf = kf * k_scale.reshape(nb * bs, kv, 1).float()
        vf = vf * v_scale.reshape(nb * bs, kv, 1).float()
    out = torch.zeros((b_, kv, rep, hd))
    for b in range(b_):
        p = int(pos[b])
        for kvh in range(kv):
            qg = q[b, 0, kvh * rep:(kvh + 1) * rep].float()
            warps = []
            for w in range(WARPS):
                states = []
                for g in range(groups):
                    m = torch.full((rep,), -torch.inf)
                    l = torch.zeros(rep)
                    acc = torch.zeros((rep, hd))
                    for j in range(w, mb, WARPS):
                        entry, base = int(tbl[b, j]), j * bs
                        if entry < 0 or base > p or \
                                (window and base + bs <= p - window):
                            continue  # the whole block is skipped
                        for t in range(g, bs, groups):
                            ctx = base + t
                            if ctx > p or (window and ctx <= p - window):
                                continue
                            row = entry * bs + t
                            s = (qg @ kf[row, kvh]) * scale
                            m_new = torch.maximum(m, s)
                            alpha = torch.exp(m - m_new)
                            pr = torch.exp(s - m_new)
                            l = alpha * l + pr
                            acc = alpha[:, None] * acc + \
                                pr[:, None] * vf[row, kvh][None]
                            m = m_new
                    states.append((m, l, acc))
                warps.append(_tree(states, empty_rule))
            m = torch.stack([s[0] for s in warps])  # (4, rep)
            l = torch.stack([s[1] for s in warps])
            acc = torch.stack([s[2] for s in warps])  # (4, rep, hd)
            mx = m.amax(0)
            e = torch.exp(m - mx)
            if empty_rule:
                e = torch.where(l > 0, e, 0.0)
            tot = (e * l).sum(0)
            out[b, kvh] = (e[..., None] * acc).sum(0) / \
                torch.clamp_min(tot, 1e-30)[:, None]
    return out.reshape(b_, 1, h, hd).to(q.dtype)


def _ragged(rng, pos, mb, nb, bs):
    tbl = np.full((len(pos), mb), -1, np.int32)
    perm = iter(rng.permutation(nb))
    for i, p in enumerate(pos):
        for j in range(p // bs + 1):
            tbl[i, j] = next(perm)
    return tbl


PAGED_CASES = {  # name: (pos, window, hole, inactive_last)
    "pos0": ((0, 40, 7), 0, False, False),
    "pos15-16-127": ((15, 16, 127), 0, False, False),
    "window16-pos100": ((100, 16, 127), 16, False, False),
    "sentinel-hole": ((40, 70, 5), 0, True, False),
    "inactive-slot": ((22, 48, 0), 0, False, True),
}


def _paged_case(name, dtype, geom, seed=0):
    pos, window, hole, inactive = PAGED_CASES[name]
    B = len(pos)
    H, KV, hd = geom
    bs, mb = 16, 8
    nb = B * mb
    rng = np.random.default_rng(seed)
    qdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    pdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    q = jnp.asarray(rng.standard_normal((B, 1, H, hd)), qdt)
    k = jnp.asarray(rng.standard_normal((nb, bs, KV, hd)), pdt)
    v = jnp.asarray(rng.standard_normal((nb, bs, KV, hd)), pdt)
    tbl = _ragged(rng, pos, mb, nb, bs)
    if hole:
        tbl[0, 1] = -1  # a sentinel inside slot 0's span
    if inactive:
        tbl[-1] = -1
    tq, tk, tv = (to_torch(np.asarray(a)) for a in (q, k, v))
    kw, jkw = {}, {}
    if dtype == "int8":
        (tk, ks), (tv, vs) = _kv_quant(tk), _kv_quant(tv)
        kw = dict(k_scale=ks, v_scale=vs)
        jkw = {n: jnp.asarray(t.numpy()) for n, t in kw.items()}
        k, v = jnp.asarray(tk.numpy()), jnp.asarray(tv.numpy())
    tt = torch.from_numpy(tbl)
    tp = torch.tensor(pos, dtype=torch.int32)
    ref = paged_decode_ref(q, k, v, jnp.asarray(tbl),
                           jnp.asarray(np.asarray(pos, np.int32)),
                           window=window, **jkw)
    return (tq, tk, tv, tt, tp, kw, window, inactive,
            np.asarray(ref.astype(jnp.float32)))


def _check_paged(name, dtype, geom, empty_rule=True):
    tq, tk, tv, tt, tp, kw, window, inactive, ref = _paged_case(
        name, dtype, geom)
    out = paged_splits(tq, tk, tv, tt, tp, window=window,
                       empty_rule=empty_rule, **kw)
    assert bool(torch.isfinite(out).all()), f"{name}: not finite"
    plain = paged_decode_torch(tq, tk, tv, tt, tp, window=window, **kw)
    live = slice(0, tq.shape[0] - 1 if inactive else tq.shape[0])
    if inactive:
        assert bool((out[-1] == 0).all()), "an empty table flushes zeros"
    err = (out[live].float() - plain[live].float()).abs().max().item()
    err_ref = float(np.abs(out[live].float().numpy() - ref[live]).max())
    assert err <= PAGED_ATOL[dtype], (name, err)
    assert err_ref <= PAGED_ATOL[dtype], (name, err_ref)


@pytest.mark.parametrize("geom", [(12, 12, 64), (16, 2, 128)],
                         ids=["rep1-hd64", "rep8-hd128"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", list(PAGED_CASES))
def test_paged_splits_match_plain_and_reference(name, dtype, geom):
    _check_paged(name, dtype, geom)


def test_paged_split_geometry():
    """The lane groups of the served case and of qwen2.5-3b's geometry: a
    bf16 hd-64 row is 8 lanes of one 16-byte load (4 rows per warp load),
    an f32 hd-128 row a whole warp, an int8 hd-64 row 8 lanes of 8 bytes."""
    for dt, hd, lanes in ((torch.bfloat16, 64, 8), (torch.bfloat16, 128, 16),
                          (torch.float32, 64, 16), (torch.float32, 128, 32),
                          (torch.int8, 64, 8), (torch.int8, 128, 16)):
        assert hd // CHUNK[dt] == lanes
        assert CHUNK[dt] * torch.empty((), dtype=dt).element_size() in (8, 16)


def test_paged_empty_split_rule_is_needed():
    """The mutation that weighs an empty split by exp(m - M) (here
    exp(-inf + inf) = nan) fails the named case: at pos 0 warps 1-3 and
    all but one lane group see no key."""
    with pytest.raises(AssertionError, match="pos0: not finite"):
        _check_paged("pos0", "bf16", (12, 12, 64), empty_rule=False)


# ------------------------------------------- paged_attn, context split
def paged_ctx(q, k_pool, v_pool, tbl, pos, *, k_scale=None, v_scale=None,
              window=0, chunks=None, empty_rule=True):
    """The context-split kernel and its merge.  q (B, 1, H, hd) bf16; pools
    (NB, bs, KV, hd) bf16, or int8 with (NB, bs, KV) f16 scales; tbl
    (B, MB); pos (B,).  ``chunks``: the chunk count, ``ctx_chunks(MB, bs)``
    (the kernel's) when None.  ``empty_rule=False`` is the mutation that
    weighs an empty partial by exp(m - M) in the merge.  Returns
    (B, 1, H, hd) in q's dtype and, per (slot, kv head), the chunks that
    saw a key."""
    b_, _, h, hd = q.shape
    nb, bs, kv, _ = k_pool.shape
    rep, mb = h // kv, tbl.shape[1]
    assert 9 <= rep <= CTX_ROWS and hd % 16 == 0
    c_ = ctx_chunks(mb, bs) if chunks is None else chunks
    scale = hd ** -0.5
    int8 = k_scale is not None
    kf = k_pool.reshape(nb * bs, kv, hd).float()  # bf16 or int8: exact
    vf = v_pool.reshape(nb * bs, kv, hd).float()
    if int8:
        ksf = k_scale.reshape(nb * bs, kv).float()
        vsf = v_scale.reshape(nb * bs, kv).float()
    groups = hd // 16
    out = torch.zeros((b_, kv, rep, hd))
    live = {}
    for b in range(b_):
        p = int(pos[b])
        lo = p - window + 1 if window else 0
        for kvh in range(kv):
            qt = torch.zeros((CTX_ROWS, hd))  # the m16 tile, zero past rep
            qt[:rep] = q[b, 0, kvh * rep:(kvh + 1) * rep].float()
            parts = []
            for c in range(c_):
                rows = []  # each key's flat pool row, -1 if not visible
                for t in range(CTX_KEYS):
                    cx = c * CTX_KEYS + t
                    row = -1
                    if lo <= cx <= p and cx // bs < mb and \
                            int(tbl[b, cx // bs]) >= 0:
                        row = int(tbl[b, cx // bs]) * bs + cx % bs
                    rows.append(row)
                rows = torch.tensor(rows)
                vis = rows >= 0
                if not bool(vis.any()):  # the empty partial
                    parts.append((torch.full((CTX_ROWS,), -torch.inf),
                                  torch.zeros(CTX_ROWS),
                                  torch.full((CTX_ROWS, hd), torch.nan)))
                    continue
                safe = torch.where(vis, rows, 0)
                kt = torch.where(vis[:, None], kf[safe, kvh], 0.0)
                vt = torch.where(vis[:, None], vf[safe, kvh], 0.0)
                # four warps' partials over the 16-dim groups w, w + 4, ...
                s = torch.zeros((CTX_ROWS, CTX_KEYS))
                for w in range(4):
                    dims = torch.cat([torch.arange(g * 16, g * 16 + 16)
                                      for g in range(w, groups, 4)] or
                                     [torch.zeros(0, dtype=torch.long)])
                    s = s + qt[:, dims] @ kt[:, dims].T
                kmul = torch.full((CTX_KEYS,), scale)
                if int8:
                    kmul = kmul * torch.where(vis, ksf[safe, kvh], 1.0)
                s = torch.where(vis[None], s * kmul[None], -torch.inf)
                m = s.amax(-1)
                pr = torch.where(vis[None], torch.exp(s - m[:, None]), 0.0)
                l = pr.sum(-1)
                if int8:
                    pr = pr * torch.where(vis, vsf[safe, kvh], 1.0)[None]
                p_hi = pr.to(torch.bfloat16).float()
                p_lo = (pr - p_hi).to(torch.bfloat16).float()
                parts.append((m, l, p_hi @ vt + p_lo @ vt))
            live[(b, kvh)] = [c for c, part in enumerate(parts)
                              if bool((part[1] > 0).any())]
            # the merge launch, rows past rep never stored
            m = torch.stack([x[0][:rep] for x in parts])  # (C, rep)
            l = torch.stack([x[1][:rep] for x in parts])
            mx = torch.where(l > 0, m, -torch.inf).amax(0)
            tot = torch.zeros(rep)
            o = torch.zeros((rep, hd))
            for (pm, pl, pa), lc, mc in zip(parts, l, m):
                if empty_rule and not bool((lc > 0).all()):
                    continue  # a partial with l = 0 weighs 0, acc unread
                e = torch.exp(mc - mx)
                tot = tot + e * lc
                o = o + e[:, None] * pa[:rep]
            out[b, kvh] = o / torch.clamp_min(tot, 1e-30)[:, None]
    return out.reshape(b_, 1, h, hd).to(q.dtype), live


CTX_CASES = {  # name: (pos, mb, hole, inactive_last)
    # past the window of 2048, a short slot, an empty table
    "past-window": ((2100, 700, 64, 0), 136, False, True),
    # chunk edges: keys 0, 63, 64 and 127 last
    "chunk-edges": ((0, 63, 64, 127), 9, False, False),
    # sentinels inside slot 0's span (keys 48-63, and all of chunk 1:
    # an empty partial between live ones), spans of 2 and 13 chunks
    "sentinel-hole": ((1100, 100, 813), 72, True, False),
}


def _ctx_case(name, dtype, geom, seed=0):
    pos, mb, hole, inactive = CTX_CASES[name]
    B = len(pos)
    H, KV, hd = geom
    bs = 16
    rng = np.random.default_rng(seed)
    nb = sum(p // bs + 1 for p in pos)
    pdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    q = jnp.asarray(rng.standard_normal((B, 1, H, hd)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((nb, bs, KV, hd)), pdt)
    v = jnp.asarray(rng.standard_normal((nb, bs, KV, hd)), pdt)
    tbl = _ragged(rng, pos, mb, nb, bs)
    if hole:
        tbl[0, 3] = -1  # keys 48-63 of slot 0: inside its first chunk
        tbl[0, 4:8] = -1  # keys 64-127: its second chunk, wholly
    if inactive:
        tbl[-1] = -1
    tq, tk, tv = (to_torch(np.asarray(a)) for a in (q, k, v))
    kw, jkw = {}, {}
    if dtype == "int8":
        (tk, ks), (tv, vs) = _kv_quant(tk), _kv_quant(tv)
        kw = dict(k_scale=ks, v_scale=vs)
        jkw = {n: jnp.asarray(t.numpy()) for n, t in kw.items()}
        k, v = jnp.asarray(tk.numpy()), jnp.asarray(tv.numpy())
    return tq, tk, tv, torch.from_numpy(tbl), torch.tensor(
        pos, dtype=torch.int32), kw, jkw, (q, k, v, tbl), inactive


@pytest.mark.parametrize("geom", [(24, 2, 256), (16, 1, 256)],
                         ids=["rep12-kv2", "rep16-kv1"])
@pytest.mark.parametrize("window", [0, 2048])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", list(CTX_CASES))
def test_paged_ctx_matches_plain_and_reference(name, dtype, window, geom):
    tq, tk, tv, tt, tp, kw, jkw, (q, k, v, tbl), inactive = _ctx_case(
        name, dtype, geom)
    out, live = paged_ctx(tq, tk, tv, tt, tp, window=window, **kw)
    assert bool(torch.isfinite(out).all()), f"{name}: not finite"
    plain = paged_decode_torch(tq, tk, tv, tt, tp, window=window, **kw)
    ref = np.asarray(paged_decode_ref(
        q, k, v, jnp.asarray(tbl), jnp.asarray(tp.numpy()), window=window,
        **jkw).astype(jnp.float32))
    n = tq.shape[0] - 1 if inactive else tq.shape[0]
    if inactive:
        assert bool((out[-1] == 0).all()), "an empty table flushes zeros"
        assert all(not live[(n, h)] for h in range(tk.shape[2]))
    err = (out[:n].float() - plain[:n].float()).abs().max().item()
    err_ref = float(np.abs(out[:n].float().numpy() - ref[:n]).max())
    assert err <= PAGED_ATOL[dtype], (name, err)
    assert err_ref <= PAGED_ATOL[dtype], (name, err_ref)
    # the chunks that saw a key: those of [pos - window + 1, pos] on
    # allocated entries; every other chunk is empty
    for b, p in enumerate(tp.tolist()):
        lo = max(0, p - window + 1) if window else 0
        want = [c for c in range(lo // CTX_KEYS, p // CTX_KEYS + 1)
                if any(int(tt[b, x // 16]) >= 0 for x in range(
                    max(lo, c * CTX_KEYS), min(p, c * CTX_KEYS + 63) + 1))]
        assert live[(b, 0)] == want, (b, live[(b, 0)], want)


def test_paged_ctx_chunks_fixed_by_the_table_equal_chunks_sized_to_pos():
    """The rule that lets a graph replay: C from MB alone (here 34 chunks,
    of which slot 0 uses 33) gives the output of C sized to the largest
    position, bit for bit: the chunks past every pos are empty partials
    and weigh exactly 0."""
    for dtype in ("bf16", "int8"):
        tq, tk, tv, tt, tp, kw, *_ = _ctx_case("past-window", dtype,
                                               (16, 1, 256), seed=3)
        fixed, _ = paged_ctx(tq, tk, tv, tt, tp, window=2048, **kw)
        sized = -(-(int(tp.max()) + 1) // CTX_KEYS)
        assert ctx_chunks(tt.shape[1], 16) == 34 and sized == 33
        by_pos, _ = paged_ctx(tq, tk, tv, tt, tp, window=2048, chunks=sized,
                              **kw)
        assert torch.equal(fixed, by_pos), dtype


def test_paged_ctx_empty_partial_rule_is_needed():
    """The mutation that weighs an empty partial by exp(m - M) reads its
    acc, which the kernel never writes (NaN here: the scratch is
    uninitialized), and fails the named case."""
    tq, tk, tv, tt, tp, kw, *_ = _ctx_case("chunk-edges", "bf16",
                                           (16, 1, 256))
    out, _ = paged_ctx(tq, tk, tv, tt, tp, empty_rule=False, **kw)
    assert not bool(torch.isfinite(out).all())
