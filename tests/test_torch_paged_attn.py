"""The ``paged_attn`` kernel module (``repro_torch.kernels.paged_attn``).

On the CPU the wrapper runs the plain dense-gather version, held against
the JAX oracle ``paged_decode_ref`` at the bounds of ``tests/test_paged_attn
.py`` — f32 5e-6, bf16 1.6e-2 (one output ulp), int8 1e-2 — across MHA and
GQA, sliding windows, ragged tables with ``-1`` sentinels and an inactive
slot.  (Measured on the CPU: 0 at every case; the plain version repeats the
reference's arithmetic.)  At the layer level, ``attn_decode`` on paged pools
must write the pools bit for bit as the reference does.  The CUDA kernel
runs only on a card; its tests are in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn.ref import paged_decode_ref
from repro.models import attention as jatt
from repro_torch.convert import to_torch, tree_to_torch
from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                paged_decode_torch)
from repro_torch.models import attention as tatt

ATOL = {"f32": 5e-6, "bf16": 1.6e-2, "int8": 1e-2}
_ref = jax.jit(paged_decode_ref, static_argnames=("window",))
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _ragged(rng, pos, mb, nb, bs):
    """Dense-prefix tables covering each row's pos, -1 sentinels after."""
    tbl = np.full((len(pos), mb), -1, np.int32)
    perm = iter(rng.permutation(nb))
    for i, p in enumerate(pos):
        for j in range(p // bs + 1):
            tbl[i, j] = next(perm)
    return tbl


def _case(seed, dtype, B=3, H=4, KV=2, hd=16, bs=8, nb=14, mb=4,
          pos=(5, 17, 26)):
    rng = np.random.default_rng(seed)
    qdt = JDT["bf16" if dtype == "int8" else dtype]
    q = jnp.asarray(rng.standard_normal((B, 1, H, hd)), qdt)
    k = jnp.asarray(rng.standard_normal((nb, bs, KV, hd)),
                    jnp.float32 if dtype == "int8" else qdt)
    v = jnp.asarray(rng.standard_normal((nb, bs, KV, hd)), k.dtype)
    kw = {}
    if dtype == "int8":
        k, ks = jatt._kv_quant(k)
        v, vs = jatt._kv_quant(v)
        kw = dict(k_scale=ks, v_scale=vs)
    tbl = _ragged(rng, pos, mb, nb, bs)
    return q, k, v, jnp.asarray(tbl), jnp.asarray(np.asarray(pos, np.int32)), kw


def _torch_args(q, k, v, tbl, pos, kw, device=None):
    t = [to_torch(np.asarray(a), device) for a in (q, k, v, tbl, pos)]
    return t, {n: to_torch(np.asarray(a), device) for n, a in kw.items()}


def _err(ref, out):
    return float(np.max(np.abs(np.asarray(ref.astype(jnp.float32))
                               - out.float().cpu().numpy())))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("kv_heads", [4, 2, 1])  # H=4: MHA, GQA, MQA
def test_plain_matches_reference(dtype, window, kv_heads):
    q, k, v, tbl, pos, kw = _case(0, dtype, KV=kv_heads)
    ref = _ref(q, k, v, tbl, pos, window=window, **kw)
    (tq, tk, tv, tt, tp), tkw = _torch_args(q, k, v, tbl, pos, kw)
    before = paged_attention.launches
    out = paged_attention(tq, tk, tv, tt, tp, window=window, **tkw)
    assert paged_attention.launches == before, "a CPU tensor launches nothing"
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert _err(ref, out) <= ATOL[dtype], (dtype, window, kv_heads)


def test_inactive_slot_is_finite():
    q, k, v, tbl, pos, kw = _case(2, "f32", B=2, pos=(13, 0))
    tbl = tbl.at[1].set(-1)
    ref = _ref(q, k, v, tbl, pos)
    (tq, tk, tv, tt, tp), _ = _torch_args(q, k, v, tbl, pos, kw)
    out = paged_decode_torch(tq, tk, tv, tt, tp)
    assert bool(torch.isfinite(out).all())
    assert _err(ref[0], out[0]) <= ATOL["f32"]


def test_impl_words_dispatch_by_device():
    q, k, v, tbl, pos, kw = _case(4, "f32")
    (tq, tk, tv, tt, tp), _ = _torch_args(q, k, v, tbl, pos, kw)
    with pytest.raises(ValueError, match="impl"):
        paged_attention(tq, tk, tv, tt, tp, impl="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        paged_attention(tq, tk, tv, tt, tp, impl="cuda")
    torch.testing.assert_close(paged_attention(tq, tk, tv, tt, tp,
                                               impl="torch"),
                               paged_decode_torch(tq, tk, tv, tt, tp),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_attn_decode_paged_matches_reference(kv_dtype):
    """Through ``attn_decode`` (projections, rope, pool scatter, attention):
    pools bit-identical to the reference's, outputs within the bound."""
    rng = np.random.default_rng(6)
    d, H, KV, hd, bs, nb, mb, B = 32, 4, 2, 8, 4, 10, 3, 3
    jp = jatt.init_attention(jax.random.key(0), d, H, KV, hd)
    tp = tree_to_torch(jax.tree.map(np.asarray, jp))
    kf = jnp.asarray(rng.standard_normal((nb, bs, KV, hd)), jnp.bfloat16)
    vf = jnp.asarray(rng.standard_normal((nb, bs, KV, hd)), jnp.bfloat16)
    if kv_dtype == "int8":
        (kq, ks), (vq, vs) = jatt._kv_quant(kf), jatt._kv_quant(vf)
        jcache = jatt.PagedAttnCache(kq, vq, ks, vs)
    else:
        jcache = jatt.PagedAttnCache(kf, vf)
    tcache = tatt.PagedAttnCache(*[None if a is None else
                                   to_torch(np.asarray(a)) for a in jcache])
    pos = np.array([3, 9, 0], np.int32)
    tbl = _ragged(rng, pos, mb, nb, bs)
    tbl[2] = -1  # inactive slot: its write is dropped
    x = jnp.asarray(rng.standard_normal((B, 1, d)), jnp.bfloat16)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, rope_theta=1e4)
    y, jnew = jax.jit(lambda *a: jatt.attn_decode(*a[:4], block_table=a[4],
                                                  **kw))(
        jp, x, jcache, jnp.asarray(pos), jnp.asarray(tbl))
    yt, tnew = tatt.attn_decode(tp, to_torch(np.asarray(x)), tcache,
                                torch.from_numpy(pos),
                                block_table=torch.from_numpy(tbl), **kw)
    for a, b in zip(jnew, tnew):
        if a is not None:
            np.testing.assert_array_equal(
                np.asarray(a.astype(jnp.float32)), b.float().numpy())
    assert _err(y[:2], yt[:2]) <= ATOL["bf16"]
