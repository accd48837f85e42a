"""The port's CUDA kernels on the card (``cuda`` marker; skip without an
sm_90 card).  Run there with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports neither ``jax`` nor ``repro``: the machine with the card
has no JAX.  Each kernel is held against its plain PyTorch version on the
same card tensors: ``imc_mac`` bit for bit, ``paged_attn`` at the bounds of
``tests/test_paged_attn.py`` (f32 5e-6, bf16 1.6e-2 = one output ulp, int8
1e-2).  Every launch bumps the wrapper's counter exactly once.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.imc_mac.ops import imc_mac, imc_mac_torch
from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                paged_decode_torch)
from repro_torch.models.attention import _kv_quant

ATOL = {"f32": 5e-6, "bf16": 1.6e-2, "int8": 1e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA card with sm_90 (Hopper)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(4, 768, 768), (4, 768, 3072),
                                   (64, 3072, 768), (7, 100, 37),
                                   (33, 1030, 129)])
def test_imc_mac_bit_exact(hopper, m, k, n):
    g = torch.Generator(device=hopper).manual_seed(m * k + n)
    qa = torch.randint(-127, 128, (m, k), generator=g, device=hopper,
                       dtype=torch.int8)
    qw = torch.randint(-127, 128, (k, n), generator=g, device=hopper,
                       dtype=torch.int8)
    before = imc_mac.launches
    out = imc_mac(qa, qw)
    torch.cuda.synchronize()
    assert imc_mac.launches == before + 1
    assert torch.equal(out, imc_mac_torch(qa, qw))


def test_imc_mac_int32_case_and_operand_errors(hopper):
    qa = torch.full((8, 2048), 127, dtype=torch.int8, device=hopper)
    qw = torch.full((2048, 8), -127, dtype=torch.int8, device=hopper)
    out = imc_mac(qa, qw).cpu()
    assert bool((out == -127 * 127 * 2048).all())
    with pytest.raises(ValueError, match="one CUDA device"):
        imc_mac(qa, qw.cpu())
    with pytest.raises(TypeError, match="int8"):
        imc_mac(qa.to(torch.int32), qw)


def _ragged(rng, pos, mb, nb, bs):
    tbl = np.full((len(pos), mb), -1, np.int32)
    perm = iter(rng.permutation(nb))
    for i, p in enumerate(pos):
        for j in range(p // bs + 1):
            tbl[i, j] = next(perm)
    return tbl


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("geom", [(4, 12, 12, 64), (3, 16, 2, 128)])
def test_paged_attn_matches_plain(hopper, dtype, window, geom):
    """Demonstrator (MHA, hd 64) and qwen2.5-3b (rep 8, hd 128) geometries;
    ragged tables with sentinels, the last slot inactive."""
    B, H, KV, hd = geom
    bs, mb = 16, 4
    nb = B * mb
    rng = np.random.default_rng(7)
    qdt = torch.float32 if dtype == "f32" else torch.bfloat16
    pdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.tensor(rng.standard_normal((B, 1, H, hd)), dtype=qdt,
                     device=hopper)
    k = torch.tensor(rng.standard_normal((nb, bs, KV, hd)), dtype=pdt,
                     device=hopper)
    v = torch.tensor(rng.standard_normal((nb, bs, KV, hd)), dtype=pdt,
                     device=hopper)
    kw = {}
    if dtype == "int8":
        (k, ks), (v, vs) = _kv_quant(k), _kv_quant(v)
        kw = dict(k_scale=ks, v_scale=vs)
    pos = [5, 17, 40, 0][:B]
    tbl = _ragged(rng, pos, mb, nb, bs)
    tbl[B - 1] = -1
    tbl = torch.tensor(tbl, device=hopper)
    p = torch.tensor(pos, dtype=torch.int32, device=hopper)
    before = paged_attention.launches
    out = paged_attention(q, k, v, tbl, p, window=window, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_decode_torch(q, k, v, tbl, p, window=window, **kw)
    assert bool(torch.isfinite(out).all())
    assert bool((out[B - 1] == 0).all()), "an empty table flushes zeros"
    err = (out[:B - 1].float() - ref[:B - 1].float()).abs().max().item()
    assert err <= ATOL[dtype], err


def test_paged_attn_rejects_bad_operands(hopper):
    q = torch.zeros((1, 1, 2, 8), dtype=torch.bfloat16, device=hopper)
    k = torch.zeros((2, 4, 2, 8), dtype=torch.float32, device=hopper)
    tbl = torch.zeros((1, 1), dtype=torch.int32, device=hopper)
    p = torch.zeros((1,), dtype=torch.int32, device=hopper)
    with pytest.raises(TypeError):
        paged_attention(q, k, k, tbl, p)  # f32 pools need f32 queries
    with pytest.raises(ValueError, match="plain version"):
        paged_attention(q, k.bfloat16(), k.bfloat16(), tbl, p, impl="torch")
