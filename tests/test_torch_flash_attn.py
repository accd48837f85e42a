"""The ``flash_attn`` module (``repro_torch.kernels.flash_attn``) against
the JAX reference, on the CPU.

The CUDA kernel runs on the card only (``tests/test_torch_cuda.py``); here
its plain version ``flash_attention_torch`` — what the public
``flash_attention`` runs for CPU tensors — is held against the JAX Pallas
kernel run as its own tests run it (``interpret=True``), on the small
shapes of ``tests/test_flash_attn.py`` plus GQA, a sliding window and
sequence lengths that are not multiples of 8, within that file's bounds:
f32 3e-6, bf16 2e-2.  Inputs come from numpy with a fixed seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ops import flash_attention as j_flash
from repro_torch.convert import to_torch
from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                flash_attention_torch)

ATOL = {"f32": 3e-6, "bf16": 2e-2}
CASES = [  # b, s, h, kv, hd, window
    (2, 8, 4, 2, 32, 0), (2, 40, 4, 2, 32, 0), (1, 37, 8, 1, 16, 0),
    (1, 64, 8, 2, 64, 16), (2, 128, 4, 4, 32, 0), (1, 160, 4, 2, 32, 16)]


def _mk(b, s, h, kv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    dt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return tuple(jnp.asarray(rng.standard_normal((b, s, n, hd)), dt)
                 for n in (h, kv, kv))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}-s{}-h{}-kv{}-hd{}"
                         "-w{}".format(*c))
def test_plain_matches_interpreted_kernel(case, dtype):
    b, s, h, kv, hd, window = case
    q, k, v = _mk(b, s, h, kv, hd, dtype, seed=s + h)
    ref = j_flash(q, k, v, window=window, interpret=True)
    tq, tk, tv = (to_torch(np.asarray(a)) for a in (q, k, v))
    out = flash_attention_torch(tq, tk, tv, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=ATOL[dtype], rtol=ATOL[dtype])


def test_public_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = (to_torch(np.asarray(a)) for a in _mk(1, 24, 4, 2, 16, "bf16",
                                                    seed=0))
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=8)
    assert flash_attention.launches == before, "a CPU tensor launches nothing"
    assert torch.equal(out, flash_attention_torch(q, k, v, window=8))


def test_causal_and_window_masks():
    """Row i attends to keys (i - window, i]: a value placed only at key j
    reaches exactly the rows that may see it."""
    s, hd = 12, 4
    q = torch.zeros((1, s, 1, hd))
    k = torch.zeros((1, s, 1, hd))
    v = torch.zeros((1, s, 1, hd))
    v[0, 5, 0, 0] = 1.0
    for window, rows in ((0, range(5, s)), (3, range(5, 8))):
        out = flash_attention(q, k, v, window=window)[0, :, 0, 0]
        seen = [i for i in range(s) if out[i] > 0]
        assert seen == list(rows)
