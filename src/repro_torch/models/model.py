"""LM wrapper: embeddings, stack, head, serving steps (port of
``repro/models/model.py``; the loss and the modality frontends come later).

Public API:
  init_params(cfg, generator, device)       -> params dict
  forward_logits(params, batch, cfg)        -> logits (small models / tests)
  prefill(params, batch, cfg)               -> (last_logits, StackCache)
  decode_step(params, cache, token, cfg)    -> (logits, StackCache)

Under a noisy fabric spec each entry point takes ``noise_seed`` and runs its
forward inside :class:`~repro_torch.models.common.fabric_noise_seed`, as the
reference's ``launch/steps.py`` does with its per-step key.

Batches: {"tokens": (B, S) int} (+ optional "length": the true prompt
length of a right-padded bucket, an int or a 0-dim integer tensor on the
tokens' device, as a captured prefill step takes it); decode takes ``token``
(B, 1) int.  ``noise_seed`` is a 64-bit integer or a seed table (see
:mod:`repro_torch.models.common`).
The embedding lookup and the head matmul stay plain torch, as the reference
leaves them outside any kernel.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import (fabric_noise_seed, init_dense,
                                       init_rmsnorm, rmsnorm)
from repro_torch.models.transformer import (StackCache, check_supported,
                                            init_stack, stack_forward)


# -------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: DeviceLike = None, *, seed: int = 0):
    """Random params in the reference's layout and dtypes, drawn from
    ``generator`` (default: a CPU generator seeded with ``seed``).

    ``device=None`` means the card, and raises without one.
    """
    dev = resolve_device(device)
    check_supported(cfg)
    g = generator if generator is not None else \
        torch.Generator().manual_seed(seed)
    emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=g,
                      dtype=torch.float32, device=g.device) * 0.02
    params = {
        "embed": emb.to(device=dev, dtype=torch.bfloat16),
        "blocks": init_stack(g, cfg, device=dev),
        "final_norm": init_rmsnorm(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(g, cfg.d_model, cfg.vocab_size,
                                       scale=cfg.d_model ** -0.5, device=dev)
    return params


def _head_weight(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]["w"]


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.to(torch.int64)]


def _noise_ctx(noise_seed):
    return contextlib.nullcontext() if noise_seed is None else \
        fabric_noise_seed(noise_seed)


# -------------------------------------------------------------------- logits
def forward_logits(params, batch, cfg: ModelConfig,
                   noise_seed: Optional[int] = None) -> torch.Tensor:
    """Full (B, S, V) f32 logits of a causal forward — small models only.

    The serving slice has no training forward; a prefill with no extra cache
    room computes the same causal forward and its cache is dropped.
    """
    x = _embed(params, batch["tokens"])
    with _noise_ctx(noise_seed):
        x, _ = stack_forward(params["blocks"], x, cfg, "prefill")
    x = rmsnorm(params["final_norm"], x)
    return (x @ _head_weight(params, cfg).to(x.dtype)).to(torch.float32)


# ------------------------------------------------------------------ serving
def prefill(params, batch, cfg: ModelConfig, max_new_tokens: int = 0,
            noise_seed: Optional[int] = None):
    """batch: {"tokens": (B, S)} (+ optional "length": the true prompt length
    of a right-padded bucket — the last-token logits then come from position
    ``length - 1`` and the cache marks the padded tail empty)."""
    length = batch.get("length")
    x = _embed(params, batch["tokens"])
    with _noise_ctx(noise_seed):
        x, cache = stack_forward(params["blocks"], x, cfg, "prefill",
                                 prefill_extra=max_new_tokens,
                                 true_len=length)
    if length is None:
        x_last = x[:, -1:]
    else:  # a gather at length - 1: a device length is never read back
        last = torch.as_tensor(length, device=x.device).reshape(1)
        x_last = x.index_select(1, last.to(torch.int64) - 1)
    x_last = rmsnorm(params["final_norm"], x_last)
    logits = x_last @ _head_weight(params, cfg).to(x_last.dtype)
    return logits[:, 0].to(torch.float32), cache


def decode_step(params, cache: StackCache, token: torch.Tensor,
                cfg: ModelConfig, block_table=None,
                noise_seed: Optional[int] = None):
    """token: (B, 1) int. Returns (logits (B, V) f32, cache).

    ``block_table`` ((B, max_blocks) int32) routes attention through paged
    pools when ``cache`` carries them (see :mod:`.kv_cache`).  The cache's
    K/V tensors are updated in place.
    """
    x = _embed(params, token)
    with _noise_ctx(noise_seed):
        x, new_cache = stack_forward(params["blocks"], x, cfg, "decode",
                                     cache=cache, pos=cache.pos,
                                     block_table=block_table)
    x = rmsnorm(params["final_norm"], x)
    logits = x @ _head_weight(params, cfg).to(x.dtype)
    return logits[:, 0].to(torch.float32), new_cache
