"""Decoder stack: a loop over dense attention blocks (port of
``repro/models/transformer.py``).

The reference stacks each pattern position's parameters across groups and
runs ``jax.lax.scan``; the port keeps one entry per layer in order (layer
``g * len(pattern) + p`` is group ``g``, position ``p``; the tail follows)
and loops in Python.  Only the attention kinds run here: ``attn`` (global)
and ``local`` (sliding window), each followed by its MLP.  MoE, SSD and
RG-LRU blocks raise "not ported yet".
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fabric import check_ported
from repro_torch.models.attention import (attn_decode, attn_prefill,
                                          init_attention)
from repro_torch.models.common import init_rmsnorm, rmsnorm
from repro_torch.models.mlp import apply_mlp, init_mlp

ATTN_KINDS = ("attn", "local")


class StackCache(NamedTuple):
    layers: List[Any]  # one AttnCache / PagedAttnCache per layer
    pos: torch.Tensor  # next position: () after a prefill, (slots,) batched


def layer_kinds(cfg: ModelConfig) -> List[str]:
    return list(cfg.pattern) * cfg.n_groups_layers + list(cfg.tail)


def check_supported(cfg: ModelConfig) -> None:
    """Raise up front for what this slice has not ported."""
    bad = sorted(set(k for k in layer_kinds(cfg) if k not in ATTN_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported yet (repro_torch "
            f"runs {ATTN_KINDS} blocks)")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  "is not ported yet")
    if cfg.mlp == "none":
        raise NotImplementedError(f"{cfg.name}: mlp='none' is not ported yet")
    if cfg.imc_fabric is not None:
        check_ported(cfg.imc_fabric)


# ------------------------------------------------------------------ init
def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str, *,
               device=None):
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    d = cfg.d_model
    p = {"norm1": init_rmsnorm(d, device=device),
         "attn": init_attention(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, qkv_bias=cfg.qkv_bias,
                                device=device)}
    if cfg.post_norm:
        p["post_norm1"] = init_rmsnorm(d, device=device)
        p["post_norm2"] = init_rmsnorm(d, device=device)
    p["norm2"] = init_rmsnorm(d, device=device)
    p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.mlp, device=device)
    return p


def init_stack(generator: torch.Generator, cfg: ModelConfig, *, device=None):
    """Per-layer params: {"layers": [block params, ...]} in layer order."""
    return {"layers": [init_block(generator, cfg, kind, device=device)
                       for kind in layer_kinds(cfg)]}


# ------------------------------------------------------------------ blocks
def _imc_kw(cfg: ModelConfig):
    """Fabric routing for every projection in the stack: ONE typed spec."""
    spec = cfg.imc_fabric
    return {} if spec is None else {"spec": spec}


def apply_block(params, x, kind: str, cfg: ModelConfig, mode: str,
                cache=None, pos=None, prefill_extra: int = 0, true_len=None,
                block_table=None):
    """Pre-norm residual block. Returns (x, new_cache)."""
    imc = _imc_kw(cfg)
    window = cfg.window if kind == "local" else 0
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, rope_theta=cfg.rope_theta, window=window,
              **imc)
    h = rmsnorm(params["norm1"], x)
    if mode == "prefill":
        if true_len is not None:
            # ragged (right-padded) admission keeps EVERY row, even for
            # windowed layers: the cache is scattered into the pools
            cache_len = x.shape[1]
        else:
            cache_len = window if window else x.shape[1] + prefill_extra
        y, new_cache = attn_prefill(params["attn"], h, q_chunk=cfg.q_chunk,
                                    cache_len=cache_len,
                                    kv_dtype=cfg.kv_dtype, true_len=true_len,
                                    use_flash=cfg.use_flash_kernel, **kw)
    else:
        y, new_cache = attn_decode(params["attn"], h, cache, pos,
                                   block_table=block_table,
                                   attn_impl=cfg.attn_impl, **kw)
    if cfg.post_norm:
        y = rmsnorm(params["post_norm1"], y)
    # The reference compiles the block as one XLA computation, which feeds
    # norm2 the f32 sum of the residual and the attention output without
    # rounding it to x's dtype first; the residual stream itself is rounded.
    h = rmsnorm(params["norm2"], x.to(torch.float32) + y.to(torch.float32),
                out_dtype=x.dtype)
    x = x + y
    y = apply_mlp(params["mlp"], h, cfg.mlp, **imc)
    if cfg.post_norm:
        y = rmsnorm(params["post_norm2"], y)
    return x + y, new_cache


# ------------------------------------------------------------------ stack
def stack_forward(params, x, cfg: ModelConfig, mode: str,
                  cache: Optional[StackCache] = None, pos=None,
                  prefill_extra: int = 0, true_len=None, block_table=None):
    """Run the full stack. Returns (x, new_cache).

    ``true_len`` (prefill, an int): the prompt occupies positions
    ``[0, true_len)`` of a right-padded ``x``.  ``block_table`` (decode,
    (B, max_blocks) int32) routes attention through paged pools when the
    cache holds :class:`~repro_torch.models.attention.PagedAttnCache`s.
    """
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode' in the serving "
                         f"slice, got {mode!r}")
    check_supported(cfg)
    new_layers = []
    for i, kind in enumerate(layer_kinds(cfg)):
        lc = cache.layers[i] if mode == "decode" else None
        x, nc = apply_block(params["layers"][i], x, kind, cfg, mode,
                            cache=lc, pos=pos, prefill_extra=prefill_extra,
                            true_len=true_len, block_table=block_table)
        new_layers.append(nc)
    if mode == "decode":
        new_pos = pos + 1
    else:
        new_pos = torch.tensor(x.shape[1] if true_len is None else
                               int(true_len), dtype=torch.int32,
                               device=x.device)
    return x, StackCache(new_layers, new_pos)
