"""Decoder stack: a loop over attention blocks (port of
``repro/models/transformer.py``).

The reference stacks each pattern position's parameters across groups and
runs ``jax.lax.scan``; the port keeps one entry per layer in order (layer
``g * len(pattern) + p`` is group ``g``, position ``p``; the tail follows)
and loops in Python.  Block kinds: ``attn`` (global attention + MLP),
``local`` (sliding-window attention + MLP) and ``moe`` (global attention +
the MoE FFN of :mod:`repro_torch.models.moe`).  SSD and RG-LRU blocks, and
``mlp="none"``, raise "not ported yet".

Modes: ``train`` (no cache; with ``cfg.remat`` and autograd recording,
each layer runs under ``torch.utils.checkpoint`` and is recomputed in the
backward, as the reference's ``jax.checkpoint`` of its scan body),
``prefill`` and ``decode``.  A noisy fabric's training forward hands each
layer its own span of seeds before the layer runs
(:func:`~repro_torch.models.common.take_fabric_seeds`), so a recomputed
layer draws the noise of its first run, and a forward draws the seeds a
prefill over the same tokens draws.  The MoE layers' auxiliary losses are
summed over the stack in every mode, as the reference's ``_acc_aux`` sums
them.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attn_decode, attn_forward,
                                          attn_prefill, init_attention)
from repro_torch.models.common import (init_rmsnorm, rmsnorm,
                                       take_fabric_seeds)
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.models.moe import apply_moe, init_moe

ATTN_KINDS = ("attn", "local", "moe")  # blocks that attend, then an FFN


class StackCache(NamedTuple):
    layers: List[Any]  # one AttnCache / PagedAttnCache per layer
    pos: torch.Tensor  # next position: () after a prefill, (slots,) batched


def layer_kinds(cfg: ModelConfig) -> List[str]:
    return list(cfg.pattern) * cfg.n_groups_layers + list(cfg.tail)


def layer_dense_calls(cfg: ModelConfig, kind: str) -> int:
    """Fabric ``dense`` calls in one ``kind`` layer's forward: the four
    attention projections, and the MLP's two or three (a ``moe`` layer's
    router and experts stay off the fabric, as in the reference)."""
    if kind == "moe":
        return 4
    return 4 + (3 if cfg.mlp in ("swiglu", "geglu") else 2)


def dense_calls(cfg: ModelConfig) -> int:
    """Fabric ``dense`` calls in one forward of the stack (train, prefill or
    decode).  A noisy fabric draws one seed per call, so this sizes a step's
    seed table."""
    return sum(layer_dense_calls(cfg, kind) for kind in layer_kinds(cfg))


def check_supported(cfg: ModelConfig) -> None:
    """Raise up front for what this slice has not ported."""
    bad = sorted(set(k for k in layer_kinds(cfg) if k not in ATTN_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported yet (repro_torch "
            f"runs {ATTN_KINDS} blocks)")
    if cfg.mlp == "none":
        raise NotImplementedError(f"{cfg.name}: mlp='none' is not ported yet")


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
    if kind == "moe":
        p["moe"] = init_moe(generator, d, cfg.d_ff, cfg.n_experts, cfg.mlp,
                            device=device)
    else:
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
    """Pre-norm residual block. Returns (x, new_cache, aux): ``aux`` holds a
    ``moe`` block's auxiliary losses, None for the other kinds."""
    imc = _imc_kw(cfg)
    window = cfg.window if kind == "local" else 0
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, rope_theta=cfg.rope_theta, window=window,
              **imc)
    h = rmsnorm(params["norm1"], x)
    if mode == "train":
        y = attn_forward(params["attn"], h, q_chunk=cfg.q_chunk,
                         chunk_remat=cfg.chunk_remat,
                         native_dtype_dots=cfg.native_dtype_dots,
                         use_flash=cfg.use_flash_kernel, **kw)
        new_cache = None
    elif mode == "prefill":
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
    aux = None
    if kind == "moe":
        y, aux = apply_moe(params["moe"], h, n_experts=cfg.n_experts,
                           top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, kind=cfg.mlp,
                           combine_dtype=(torch.float32
                                          if cfg.moe_combine_dtype == "f32"
                                          else torch.bfloat16))
    else:
        y = apply_mlp(params["mlp"], h, cfg.mlp, **imc)
    if cfg.post_norm:
        y = rmsnorm(params["post_norm2"], y)
    return x + y, new_cache, aux


# ------------------------------------------------------------------ stack
def _zero_aux(device) -> Dict[str, torch.Tensor]:
    """The MoE auxiliary losses before any layer: float32 zeros, which a
    stack without a router keeps (the reference's ``_acc_aux`` adds nothing
    for such blocks)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance_loss": z, "router_z_loss": z}


def _acc_aux(acc, aux):
    return acc if aux is None else {k: acc[k] + aux[k] for k in acc}


def _train_layer(params, x, kind, cfg, seeds):
    """One layer of a training forward, under its own span of noise seeds
    (None for a noise-free fabric).  Returns (x, aux): a ``moe`` layer's two
    auxiliary losses, or two zeros, so that they pass through
    ``torch.utils.checkpoint`` as tensors."""
    with seeds if seeds is not None else contextlib.nullcontext():
        x, _, aux = apply_block(params, x, kind, cfg, "train")
    if aux is None:
        aux = _zero_aux(x.device)
    return x, aux["load_balance_loss"], aux["router_z_loss"]


def stack_forward(params, x, cfg: ModelConfig, mode: str,
                  cache: Optional[StackCache] = None, pos=None,
                  prefill_extra: int = 0, true_len=None, block_table=None):
    """Run the full stack. Returns (x, new_cache, aux): ``new_cache`` is
    None in ``train`` mode; ``aux`` holds the MoE losses summed over the
    layers (float32 zeros for a stack without MoE layers).

    ``true_len`` (prefill, an int or a 0-dim integer tensor on x's device):
    the prompt occupies positions ``[0, true_len)`` of a right-padded
    ``x``.  ``block_table`` (decode,
    (B, max_blocks) int32) routes attention through paged pools when the
    cache holds :class:`~repro_torch.models.attention.PagedAttnCache`s.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got "
                         f"{mode!r}")
    check_supported(cfg)
    aux_acc = _zero_aux(x.device)
    if mode == "train":
        spec = cfg.imc_fabric
        noisy = spec is not None and spec.noisy
        remat = cfg.remat and torch.is_grad_enabled()
        for i, kind in enumerate(layer_kinds(cfg)):
            seeds = take_fabric_seeds(layer_dense_calls(cfg, kind)) \
                if noisy else None
            p = params["layers"][i]
            if remat:
                x, lb, z = checkpoint(_train_layer, p, x, kind, cfg, seeds,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                x, lb, z = _train_layer(p, x, kind, cfg, seeds)
            if kind == "moe":
                aux_acc = _acc_aux(aux_acc, {"load_balance_loss": lb,
                                             "router_z_loss": z})
        return x, None, aux_acc
    new_layers = []
    for i, kind in enumerate(layer_kinds(cfg)):
        lc = cache.layers[i] if mode == "decode" else None
        x, nc, aux = apply_block(params["layers"][i], x, kind, cfg, mode,
                                 cache=lc, pos=pos,
                                 prefill_extra=prefill_extra,
                                 true_len=true_len, block_table=block_table)
        aux_acc = _acc_aux(aux_acc, aux)
        new_layers.append(nc)
    if mode == "decode":
        new_pos = pos + 1
    else:
        new_pos = torch.as_tensor(x.shape[1] if true_len is None else
                                  true_len, device=x.device).reshape(()).to(
            torch.int32, copy=True)
    return x, StackCache(new_layers, new_pos), aux_acc
