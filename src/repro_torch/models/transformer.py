"""Decoder stack: a loop over heterogeneous blocks (port of
``repro/models/transformer.py``).

The reference stacks each pattern position's parameters across groups and
runs ``jax.lax.scan``; the port keeps one entry per layer in order (layer
``g * len(pattern) + p`` is group ``g``, position ``p``; the tail follows)
and loops in Python.  Block kinds: ``attn`` (global attention + MLP),
``local`` (sliding-window attention + MLP), ``moe`` (global attention +
the MoE FFN of :mod:`repro_torch.models.moe`), ``rglru`` (the RG-LRU
recurrent block of :mod:`repro_torch.models.rglru` + MLP) and ``ssd`` (the
Mamba2 SSD block of :mod:`repro_torch.models.ssd`, no MLP).  A layer's
cache is an ``AttnCache`` / ``PagedAttnCache``, an ``RgLruCache`` or an
``SsdCache``.

Modes: ``train`` (no cache; with ``cfg.remat`` and autograd recording,
each layer runs under ``torch.utils.checkpoint`` and is recomputed in the
backward, as the reference's ``jax.checkpoint`` of its scan body),
``prefill`` and ``decode``.  A bucketed prefill's ``true_len`` reaches the
recurrent blocks too, whose state is then the state at ``true_len`` (the
reference hands it to attention only, and its recurrent states absorb the
padding).  A noisy fabric's training forward hands each
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
from repro_torch.models.rglru import (RgLruCache, init_rglru, rglru_decode,
                                      rglru_forward)
from repro_torch.models.ssd import SsdCache, init_ssd, ssd_decode, ssd_forward

ATTN_KINDS = ("attn", "local", "moe")  # blocks that attend, then an FFN
KINDS = ATTN_KINDS + ("rglru", "ssd")
RECURRENT_CACHES = (RgLruCache, SsdCache)  # dense per-slot state
_MLP_CALLS = {"swiglu": 3, "geglu": 3, "gelu": 2, "none": 0}


class StackCache(NamedTuple):
    layers: List[Any]  # per layer: AttnCache / PagedAttnCache, RgLruCache
    # or SsdCache
    pos: torch.Tensor  # next position: () after a prefill, (slots,) batched


def layer_kinds(cfg: ModelConfig) -> List[str]:
    return list(cfg.pattern) * cfg.n_groups_layers + list(cfg.tail)


def layer_dense_calls(cfg: ModelConfig, kind: str) -> int:
    """Fabric ``dense`` calls in one ``kind`` layer's forward: an ``ssd``
    layer's ``in_proj`` and ``out_proj``; an ``rglru`` layer's two branches
    and ``w_out`` (its gates stay off the fabric), then the MLP's; the four
    attention projections, then the MLP's (a ``moe`` layer's router and
    experts stay off the fabric, as in the reference)."""
    if kind == "ssd":
        return 2
    if kind == "moe":
        return 4
    return (3 if kind == "rglru" else 4) + _MLP_CALLS[cfg.mlp]


def dense_calls(cfg: ModelConfig) -> int:
    """Fabric ``dense`` calls in one forward of the stack (train, prefill or
    decode).  A noisy fabric draws one seed per call, so this sizes a step's
    seed table."""
    return sum(layer_dense_calls(cfg, kind) for kind in layer_kinds(cfg))


def check_supported(cfg: ModelConfig) -> None:
    """Raise up front for a block kind the stack does not know, and for
    ``mlp="none"`` beside a block that runs an MLP (the reference reads the
    missing MLP's params there)."""
    kinds = set(layer_kinds(cfg))
    bad = sorted(kinds - set(KINDS))
    if bad:
        raise ValueError(f"{cfg.name}: unknown block kinds {bad} (the stack "
                         f"runs {KINDS} blocks)")
    with_ffn = sorted(kinds - {"ssd"})
    if cfg.mlp == "none" and with_ffn:
        raise ValueError(f"{cfg.name}: mlp='none' leaves its {with_ffn} "
                         "blocks without an MLP")


# ------------------------------------------------------------------ init
def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str, *,
               device=None):
    d = cfg.d_model
    p = {"norm1": init_rmsnorm(d, device=device)}
    if kind in ATTN_KINDS:
        p["attn"] = init_attention(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, qkv_bias=cfg.qkv_bias,
                                   device=device)
    elif kind == "rglru":
        p["rglru"] = init_rglru(generator, d, cfg.lru_w, cfg.conv_width,
                                device=device)
    elif kind == "ssd":
        p["ssd"] = init_ssd(generator, d, expand=cfg.ssm_expand,
                            headdim=cfg.ssm_headdim, state=cfg.ssm_state,
                            conv_width=cfg.conv_width, device=device)
        if cfg.post_norm:
            p["post_norm1"] = init_rmsnorm(d, device=device)
        return p
    else:
        raise ValueError(kind)
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


def _mix(params, h, kind: str, cfg: ModelConfig, mode: str, cache, pos,
         prefill_extra: int, true_len, block_table):
    """The token-mixing half of a block. Returns (y, new_cache); the cache
    is None in ``train`` mode."""
    imc = _imc_kw(cfg)
    if kind == "rglru":
        if mode == "decode":
            state, conv_state = cache
            return rglru_decode(params["rglru"], h, state, conv_state, **imc)
        y, c = rglru_forward(params["rglru"], h, true_len=true_len, **imc)
        return y, (c if mode == "prefill" else None)
    if kind == "ssd":
        kw = dict(expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                  state=cfg.ssm_state, **imc)
        if mode == "decode":
            return ssd_decode(params["ssd"], h, cache, **kw)
        y, c = ssd_forward(params["ssd"], h, chunk=cfg.ssd_chunk,
                           true_len=true_len, **kw)
        return y, (c if mode == "prefill" else None)
    window = cfg.window if kind == "local" else 0
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, rope_theta=cfg.rope_theta, window=window,
              **imc)
    if mode == "train":
        return attn_forward(params["attn"], h, q_chunk=cfg.q_chunk,
                            chunk_remat=cfg.chunk_remat,
                            native_dtype_dots=cfg.native_dtype_dots,
                            use_flash=cfg.use_flash_kernel, **kw), None
    if mode == "prefill":
        if true_len is not None:
            # ragged (right-padded) admission keeps EVERY row, even for
            # windowed layers: the cache is scattered into the pools
            cache_len = h.shape[1]
        else:
            cache_len = window if window else h.shape[1] + prefill_extra
        return attn_prefill(params["attn"], h, q_chunk=cfg.q_chunk,
                            cache_len=cache_len, kv_dtype=cfg.kv_dtype,
                            true_len=true_len,
                            use_flash=cfg.use_flash_kernel, **kw)
    return attn_decode(params["attn"], h, cache, pos,
                       block_table=block_table, attn_impl=cfg.attn_impl,
                       **kw)


def apply_block(params, x, kind: str, cfg: ModelConfig, mode: str,
                cache=None, pos=None, prefill_extra: int = 0, true_len=None,
                block_table=None):
    """Pre-norm residual block. Returns (x, new_cache, aux): ``aux`` holds a
    ``moe`` block's auxiliary losses, None for the other kinds.  An ``ssd``
    block returns after its mixer (no MLP, no ``norm2``)."""
    imc = _imc_kw(cfg)
    h = rmsnorm(params["norm1"], x)
    y, new_cache = _mix(params, h, kind, cfg, mode, cache, pos,
                        prefill_extra, true_len, block_table)
    if cfg.post_norm:
        y = rmsnorm(params["post_norm1"], y)
    if kind == "ssd":
        return x + y, new_cache, None
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
