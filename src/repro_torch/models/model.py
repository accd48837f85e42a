"""LM wrapper: embeddings / modality frontends, stack, head, losses,
serving steps (port of ``repro/models/model.py``).

Public API:
  init_params(cfg, generator, device)       -> params dict
  loss_fn(params, batch, cfg)               -> (loss, metrics)
  loss_and_grads(params, batch, cfg)        -> (loss, metrics, grads)
  forward_logits(params, batch, cfg)        -> logits (small models / tests)
  prefill(params, batch, cfg)               -> (last_logits, StackCache)
  decode_step(params, cache, token, cfg)    -> (logits, StackCache)

Under a noisy fabric spec each entry point takes ``noise_seed`` and runs its
forward inside :class:`~repro_torch.models.common.fabric_noise_seed`, as the
reference's ``launch/steps.py`` does with its per-step key.

Batches: {"tokens": (B, S) int} (+ "labels": (B, S) int for the loss; +
optional "length": the true prompt length of a right-padded bucket, an int
or a 0-dim integer tensor on the tokens' device, as a captured prefill step
takes it); decode takes ``token`` (B, 1) int.  A config with a modality
frontend (``cfg.frontend`` "audio" or "vision": a stub, as in the
reference) takes {"embeddings": (B, S, frontend_dim)} in place of
"tokens" for the loss, ``forward_logits`` and ``prefill``, projected into
the model by ``frontend_proj``; its decode steps take tokens.
``noise_seed`` is a 64-bit integer or a seed table (see
:mod:`repro_torch.models.common`).  The embedding lookup, the frontend
projection, the head matmul and the cross-entropy stay plain torch, as the
reference leaves them outside any kernel and off the fabric.

With MoE layers the loss adds the auxiliary losses summed over the layers,
``AUX_LB_COEF`` x load balance + ``AUX_Z_COEF`` x router z, and the
metrics carry both.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import (dense, fabric_noise_seed,
                                       init_dense, init_rmsnorm, rmsnorm)
from repro_torch.models.transformer import (StackCache, check_supported,
                                            init_stack, stack_forward)
from repro_torch.tree import tree_leaves, tree_unflatten

AUX_LB_COEF = 0.01
AUX_Z_COEF = 0.001
CE_CHUNK = 512


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
    if cfg.frontend != "none":
        params["frontend_proj"] = init_dense(g, cfg.frontend_dim,
                                             cfg.d_model, device=dev)
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


def _embed_inputs(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """The stack's input: the frontend's projection of the batch's
    embeddings, cast to the projection's dtype (bf16, as the reference
    casts them; float64 for a float64 witness), or the token embeddings."""
    if cfg.frontend != "none":
        w = params["frontend_proj"]["w"]
        return dense(params["frontend_proj"], batch["embeddings"].to(w.dtype))
    return _embed(params, batch["tokens"])


def _noise_ctx(noise_seed):
    return contextlib.nullcontext() if noise_seed is None else \
        fabric_noise_seed(noise_seed)


# -------------------------------------------------------------------- loss
def _ce_chunk(xi, head_w, li):
    """Summed token CE of one sequence chunk: (B, c, D) x (D, V) logits in
    x's dtype, cast to f32, logsumexp minus the gold logit."""
    logits = (xi @ head_w.to(xi.dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li[..., None])[..., 0]
    return torch.sum(lse - gold)


def _chunked_ce(x, head_w, labels, chunk: int = CE_CHUNK):
    """Mean token CE without materializing the whole (B, S, V) logits: one
    sequence chunk at a time, each recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
    scan body) when autograd records."""
    b, s, d = x.shape
    if s % chunk != 0:
        chunk = s
    labels = labels.to(torch.int64)
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        args = (x[:, c0:c0 + chunk], head_w, labels[:, c0:c0 + chunk])
        tot = tot + (checkpoint(_ce_chunk, *args, use_reentrant=False,
                                preserve_rng_state=False)
                     if remat else _ce_chunk(*args))
    return tot / (b * s)


def loss_fn(params, batch, cfg: ModelConfig,
            noise_seed: Optional[int] = None):
    """Mean next-token CE of ``batch`` ({"tokens" or "embeddings",
    "labels"}: tensors on the params' device), plus the MoE auxiliary terms.
    Returns (loss, {"ce", ["load_balance_loss", "router_z_loss",] "loss"})."""
    x = _embed_inputs(params, batch, cfg)
    with _noise_ctx(noise_seed):
        x, _, aux = stack_forward(params["blocks"], x, cfg, "train")
    x = rmsnorm(params["final_norm"], x)
    ce = _chunked_ce(x, _head_weight(params, cfg), batch["labels"])
    loss, metrics = ce, {"ce": ce}
    if cfg.n_experts:
        loss = (loss + AUX_LB_COEF * aux["load_balance_loss"]
                + AUX_Z_COEF * aux["router_z_loss"])
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


def loss_and_grads(params, batch, cfg: ModelConfig,
                   noise_seed: Optional[int] = None):
    """:func:`loss_fn` and its gradient with respect to every param (the
    reference's ``jax.value_and_grad(loss_fn, has_aux=True)``).  Returns
    (loss, metrics, grads), ``grads`` shaped as ``params`` in the params'
    dtypes; a leaf the loss does not read (a frontend model's token
    embedding) gets zeros.  ``params`` are read through detached views;
    their tensors are not modified."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, cfg,
                                noise_seed=noise_seed)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, list(grads)))


# -------------------------------------------------------------------- logits
def forward_logits(params, batch, cfg: ModelConfig,
                   noise_seed: Optional[int] = None) -> torch.Tensor:
    """Full (B, S, V) f32 logits of the training forward — small models
    only."""
    x = _embed_inputs(params, batch, cfg)
    with _noise_ctx(noise_seed):
        x, _, _ = stack_forward(params["blocks"], x, cfg, "train")
    x = rmsnorm(params["final_norm"], x)
    return (x @ _head_weight(params, cfg).to(x.dtype)).to(torch.float32)


# ------------------------------------------------------------------ serving
def prefill(params, batch, cfg: ModelConfig, max_new_tokens: int = 0,
            noise_seed: Optional[int] = None):
    """batch: {"tokens": (B, S)} or, with a frontend, {"embeddings": (B, S,
    frontend_dim)} (+ optional "length": the true prompt length of a
    right-padded bucket — the last-token logits then come from position
    ``length - 1`` and the cache marks the padded tail empty)."""
    length = batch.get("length")
    x = _embed_inputs(params, batch, cfg)
    with _noise_ctx(noise_seed):
        x, cache, _ = stack_forward(params["blocks"], x, cfg, "prefill",
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
        x, new_cache, _ = stack_forward(params["blocks"], x, cfg, "decode",
                                     cache=cache, pos=cache.pos,
                                     block_table=block_table)
    x = rmsnorm(params["final_norm"], x)
    logits = x @ _head_weight(params, cfg).to(x.dtype)
    return logits[:, 0].to(torch.float32), new_cache
