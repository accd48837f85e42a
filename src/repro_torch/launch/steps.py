"""Step functions: train, prefill, decode and admission (port of
``repro/launch/steps.py``).

    train_step(params, opt_state, batch, seed=None) -> (params, opt, metrics)

runs :func:`~repro_torch.models.model.loss_fn` under the step's noise seed,
its backward (the STE through every fabric projection) and
:func:`~repro_torch.optim.adamw.adamw_update`.  Under
:func:`~repro_torch.device.deterministic`, as :func:`repro_torch.launch.train
.train` runs it, a step repeats bit for bit on the card.  A noisy fabric's
step writes its
seed table (one row per ``dense`` call of the forward) to the device once;
each layer's rows are handed to it before it runs, so the layers recomputed
in the backward replay their noise.  It returns new params and state; the
ones passed in are not modified.  Train steps run eagerly.

The serving steps:

Each step reads only its tensor arguments, so :class:`~repro_torch.launch
.engine.Engine` can bind them to static buffers and capture one CUDA graph
per step: ``seeds`` is the step's seed table (an int32 (calls, 2) tensor,
one row per noisy ``dense`` call, see :mod:`repro_torch.models.common`), or
None for a noise-free fabric; a padded prompt's true length and an
admission's slot are device tensors, never Python ints.

    prefill_step(params, tokens, length=None, seeds=None) -> (logits, cache)
    serve_step(params, cache, token, block_table=None, seeds=None) -> logits
    admit_step(cache, one, slot, table_row=None) -> None

``serve_step`` and ``admit_step`` update ``cache`` in place (the pools or
rings, the recurrent layers' state and ``cache.pos``), so the state a graph
captured stays the state it replays on.

Not ported: ``input_specs`` with its helpers, which build abstract inputs
for the XLA dry-run (``jax.ShapeDtypeStruct``s for ``lower().compile()``);
one H100 runs no ahead-of-time lowering, so they have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import seed_table
from repro_torch.models.kv_cache import merge_prefill_cache
from repro_torch.models.model import decode_step, loss_and_grads, prefill
from repro_torch.models.transformer import RECURRENT_CACHES, dense_calls
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig()):
    spec = cfg.imc_fabric
    calls = dense_calls(cfg) if spec is not None and spec.noisy else 0

    def train_step(params, opt_state, batch, seed=None):
        seeds = None
        if calls:
            if seed is None:
                raise ValueError("the train step of a noisy fabric needs a "
                                 "seed")
            dev = tree_leaves(params)[0].device
            seeds = torch.from_numpy(seed_table(seed, calls)).to(dev)
        _, metrics, grads = loss_and_grads(params, batch, cfg,
                                           noise_seed=seeds)
        new_params, new_opt, om = adamw_update(grads, opt_state, opt_cfg)
        return new_params, new_opt, dict(metrics, **om)

    return train_step


def make_prefill_step(cfg: ModelConfig, max_new_tokens: int = 0):
    def prefill_step(params, tokens, length=None, seeds=None):
        batch = {"tokens": tokens}
        if length is not None:
            batch["length"] = length
        return prefill(params, batch, cfg, max_new_tokens=max_new_tokens,
                       noise_seed=seeds)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, token, block_table=None, seeds=None):
        logits, new = decode_step(params, cache, token, cfg,
                                  block_table=block_table, noise_seed=seeds)
        # a recurrent layer's decode returns a new state, and the next
        # positions are new: both land in the bound state
        for old, fresh in zip(cache.layers, new.layers):
            if isinstance(old, RECURRENT_CACHES):
                for dst, src in zip(old, fresh):
                    dst.copy_(src)
        cache.pos.copy_(new.pos)
        return logits

    return serve_step


def admit_step(cache, one, slot, table_row=None):
    """Scatter one request's prefilled (B=1) cache into ``cache`` at
    ``slot`` (a one-element device tensor), in place."""
    merge_prefill_cache(cache, one, table_row, slot)
