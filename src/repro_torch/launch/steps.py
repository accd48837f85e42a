"""Step functions: prefill, decode and admission (port of
``repro/launch/steps.py``).

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
rings, and ``cache.pos``), so the state a graph captured stays the state it
replays on.

Not ported: ``make_train_step`` (training is not ported yet) and
``input_specs`` with its helpers, which build abstract inputs for the XLA
dry-run (``jax.ShapeDtypeStruct``s for ``lower().compile()``); one H100
runs no ahead-of-time lowering, so they have no counterpart here.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.kv_cache import merge_prefill_cache
from repro_torch.models.model import decode_step, prefill


def make_train_step(cfg: ModelConfig, *args, **kw):
    raise NotImplementedError("the training step is not ported yet")


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
        cache.pos.copy_(new.pos)  # the next positions land in the state
        return logits

    return serve_step


def admit_step(cache, one, slot, table_row=None):
    """Scatter one request's prefilled (B=1) cache into ``cache`` at
    ``slot`` (a one-element device tensor), in place."""
    merge_prefill_cache(cache, one, table_row, slot)
