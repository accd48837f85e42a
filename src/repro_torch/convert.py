"""Carry parameters, optimizer state (and caches) from the JAX package's
layout into the port.

The reference stacks every pattern position's parameters across layer
groups (leading dim G, for ``jax.lax.scan``; ``repro/models/transformer.py``
``init_stack``); the port keeps one entry per layer in order: layer
``g * len(pattern) + p`` is group ``g`` of position ``p``, and the tail
layers follow.  Weights keep the reference's ``(d_in, d_out)`` layout and
dtypes.  Inputs are numpy arrays (``np.asarray`` of each JAX leaf); bf16
arrives as the ``ml_dtypes`` bfloat16 numpy dtype and is carried bit for bit.
This module imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def to_torch(a, device=None) -> torch.Tensor:
    """numpy (or array-like) -> tensor, bf16 bit patterns preserved."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device) if device is not None else t


def tree_to_torch(tree, device=None):
    """Map :func:`to_torch` over dicts, lists, tuples and NamedTuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_to_torch(v, device) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    return to_torch(tree, device)


def _take(tree, g: int):
    """Group ``g`` of a tree whose leaves carry a leading G dim."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_take(v, g) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, g) for v in tree)
    return tree[g]


def layers_from_groups(groups, tail, cfg: ModelConfig) -> List[Any]:
    """Per-layer entries, in layer order, from the reference's stacked
    ``groups`` (one tree per pattern position, leading dim G) and
    ``tail``."""
    layers = []
    for g in range(cfg.n_groups_layers):
        for p in range(len(cfg.pattern)):
            layers.append(_take(groups[p], g))
    layers.extend(tail)
    return layers


def params_from_jax(tree, cfg: ModelConfig, device=None):
    """The reference's ``init_params`` tree (numpy leaves) -> port params.
    A layer's leaves keep their names, MoE ones included (the float32
    router, the (E, D, F) / (E, F, D) expert stacks)."""
    blocks = tree["blocks"]
    out = {
        "embed": to_torch(tree["embed"], device),
        "blocks": {"layers": tree_to_torch(
            layers_from_groups(blocks["groups"], blocks["tail"], cfg),
            device)},
        "final_norm": tree_to_torch(tree["final_norm"], device),
    }
    for name in ("frontend_proj", "lm_head"):
        if name in tree:
            out[name] = tree_to_torch(tree[name], device)
    return out


def adamw_state_from_jax(state, cfg: ModelConfig, device=None):
    """The reference's ``AdamWState`` (numpy leaves: ``step`` and the
    ``master``, ``m``, ``v`` trees shaped as its params) -> the port's
    :class:`~repro_torch.optim.adamw.AdamWState`, so that one AdamW step
    can be compared on identical state."""
    from repro_torch.optim.adamw import AdamWState

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    return AdamWState(step, *(params_from_jax(t, cfg, device)
                              for t in (state.master, state.m, state.v)))
