"""Gradient compression for cross-host all-reduce: int8 + error feedback
(port of ``repro/runtime/compression.py``).

Compressing gradients to int8 with per-tensor scales cuts the bytes of a
slow cross-host reduction 4x (vs f32) / 2x (vs bf16); error feedback (the
residual carried to the next step) keeps convergence unbiased in practice.

Composes in front of the optimizer: compress -> (all-reduce) ->
decompress.  On one card the all-reduce is the identity; the numerics
(quantize + residual) are what would run across hosts.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class CompressionState(NamedTuple):
    residual: Any  # error-feedback carry, same tree as grads (f32)


def init_compression(grads_like) -> CompressionState:
    return CompressionState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def compress(grads, state: CompressionState):
    """Returns ((q int8 tree, scales tree), new residual carry)."""

    def one(g, r):
        g = g.to(torch.float32) + r
        amax = torch.amax(torch.abs(g))
        scale = torch.clamp(amax, min=1e-12) / torch.full(
            (), 127.0, device=g.device)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        new_r = g - q.to(torch.float32) * scale
        return (q, scale), new_r

    flat = tree_leaves(grads)
    rflat = tree_leaves(state.residual)
    qs, rs = zip(*(one(g, r) for g, r in zip(flat, rflat)))
    q_tree = tree_unflatten(grads, [q for q, _ in qs])
    s_tree = tree_unflatten(grads, [s for _, s in qs])
    return (q_tree, s_tree), CompressionState(tree_unflatten(grads, list(rs)))


def decompress(q_tree, s_tree):
    return tree_map(lambda q, s: q.to(torch.float32) * s, q_tree, s_tree)
