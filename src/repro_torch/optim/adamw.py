"""AdamW with mixed-precision masters (port of ``repro/optim/adamw.py``).

  * params may live in bf16; the optimizer keeps fp32 master copies and
    moments, in trees shaped as the params (:mod:`repro_torch.tree`).
  * global-norm clipping, decoupled weight decay, linear-warmup cosine decay.
  * the step counter, the learning rate and the norm are 0-dim device
    tensors, so an update reads nothing back to the host.

Every new param, norm scales included, is cast to ``param_dtype`` (bf16 by
default) after a step, as in the reference.  The update writes new tensors;
the caller's state is not modified.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    master: Any  # fp32 master params
    m: Any  # fp32 first moment
    v: Any  # fp32 second moment


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init_adamw(params) -> AdamWState:
    """Masters are float32 copies (never aliases of a float32 param);
    moments are zeros; the step lies on the params' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    master = tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                      params)
    zeros = lambda: tree_map(  # noqa: E731
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), master,
                      zeros(), zeros())


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim float32 tensor on like's device, filled there (no
    host-to-device copy, so no sync): a divisor of this type divides (a
    Python-number divisor is a multiply by its reciprocal on CUDA, and
    ``number / tensor`` is one on every device)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_frac``
    of it at ``total_steps``; float32, as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    return torch.sqrt(sum(sq[1:], sq[0]))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-12)), float32, on norm's device."""
    return torch.clamp(_f32(max_norm, norm) / torch.clamp(norm, min=1e-12),
                       max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled so that their global norm is at most ``max_norm``,
    and that norm: (clipped grads, norm), as the reference's.
    :func:`adamw_update` applies the same scale leaf by leaf instead."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(grads, state: AdamWState, cfg: AdamWConfig,
                 param_dtype=torch.bfloat16):
    """Returns (new_params (param_dtype), new_state, metrics).

    Leaf by leaf: a leaf's float32 gradient and the update's temporaries
    live only while that leaf is updated, at most two of them at once
    (written in place into tensors the update allocated), so the step's
    peak holds the old and the new state and two float32 copies of the
    largest leaf, not of every gradient.  Each element takes the
    reference's ops in its order, each op rounded as it rounds it."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)

    new_m, new_v, new_master, new_params = [], [], [], []
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(state.master)):
        g = g.to(torch.float32, copy=True)
        g.mul_(scale.to(g.dtype))
        m = b1 * m
        m.add_((1 - b1) * g)  # b1 * m + (1 - b1) * g
        t = (1 - b2) * g
        t.mul_(g)
        del g
        v = b2 * v
        v.add_(t)  # b2 * v + (1 - b2) * g * g
        del t
        d = v / bc2
        d.sqrt_()
        d.add_(cfg.eps)
        u = m / bc1
        u.div_(d)
        del d
        u.add_(cfg.weight_decay * p)
        u.mul_(lr)
        p = p - u  # p - lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd * p)
        del u
        new_m.append(m)
        new_v.append(v)
        new_master.append(p)
        new_params.append(p.to(param_dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (tree_unflatten(state.master, new_params),
            AdamWState(step, tree_unflatten(state.master, new_master),
                       tree_unflatten(state.m, new_m),
                       tree_unflatten(state.v, new_v)), metrics)
