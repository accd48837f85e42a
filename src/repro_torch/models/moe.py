"""Mixture-of-Experts FFN: top-k routing through a sorted capacity table
(port of ``repro/models/moe.py``).

  1. top-k expert choice per token, flattened to T*k assignments;
  2. a stable sort of the assignments by expert; each expert's first
     ``cap`` assignments fill its slots of an (E, cap) table, the rest drop;
  3. gather the tokens -> (E, cap, D), the expert GEMMs as batched matmuls;
  4. a weighted combine back to the tokens.

No MoE weight goes through the fabric, as in the reference (whose
``apply_moe`` ignores the fabric arguments it is given): the router is a
float32 matmul and the experts are bf16 batched matmuls.

Every step runs on the device with shapes fixed by (T, E, k, cap), so the
layer makes no host sync and a CUDA graph captures it: no ``bincount``,
``nonzero``, boolean-mask indexing or ``.item()``.  The reference's scatters
become gathers: the slot table is read from the sorted assignments through
``searchsorted``, and the combine gathers each token's k contributions.

Bit for bit with the reference on the CPU, given equal router logits:

  * the softmax: XLA's float32 ``exp`` (:func:`~repro_torch.core.rbl
    .exp_f32`) and its order of summation over the experts (in order for
    E <= 32; for E a multiple of 32, in windows of 32 whose partial sums are
    then added in order);
  * ``jax.lax.top_k``: sorted by falling probability, the lower expert first
    on ties (a stable descending sort; ``torch.topk`` promises neither);
  * the slot table and the gate table, drops included: within an expert
    the assignments keep token order, so a right-padded bucket's padding
    tokens come after the real ones and never take their capacity;
  * the combine: each token's contributions added in ``combine_dtype``
    from zero, one by one in the table's order (expert ascending), as XLA's
    CPU scatter-add adds them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.rbl import ExpF32
from repro_torch.models.common import init_dense
from repro_torch.models.mlp import gelu_tanh, silu

SUM_WINDOW = 32  # XLA's CPU tree reduction: windows of 32 summed in order


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, kind: str = "swiglu", *, device=None,
             dtype=torch.bfloat16):
    """Router (float32, ``{"w": (D, E)}``) and expert stacks ``w_gate``,
    ``w_up`` (E, D, F) and ``w_down`` (E, F, D) in the reference's layout;
    ``kind="gelu"`` has no ``w_gate``."""
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale
        return w.to(device=device, dtype=dtype)

    p = {"router": init_dense(generator, d_model, n_experts, device=device,
                              dtype=torch.float32)}
    if kind != "gelu":
        p["w_gate"] = normal((n_experts, d_model, d_ff), s_in)
    p["w_up"] = normal((n_experts, d_model, d_ff), s_in)
    p["w_down"] = normal((n_experts, d_ff, d_model), s_out)
    return p


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    cap = int(n_tokens * top_k * capacity_factor / n_experts)
    # round to a lane-friendly multiple
    cap = max(((cap + 127) // 128) * 128, top_k)
    return min(cap, n_tokens * top_k)


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, adding left to right."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the order of XLA's CPU reduction: in order
    up to 32 elements; for a multiple of 32, in windows of 32, then the
    windows' partial sums in order.  Other lengths past 32 (no config has
    one) take ``torch.sum``, whose order XLA's need not share."""
    n = x.shape[-1]
    if n <= SUM_WINDOW:
        return _sum_in_order(x)
    if n % SUM_WINDOW:
        return x.sum(-1)
    parts = _sum_in_order(x.reshape(x.shape[:-1] + (-1, SUM_WINDOW)))
    return _sum_in_order(parts)


def router_probs(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(logits, axis=-1)`` in float32: exp(x - max) over its
    sum, in XLA's arithmetic (see the module docstring)."""
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    u = ExpF32.apply(logits - m)
    return u / xla_sum(u)[..., None]


class Routing(NamedTuple):
    gate_idx: torch.Tensor  # (T, k) int64: chosen experts, by falling prob
    table: torch.Tensor  # (E*cap,) int64 token ids; T marks an empty slot
    gate_table: torch.Tensor  # (E*cap,) f32 gate of each slot, 0 if empty
    addr: torch.Tensor  # (T, k) int64 slot of each token's assignment, in
    # expert order; E*cap where it was dropped


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, sorted
    descending, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs: torch.Tensor, k: int, cap: int) -> Routing:
    """Top-k choice and sorted capacity dispatch of (T, E) router
    probabilities (the reference's ``apply_moe`` up to its slot table)."""
    t, e = probs.shape
    dev = probs.device
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp_min(
        _sum_in_order(gate_vals), 1e-9)[:, None]  # renormalize top-k

    flat_e = gate_idx.reshape(-1)  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(e, device=dev)
    starts = torch.searchsorted(sorted_e, experts)
    ends = torch.searchsorted(sorted_e, experts, right=True)
    # slot j of expert x holds sorted assignment starts[x] + j, if it exists
    src = starts[:, None] + torch.arange(cap, device=dev)[None, :]
    filled = src < ends[:, None]
    src = torch.clamp_max(src, t * k - 1)
    table = torch.where(filled, (order // k)[src], t).reshape(-1)
    gate_table = torch.where(filled, gate_vals.reshape(-1)[order][src],
                             0.0).reshape(-1)
    # where each assignment landed: its rank in the sort minus its
    # expert's start, dropped past the capacity
    slot = torch.argsort(order) - starts[flat_e]
    addr = torch.where(slot < cap, flat_e * cap + slot, e * cap).reshape(t, k)
    addr = addr.gather(1, torch.argsort(gate_idx, dim=-1))  # expert order
    return Routing(gate_idx, table, gate_table, addr)


def contributions(expert_out: torch.Tensor, gate_table: torch.Tensor,
                  combine_dtype=torch.bfloat16) -> torch.Tensor:
    """(E, cap, D) expert outputs -> (E*cap, D) gated slot rows in
    ``combine_dtype``."""
    e, cap, d = expert_out.shape
    return (expert_out.reshape(e * cap, d).to(combine_dtype)
            * gate_table[:, None].to(combine_dtype))


def combine(contrib: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """(E*cap, D) slot rows -> (T, D): each token's rows at ``addr`` added
    from zero, in expert order.  A dropped assignment adds the zero row
    past the table; the sum is never -0, so adding +0 leaves it
    unchanged."""
    rows = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[1]))])
    y = rows.new_zeros((addr.shape[0], contrib.shape[1]))
    for i in range(addr.shape[1]):
        y = y + rows[addr[:, i]]
    return y


def apply_moe(params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, kind: str = "swiglu",
              combine_dtype=torch.bfloat16):
    """x: (B, S, D) -> (y, aux); aux = {load_balance_loss, router_z_loss}.

    ``combine_dtype``: the combine's accumulation dtype (bf16 by default,
    float32 for the reference's ablation)."""
    b, s, d = x.shape
    t = b * s
    e = n_experts
    cap = moe_capacity(t, e, top_k, capacity_factor)
    xf = x.reshape(t, d)

    logits = xf.to(torch.float32) @ params["router"]["w"].to(torch.float32)
    probs = router_probs(logits)
    r = route(probs, top_k, cap)

    x_pad = torch.cat([xf, xf.new_zeros((1, d))])
    expert_in = x_pad[r.table].reshape(e, cap, d)
    if kind in ("swiglu", "geglu"):
        g = torch.matmul(expert_in, params["w_gate"].to(x.dtype))
        u = torch.matmul(expert_in, params["w_up"].to(x.dtype))
        h = (silu(g) if kind == "swiglu" else gelu_tanh(g)) * u
    else:
        h = gelu_tanh(torch.matmul(expert_in, params["w_up"].to(x.dtype)))
    expert_out = torch.matmul(h, params["w_down"].to(x.dtype))
    y = combine(contributions(expert_out, r.gate_table, combine_dtype),
                r.addr)

    # aux losses; the top-1 counts as a one-hot sum (no bincount: its
    # output size is read from the data, a host sync on the card)
    top1 = r.gate_idx[:, :1] == torch.arange(e, device=x.device)
    frac_tokens = top1.sum(0).to(torch.float32) / t
    frac_probs = torch.mean(probs, dim=0)
    lb = e * torch.sum(frac_tokens * frac_probs)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y.reshape(b, s, d).to(x.dtype), {
        "load_balance_loss": lb, "router_z_loss": z}
