"""Mixture-of-Experts feed-forward with sort-based capacity dispatch (port of
``repro/models/moe.py``).

Expert weights are ``[E, d_model, d_ff]``. Dispatch groups the routed token
copies by expert with a stable sort, drops the copies past
``capacity = ceil(top_k * N / E * capacity_factor)``, runs a batched
``[E, cap, D] x [E, D, F]`` product and combines with the router gates.
Deepseek-style shared experts and llama4's top-1 routing are supported.

Two orders are the reference's and are kept:

* ``jax.lax.top_k`` keeps the lower expert index on tied probabilities: the
  port sorts with a stable descending sort (``torch.topk`` gives no such
  promise);
* the combine ``y.at[copy_token].add`` accumulates a token's K copies in
  bf16, one rounding per add, in copy order: the port adds them one by one
  in that order (a CUDA ``index_add_`` uses atomics and would reorder the
  sum for ``top_k >= 3``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .layers import F32, mlp_apply, mlp_spec
from .params import Leaf, dense, mm, weight


def moe_spec(cfg: ModelConfig):
    m: MoEConfig = cfg.moe
    E, D, Fd = m.num_experts, cfg.d_model, m.d_ff_expert
    p = {
        "router": dense(D, E, scale=D**-0.5),
        "w_in": Leaf((E, D, Fd), "normal", D**-0.5),
        "w_gate": Leaf((E, D, Fd), "normal", D**-0.5),
        "w_out": Leaf((E, Fd, D), "normal", Fd**-0.5),
    }
    if m.num_shared:
        p["shared"] = mlp_spec(D, m.d_ff_shared * m.num_shared, "swiglu")
    return p


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_by_expert(expert_ids: torch.Tensor, num_experts: int, capacity: int):
    """(slot, keep) of each routed token copy in an [E * cap] buffer
    (``moe.py:40``): a stable sort by expert, each copy's rank within its
    expert's run, and the first ``capacity`` of each run kept."""
    M = expert_ids.shape[0]
    order = torch.sort(expert_ids, stable=True).indices
    sorted_e = expert_ids[order]
    first = torch.searchsorted(sorted_e, torch.arange(num_experts, device=expert_ids.device,
                                                      dtype=sorted_e.dtype), side="left")
    pos = torch.arange(M, device=expert_ids.device) - first[sorted_e]
    keep = pos < capacity
    slot = sorted_e * capacity + torch.clamp(pos, max=capacity - 1)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(M, device=order.device))
    return slot[inv], keep[inv]


def moe_apply(cfg: ModelConfig, params, x, *, return_aux: bool = False):
    """x: [B, S, D] -> [B, S, D]."""
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    N = B * S
    E, K = m.num_experts, m.top_k
    dt = x.dtype
    xf = x.reshape(N, D)
    logits = mm(xf, weight(params, "router", dt)).to(F32)  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, K)  # [N, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    capacity = int(max(1, -(-K * N // E) * m.capacity_factor))
    flat_e = expert_ids.reshape(N * K)
    slot, keep = _group_by_expert(flat_e, E, capacity)
    copy_token = torch.arange(N * K, device=x.device) // K  # repeat(arange(N), K), no host sync
    # dispatch: dropped copies go to a spare row past the buffer
    src = torch.where(keep, slot, E * capacity)
    buf = torch.zeros((E * capacity + 1, D), dtype=dt, device=x.device)
    buf = buf.index_put((src,), xf[copy_token])[:E * capacity].reshape(E, capacity, D)
    # expert compute
    h = mm(buf, weight(params, "w_in", dt))
    g = mm(buf, weight(params, "w_gate", dt))
    h = F.silu(g.to(F32)).to(dt) * h
    yb = mm(h, weight(params, "w_out", dt)).reshape(E * capacity, D)
    # combine: a token's K copies are rows n*K .. n*K+K-1, added in that order
    y_copies = yb[torch.clamp(slot, max=E * capacity - 1)]
    y_copies = torch.where(keep[:, None], y_copies, 0.0)
    y_copies = (y_copies * gate_vals.reshape(N * K, 1).to(dt)).reshape(N, K, D)
    y = torch.zeros((N, D), dtype=dt, device=x.device)
    for j in range(K):
        y = y + y_copies[:, j]
    if m.num_shared:
        y = y + mlp_apply(params["shared"], xf, "swiglu")
    out = y.reshape(B, S, D)
    if return_aux:
        me = probs.mean(0)
        ce = torch.zeros(E, dtype=F32, device=x.device).index_add(0, flat_e, keep.to(F32)) / max(N * K, 1)
        aux = {"load_balance_loss": E * torch.sum(me * ce),
               "dropped_frac": 1.0 - keep.to(F32).mean()}
        return out, aux
    return out
