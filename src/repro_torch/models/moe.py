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

Experts over "model" (``tp``: a rank of the sharded serving step,
``serve/sharded.py``; the reference's spec splits E over "model", dim -3 of
``w_in`` / ``w_gate`` / ``w_out``): the router is read whole, so every rank
routes as the single process does. The capacity comes from the call's global
token count (the rank's N times the data ranks its batch rows split over,
``tp.rows``), and a copy's position within its expert is its global one: its
position among the rank's copies of that expert plus that expert's copies on
the lower data indices (:meth:`ServeShard.copies_before`, one all-gather of
the rank's [E] counts over "data"). So the same copies drop as in the single
process. The rank computes its E / M experts on a buffer at that global
capacity holding only its own copies: each expert's GEMM has the single
process's shape, and a row's product does not depend on the other rows. Each
model rank writes the gated outputs of the copies its experts own into [N,
K, D], zeros elsewhere, and one all-reduce over "model" sums them: exact,
since each copy has at most one owner. The K adds then run as in the single
process, so the routed part is the single process's rows bit for bit (on the
card, where the batch's rows split over "data", up to the router's product
of the rank's rows, which cuBLAS rounds elsewhere: ``serve/sharded_check``). Where
"model" does not divide E the spec leaves E whole: every rank computes every
expert, with no all-reduce. The shared expert is a tensor-parallel MLP.

Under autograd (the sharded train step's tensor parallelism): the routed
tokens ``xf`` enter "model" (``tp.enter``), since the router's gates and the
dispatch reach only the copies of the rank's experts, so each rank holds a
partial gradient of them; the router's gather sums its partial gradient back
(reduce-scatter) and the combine's all-reduce passes the whole one on. The
shared expert enters in its own column-parallel products. The capacity is
the worker's own call: each data index trains other workers on other rows,
so ``tp.rows`` stays 1 and the capacity is ``capacity(m, B * S)`` of the
rank's call, as in the single process, with no ``copies_before``.

A worker's rows split over ranks (the sharded train step's ``act_spec``
over "model", and the hierarchical mesh's rows over "data", with or without
a shard context): inside :func:`split_rows` the call is a contiguous range
of the worker's tokens, the capacity is the whole call's (the rank's N times
``rows``) and a copy's position is its global one, with the copies before
it on the lower indices of that axis from ``copies_before`` (the step's
all-gather of the [E] counts): the same mechanism as the data ranks' above,
so each row's routed part is the single process's and the same copies
drop. The counts are integers: no gradient flows through them. Training
adds no aux loss (the reference's train step does not ask ``return_aux``),
and ``return_aux`` is refused inside a split.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .layers import F32, _weight, mlp_apply, mlp_spec
from .params import Leaf, dense, mm


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


def route(cfg: ModelConfig, params, xf: torch.Tensor, tp=None):
    """(probs [N, E], gates [N, K] normalised, expert ids [N, K]) of the
    tokens ``xf`` [N, D]: the router read whole on a rank (``tp``)."""
    logits = mm(xf, _weight(params, "router", xf.dtype, tp, True)).to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, cfg.moe.top_k)
    return probs, gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9), expert_ids


def capacity(m: MoEConfig, tokens: int) -> int:
    """Copies an expert keeps in a call of ``tokens`` tokens (``moe.py:71``)."""
    return int(max(1, -(-m.top_k * tokens // m.num_experts) * m.capacity_factor))


_SPLIT = []  # the open split_rows contexts: (rows, copies_before)


@contextlib.contextmanager
def split_rows(rows: int, copies_before):
    """Inside it, a :func:`moe_apply` with no shard context is one part of a
    call split over ``rows`` ranks by contiguous token ranges: the capacity
    is the whole call's, and ``copies_before(counts [E]) -> [E]`` gives each
    expert's copies on the ranks before this one."""
    _SPLIT.append((rows, copies_before))
    try:
        yield
    finally:
        _SPLIT.pop()


def _group_by_expert(expert_ids: torch.Tensor, num_experts: int, capacity: int, before=None):
    """(slot, keep) of each routed token copy in an [E * cap] buffer
    (``moe.py:40``): a stable sort by expert, each copy's rank within its
    expert's run, and the first ``capacity`` of each run kept. ``before``:
    ``fn(counts) -> [E]``, each expert's copies that precede these in the
    global copy order (a rank's range of a split batch), from its [E]
    counts here; None: none."""
    M = expert_ids.shape[0]
    order = torch.sort(expert_ids, stable=True).indices
    sorted_e = expert_ids[order]
    experts = torch.arange(num_experts, device=expert_ids.device, dtype=sorted_e.dtype)
    first = torch.searchsorted(sorted_e, experts, side="left")
    pos = torch.arange(M, device=expert_ids.device) - first[sorted_e]
    if before is not None:
        pos = pos + before(torch.searchsorted(sorted_e, experts, side="right") - first)[sorted_e]
    keep = pos < capacity
    slot = sorted_e * capacity + torch.clamp(pos, max=capacity - 1)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(M, device=order.device))
    return slot[inv], keep[inv]


def moe_apply(cfg: ModelConfig, params, x, *, return_aux: bool = False, tp=None):
    """x: [B, S, D] -> [B, S, D]. ``tp``: a rank's shard context (the
    module's docstring); ``return_aux`` takes none with more than one rank."""
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    N = B * S
    E, K = m.num_experts, m.top_k
    dt = x.dtype
    if return_aux and (_SPLIT or tp is not None and (tp.model_size > 1 or tp.data_size > 1)):
        raise ValueError("moe_apply's aux losses are the single process's: no shard context across ranks")
    xf = x.reshape(N, D)
    # the rank's experts e0 .. e0 + ne - 1 (all of them unless E is split over "model")
    blk = None if tp is None else tp.model_block(params, "w_in", -3)
    e0, ne = blk if blk is not None else (0, E)
    xr = xf if blk is None else tp.enter(xf)  # routed to the rank's experts only
    probs, gate_vals, expert_ids = route(cfg, params, xr, tp)  # [N, E], [N, K], [N, K]
    # the call's tokens are this rank's N times rows; the copies before this rank's, by expert
    rows, before = _SPLIT[-1] if _SPLIT else (tp.rows, tp.copies_before) if tp is not None else (1, None)
    cap = capacity(m, N * rows)
    flat_e = expert_ids.reshape(N * K)
    slot, keep = _group_by_expert(flat_e, E, cap, None if rows == 1 else before)
    copy_token = torch.arange(N * K, device=x.device) // K  # repeat(arange(N), K), no host sync
    if blk is not None:  # the copies this rank's experts own; the others are as dropped here
        keep = keep & (flat_e >= e0) & (flat_e < e0 + ne)
        slot = slot - e0 * cap
    # dispatch: dropped copies go to a spare row past the buffer
    src = torch.where(keep, slot, ne * cap)
    buf = torch.zeros((ne * cap + 1, D), dtype=dt, device=x.device)
    buf = buf.index_put((src,), xr[copy_token])[:ne * cap].reshape(ne, cap, D)
    # expert compute
    h = mm(buf, _weight(params, "w_in", dt, tp))
    g = mm(buf, _weight(params, "w_gate", dt, tp))
    h = F.silu(g.to(F32)).to(dt) * h
    yb = mm(h, _weight(params, "w_out", dt, tp)).reshape(ne * cap, D)
    # combine: a token's K copies are rows n*K .. n*K+K-1, added in that order
    y_copies = yb[torch.clamp(slot, 0, ne * cap - 1)]
    y_copies = torch.where(keep[:, None], y_copies, 0.0)
    y_copies = (y_copies * gate_vals.reshape(N * K, 1).to(dt)).reshape(N, K, D)
    if blk is not None:  # each copy has one owner: the sum over "model" is exact
        y_copies = tp.all_reduce(y_copies, "model")
    y = torch.zeros((N, D), dtype=dt, device=x.device)
    for j in range(K):
        y = y + y_copies[:, j]
    if m.num_shared:
        y = y + mlp_apply(params["shared"], xf, "swiglu", tp)
    out = y.reshape(B, S, D)
    if return_aux:
        me = probs.mean(0)
        ce = torch.zeros(E, dtype=F32, device=x.device).index_add(0, flat_e, keep.to(F32)) / max(N * K, 1)
        aux = {"load_balance_loss": E * torch.sum(me * ce),
               "dropped_frac": 1.0 - keep.to(F32).mean()}
        return out, aux
    return out
