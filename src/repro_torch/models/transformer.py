"""Block composition and layer stacking (port of ``repro/models/transformer.py``).

A model is a sequence of blocks, one per entry of ``cfg.block_pattern``:

  attn / attn_local   pre-norm attention (+ window) + MLP
  moe                 pre-norm attention + MoE feed-forward
  mamba               Mamba2 (SSD) block
  rwkv                RWKV6 time-mix + channel-mix block
  shared              weight-tied attention block (zamba2): every ``shared``
                      slot uses the one parameter set ``shared_blk`` and its
                      own cache

The stacking plan is the reference's (``plan_stack``), because it fixes the
parameter tree and so the ravel order and the checkpoint keys: a periodic
pattern becomes a scan segment whose parameters are stacked ``[count, ...]``
leaves, everything else is unrolled. The reference scans a segment with
``lax.scan``; here it is a plain loop over the repetitions.

``tp``: the optional shard context of a rank of a sharded model
(:mod:`.layers`), passed on to every block's layers: attention (GQA or MLA,
the ``shared`` block's too), MLP, MoE, and the Mamba2 and RWKV-6 mixers
(:mod:`.ssm`), and to their RMSNorms.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from .config import ModelConfig
from .params import index_tree, map_tree, stacked

# ---------------------------------------------------------------------------
# Stacking plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str                      # "scan" | "unroll"
    block_kinds: Tuple[str, ...]   # super-block pattern (scan) or single kind
    count: int                     # scan repetitions (1 for unroll)
    first_layer: int               # absolute index of the segment's first layer


def plan_stack(pattern: Tuple[str, ...]) -> List[Segment]:
    """Cover the pattern with scan segments wherever a period repeats >= 2x
    (``transformer.py:45``): greedy left to right, periods 1..8, the one
    covering the most layers (>= 4) wins; otherwise unroll one layer."""
    n = len(pattern)
    segs: List[Segment] = []
    i = 0
    while i < n:
        best = None  # (covered, p, reps)
        for p in range(1, 9):
            reps = 1
            while i + (reps + 1) * p <= n and pattern[i + reps * p:i + (reps + 1) * p] == pattern[i:i + p]:
                reps += 1
            covered = reps * p
            if reps >= 2 and covered >= 4 and (best is None or covered > best[0]):
                best = (covered, p, reps)
        if best:
            covered, p, reps = best
            segs.append(Segment("scan", tuple(pattern[i:i + p]), reps, i))
            i += covered
        else:
            segs.append(Segment("unroll", (pattern[i],), 1, i))
            i += 1
    return segs


# ---------------------------------------------------------------------------
# Single block spec / apply / decode
# ---------------------------------------------------------------------------


def block_spec(cfg: ModelConfig, kind: str):
    D = cfg.d_model
    if kind in ("attn", "attn_local", "moe"):
        p = {"ln1": L.rmsnorm_spec(D),
             "attn": L.mla_spec(cfg) if cfg.mla else L.attention_spec(cfg),
             "ln2": L.rmsnorm_spec(D)}
        if kind == "moe":
            p["moe"] = MOE.moe_spec(cfg)
        else:
            p["mlp"] = L.mlp_spec(D, cfg.d_ff, cfg.mlp_kind)
        return p
    if kind == "mamba":
        return {"ln": L.rmsnorm_spec(D), "mamba": SSM.mamba_spec(cfg)}
    if kind == "rwkv":
        return {"ln1": L.rmsnorm_spec(D), "ln2": L.rmsnorm_spec(D), "rwkv": SSM.rwkv_spec(cfg)}
    if kind == "shared":
        return {}  # weight-tied: the parameters live in stack["shared_blk"]
    raise ValueError(kind)


def shared_block_spec(cfg: ModelConfig):
    """zamba2's weight-tied attention block."""
    return {"ln1": L.rmsnorm_spec(cfg.d_model), "attn": L.attention_spec(cfg),
            "ln2": L.rmsnorm_spec(cfg.d_model),
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.mlp_kind)}


def _attn_window(cfg: ModelConfig, kind: str, window_override) -> Optional[int]:
    if kind == "attn_local":
        return cfg.sliding_window
    return window_override  # the serving-time sliding-window variant for dense archs


def block_apply(cfg, kind, params, shared_params, x, *, window_override=None, chunk=512, tp=None):
    """Prefill forward of one block. x: [B, S, D]."""
    if kind == "shared":
        params, kind = shared_params, "attn"
    if kind in ("attn", "attn_local", "moe"):
        w = _attn_window(cfg, kind, window_override)
        kw = {} if tp is None else {"tp": tp}
        h = L.rmsnorm(params["ln1"], x, cfg.rms_eps, tp)
        attn = L.mla_apply if cfg.mla else L.attention_apply
        x = x + attn(cfg, params["attn"], h, window=w, chunk=chunk, **kw)
        h = L.rmsnorm(params["ln2"], x, cfg.rms_eps, tp)
        if kind == "moe":
            h = MOE.moe_apply(cfg, params["moe"], h, tp=tp)
        else:
            h = L.mlp_apply(params["mlp"], h, cfg.mlp_kind, tp)
        return x + h
    if kind == "mamba":
        return x + SSM.mamba_apply(cfg, params["mamba"], L.rmsnorm(params["ln"], x, cfg.rms_eps, tp), tp=tp)
    if kind == "rwkv":
        h = L.rmsnorm(params["ln1"], x, cfg.rms_eps, tp)
        x = x + SSM.rwkv_timemix_apply(cfg, params["rwkv"], h, tp=tp)
        h = L.rmsnorm(params["ln2"], x, cfg.rms_eps, tp)
        return x + SSM.rwkv_chanmix_apply(cfg, params["rwkv"], h, tp=tp)
    raise ValueError(kind)


def block_cache_init(cfg, kind, batch, cache_len, *, window_override=None,
                     dtype=L.COMPUTE_DTYPE, device=None):
    if kind == "shared":
        kind = "attn"
    if kind in ("attn", "attn_local", "moe"):
        w = _attn_window(cfg, kind, window_override)
        length = min(cache_len, w) if w else cache_len
        init = L.mla_cache_init if cfg.mla else L.attention_cache_init
        return init(cfg, batch, length, dtype, device)
    if kind == "mamba":
        return SSM.mamba_cache_init(cfg, batch, dtype, device)
    if kind == "rwkv":
        return SSM.rwkv_cache_init(cfg, batch, dtype, device)
    raise ValueError(kind)


def block_decode(cfg, kind, params, shared_params, x, cache, pos, *, window_override=None, tp=None):
    if kind == "shared":
        params, kind = shared_params, "attn"
    if kind in ("attn", "attn_local", "moe"):
        w = _attn_window(cfg, kind, window_override)
        kw = {} if tp is None else {"tp": tp}
        h = L.rmsnorm(params["ln1"], x, cfg.rms_eps, tp)
        decode = L.mla_decode if cfg.mla else L.attention_decode
        h, cache = decode(cfg, params["attn"], h, cache, pos, window=w, **kw)
        x = x + h
        h = L.rmsnorm(params["ln2"], x, cfg.rms_eps, tp)
        if kind == "moe":
            h = MOE.moe_apply(cfg, params["moe"], h, tp=tp)
        else:
            h = L.mlp_apply(params["mlp"], h, cfg.mlp_kind, tp)
        return x + h, cache
    if kind == "mamba":
        h, new = SSM.mamba_decode(cfg, params["mamba"], L.rmsnorm(params["ln"], x, cfg.rms_eps, tp),
                                  cache, pos, tp=tp)
        return x + h, new
    if kind == "rwkv":
        h = L.rmsnorm(params["ln1"], x, cfg.rms_eps, tp)
        tm_cache = {"state": cache["state"], "x_last": cache["x_last"]}
        hh, tm_new = SSM.rwkv_timemix_decode(cfg, params["rwkv"], h, tm_cache, pos, tp=tp)
        x = x + hh
        h2 = L.rmsnorm(params["ln2"], x, cfg.rms_eps, tp)
        x = x + SSM.rwkv_chanmix_apply(cfg, params["rwkv"], h2,
                                       x_last=cache["cm_x_last"].to(h2.dtype), tp=tp)
        return x, {"state": tm_new["state"], "x_last": tm_new["x_last"],
                   "cm_x_last": h2[:, 0].to(cache["cm_x_last"].dtype)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Stack spec / apply / decode
# ---------------------------------------------------------------------------


def stack_spec(cfg: ModelConfig):
    """The stack's parameter tree: ``segments`` (one block per unrolled
    segment; per scan segment a dict ``b<j>`` of the super-block's blocks
    with every leaf stacked ``[count, ...]``) and ``shared_blk``."""
    params: dict = {"segments": []}
    if "shared" in cfg.block_pattern:
        params["shared_blk"] = shared_block_spec(cfg)
    for seg in plan_stack(cfg.block_pattern):
        if seg.kind == "unroll":
            params["segments"].append(block_spec(cfg, seg.block_kinds[0]))
        else:
            blk = {f"b{j}": block_spec(cfg, bk) for j, bk in enumerate(seg.block_kinds)}
            params["segments"].append(map_tree(lambda leaf: stacked(leaf, seg.count), blk))
    return params


def _layers(cfg: ModelConfig, params):
    """(kind, block params, segment index, repetition, slot) of each layer in
    order; a scan segment's repetitions index its stacked leaves."""
    for si, (seg, seg_params) in enumerate(zip(plan_stack(cfg.block_pattern), params["segments"])):
        if seg.kind == "unroll":
            yield seg.block_kinds[0], seg_params, si, None, None
            continue
        for rep in range(seg.count):
            rep_params = index_tree(seg_params, rep)
            for j, bk in enumerate(seg.block_kinds):
                yield bk, rep_params[f"b{j}"], si, rep, f"b{j}"


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the matmuls with no batch dimension, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _make_checkpoint(remat: bool, remat_policy: Optional[str]):
    """``fn(f, x)``: ``f(x)``, under activation checkpointing when ``remat``
    and autograd records (``torch.no_grad`` runs it plainly)."""
    if remat_policy not in (None, "full", "dots"):
        raise ValueError(f"remat_policy {remat_policy!r} not in None / 'full' / 'dots'")
    if not remat:
        return lambda f, x: f(x)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)

    def run(f, x):
        if not torch.is_grad_enabled():
            return f(x)
        return checkpoint(f, x, use_reentrant=False, **kw)

    return run


def stack_apply(cfg: ModelConfig, params, x, *, window_override=None, chunk=512, remat=True,
                remat_policy=None, tp=None):
    shared = params.get("shared_blk")
    ckpt = _make_checkpoint(remat, remat_policy)
    segs = plan_stack(cfg.block_pattern)
    for seg, seg_params in zip(segs, params["segments"]):
        reps = [seg_params] if seg.kind == "unroll" else [index_tree(seg_params, r)
                                                           for r in range(seg.count)]
        for rep_params in reps:
            def body(h, rep_params=rep_params, seg=seg):
                for j, bk in enumerate(seg.block_kinds):
                    p = rep_params if seg.kind == "unroll" else rep_params[f"b{j}"]
                    h = block_apply(cfg, bk, p, shared, h, window_override=window_override,
                                    chunk=chunk, tp=tp)
                return h

            x = ckpt(body, x)
    return x


def stack_cache_init(cfg: ModelConfig, batch: int, cache_len: int, *, window_override=None,
                     dtype=L.COMPUTE_DTYPE, device=None):
    """Per-layer caches grouped by segment (stacked ``[count, ...]`` for a
    scan segment), all zeros."""
    caches = []
    for seg in plan_stack(cfg.block_pattern):
        if seg.kind == "unroll":
            caches.append(block_cache_init(cfg, seg.block_kinds[0], batch, cache_len,
                                           window_override=window_override, dtype=dtype,
                                           device=device))
        else:
            one = {f"b{j}": block_cache_init(cfg, bk, batch, cache_len,
                                             window_override=window_override, dtype=dtype,
                                             device=device)
                   for j, bk in enumerate(seg.block_kinds)}
            caches.append(map_tree(lambda t: t.expand((seg.count,) + t.shape).clone(), one))
    return caches


def stack_decode(cfg: ModelConfig, params, caches, x, pos, *, window_override=None, tp=None):
    """One decode step through every layer; returns (x, new caches), the new
    caches in the layout of ``caches``."""
    shared = params.get("shared_blk")
    new = [None if seg.kind == "unroll" else [dict() for _ in range(seg.count)]
           for seg in plan_stack(cfg.block_pattern)]
    for kind, blk, si, rep, slot in _layers(cfg, params):
        if rep is None:
            x, new[si] = block_decode(cfg, kind, blk, shared, x, caches[si], pos,
                                      window_override=window_override, tp=tp)
        else:
            cache = map_tree(lambda t: t[rep], caches[si][slot])
            x, new[si][rep][slot] = block_decode(cfg, kind, blk, shared, x, cache, pos,
                                                 window_override=window_override, tp=tp)
    for si, seg in enumerate(plan_stack(cfg.block_pattern)):
        if seg.kind == "scan":
            # [{slot: cache}] per repetition -> {slot: cache of stacked leaves}
            new[si] = map_tree(lambda *ts: torch.stack(ts), *new[si])
    return x, new
