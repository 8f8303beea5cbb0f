"""Holding the sharded serving step (:mod:`.sharded`) on R ranks against the
single-process port (``lm.forward`` / ``lm.decode_step``). The CPU tests
(4 gloo ranks) and ``chip_smoke.py``'s 4 gloo ranks on one card both run
:func:`run_case` on every rank and :func:`hold` on its result, with the
bounds set here.

A case: a prefill of ``batch`` x ``prompt`` tokens (pixtral: and its
patches) and ``steps`` teacher-forced decode steps (the same tokens in both
runs, each run on its own caches) from a cache of ``cache_len`` positions
filled with seeded random k/v, at positions ``start`` ... (past the end of a
windowed ring, so the rings wrap). The sharded run differs from the single
process where it sums elsewhere: a row-parallel product sums its M partials
in fp32 before its one bf16 rounding (the single product accumulates in one
order), and a decode over a sequence split over "data" combines the ranks'
partial softmaxes. Each bf16 rounding that lands elsewhere moves a value by
an ulp, and the layers carry it on, more of them the deeper the model. A
distance is max |sharded - single| / max |single| over the rank's block
(logits, caches): bf16's spacing is 2**-7 of a value at the bottom of its
binade.

* :data:`SMOKE_BOUNDS`, the CPU tests' (two-layer smoke configs): measured
  on 4 CPU ranks over the five dense / vlm / audio smoke families, the (2,
  2) serve, (1, 4) tp, (2, 2) tp_attn_rep and (4, 1) sequence-split meshes,
  prompts of 24 to 64 tokens and attention chunks of 8 to 512, two seeds
  each: at most 0.0084 (prefill), 0.0089 (decode), 0.0047 (caches), about
  one ulp; the two moe smoke configs on (2, 2) serve, (1, 4) tp and (4, 1):
  at most 0.0058 / 0.0086 / 0.0044. The bound allows two ulps (2**-6).
* :func:`card_bounds`, gemma3-1b at full width and depth (26 layers) on the
  card (chip_smoke.py (x2), NVIDIA H100 80GB HBM3, 700.00 W), a bound for
  each case and number. (1, 4) tp and (4, 1) serve (:data:`BOUNDS`): the
  case's reading plus a quarter. (2, 2) serve: :data:`FLOOR_TIMES` times the
  floor the same run measures, the single process run on the rank's rows
  alone against its own batch run (cuBLAS picks other kernels for other
  shapes: 0.016-0.038 on the card). Every moe case (deepseek-v2-236b at
  full width, 2 blocks): :data:`FLOOR_TIMES` times the floor of the same
  run, the rank's rows alone where the batch splits over "data", else the
  widest of each row alone, each against the batch, with no routed copy
  dropped in either run (:func:`single_case`). The ssm and hybrid cases
  (rwkv6-1.6b and zamba2-1.2b at full width, cut in depth) are held the
  same way on every mesh (:data:`FLOOR_FAMILIES`), their floor the larger of
  that one and the tensor-parallel arithmetic's in one process
  (:class:`OneRank`: each column-parallel product in the ranks' column
  blocks, each row-parallel one as M fp32 partials summed before one
  rounding, against the plain single process). So is gemma3-1b's (2, 2)
  case at B = 4 (its scan repetitions split over "data"): a part of two
  rows alone gives the batch's prefill bits on the card (its prefill floor
  read 0, the sharded prefill 0.0082-0.0103), so the row-parallel partial
  sums' own floor (:class:`OneRank`) joins it wherever the batch splits
  over "data" into parts of more than one row. On the card a part of the
  batch alone gives the batch's bits for both models, while the sharded
  arithmetic moves rwkv6's prefill logits by ~0.3 of the largest (its
  chunked recurrence amplifies a rounding; in one process on the CPU at
  D = 512 the partial sums alone move them 0.043-0.048).
* The routed experts (:func:`routed_rank`: the first MoE layer without its
  shared experts, on seeded activations) on every rank equal the single
  process's rows bit for bit: the capacity and the copies' positions are
  the call's global ones, and a GEMM row does not depend on the others. On
  the card that holds for the experts' batched GEMM (a block of 40 or 80 of
  160 experts, other rows zeroed: bit-equal) but not for the router's
  product of a rank's rows where the batch splits over "data" (cuBLAS
  rounds 512 of 1024 rows elsewhere): there the rank must pick the single
  process's experts, and its output lie within :data:`ROUTED_SPLIT_ROWS`
  (measured 0.0047-0.0050, deepseek-v2-236b's first 2 blocks at (2, 2)).
* Where a rank runs the whole batch with no partial sums (M = 1, a batch
  that does not split over "data"), its prefill is the single process's
  bit for bit. At B = 1 on (4, 1) (long_500k's split: the recurrent states,
  token shifts and conv windows gathered over "data" before the step reads
  them, :func:`~.sharded.make_decode_step`) there is no floor: rwkv6-1.6b,
  whose caches are all gathered, is held bit for bit in every number;
  zamba2-1.2b, whose shared attention's ring splits its slots, to
  gemma3-1b's (4, 1) bound (:func:`card_bounds`).

At full width these distances cannot tell fp32 partials from partials
rounded to bf16 before the sum, as XLA's partitioned program rounds them
(0.047-0.057 from its own one-device program on pixtral's smoke logits).
:func:`rounded_once` does: the first block's ``w_out`` product at the
model's width, through the rank's row-parallel product, against the
correctly rounded product (fp64); at most :data:`ROUNDED_ONCE` of its
outputs may differ from it, and the same partials rounded to bf16 before
the sum must miss it, so the check tells the two apart in every run. Shares
missed, measured (port / single product / bf16 partials): CPU smoke configs
0-1.5e-4 / 5e-5-1.2e-4 / 0.37-0.41; gemma3-1b on the card 0.0011-0.0022 /
0.0040 / 0.37-0.40.

The bytes each rank handed its communicator in a step equal the dry-run's
count of the same step on ``meta`` exactly, and greedy sampling over the
ranks picks the single process's tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..launch.comm import CountingComm
from ..launch import op_cost
from ..models import lm
from ..models import moe as MOE
from ..models.params import LOW_DTYPE, index_tree, leaves, leaves_with_path, mm, path_key
from ..train import sharded_check as TC
from . import sharded as SS

SMOKE_BOUNDS = {"prefill": 2**-6, "decode": 2**-6, "caches": 2**-6}
# the card's, gemma3-1b at full width, by (mesh, serve layout): the readings
# (1, 4) tp 0.0206 / 0.0475 / 0.0313, (4, 1) serve 0 / 0.0380 / 0.0284, plus a quarter
BOUNDS = {"1x4/tp": {"prefill": 0.026, "decode": 0.06, "caches": 0.04},
          "4x1/serve": {"prefill": 0.0, "decode": 0.048, "caches": 0.036}}
FLOOR_TIMES = 1.5  # (2, 2) serve on the card: each number within 1.5 x the same run's floor
# the families whose card bounds on every mesh are FLOOR_TIMES x the floor the same run measures
FLOOR_FAMILIES = ("moe", "ssm", "hybrid")
# the families whose floor also takes the tensor-parallel arithmetic in one process (OneRank)
TP_FLOOR_FAMILIES = ("ssm", "hybrid")
ROUNDED_ONCE = 2**-7  # the share of a row-parallel product's outputs that may miss the correctly rounded one
# the routed part on the card where the batch's rows split over "data": the single process's experts, within
# one bf16 ulp of its largest value (cuBLAS rounds the router product of a rank's rows elsewhere)
ROUTED_SPLIT_ROWS = 2**-7


def inputs(cfg, *, batch: int, prompt: int, cache_len: int, steps: int, seed: int = 0,
           window_override=None, device="cpu") -> dict:
    """A case's inputs from ``seed`` (numpy, then moved to ``device``): the
    prefill batch, the decode tokens, the initial caches (N(0, 1) in each
    leaf's dtype: bf16, the recurrent states fp32)."""
    rng = np.random.default_rng(seed)
    tok = (batch, cfg.num_codebooks, prompt) if cfg.num_codebooks else (batch, prompt)
    out = {"batch": {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, tok).astype(np.int32))}}
    if cfg.num_patches:
        out["batch"]["patches"] = torch.from_numpy(
            rng.standard_normal((batch, cfg.num_patches, cfg.d_model)).astype(np.float32)).bfloat16()
    one = (batch, cfg.num_codebooks, 1) if cfg.num_codebooks else (batch, 1)
    out["tokens"] = [torch.from_numpy(rng.integers(0, cfg.vocab_size, one).astype(np.int32)) for _ in range(steps)]
    zeros = lm.cache_init(cfg, batch, cache_len, window_override=window_override, device="meta")
    out["caches"] = _map(lambda t: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)).to(t.dtype),
                         zeros)
    return _map(lambda t: t.to(device), out)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _block(want: torch.Tensor, got: torch.Tensor, layout) -> torch.Tensor:
    """The rank's block of a single-process result: its rows over "data"
    where ``got`` has fewer, its vocabulary block over "model" where ``got``
    has fewer columns."""
    a, m = layout.coords
    if got.shape[0] < want.shape[0]:
        want = want.narrow(0, a * got.shape[0], got.shape[0])
    if got.shape[-1] < want.shape[-1]:
        want = want.narrow(-1, m * got.shape[-1], got.shape[-1])
    return want


def _dist(got, want) -> float:
    """max |got - want| / max |want|: the largest difference in units of the
    largest value (bf16's spacing is 2**-7 of a value at the bottom of its
    binade, 2**-8 at the top)."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _counted(fn, *args) -> dict:
    with op_cost.counting() as c:
        fn(*args)
    return {k: float(v) for k, v in c.coll.items()}


def with_capacity(cfg, capacity_factor: float):
    """``cfg`` with its experts' ``capacity_factor`` replaced."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))


def _no_drops(cfg):
    """``cfg`` where no routed copy drops: an expert gets at most one copy
    a token, and capacity_factor E / K gives every expert the call's N."""
    return with_capacity(cfg, cfg.moe.num_experts / cfg.moe.top_k) if cfg.moe is not None else cfg


def _first_moe(tree):
    """The first MoE layer's parameters (of a scan segment, its first repetition)."""
    if isinstance(tree, dict):
        if "moe" in tree:
            node = tree["moe"]
            return node if node["router"].dim() == 2 else index_tree(node, 0)
        found = (_first_moe(v) for v in tree.values())
    elif isinstance(tree, list):
        found = (_first_moe(v) for v in tree)
    else:
        return None
    return next((f for f in found if f is not None), None)


def _routed_cfg(cfg):
    """``cfg`` without shared experts: ``moe_apply`` of it is the routed part."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_shared=0))


def routed_inputs(cfg, batch: int, prompt: int, device="cpu") -> torch.Tensor:
    """The routed check's activations [batch, prompt, d_model] (bf16, seeded)."""
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.standard_normal((batch, prompt, cfg.d_model)).astype(np.float32)).to(
        device=device, dtype=LOW_DTYPE)


def routed_single(cfg, params, *, batch: int, prompt: int, split: int, device="cpu") -> dict:
    """The single process's routed part (``moe_apply`` without the shared
    experts) of the first MoE layer on :func:`routed_inputs` (``out``), its
    capacity and dropped copies, and whether a capacity taken from the
    tokens of one of ``split`` data ranks (each rank routing its own range
    from position 0) would drop other copies (``local_drops_differ``; None
    where the batch does not split)."""
    node, rc = _first_moe(params.tree), _routed_cfg(cfg)
    x = routed_inputs(cfg, batch, prompt, device)
    m = cfg.moe
    with torch.no_grad():
        out = MOE.moe_apply(rc, node, x)
        _, gates, ids = MOE.route(rc, node, x.reshape(-1, cfg.d_model))
    flat = ids.reshape(-1)
    N = batch * prompt
    cap = MOE.capacity(m, N)
    keep = MOE._group_by_expert(flat, m.num_experts, cap)[1]
    res = {"out": out, "ids": ids.reshape(batch, prompt, -1), "gates": gates.reshape(batch, prompt, -1),
           "capacity": cap, "dropped": int((~keep).sum()), "copies": int(keep.numel()), "local_drops_differ": None}
    if split > 1:
        n = flat.numel() // split
        local = [MOE._group_by_expert(flat[a * n:(a + 1) * n], m.num_experts, MOE.capacity(m, N // split))[1]
                 for a in range(split)]
        res["local_capacity"] = MOE.capacity(m, N // split)
        res["local_drops_differ"] = not torch.equal(torch.cat(local), keep)
    return res


def routed_rank(cfg, layout, aux, sp, want: dict, *, batch: int, prompt: int, device="cpu") -> dict:
    """The rank's routed part on its rows of :func:`routed_inputs` (its
    experts' shard context, ``aux`` carrying the collectives) against the
    single process's (``want``, :func:`routed_single`): ``equal`` bit for
    bit, its distance (``dist``), and whether the rank's router picks the
    single process's experts (``routes_equal``) with its gates bit for bit
    (``gates_equal``)."""
    tp = SS.ServeShard(cfg, layout, aux, rows=layout.rows_split(batch))
    x = layout.local_batch({"x": routed_inputs(cfg, batch, prompt, device)})["x"]
    node, rc = _first_moe(sp.tree), _routed_cfg(cfg)
    with torch.no_grad():
        got = MOE.moe_apply(rc, node, x, tp=tp)
        _, gates, ids = MOE.route(rc, node, x.reshape(-1, cfg.d_model), tp)
    mine = _rows(want["out"], got, layout)
    bits = lambda a, b: bool(a.shape == b.shape and torch.equal(a, b))  # noqa: E731
    return {"equal": bits(got.view(torch.int16), mine.view(torch.int16)), "dist": _dist(got, mine),
            "max_abs": float((got.float() - mine.float()).abs().max()),
            "routes_equal": bits(ids, _rows(want["ids"], got, layout).reshape(ids.shape)),
            "gates_equal": bits(gates.view(torch.int32), _rows(want["gates"], got, layout).reshape(gates.shape).view(
                torch.int32)),
            "experts": tp.model_block(node, "w_in", -3),
            **{k: want[k] for k in ("capacity", "dropped", "copies", "local_drops_differ", "local_capacity")
               if k in want}}


class OneRank(TC.OneRank):
    """The sharded serving step's arithmetic in one process over ``parts``
    "model" ranks: the training floor's context (row-parallel products as
    ``parts`` fp32 partials summed before one rounding) whose column-parallel
    products also run in ``parts`` contiguous column blocks, the ranks'
    shapes, where the columns split into ``parts``. The values are the single
    process's, rounded as the ranks round them."""

    def col_mm(self, x, ws):
        out = []
        for w in ws:
            n = w.shape[-1] // self.parts
            out.append(mm(x, w) if w.shape[-1] % self.parts else
                       torch.cat([mm(x, w[..., i * n:(i + 1) * n].contiguous()) for i in range(self.parts)], -1))
        return out


def _tp_floor(cfg, params, x, out, *, parts: int, start: int, chunk: int, kw: dict) -> dict:
    """The distances of :class:`OneRank`'s prefill, decode steps and last
    caches from the single process's (``out``), over the whole batch."""
    one = OneRank(cfg, parts)
    sp = SS.shard_params(params, one.layout)
    floor = {"prefill": _dist(lm.forward(cfg, sp, x["batch"], chunk=chunk, remat=False, tp=one, **kw),
                              out["prefill"]), "decode": 0.0}
    caches = x["caches"]
    for i, tok in enumerate(x["tokens"]):
        logits, caches = lm.decode_step(cfg, sp, caches, tok, start + i, tp=one, **kw)
        floor["decode"] = max(floor["decode"], _dist(logits, out["decode"][i]))
    floor["caches"] = max(_dist(a, b) for a, b in zip(leaves(caches), leaves(out["caches"])))
    return floor


def single_case(cfg, params, *, batch: int, prompt: int, cache_len: int, steps: int, start: int, split: int = 1,
                model: int = 1, window_override=None, chunk: int = 512, device="cpu") -> dict:
    """The single process's side of a case (:func:`run_case`) on
    ``params``: the prefill logits, each decode step's logits and the last
    caches; the floor (``floor``, by part): the same program on a part of
    the batch alone against its batch run (each of ``split`` data ranks'
    rows, or, for the :data:`FLOOR_FAMILIES` where the batch does not split,
    each row), with no routed copy
    dropped in either (an MoE's capacity is the call's, so a part alone
    would drop others); over ``model`` > 1 ranks, for the
    :data:`TP_FLOOR_FAMILIES` and where the batch splits over "data" into
    parts of more than one row, also :class:`OneRank`'s distances
    (``tp_floor``); and for an MoE the routed part (:func:`routed_single`)."""
    x = inputs(cfg, batch=batch, prompt=prompt, cache_len=cache_len, steps=steps, seed=1,
               window_override=window_override, device=device)
    kw = dict(window_override=window_override)
    out = {"decode": []}
    with torch.no_grad():
        out["prefill"] = lm.forward(cfg, params, x["batch"], chunk=chunk, remat=False, **kw)
        caches = x["caches"]
        for i, tok in enumerate(x["tokens"]):
            logits, caches = lm.decode_step(cfg, params, caches, tok, start + i, **kw)
            out["decode"].append(logits)
    out["caches"] = caches
    out["floor"] = {}
    # where the batch does not split, each row alone: the floor of an MoE, ssm or hybrid case (gemma3-1b's
    # cases have BOUNDS)
    by_floor = cfg.family in FLOOR_FAMILIES
    n, parts = (batch // split, range(split)) if split > 1 else (1, range(batch if by_floor and batch > 1 else 0))
    fc = _no_drops(cfg)
    pick = lambda t, a: t.narrow(0, a * n, n)  # noqa: E731
    with torch.no_grad():
        if parts:  # the batch run with no copy dropped (the case's own where nothing can drop)
            whole = {"prefill": out["prefill"], "decode": out["decode"], "caches": caches} if fc is cfg else None
            if whole is None:
                whole = {"prefill": lm.forward(fc, params, x["batch"], chunk=chunk, remat=False, **kw), "decode": []}
                cw = x["caches"]
                for i, tok in enumerate(x["tokens"]):
                    logits, cw = lm.decode_step(fc, params, cw, tok, start + i, **kw)
                    whole["decode"].append(logits)
                whole["caches"] = cw
        for a in parts:
            alone = lm.forward(fc, params, {k: pick(v, a) for k, v in x["batch"].items()}, chunk=chunk, remat=False,
                               **kw)
            floor = {"prefill": _dist(alone, pick(whole["prefill"], a)), "decode": 0.0}
            c = SS.cache_rows(x["caches"], a * n, n)
            for i, tok in enumerate(x["tokens"]):
                alone, c = lm.decode_step(fc, params, c, pick(tok, a), start + i, **kw)
                floor["decode"] = max(floor["decode"], _dist(alone, pick(whole["decode"][i], a)))
            floor["caches"] = max(_dist(g, w) for g, w in zip(leaves(c), leaves(SS.cache_rows(whole["caches"], a * n,
                                                                                                n))))
            out["floor"][a] = floor
            del alone, c
    if model > 1 and (cfg.family in TP_FLOOR_FAMILIES or split > 1 and batch // split > 1):
        with torch.no_grad():
            out["tp_floor"] = _tp_floor(cfg, params, x, out, parts=model, start=start, chunk=chunk, kw=kw)
    if cfg.moe is not None:
        out["routed"] = routed_single(cfg, params, batch=batch, prompt=prompt, split=split, device=device)
    return out


def run_case(cfg, layout, comm, aux, *, batch: int, prompt: int, cache_len: int, steps: int, start: int,
             window_override=None, chunk: int = 512, device="cpu", want: Optional[dict] = None) -> dict:
    """One case on this rank (every rank of the mesh calls it): the single
    process first (:func:`single_case` of ``lm_init(seed=0)``; or ``want``,
    its result computed elsewhere, so that no rank need hold the whole
    model), then the sharded step on the rank's blocks of the same
    parameters (:func:`~.sharded.init_params`). Returns the distances
    (``prefill``, ``decode`` per step, ``caches``), the floor (this rank's
    data index's where the batch splits, else the largest of the rows';
    :data:`FLOOR_TIMES` times it is a full-width case's bound),
    :func:`rounded_once`, the bytes handed to ``comm`` a step (``moved``)
    and the same steps' count on ``meta`` (``counted``), how greedy
    sampling over the ranks (``aux`` gathers for the checks) compares with
    the argmax of the gathered logits (``greedy_equal``) and of the single
    process's (``greedy_single``, the share of equal tokens;
    ``greedy_margin``, how far below the single process's largest logit
    the picked tokens' lie there), and for an MoE :func:`routed_rank`."""
    split = layout.rows_split(batch)
    case = dict(batch=batch, prompt=prompt, cache_len=cache_len, steps=steps, start=start,
                window_override=window_override, chunk=chunk, device=device)
    if want is None:
        params = lm.lm_init(cfg, device=device, seed=0)
        want = single_case(cfg, params, split=split, model=layout.model_size, **case)
        del params
    x = inputs(cfg, batch=batch, prompt=prompt, cache_len=cache_len, steps=steps, seed=1,
               window_override=window_override, device=device)
    kw = dict(window_override=window_override)
    n = next(iter(layout.local_batch(x["batch"]).values())).shape[0]
    if split > 1:  # the floor of the rank's rows; where every rank holds the batch, the widest part's
        floor = want["floor"][layout.coords[0]]
    else:
        floor = {k: max(f[k] for f in want["floor"].values()) for k in ("prefill", "decode", "caches")} \
            if want["floor"] else None
    if "tp_floor" in want:  # the tensor-parallel arithmetic in one process, where it moves more
        floor = {k: max(floor[k] if floor else 0.0, want["tp_floor"][k]) for k in ("prefill", "decode", "caches")}
    sp = SS.init_params(cfg, layout, seed=0, device=device)
    checked = rounded_once(cfg, layout, aux, sp, device)
    prefill = SS.make_prefill_step(cfg, layout, comm, chunk=chunk, **kw)
    decode = SS.make_decode_step(cfg, layout, comm, batch, cache_len, **kw)
    # the dry-run's count of the same steps on meta
    counter = CountingComm()
    meta_p = SS.shard_params(lm.lm_init(cfg, device="meta"), layout)
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    counted = {"prefill": _counted(SS.make_prefill_step(cfg, layout, counter, chunk=chunk, **kw), meta_p,
                                   _map(meta, x["batch"])),
               "decode": _counted(SS.make_decode_step(cfg, layout, counter, batch, cache_len, **kw), meta_p,
                                  _map(meta, SS.shard_caches(x["caches"], cfg, layout)), meta(x["tokens"][0]),
                                  torch.empty((), dtype=torch.int64, device="meta"))}
    before = dict(comm.bytes)
    got_pf = prefill(sp, x["batch"])
    moved = {"prefill": {k: float(v - before.get(k, 0)) for k, v in comm.bytes.items() if v - before.get(k, 0)}}
    res = {"prefill": _dist(got_pf, _block(want["prefill"], got_pf, layout)), "decode": [],
           "heads": SS.attention_heads(cfg, layout).__dict__, "moe": cfg.moe is not None, "rows_split": split,
           "by_floor": cfg.family in FLOOR_FAMILIES, "family": cfg.family,
           "ssm_heads": None if SS.recurrent_heads(cfg, layout) is None else SS.recurrent_heads(cfg, layout).__dict__,
           # the whole batch on this rank and no partial sums: the single process's arithmetic
           "prefill_exact": layout.model_size == 1 and n == batch}
    del got_pf
    lc = SS.shard_caches(x["caches"], cfg, layout)
    for i, tok in enumerate(x["tokens"]):
        before = dict(comm.bytes)
        got, lc = decode(sp, lc, tok, torch.tensor(start + i, device=tok.device))
        step = {k: float(v - before.get(k, 0)) for k, v in comm.bytes.items() if v - before.get(k, 0)}
        if moved.setdefault("decode", step) != step:
            raise AssertionError(f"decode step {i} handed {step}, step 0 {moved['decode']}")
        res["decode"].append(_dist(got, _block(want["decode"][i], got, layout)))
    want_c = SS.shard_caches(want["caches"], cfg, layout)
    res["caches"] = max(_dist(a, b) for a, b in zip(leaves(lc), leaves(want_c)))
    res["cache_bytes"] = sum(t.numel() * t.element_size() for t in leaves(lc))
    res["cache_bytes_specs"] = SS.cache_bytes(layout, want["caches"])
    # the rank's cache bytes at rest by the kind of split over the data axes (serve/sharded.cache_split), and
    # each "other" leaf's
    kinds = leaves(SS.cache_split(want["caches"], layout).kinds)
    res["cache_bytes_by_kind"], res["other_leaf_bytes"] = {}, {}
    for (path, t), k in zip(leaves_with_path(lc), kinds):
        res["cache_bytes_by_kind"][str(k)] = res["cache_bytes_by_kind"].get(str(k), 0) + t.numel() * t.element_size()
        if k == "other":
            res["other_leaf_bytes"][path_key(path)] = t.numel() * t.element_size()
    res["seq_split"] = "seq" in kinds
    res["param_numel"] = sp.flat.numel()
    res["param_numel_specs"] = SS.param_numel(layout, sp.global_spec)
    res["moved"], res["counted"], res["floor"], res["rounded_once"] = moved, counted, floor, checked
    # greedy sampling over the ranks' blocks, against the argmax of the gathered rows
    tokens = SS.greedy(got, layout, aux, cfg.vocab_size)
    if got.shape[-1] < cfg.vocab_size:
        full = SS.gather_dim(aux, layout, got.contiguous(), got.dim() - 1, "model")
    else:
        full = got
    res["greedy_equal"] = bool(torch.equal(tokens, full.argmax(-1)))
    single = _rows(want["decode"][-1], got, layout).float()
    res["greedy_single"] = float((tokens == single.argmax(-1)).float().mean())
    res["greedy_margin"] = float((single.amax(-1) - single.gather(-1, tokens[..., None])[..., 0]).max()
                                 / single.abs().max())
    if cfg.moe is not None:
        res["routed"] = routed_rank(cfg, layout, aux, sp, want["routed"], batch=batch, prompt=prompt, device=device)
    return res


def _first(tree, name: str):
    """The first dict node of ``tree`` that holds ``name``; of a scan
    segment, its first repetition."""
    if isinstance(tree, dict):
        if name in tree:
            while tree[name].dim() > 2:
                tree = index_tree(tree, 0)
            return tree
        found = (_first(v, name) for v in tree.values())
    elif isinstance(tree, list):
        found = (_first(v, name) for v in tree)
    else:
        return None
    return next((f for f in found if f is not None), None)


def rounded_once(cfg, layout, aux, sp, device) -> Optional[dict]:
    """The row-parallel product alone, at the model's width: ``x @ w_out``
    of the first block's MLP for 256 random bf16 rows, as the rank computes
    it (``ServeShard.row_mm``: fp32 partials summed over "model", rounded
    once; ``port``), as the single process does (``mm`` of the whole
    weight, gathered from the ranks' blocks; ``single``), and with each
    rank's partial rounded to bf16 before the sum (``bf16``). Each is the
    share of outputs that differ from the correctly rounded product (fp64,
    rounded to bf16). None where M = 1 (nothing is summed over ranks).
    ``aux`` carries the collectives."""
    if layout.model_size == 1:
        return None
    mine = _first(sp.tree, "w_out")
    w = mine["w_out"]
    for dim, entry in enumerate(mine.specs["w_out"]):
        if entry is not None:
            w = SS.gather_dim(aux, layout, w.contiguous(), dim, layout.axis(entry))
    w = w.to(LOW_DTYPE)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(256, w.shape[0], generator=g).to(LOW_DTYPE).to(device)
    exact = (x.double() @ w.double()).to(LOW_DTYPE)
    tp = SS.ServeShard(cfg, layout, aux)
    first, count = tp.model_block(mine, "w_out", -2)
    partial = mm(x[:, first:first + count], tp.weight(mine, "w_out", LOW_DTYPE)).float()
    missed = lambda y: float((y != exact).float().mean())  # noqa: E731
    with torch.no_grad():
        return {"port": missed(tp.row_mm(x, mine, "w_out")), "single": missed(mm(x, w)),
                "bf16": missed(aux.all_reduce(partial, "model").to(LOW_DTYPE))}


def _rows(want, got, layout):
    """The rank's rows of a single-process result, every column."""
    a = layout.coords[0]
    return want.narrow(0, a * got.shape[0], got.shape[0]) if got.shape[0] < want.shape[0] else want


def card_bounds(case: str, res: dict) -> dict:
    """The card's bounds of a case (``"mesh/serve layout"``) at full width:
    gemma3-1b's :data:`BOUNDS`, or for its (2, 2) serve and every case of
    the :data:`FLOOR_FAMILIES` :data:`FLOOR_TIMES` times the floor this rank
    measured in the same run; an MoE case whose batch rows split over
    "data" also bounds the routed part by :data:`ROUTED_SPLIT_ROWS`
    (elsewhere it is bit for bit). A case of the :data:`FLOOR_FAMILIES` with
    no floor (one row, every rank the whole batch, M = 1: the long_500k
    split at B = 1 on (4, 1)) is bit for bit where no ring splits its slots
    (the caches gathered over "data" are bit copies, the arithmetic the
    single process's), else held to gemma3-1b's bound of the same mesh,
    whose sequence split it shares."""
    if res["by_floor"] and res["floor"] is None and res["prefill_exact"]:
        return BOUNDS[case] if res["seq_split"] else {"prefill": 0.0, "decode": 0.0, "caches": 0.0}
    if case in BOUNDS and not res["by_floor"]:
        return BOUNDS[case]
    if (case != "2x2/serve" and not res["by_floor"]) or res["floor"] is None:
        raise KeyError(f"no card bounds for {case}")
    out = {k: FLOOR_TIMES * v for k, v in res["floor"].items()}
    if res["moe"] and res["rows_split"] > 1:
        out["routed"] = ROUTED_SPLIT_ROWS
    return out


def hold(name: str, res: dict, bounds: dict) -> None:
    """Raise where a case's result is outside ``bounds`` (a prefill that
    runs the single process's arithmetic: 0), its row-parallel product is
    not rounded once (or the check would not have told), greedy sampling
    picks other tokens than the single process (an MoE case: tokens not
    tied with them; an ssm or hybrid case: tokens whose single-process
    logits lie farther below the largest than the decode bound), its bytes
    differ from the count, or an MoE's routed
    part is not the single process's rows bit for bit (``bounds["routed"]``:
    the same experts within that distance)."""
    worst = {"prefill": res["prefill"], "decode": max(res["decode"]), "caches": res["caches"]}
    limit = dict(bounds, prefill=0.0) if res["prefill_exact"] else bounds
    bad = {k: v for k, v in worst.items() if not v <= limit[k]}
    if bad:
        raise AssertionError(f"{name}: {bad} past the bounds {limit}")
    ro = res["rounded_once"]
    if ro is not None and not ro["port"] <= ROUNDED_ONCE < ro["bf16"]:
        raise AssertionError(f"{name}: shares of the row-parallel product's outputs not correctly rounded {ro}: "
                             f"the port's must be at most {ROUNDED_ONCE}, bf16 partials' above it")
    if res["moved"] != res["counted"]:
        raise AssertionError(f"{name}: bytes handed to the communicator {res['moved']} != counted {res['counted']}")
    if not res["greedy_equal"]:
        raise AssertionError(f"{name}: greedy over the ranks differs from the argmax of the gathered logits")
    # an MoE case may pick another of the single process's tokens tied at its largest bf16 logit; an ssm or
    # hybrid case one whose logit there lies within the decode bound of the largest (the bound lets every logit
    # move that far: rwkv6's full-width tp case picks one 0.00325 of the largest below it, its bound 0.039)
    tie = res["moe"] and res["greedy_margin"] == 0.0
    near = res.get("family") in TP_FLOOR_FAMILIES and res["greedy_margin"] <= bounds["decode"]
    if res["greedy_single"] != 1.0 and not (tie or near):
        raise AssertionError(f"{name}: greedy over the ranks picks the single process's token in a share "
                             f"{res['greedy_single']} of the rows")
    routed, lim = res.get("routed"), bounds.get("routed", 0.0)
    if routed is not None and not (routed["equal"] or (routed["routes_equal"] and routed["dist"] <= lim)):
        raise AssertionError(f"{name}: the routed experts' output differs from the single process's rows (distance "
                             f"{routed['dist']}, the same experts {routed['routes_equal']}; bound {lim})")
    if res["param_numel"] != res["param_numel_specs"]:
        raise AssertionError(f"{name}: the rank holds {res['param_numel']} parameters, the specs "
                             f"{res['param_numel_specs']}")
