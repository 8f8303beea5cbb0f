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
  on 4 CPU ranks over the five ported smoke families, the (2, 2) serve,
  (1, 4) tp, (2, 2) tp_attn_rep and (4, 1) sequence-split meshes, prompts
  of 24 to 64 tokens and attention chunks of 8 to 512, two seeds each: at
  most 0.0084 (prefill), 0.0089 (decode), 0.0047 (caches), about one ulp;
  the bound allows two (2**-6).
* :func:`card_bounds`, gemma3-1b at full width and depth (26 layers) on the
  card (chip_smoke.py (x2), NVIDIA H100 80GB HBM3, 700.00 W), a bound for
  each case and number. (1, 4) tp and (4, 1) serve (:data:`BOUNDS`): the
  case's reading plus a quarter. (2, 2) serve: :data:`FLOOR_TIMES` times the
  floor the same run measures, the single process run on the rank's rows
  alone against its own batch run (cuBLAS picks other kernels for other
  shapes: 0.016-0.038 on the card).
* Where a rank runs the whole batch with no partial sums (M = 1, a batch
  that does not split over "data"), its prefill is the single process's
  bit for bit.

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

from typing import Optional

import numpy as np
import torch

from ..launch.comm import CountingComm
from ..launch import op_cost
from ..models import lm
from ..models.params import LOW_DTYPE, index_tree, leaves, mm, weight
from . import sharded as SS

SMOKE_BOUNDS = {"prefill": 2**-6, "decode": 2**-6, "caches": 2**-6}
# the card's, gemma3-1b at full width, by (mesh, serve layout): the readings
# (1, 4) tp 0.0206 / 0.0475 / 0.0313, (4, 1) serve 0 / 0.0380 / 0.0284, plus a quarter
BOUNDS = {"1x4/tp": {"prefill": 0.026, "decode": 0.06, "caches": 0.04},
          "4x1/serve": {"prefill": 0.0, "decode": 0.048, "caches": 0.036}}
FLOOR_TIMES = 1.5  # (2, 2) serve on the card: each number within 1.5 x the same run's floor
ROUNDED_ONCE = 2**-7  # the share of a row-parallel product's outputs that may miss the correctly rounded one


def inputs(cfg, *, batch: int, prompt: int, cache_len: int, steps: int, seed: int = 0,
           window_override=None, device="cpu") -> dict:
    """A case's inputs from ``seed`` (numpy, then moved to ``device``): the
    prefill batch, the decode tokens, the initial caches (N(0, 1) in bf16)."""
    rng = np.random.default_rng(seed)
    tok = (batch, cfg.num_codebooks, prompt) if cfg.num_codebooks else (batch, prompt)
    out = {"batch": {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, tok).astype(np.int32))}}
    if cfg.num_patches:
        out["batch"]["patches"] = torch.from_numpy(
            rng.standard_normal((batch, cfg.num_patches, cfg.d_model)).astype(np.float32)).bfloat16()
    one = (batch, cfg.num_codebooks, 1) if cfg.num_codebooks else (batch, 1)
    out["tokens"] = [torch.from_numpy(rng.integers(0, cfg.vocab_size, one).astype(np.int32)) for _ in range(steps)]
    zeros = lm.cache_init(cfg, batch, cache_len, window_override=window_override, device="meta")
    out["caches"] = _map(lambda t: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)).bfloat16(),
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


def run_case(cfg, layout, comm, aux, *, batch: int, prompt: int, cache_len: int, steps: int, start: int,
             window_override=None, chunk: int = 512, device="cpu") -> dict:
    """One case on this rank (every rank of the mesh calls it): the single
    process first (``lm_init(seed=0)``), then the sharded step on
    :func:`~.sharded.shard_params` of the same parameters. Returns the
    distances (``prefill``, ``decode`` per step, ``caches``), the floor
    (the single process on the rank's rows alone, where it holds fewer than
    ``batch``), :func:`rounded_once`, the bytes handed to ``comm`` a step
    (``moved``) and the same steps' count on ``meta`` (``counted``), and
    how greedy sampling over the ranks (``aux`` gathers for the checks)
    compares with the argmax of the gathered logits (``greedy_equal``) and
    of the single process's (``greedy_single``, the share of equal tokens)."""
    params = lm.lm_init(cfg, device=device, seed=0)
    x = inputs(cfg, batch=batch, prompt=prompt, cache_len=cache_len, steps=steps, seed=1,
               window_override=window_override, device=device)
    kw = dict(window_override=window_override)
    with torch.no_grad():
        want_pf = lm.forward(cfg, params, x["batch"], chunk=chunk, remat=False, **kw)
        caches, want_dec = x["caches"], []
        for i, tok in enumerate(x["tokens"]):
            logits, caches = lm.decode_step(cfg, params, caches, tok, start + i, **kw)
            want_dec.append(logits)
    floor = None
    rows = layout.local_batch(x["batch"])
    n = next(iter(rows.values())).shape[0]
    if n < batch:  # the same program on the rank's rows alone: its own spread on this device
        a = layout.coords[0]
        narrow = lambda t: t.narrow(t.dim() - 4, a * n, n)  # noqa: E731
        with torch.no_grad():
            alone = lm.forward(cfg, params, rows, chunk=chunk, remat=False, **kw)
            floor = {"prefill": _dist(alone, _rows(want_pf, alone, layout)), "decode": 0.0}
            del alone
            c = _map(narrow, x["caches"])
            for i, tok in enumerate(x["tokens"]):
                alone, c = lm.decode_step(cfg, params, c, tok[a * n:(a + 1) * n], start + i, **kw)
                floor["decode"] = max(floor["decode"], _dist(alone, _rows(want_dec[i], alone, layout)))
            floor["caches"] = max(_dist(g, w) for g, w in zip(leaves(c), leaves(_map(narrow, caches))))
            del alone, c
    sp = SS.shard_params(params, layout)
    checked = rounded_once(cfg, layout, aux, params, sp, device)
    del params
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
    res = {"prefill": _dist(got_pf, _block(want_pf, got_pf, layout)), "decode": [],
           "heads": SS.attention_heads(cfg, layout).__dict__,
           # the whole batch on this rank and no partial sums: the single process's arithmetic
           "prefill_exact": layout.model_size == 1 and n == batch}
    del want_pf, got_pf
    lc = SS.shard_caches(x["caches"], cfg, layout)
    for i, tok in enumerate(x["tokens"]):
        before = dict(comm.bytes)
        got, lc = decode(sp, lc, tok, torch.tensor(start + i, device=tok.device))
        step = {k: float(v - before.get(k, 0)) for k, v in comm.bytes.items() if v - before.get(k, 0)}
        if moved.setdefault("decode", step) != step:
            raise AssertionError(f"decode step {i} handed {step}, step 0 {moved['decode']}")
        res["decode"].append(_dist(got, _block(want_dec[i], got, layout)))
    want_c = SS.shard_caches(caches, cfg, layout)
    res["caches"] = max(_dist(a, b) for a, b in zip(leaves(lc), leaves(want_c)))
    res["cache_bytes"] = sum(t.numel() * t.element_size() for t in leaves(lc))
    res["cache_bytes_specs"] = SS.cache_bytes(layout, caches)
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
    res["greedy_single"] = float((tokens == _rows(want_dec[-1], got, layout).argmax(-1)).float().mean())
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


def rounded_once(cfg, layout, aux, params, sp, device) -> Optional[dict]:
    """The row-parallel product alone, at the model's width: ``x @ w_out``
    of the first block for 256 random bf16 rows, as the rank computes
    it (``ServeShard.row_mm``: fp32 partials summed over "model", rounded
    once; ``port``), as the single process does (``mm``; ``single``), and
    with each rank's partial rounded to bf16 before the sum (``bf16``). Each
    is the share of outputs that differ from the correctly rounded product
    (fp64, rounded to bf16). None where M = 1 (nothing is summed over
    ranks). ``aux`` carries the collectives."""
    if layout.model_size == 1:
        return None
    whole, mine = _first(params.tree, "w_out"), _first(sp.tree, "w_out")
    w = weight(whole, "w_out", LOW_DTYPE)
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
    """The card's bounds of a case (``"mesh/serve layout"``) at gemma3-1b's
    full width: :data:`BOUNDS`'s, or for (2, 2) serve :data:`FLOOR_TIMES`
    times the floor this rank measured in the same run."""
    if case in BOUNDS:
        return BOUNDS[case]
    if case != "2x2/serve" or res["floor"] is None:
        raise KeyError(f"no card bounds for {case}")
    return {k: FLOOR_TIMES * v for k, v in res["floor"].items()}


def hold(name: str, res: dict, bounds: dict) -> None:
    """Raise where a case's result is outside ``bounds`` (a prefill that
    runs the single process's arithmetic: 0), its row-parallel product is
    not rounded once (or the check would not have told), greedy sampling
    picks other tokens than the single process, or its bytes differ from
    the count."""
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
    if res["greedy_single"] != 1.0:
        raise AssertionError(f"{name}: greedy over the ranks picks the single process's token in a share "
                             f"{res['greedy_single']} of the rows")
    if res["param_numel"] != res["param_numel_specs"]:
        raise AssertionError(f"{name}: the rank holds {res['param_numel']} parameters, the specs "
                             f"{res['param_numel_specs']}")
