"""Dry-run: count every (arch x shape) step for the production meshes on
``meta`` and derive its H100 roofline terms; with ``--measure``, also run the
step, reduced to one card, and put its measured time beside the bound of
the same counted work (counterpart of ``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out runs/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --measure   # on the card

The reference lowers and compiles a partitioned SPMD program for 256 or 512
devices and reads per-device totals from its HLO. The port compiles no
program; it counts on ``meta`` (:mod:`.op_cost`) either one rank of its own
sharded program (``"split": "per_rank"``) or the whole step once, split
evenly over the mesh's devices (``"split": "even"``, no collective term,
``collective_note`` says why). Per rank:

* the serving shapes (prefill_32k, decode_32k, long_500k) of every family
  (those of the ssm and hybrid families at long_500k's B = 1 aside): rank 0 of ``serve/sharded.py``'s step under
  ``--serve-layout`` (ZeRO-3 gathers over "data", tensor parallelism over
  "model", the routed experts over "model" on E); ``state_bytes_per_device`` puts the rank's parameters and
  caches beside the reference's ``param_specs`` / ``cache_specs``;
* a train shape of every family on a ("data", "model") mesh: one rank of ``train/sharded.py``'s step, by default with
  tensor parallelism over "model" (the reference's ``worker`` layout), with
  ``--train-act-model-sharded`` under ``act_spec`` instead (the record
  ``<arch>__<shape>__<mesh>__act.json``, any family without experts);
  ``state_bytes_per_device`` puts the rank's flat state (its blocks, or
  its whole rows, and its ZeRO-1 slices) beside the reference's per-leaf
  specs.

A per-rank record's collectives' result-shape bytes by kind
(``collective_bytes_per_device``) give the roofline's third term. Its bytes
are the eager program's, op by op; there is no XLA memory analysis
(``argument_bytes`` is the built arguments' size) and no saved HLO.

``--measure`` runs the step on one card (``--device``, the card by
default; there is no CPU fallback) at the sizes of :data:`REDUCED`, times it
with CUDA events (median of :data:`REPS` after :data:`WARMUP`), counts the
same reduced step on ``meta`` and records ``roofline_share`` (bound / time)
and, for train and prefill, ``mfu`` (MODEL_FLOPS / (time x peak)).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
import traceback

import numpy as np
import torch

from .. import configs, obs
from ..kernels import runtime
from ..models import lm
from ..models.params import FlatParams, leaf_sizes, map_tree, stacked
from ..serve import sharded as SS
from . import op_cost, roofline
from . import sharding as sh
from .mesh import make_hierarchical_mesh, make_production_mesh
from .specs import (META, SHAPES, build, compressed_draws, decode_token, long_ctx_window, serve_batch,
                    train_parts)

log = obs.get_logger("dryrun")

DEFAULT_OUT = "runs/dryrun_torch"
COLLECTIVE_KINDS = ("all-gather", "reduce-scatter", "all-reduce")
# why a record of the even split has no collective term; the build's meta["even_note"] says what is not ported
EVEN_NOTE = ("collective_s is None: this step is counted once for the whole mesh and split evenly, because the "
             "port has no program of it across ranks: ")
WARMUP, REPS = 2, 5
# the measured step on one card: how each shape is cut to fit it
REDUCED = {
    "train_4k": dict(workers=2, batch_per_worker=1,
                     cut="W = 2 workers x 1 sequence of 4096 (global batch 2 of 256)"),
    "prefill_32k": dict(batch=1, cut="batch 1 of 32"),
    "decode_32k": dict(batch=16, cut="batch 16 of 128"),
    "long_500k": dict(batch=1, cut="none"),
}


def argument_bytes(tree) -> int:
    """Bytes of the tensors an argument tree holds (a ``FlatParams``: its
    fp32 masters and their bf16 copy)."""
    if isinstance(tree, FlatParams):
        return argument_bytes([tree.flat, tree.flat_low])
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(argument_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(argument_bytes(v) for v in tree)
    return 0


def count(kind: str, fn, *args, one_worker: bool = True) -> op_cost.OpCount:
    """The op count of ``fn(*args)`` (a train step: W workers counted as one
    worker's pass, :func:`.op_cost.one_worker_for_all`, unless
    ``one_worker`` is False)."""
    with op_cost.counting() as c:
        if kind == "train" and one_worker:
            with op_cost.one_worker_for_all(c):
                fn(*args)
        else:
            fn(*args)
    return c


def mesh_name(multi_pod: bool, hierarchical_workers: int) -> str:
    if hierarchical_workers:
        return f"wk{hierarchical_workers}x{16 // hierarchical_workers}x16"
    return "2x16x16" if multi_pod else "16x16"


def run_one(arch: str, shape: str, *, multi_pod: bool = False, downlink: str = "marina:perm",
            verbose: bool = True, serve_layout: str = "serve", remat_policy=None,
            train_act_model_sharded: bool = False, hierarchical_workers: int = 0,
            measure: bool = False, device="cuda") -> dict:
    mesh = (make_hierarchical_mesh(hierarchical_workers) if hierarchical_workers
            else make_production_mesh(multi_pod=multi_pod))
    chips = mesh.size
    t0 = time.perf_counter()
    built = build(arch, shape, mesh, downlink_spec=downlink, serve_layout=serve_layout,
                  remat_policy=remat_policy, train_act_model_sharded=train_act_model_sharded)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = count(built.meta["kind"], built.fn, *built.args)
    t_count = time.perf_counter() - t0
    cfg, kind = built.meta["cfg"], built.meta["kind"]
    per_rank = built.meta.get("split") == "per_rank"
    if per_rank:  # one rank's step: the count is per device, collectives included
        flops_dev, bytes_dev = c.total_flops, c.total_bytes
        flops, nbytes = flops_dev * chips, bytes_dev * chips
        coll = {k: float(c.coll[k]) for k in COLLECTIVE_KINDS}
        coll_dev = c.total_coll
    else:
        flops, nbytes = c.total_flops, c.total_bytes
        flops_dev, bytes_dev = flops / chips, nbytes / chips
        coll = coll_dev = None
    mf = roofline.model_flops(cfg, kind, built.meta["global_batch"], built.meta["seq"])
    terms = roofline.roofline_terms(flops_dev, bytes_dev, coll_dev)
    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name(multi_pod, hierarchical_workers),
        "chips": chips,
        "kind": kind,
        "downlink": downlink if kind == "train" else None,
        "serve_layout": serve_layout if kind != "train" else None,
        "remat_policy": remat_policy,
        "window_override": built.meta.get("window"),
        "t_build_s": round(t_build, 3),
        "t_count_s": round(t_count, 3),
        "flops_global": flops,
        "bytes_global": nbytes,
        "split": "per_rank" if per_rank else "even",
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll,
        "collective_total_per_device": coll_dev,
        "argument_bytes": argument_bytes(built.args),
        "top_ops": c.top(),
        "model_flops": mf,
        "useful_flops_ratio": mf / flops if flops else None,
        "roofline": terms,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    if per_rank and kind == "train":
        act = built.meta["act_spec"]
        rec["act_spec"] = list(act) if act is not None else None
        rec["tensor_parallel"] = built.meta["layout"].tp
        rec["state_bytes_per_device"] = state_bytes_per_device(built)
    elif per_rank:
        rec["state_bytes_per_device"] = serve_state_bytes(built)
    else:
        rec["collective_note"] = EVEN_NOTE + built.meta["even_note"]
    if verbose:
        log.info(f"{arch:26s} {shape:12s} mesh={rec['mesh']:8s} count={t_count:6.1f}s "
                 f"flops={flops:.3e} bytes={nbytes:.3e} dominant={terms['dominant'].replace('_s', '')}")
    obs.default_tracker().log({"dryrun": {
        "arch": arch, "shape": shape, "mesh": rec["mesh"], "t_count_s": t_count,
        "flops_global": flops, "bytes_global": nbytes, "dominant": terms["dominant"]}})
    if measure:
        rec["measured"] = measure_step(arch, shape, device=device, downlink=downlink)
    return rec


def state_bytes_per_device(built) -> dict:
    """Per-device bytes of the counted rank's train state (``server``,
    ``opt``, ``workers``) in the port's flat ZeRO-1 layout, beside the same
    state under the reference's per-leaf specs (``sharding.param_specs``:
    ``server`` for the master and the moments, ``worker`` for the replicas)."""
    state, specs = built.args[0], built.specs[0]
    mesh = built.meta["layout"].mesh
    tree = lm.lm_spec(built.meta["cfg"])

    def spec_bytes(tree, spec, itemsize):
        if isinstance(spec, sh.Spec):
            return sh.local_numel(tree.shape, spec, mesh) * itemsize
        keys = spec.keys() if isinstance(spec, dict) else range(len(spec))
        return sum(spec_bytes(tree[k], spec[k], itemsize) for k in keys)

    ref = spec_bytes(tree, specs["server"], 4)
    ref += sum(spec_bytes(tree, specs["opt"][k], 4) for k, v in state["opt"].items()
               if isinstance(v, torch.Tensor))
    if "workers" in state:
        w = state["workers"]
        wtree = map_tree(lambda leaf: stacked(leaf, built.meta["W"]), tree) if w.dim() == 2 else tree
        ref += spec_bytes(wtree, specs["workers"], w.element_size())
    flat = argument_bytes([state[k] for k in ("server", "opt", "workers") if k in state])
    return {"flat_zero1": flat, "param_specs": ref}


def serve_state_bytes(built) -> dict:
    """Per-device bytes of the counted serving rank's parameters (its
    blocks' fp32 masters and bf16 copy, beside the reference's bf16
    parameters under the same ``param_specs``) and, for a decode shape, its
    caches (beside the same caches under the reference's ``cache_specs``,
    which do not split the kv heads over "model")."""
    layout = built.meta["layout"]
    out = {"params": SS.param_bytes(layout, lm.lm_spec(built.meta["cfg"]))}
    if "caches" in built.meta:
        out["caches"] = {"port": argument_bytes(built.args[1]),
                         "cache_specs": SS.cache_bytes(layout, built.meta["caches"])}
    return out


# ---------------------------------------------------------------------------
# the measured step on one card
# ---------------------------------------------------------------------------


def card_name() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s first line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _time_ms(dev, fn, warmup=WARMUP, reps=REPS):
    """CUDA-event times in ms of ``reps`` calls of ``fn()`` after ``warmup``,
    and the last call's output (each earlier one is dropped before the next
    call, so no two are held at once)."""
    for _ in range(warmup):
        fn()
    times, out = [], None
    for _ in range(reps):
        out = None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        out = fn()
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def _train_case(cfg, dev, downlink_spec):
    from ..data import SyntheticLMData
    from ..train import init_state
    from ..train import downlink as D

    r = REDUCED["train_4k"]
    W, B, S = r["workers"], r["batch_per_worker"], SHAPES["train_4k"]["seq"]
    step, dl, tcfg, opt = train_parts(cfg, W, downlink_spec=downlink_spec)
    sizes = leaf_sizes(lm.lm_spec(cfg))
    gen, dgen = torch.Generator().manual_seed(0), torch.Generator(dev).manual_seed(0)
    draws = D.draw_round(dl, sizes, gen, dgen)
    while draws.coin:  # the compressed round, as the count
        draws = D.draw_round(dl, sizes, gen, dgen)
    state = {"s": init_state(cfg, tcfg, dl, opt, seed=0, device=dev)}
    batch = SyntheticLMData(cfg, W, B, S, device=str(dev)).batch(0)

    def run():
        state["s"], m = step(state["s"], batch, draws)
        return m["loss"]

    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device=META) for k, v in batch.items()}
    counted = count("train", step, init_state(cfg, tcfg, dl, opt, device=META), meta_batch,
                    compressed_draws(dl, sizes))
    return run, counted, dict(workers=W, global_batch=W * B, seq=S)


def _prefill_case(cfg, dev, params):
    r = REDUCED["prefill_32k"]
    B, S = r["batch"], SHAPES["prefill_32k"]["seq"]
    gen = torch.Generator(dev).manual_seed(0)
    batch = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=gen, device=dev, dtype=v.dtype)
                 if k == "tokens" else torch.randn(v.shape, generator=gen, device=dev).to(v.dtype))
             for k, v in serve_batch(cfg, B, S).items()}

    def run():
        with torch.no_grad():
            return lm.forward(cfg, params, batch, chunk=512)

    with torch.no_grad():
        counted = count("prefill", lm.forward, cfg, lm.lm_init(cfg, device=META), serve_batch(cfg, B, S))
    return run, counted, dict(global_batch=B, seq=S)


def _decode_case(cfg, dev, params, shape):
    from ..serve import DecodeEngine
    from ..serve.engine import decode_into

    B, S = REDUCED[shape]["batch"], SHAPES[shape]["seq"]
    window = long_ctx_window(cfg) if shape == "long_500k" else None
    eng = DecodeEngine(cfg, params, cache_len=S, batch_size=B, window_override=window, device=dev)
    step = eng._stepper()
    gen = torch.Generator(dev).manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, tuple(decode_token(cfg, B).shape), generator=gen, device=dev)

    def run():
        return step(tok, S - 1)

    with torch.no_grad():
        counted = count("decode", lambda *a: decode_into(*a, window_override=window), cfg,
                        lm.lm_init(cfg, device=META),
                        lm.cache_init(cfg, B, S, window_override=window, device=META),
                        torch.empty(tok.shape, dtype=tok.dtype, device=META),
                        torch.empty((), dtype=torch.int64, device=META))
    return run, counted, dict(global_batch=B, seq=S, window_override=window)


def _card(device) -> torch.device:
    """``device`` as an indexed CUDA device; raises for any other."""
    dev = runtime.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_step times a step on the card, not on {dev}")
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


def measure_step(arch: str, shape: str, *, device="cuda", downlink: str = "marina:perm",
                 params=None) -> dict:
    """Run ``shape``'s step of ``arch`` on the card at :data:`REDUCED`'s
    sizes and return its measured record: ms (median of :data:`REPS` CUDA-
    event times after :data:`WARMUP`), peak memory, the count of the same
    step on ``meta``, its roofline on one card, ``roofline_share``, ``mfu``
    (train, prefill), the kernels it launched, the card. The step runs at
    the reference's precision (no TF32, ``set_reference_precision``), as the
    serving engine runs. ``params``: the serving shapes' weights
    (``lm_init(seed=0)`` if None)."""
    from ..models.layers import set_reference_precision

    dev = _card(device)
    cfg = configs.get(arch)
    kind = SHAPES[shape]["kind"]
    set_reference_precision()
    if kind != "train" and params is None:
        params = lm.lm_init(cfg, device=dev, seed=0)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = runtime.LAUNCHES.copy()
    if kind == "train":
        run, counted, sizes = _train_case(cfg, dev, downlink)
    elif kind == "prefill":
        run, counted, sizes = _prefill_case(cfg, dev, params)
    else:
        run, counted, sizes = _decode_case(cfg, dev, params, shape)
    times, out = _time_ms(dev, run)
    peak = torch.cuda.max_memory_allocated(dev)
    finite = bool(torch.isfinite(out).all())
    out_shape = list(out.shape)
    del out, run  # the step's state, batch or engine with it
    launches = {k: v - before.get(k, 0) for k, v in runtime.LAUNCHES.items() if v - before.get(k, 0)}
    torch.cuda.empty_cache()
    ms = float(np.median(times))
    mf = roofline.model_flops(cfg, kind, sizes["global_batch"], sizes["seq"])
    rec = derive_measured({
        "card": card_name(), "device": torch.cuda.get_device_name(dev),
        "reduced": REDUCED[shape]["cut"], **sizes,
        "ms": ms, "ms_runs": times, "warmup": WARMUP, "peak_bytes": peak,
        "output_shape": out_shape, "finite": finite,
        "flops": counted.total_flops, "bytes": counted.total_bytes, "top_ops": counted.top(),
        "model_flops": mf, "launches": launches}, kind)
    log.info(f"{arch} {shape} measured: {ms:.3f} ms, peak {peak / 2**30:.2f} GiB, bound "
             f"{rec['roofline']['bound_s'] * 1e3:.3f} ms ({rec['roofline']['dominant']}), share "
             f"{rec['roofline_share']:.4f}, mfu {rec['mfu']} ({rec['card']})")
    return rec


def record_problems(rec: dict) -> list:
    """What is wrong with a dry-run record (empty: valid): counts finite and
    positive, a dominant term, a collective term exactly where the count is
    one rank's (``per_rank``; an ``even`` record says why it has none), the
    useful-FLOPs ratio in (0, 1.05 x the
    embedding allowance] (MODEL_FLOPS charges an untied embedding table 2
    FLOPs a token, but a lookup multiplies nothing: rwkv6-1.6b's 8% of its
    parameters), and a measured step finite with a positive share (the
    eager byte count is a proxy: the card's L2 may beat it)."""
    cfg = configs.get(rec["arch"])
    n = cfg.active_param_count()
    table = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model * max(cfg.num_codebooks, 1)
    out = []
    for k in ("flops_global", "bytes_global", "model_flops"):
        if not (np.isfinite(rec[k]) and rec[k] > 0):
            out.append(f"{k} = {rec[k]}")
    t = rec["roofline"]
    if t.get("dominant") not in ("compute_s", "memory_s", "collective_s") or not t["bound_s"] > 0:
        out.append(f"roofline {t}")
    if rec.get("split") == "per_rank" and not (t.get("collective_s") or 0) > 0:
        out.append(f"a per-rank count without a collective term: {t}")
    if rec.get("split") == "even" and (t.get("collective_s") is not None or not rec.get("collective_note")):
        out.append(f"an even split with a collective term or without the note that says why: {t}")
    ratio, limit = rec["useful_flops_ratio"], 1.05 * n / (n - table)
    if not (ratio is not None and 0 < ratio <= limit):
        out.append(f"useful_flops_ratio {ratio} outside (0, {limit:.4f}]")
    m = rec.get("measured")
    if m is not None and not (m["finite"] and 0 < m["roofline_share"] < float("inf") and m["ms"] > 0):
        out.append(f"measured: finite {m['finite']}, share {m['roofline_share']}, ms {m['ms']}")
    return out


def derive_measured(m: dict, kind: str) -> dict:
    """A measured record's roofline terms (one card), ``roofline_share`` and
    ``mfu`` from its counts and its ms."""
    m = dict(m)
    m["roofline"] = roofline.roofline_terms(m["flops"], m["bytes"])
    s = m["ms"] / 1e3
    m["roofline_share"] = m["roofline"]["bound_s"] / s
    m["mfu"] = m["model_flops"] / (s * roofline.PEAK_FLOPS) if kind in ("train", "prefill") else None
    return m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--downlink", default="marina:perm")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--serve-layout", default="serve", choices=["serve", "tp", "tp_attn_rep"])
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--train-act-model-sharded", action="store_true")
    ap.add_argument("--hierarchical-workers", type=int, default=0)
    ap.add_argument("--measure", action="store_true",
                    help="also run each step on the card at its reduced size and time it")
    ap.add_argument("--device", default="cuda", help="where --measure runs (the card; no CPU fallback)")
    args = ap.parse_args(argv)

    archs = list(configs.ALIASES) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{mesh_name(mp, args.hierarchical_workers)}"
                if args.train_act_model_sharded and SHAPES[shape]["kind"] == "train":
                    tag += "__act"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    log.info(f"skip (cached) {tag}")
                    continue
                try:
                    rec = run_one(arch, shape, multi_pod=mp, downlink=args.downlink,
                                  serve_layout=args.serve_layout, remat_policy=args.remat_policy,
                                  train_act_model_sharded=args.train_act_model_sharded,
                                  hierarchical_workers=args.hierarchical_workers,
                                  measure=args.measure, device=args.device)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:  # noqa: BLE001 - report every combination, then fail
                    traceback.print_exc()
                    failures.append((tag, repr(e)))
    if failures:
        log.error(f"FAILURES ({len(failures)}):")
        for tag, err in failures:
            log.error(f"  {tag} {err[:200]}")
        raise SystemExit(1)
    log.info("all requested combinations counted OK")


if __name__ == "__main__":
    main()
