"""Milliseconds a step of the sharded train step, 4 gloo ranks on one card.

    PYTHONPATH=<tree>/src python <this file> [--cases NAME ...] [--steps 3] [--device cpu] [--out FILE]

One process group of 4 ranks (``torch.multiprocessing.spawn``, ``file://``
rendezvous), every rank on the one card (or on the CPU with ``--device
cpu``), runs each case of :data:`CASES` in turn: seed 1's state shared out
(``train/sharded.init_state``), one warm-up step, then ``steps`` steps from
a synthetic batch, each between a card synchronisation and a barrier on
every rank. For each case it prints and writes to ``--out`` (JSON) rank 0's
ms of each timed step and their median, the bytes the step handed to gloo
by kind (``Comm.bytes``, one step) and the largest peak memory of a rank.
No single-process step runs beside it, so the time is the sharded step's
alone; its correctness is ``sharded_check.run_case``'s (chip_smoke.py
(w2)).

Run it as a file with ``PYTHONPATH`` naming the tree to time: it imports
only ``repro_torch``, so one copy times an earlier tree of the port too (the
cases whose step that tree has; before ``connect`` took ``act``, an
``act_spec`` case's layout is the one made without ``cfg``). Two trees are
compared within one call on one card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
# name -> (arch, downlink, replicas' dtype, rows a worker, sequence, attention chunk, mesh axes, mesh shape,
# mode, workers): the EF21-P cases of chip_smoke.py (w2) (and the hierarchical one of the CPU tests), "arch/n"
# the full-width config cut to its first n layers; mode "data", "act" (act_spec over "model"), "tp" (tensor
# parallelism over "model"), "hier" (the hierarchical mesh) or "hier_act" (act_spec there)
DM, HIER = ("data", "model"), ("wk", "data", "model")
CASES = {
    "ef21p/gemma-2b/data": ("gemma-2b", "ef21p:16:64", "float32", 2, 64, 32, DM, (4, 1), "data", 4),
    "ef21p/gemma-2b/act": ("gemma-2b", "ef21p:16:64", "float32", 2, 64, 32, DM, (2, 2), "act", 4),
    "ef21p/deepseek-v2-236b/tp": ("deepseek-v2-236b", "ef21p:16:64", "float32", 2, 64, 32, DM, (2, 2), "tp", 4),
    "ef21p/llama4-maverick-400b-a17b/tp": ("llama4-maverick-400b-a17b", "ef21p:16:64", "float32", 2, 64, 32, DM,
                                           (1, 4), "tp", 4),
    "ef21p/gemma3-1b/2/tp": ("gemma3-1b/2", "ef21p:128:1024", "float32", 1, 128, 128, DM, (1, 4), "tp", 2),
    "ef21p/gemma-2b/hier": ("gemma-2b", "ef21p:16:64", "float32", 2, 64, 32, HIER, (1, 2, 2), "hier", 1),
    "ef21p/demo-100m/hier_act": ("demo-100m", "ef21p:128:1024", "float32", 4, 128, 128, HIER, (1, 2, 2), "hier_act",
                                 1),
}


def config(arch: str):
    """The smoke config ``arch``, demo-100m, or "arch/n": the full-width
    config's first n layers (gemma3-1b's a local and a global one)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.train_lm import model_100m

    if arch == "demo-100m":
        return model_100m()
    if arch == "gemma3-1b/2":
        return dataclasses.replace(configs.get("gemma3-1b"), num_layers=2, block_pattern=("attn_local", "attn"))
    name, _, depth = arch.partition("/")
    if depth:
        cfg = configs.get(name)
        return dataclasses.replace(cfg, num_layers=int(depth), block_pattern=cfg.block_pattern[:int(depth)])
    return configs.get_smoke(arch)


def time_case(rank: int, case: tuple, steps: int, dev: torch.device) -> dict:
    """One case on this rank: its step's ms, bytes by kind and peak memory."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.models import params as P
    from repro_torch.optim import constant_lr, make_optimizer
    from repro_torch.train import TrainerConfig, make_downlink
    from repro_torch.train import downlink as D
    from repro_torch.train import sharded as SH

    arch, spec, dtype, rows, seq, chunk, names, shape, mode, W = case
    cfg = config(arch)
    act = mode in ("act", "hier_act")
    kw = {"cfg": cfg}
    if "act" in inspect.signature(SH.connect).parameters:
        kw["act"] = act
    elif mode == "act":
        kw["cfg"] = None
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    layout, comm = SH.connect(Mesh(names, shape), W, sum(P.leaf_sizes(lm.lm_spec(cfg))), **kw)
    tcfg = TrainerConfig(n_workers=W, attn_chunk=chunk, weight_dtype=getattr(torch, dtype),
                         act_spec=SH.ACT_SPEC if act else None)
    dl, opt = make_downlink(spec, W), make_optimizer("adamw", weight_decay=0.01)
    step = SH.make_sharded_train_step(cfg, tcfg, dl, opt, constant_lr(2e-3), layout, comm)
    state = SH.init_state(cfg, tcfg, dl, opt, layout, seed=1, device=dev)
    data = SyntheticLMData(cfg, W, rows, seq, device=str(dev))
    ms, moved = [], {}
    for i in range(steps + 1):  # step 0 warms up
        batch = data.batch(i)
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        before, t0 = dict(comm.bytes), time.perf_counter()
        state, _ = step(state, batch, D.DownlinkDraws())
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
            moved = {k: v - before.get(k, 0) for k, v in comm.bytes.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    del state, step, comm, layout
    if cuda:
        torch.cuda.empty_cache()
    return {"ms": ms, "moved": moved, "peak_gib": peak}


def rank_main(rank: int, init: str, names: list, steps: int, device: str, out: str) -> None:
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
    res = {}
    for name in names:
        r = time_case(rank, CASES[name], steps, dev)
        every = [None] * WORLD
        dist.all_gather_object(every, r)
        res[name] = {"ms": r["ms"], "median_ms": statistics.median(r["ms"]), "moved": r["moved"],
                     "peak_gib": max(e["peak_gib"] for e in every) if r["peak_gib"] is not None else None}
        if rank == 0:
            print(f"{name}: {res[name]['median_ms']:.1f} ms a step (rank 0: "
                  f"{', '.join(f'{t:.1f}' for t in r['ms'])}); bytes a step {r['moved']}; peak "
                  f"{res[name]['peak_gib']} GiB a rank", flush=True)
    if rank == 0 and out:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    dist.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES), choices=list(CASES))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu")
    rdv = os.path.join(tempfile.mkdtemp(), "rdv")
    mp.spawn(rank_main, args=(f"file://{rdv}", a.cases, a.steps, a.device, a.out), nprocs=WORLD)
    if a.out:
        with open(a.out) as f:
            return json.load(f)
    return {}


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
