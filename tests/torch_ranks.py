"""Gloo ranks of the sharded train step in a subprocess, one part a process
group, and the runner the test files start them with (:func:`run`).

``python torch_ranks.py PART ARCH INIT OUT_DIR`` spawns the part's ranks
(``torch.multiprocessing.spawn``, ``file://`` rendezvous ``INIT``, 4 ranks)
that run one part:

* ``fd``: the two backwards ``gather_replicated`` and ``exit_enter`` in
  float64 against central differences on each pair of ranks (ARCH unused);
* ``leaves``: ARCH's leaf gradients at (1, 2) (the pairs) and (1, 4)
  against ``trainer.worker_value_and_grad`` in one process, with the single
  process's own distance under the tensor-parallel summation order
  (``sharded_check.OneRank``) and the routes of a moe config;
* ``steps``: ARCH's 3 teacher-forced steps at (1, 4) and (2, 2) for each
  of :data:`CASES`, tensor parallelism over "model";
* ``act_moe``: each of ARCH (moe configs, comma-separated) under
  ``act_spec`` on (2, 2): the routes (expert ids, kept copies, capacity) of
  every moe call of a step against the single process's, at the config's
  capacity factor and at :data:`LOW_CF`, and 3 teacher-forced steps of each
  of :data:`ACT_CASES` (the second at :data:`LOW_CF`);
* ``multipod``: ARCH's steps on the ("pod", "data", "model") meshes (2, 1,
  2) and (2, 2, 1), W = 4;
* ``hier``: each of ARCH's (comma-separated) steps on the hierarchical
  ("wk", "data", "model") meshes of :data:`HIER_CASES`;
* ``whole``: the rules for a weight that "model" does not split
  (``serve/sharded.ServeShard``: entered where the rank reads its product
  in part, the alike view of a layer whose output product is whole) in
  float64 against central differences on each pair of ranks, then each of
  ARCH's (comma-separated ``sharded_check.VARIANTS``) leaf gradients at
  (1, 4) and, for :data:`WHOLE_STEPS`, 3 steps of :data:`WHOLE_CASE`.

The steps are ``sharded_check.run_case`` with ``check_rank=0``: rank 0
alone runs the single process and its floor and broadcasts the state that
teacher-forces the next step; the comparisons are of what the ranks
gathered, which holds every rank's share. Each rank appends its case
boundaries to ``OUT_DIR/rank<r>.progress`` and rank 0 writes the report to
``OUT_DIR/report.pkl``.
"""
import os
import pickle
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CASES = [("marina:perm/bf16", "marina:perm", "bfloat16", False),
         ("ef21p/forced", "ef21p:16:64", "float32", True)]
LOW_CF = 1.0  # a capacity factor at which the smoke moe configs drop routed copies
# (name, downlink, replicas' dtype, forced sync at step 1, capacity factor: None the config's)
ACT_CASES = [("marina:perm/bf16", "marina:perm", "bfloat16", False, None),
             ("marina:perm/low_cf", "marina:perm", "float32", False, LOW_CF)]
MULTIPOD_MESHES = ((2, 1, 2), (2, 2, 1))
# (name, downlink, replicas' dtype, forced sync, mesh (wk, data, model), workers)
# the whole part's step case, and the variants (sharded_check.VARIANTS) it runs it for
WHOLE_CASE = ("marina:perm/bf16", "marina:perm", "bfloat16", False, (1, 4))
WHOLE_STEPS = ("deepseek-v2-236b@e3", "zamba2-1.2b@n17")
HIER_CASES = [("marina:perm/bf16", "marina:perm", "bfloat16", False, (2, 2, 1), 2),
              ("ef21p/forced", "ef21p:16:64", "float32", True, (1, 2, 2), 1)]


def progress(out_dir, rank, what):
    """One line a case boundary, read by :func:`run` when the group outlives its time."""
    with open(os.path.join(out_dir, f"rank{rank}.progress"), "a") as f:
        f.write(f"{time.time():.1f} {what}\n")


def run(tmp, part: str, arch: str, timeout: float):
    """The report of ``part`` for ``arch`` from 4 gloo ranks in a subprocess
    under ``tmp``, which must end within ``timeout`` seconds; past it the
    failure names the case each rank was running."""
    tmp = str(tmp)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    args = [sys.executable, os.path.abspath(__file__), part, arch, f"file://{tmp}/rdv", tmp]
    try:
        res = subprocess.run(args, env=env, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        last = []
        for r in range(WORLD):
            path = os.path.join(tmp, f"rank{r}.progress")
            lines = open(path).read().splitlines() if os.path.exists(path) else ["no case started"]
            last.append(f"rank {r}: {lines[-1]}")
        out = (e.stdout or b"")[-2000:]
        raise AssertionError(f"{part} {arch}: 4 gloo ranks past {timeout} s; the last case boundaries: "
                             f"{'; '.join(last)}; output {out!r}") from None
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    with open(os.path.join(tmp, "report.pkl"), "rb") as f:
        return pickle.load(f)


def finite_differences(rank, pair):
    # gather_replicated / exit_enter on a pair of ranks, float64: each input's analytic
    # gradient against central differences of the loss (the same on both ranks)
    from repro_torch.launch import comm as C
    comm = C.Comm({"model": pair})
    m = rank % 2
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 4, generator=g, dtype=torch.float64)                  # replicated
    blocks = [torch.randn(2, 4, 2, generator=g, dtype=torch.float64) for _ in range(2)]
    wg, wp = (b[m].clone() for b in blocks)                                # rank m's blocks [4, 2]

    def gathered(x, wg, wp):
        full = C.gather_replicated(comm, wg, 1, 2, "model", m)            # [4, 4] on both ranks
        z = torch.tanh(x @ full)                                           # used alike: replicated
        part = C.exit(comm, (C.enter(comm, z, "model") @ wp).sum(0), "model")  # and by each rank's block
        return (z * z).sum() + (part * torch.sin(part)).sum() + (x * x).sum()

    def partial_sum(x, wg, wp):
        h = torch.tanh(C.enter(comm, x, "model") @ wg)                    # the rank's columns [3, 2]
        ss = C.exit_enter(comm, (h * h).sum(-1, keepdim=True), "model")   # the whole row's sum
        y = h * torch.rsqrt(ss + 0.5) * wp[0]                              # used with the rank's block
        return C.exit(comm, (y * torch.cos(y)).sum().reshape(1), "model")[0] + (x * x).sum()

    worst = {}
    for name, loss in (("gather_replicated", gathered), ("exit_enter", partial_sum)):
        args = [t.clone().requires_grad_(True) for t in (x, wg, wp)]
        loss(*args).backward()
        worst[name] = 0.0
        eps = 1e-6
        for i, t in enumerate(args):
            for r in range(2):                    # a block is moved on its own rank, x on both
                for j in range(t.numel()):
                    moved = []
                    for sgn in (1, -1):
                        vals = [a.detach().clone() for a in args]
                        if i == 0 or r == m:
                            vals[i].view(-1)[j] += sgn * eps
                        moved.append(float(loss(*vals)))
                    num = (moved[0] - moved[1]) / (2 * eps)
                    if i == 0 or r == m:
                        mine = float(t.grad.view(-1)[j])
                        worst[name] = max(worst[name], abs(num - mine) / max(abs(num), 1.0))
                if i == 0:
                    break
    return worst


def whole_fd(rank, pair):
    # ServeShard's rules for a weight that "model" does not split, on a pair of ranks in float64: each input's
    # analytic gradient against central differences of the loss (the same on both ranks)
    from repro_torch import configs
    from repro_torch.launch import comm as C
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import Spec
    from repro_torch.serve import sharded as SS
    comm = C.Comm({"model": pair})
    m = rank % 2
    tp = SS.ServeShard(configs.get_smoke("gemma-2b"), SS.ServeLayout(Mesh(("data", "model"), (1, 2)), m, "tp"), comm)
    f64 = torch.float64
    g = torch.Generator().manual_seed(9)
    x = torch.randn(3, 4, generator=g, dtype=f64)                                        # replicated
    whole = torch.randn(4, 6, generator=g, dtype=f64)                                    # whole on both ranks
    out_w = torch.randn(6, 2, generator=g, dtype=f64)                                    # whole on both ranks
    split = torch.randn(2, 4, 3, generator=g, dtype=f64)[m].clone()                      # rank m's block of [4, 6]
    rows = torch.randn(2, 3, 2, generator=g, dtype=f64)[m].clone()                       # rank m's rows of [6, 2]
    cols = torch.randn(2, 2, 3, generator=g, dtype=f64)[m].clone()                       # rank m's columns of [2, 6]

    class Node(dict):  # a parameter node carrying its leaves' specs, as ShardedParams' nodes do
        pass

    def node(specs, **ws):
        n = Node(ws)
        n.specs = specs
        return n

    def after(z, down):  # z used alike, then by the rank's columns of a column-parallel product
        part = C.exit(comm, (C.enter(comm, z, "model") @ down).sum(0), "model")
        return (z * z).sum() + (part * torch.sin(part)).sum() + (x * x).sum()

    def read_in_part(x, w, down):
        # in_proj whole at rest: the product's output feeds only the rank's columns (its heads)
        p = node({"in_proj": Spec(None, None)}, in_proj=w)
        y = C.enter(comm, x, "model") @ tp.weight(p, "in_proj", f64)
        h = torch.tanh(y[:, 3 * m:3 * m + 3])
        out = C.exit(comm, h @ down, "model")
        return (out * torch.cos(out)).sum() + (x * x).sum()

    def alike(x, w, wo, down):
        # an MLP whose w_out "model" does not split: the alike view, its weights whole
        p = node({"w_in": Spec(None, None), "w_out": Spec(None, None)}, w_in=w, w_out=wo)
        t = tp.core(p, "w_out")
        return after(t.row_mm(torch.tanh(t.col_mm(x, [t.weight(p, "w_in", f64)])[0]), p, "w_out"), down)

    def alike_gathered(x, w, wo, down):
        # the alike view reads a weight split over "model" whole: the rank keeps its block of the gradient
        p = node({"w_in": Spec(None, "model"), "w_out": Spec(None, None)}, w_in=w, w_out=wo)
        t = tp.core(p, "w_out")
        return after(t.row_mm(torch.tanh(t.col_mm(x, [t.weight(p, "w_in", f64)])[0]), p, "w_out"), down)

    cases = (("read_in_part", read_in_part, (x, whole, rows), (0, 1)),
             ("alike", alike, (x, whole, out_w, cols), (0, 1, 2)),
             ("alike_gathered", alike_gathered, (x, split, out_w, cols), (0, 2)))
    worst = {}
    for name, loss, inputs, replicated in cases:
        args = [t.clone().requires_grad_(True) for t in inputs]
        loss(*args).backward()
        worst[name] = 0.0
        eps = 1e-6
        for i, t in enumerate(args):
            for r in range(2):                    # a block is moved on its own rank, a replicated input on both
                for j in range(t.numel()):
                    moved = []
                    for sgn in (1, -1):
                        vals = [a.detach().clone() for a in args]
                        if i in replicated or r == m:
                            vals[i].view(-1)[j] += sgn * eps
                        moved.append(float(loss(*vals)))
                    num = (moved[0] - moved[1]) / (2 * eps)
                    if i in replicated or r == m:
                        mine = float(t.grad.view(-1)[j])
                        worst[name] = max(worst[name], abs(num - mine) / max(abs(num), 1.0))
                if i in replicated:
                    break
    return worst


def leaf_grads(rank, pair, arch, out_dir, shapes=((1, 2), (1, 4))):
    # each leaf's gradient at (1, 2) (the pairs) and (1, 4) against the single process, the single
    # process's own distance with the tensor-parallel summation order (OneRank), and the routes; the
    # single process's gradient and routes once for both meshes, all of it on rank 0
    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import comm as C
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm, moe as MOE, params as P
    from repro_torch.serve import sharded as SS
    from repro_torch.train import sharded as SH, sharded_check as SC, trainer

    routes, real = [], MOE.top_k

    def top_k(probs, k):  # the expert ids of every route
        vals, idx = real(probs, k)
        routes.append(idx.clone())
        return vals, idx

    MOE.top_k = top_k
    cfg = SC.variant(arch)
    spec = lm.lm_spec(cfg)
    x = lm.lm_init(cfg, device="cpu", seed=1).flat.detach()
    batch = {k: v[0] for k, v in SyntheticLMData(cfg, 1, 2, 64, device="cpu").batch(0).items()}
    kw = dict(chunk=32, remat=True, window_override=None, remat_policy=None)
    if rank == 0:
        l1, g1 = trainer.worker_value_and_grad(cfg, spec, kw, x, batch)
        ids1 = list(routes)
        floor = SC.loss_floor(cfg, [x], {k: v[None] for k, v in batch.items()}, chunk=32)
    out = {}
    for shape in shapes:
        progress(out_dir, rank, f"start leaves {arch} {shape}")
        M = shape[1]
        mesh = Mesh(("data", "model"), shape)
        r = rank % M
        comm = C.Comm({"model": pair if M == 2 else None})
        layout = SH.Layout(mesh, r, 1, sum(P.leaf_sizes(spec)), SH.model_blocks(cfg, mesh, r))
        tp = SS.ServeShard(cfg, SS.ServeLayout(mesh, r, "tp"), comm)
        del routes[:]
        l2, g2 = trainer.worker_value_and_grad(cfg, spec, dict(kw, tp=tp), layout.model_local(x), batch)
        ids2 = list(routes)
        parts = g2.new_empty(M * layout.d_local)
        comm.all_gather(parts, g2, "model")
        if rank:
            continue
        g2 = layout.whole(parts.reshape(M, -1))
        lf, gf = trainer.worker_value_and_grad(cfg, spec, dict(kw, tp=SC.OneRank(cfg, M)), x, batch)
        leaves, o = {}, 0
        for path, leaf in P.leaves_with_path(spec):
            a, b, f = g1[o:o + leaf.size], g2[o:o + leaf.size], gf[o:o + leaf.size]
            top = float(a.abs().max())
            rel = [float((a - o).abs().max()) for o in (b, f)]  # a zero gradient must stay zero
            rel = [v / top if top else (0.0 if v == 0 else float("inf")) for v in rel]
            leaves[P.path_key(path)] = (*rel, top)
            o += leaf.size
        # remat recomputes each forward: the first half of the routes are the forward's
        half = len(ids1) // 2
        out[shape] = {
            "loss": abs(float(l1) - float(l2)), "loss_onerank": abs(float(l1) - float(lf)),
            "floor": floor, "leaves": leaves, "routes": len(ids1),
            "routes_equal": len(ids1) == len(ids2) and all(torch.equal(a, b) for a, b in zip(ids1, ids2)),
            "routes_moved": sum(int((a != b).sum()) for a, b in zip(ids1[:half], ids2[:half]))}
    MOE.top_k = real
    return out


def act_routes(rank, cfg, layout, comm, W):
    # every moe call of one act_spec step from seed 1's state: each rank's (expert ids, kept copies,
    # capacity), gathered to rank 0 and its model indices' pieces put together, against the single
    # process's step (the calls of a worker in order: its forward's, then remat's recomputation)
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import moe as MOE
    from repro_torch.optim import constant_lr, make_optimizer
    from repro_torch.train import TrainerConfig, init_state, make_downlink, make_train_step
    from repro_torch.train import downlink as D, sharded as SH

    recs, real = [], MOE._group_by_expert

    def recorded(expert_ids, num_experts, capacity, before=None):
        slot, keep = real(expert_ids, num_experts, capacity, before)
        recs.append((expert_ids.clone(), keep.clone(), capacity))
        return slot, keep

    MOE._group_by_expert = recorded
    tcfg = TrainerConfig(n_workers=W, attn_chunk=32, act_spec=SH.ACT_SPEC)
    dl, opt = make_downlink("marina:perm", W), make_optimizer("adamw")
    state = init_state(cfg, tcfg, dl, opt, device="cpu", seed=1)
    batch = SyntheticLMData(cfg, W, 2, 64, device="cpu").batch(0)
    step = SH.make_sharded_train_step(cfg, tcfg, dl, opt, constant_lr(2e-3), layout, comm)
    step(SH.shard_state(state, layout), batch, D.DownlinkDraws(coin=True))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, list(recs))
    out = None
    if rank == 0:
        del recs[:]
        single = make_train_step(cfg, TrainerConfig(n_workers=W, attn_chunk=32), dl, opt, constant_lr(2e-3))
        single(state, batch, D.DownlinkDraws(coin=True))
        per, M = len(recs) // W, layout.model_size
        pieces = {}
        for r, mine in enumerate(every):
            a, m = divmod(r, M)
            for k, rec in enumerate(mine):
                pieces.setdefault((a * layout.local + k // per, k % per), {})[m] = rec
        equal = len(pieces) == len(recs) > 0
        for (w, c), by_m in pieces.items():
            ids = torch.cat([by_m[m][0] for m in range(M)])
            keep = torch.cat([by_m[m][1] for m in range(M)])
            want = recs[w * per + c]
            equal = equal and torch.equal(ids, want[0]) and torch.equal(keep, want[1]) and all(
                by_m[m][2] == want[2] for m in range(M))
        out = {"calls": len(recs), "equal": equal, "dropped": sum(int((~k).sum()) for _, k, _ in recs),
               "copies": sum(k.numel() for _, k, _ in recs)}
    MOE._group_by_expert = real
    return out


def sharded_steps(rank, arch, out_dir, cases, mesh_of, cfg_of=None):
    # each case's 3 teacher-forced steps on its mesh; rank 0 holds the single process
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import lm, params as P
    from repro_torch.train import TrainerConfig
    from repro_torch.train import sharded as SH, sharded_check as SC

    launches = []
    real = ops.rotk_apply_rows

    def counted(*a, **kw):  # the CPU path counts no launch: count the block-map calls here
        if kw.get("block") is not None:
            launches.append(kw["block"])
        return real(*a, **kw)

    ops.rotk_apply_rows = counted
    report = {}
    for case in cases:
        name, spec, dtype, forced = case[:4]
        mesh, W, act = mesh_of(case)
        cfg = cfg_of(case) if cfg_of else SC.variant(arch)
        progress(out_dir, rank, f"start {name} {arch} {mesh.sizes}")
        layout, comm = SH.connect(mesh, W, sum(P.leaf_sizes(lm.lm_spec(cfg))), cfg=None if act else cfg)
        del launches[:]
        tcfg = TrainerConfig(n_workers=W, attn_chunk=32, weight_dtype=getattr(torch, dtype),
                             act_spec=SH.ACT_SPEC if act else None)
        res = SC.run_case(cfg, tcfg, spec, layout, comm, SH.Comm(), batch_rows=2, seq=64, device="cpu",
                          forced=forced, check_rank=0)
        res.update(block_launches=len(launches), two_level=sum(len(b) == 5 for b in launches),
                   d_rank=layout.d_rank, d=layout.d)
        report[(name, mesh.sizes)] = res
    ops.rotk_apply_rows = real
    return report


def act_moe(rank, arch, out_dir):
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm, params as P
    from repro_torch.train import sharded as SH

    base = configs.get_smoke(arch)

    def with_cf(cf):
        return base if cf is None else dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cf))

    mesh, W = Mesh(("data", "model"), (2, 2)), 4
    layout, comm = SH.connect(mesh, W, sum(P.leaf_sizes(lm.lm_spec(base))))
    report = {}
    for cf in (None, LOW_CF):
        progress(out_dir, rank, f"start routes {arch} cf {cf}")
        report[("routes", cf)] = act_routes(rank, with_cf(cf), layout, comm, W)
    report.update(sharded_steps(rank, arch, out_dir, ACT_CASES, lambda c: (mesh, W, True),
                                lambda c: with_cf(c[4])))
    return report


def whole_weights(rank, pair, archs, out_dir):
    # weights "model" does not split: whole_fd, then each of archs' (comma-separated) leaf gradients at (1, 4),
    # and the 3 steps of WHOLE_CASE at (1, 4) for each of those in WHOLE_STEPS
    from repro_torch.launch.mesh import Mesh

    progress(out_dir, rank, "start whole_fd")
    report = {"fd": whole_fd(rank, pair)}
    for arch in archs.split(","):
        report[("leaves", arch)] = leaf_grads(rank, pair, arch, out_dir, ((1, 4),))
        if arch in WHOLE_STEPS:
            report[("steps", arch)] = sharded_steps(rank, arch, out_dir, [WHOLE_CASE],
                                                    lambda c: (Mesh(("data", "model"), c[4]), 4, False))
    return report


def each_arch(part, rank, archs, out_dir):
    """``part(rank, arch, out_dir)`` for each of the comma-separated
    ``archs`` in one process group: {arch: its report}."""
    return {arch: part(rank, arch, out_dir) for arch in archs.split(",")}


def worker(rank, part, arch, init, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import Mesh
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
    progress(out_dir, rank, f"start {part} {arch}")
    if part in ("fd", "leaves", "whole"):
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        pair = pairs[rank // 2]
        if part == "whole":
            report = whole_weights(rank, pair, arch, out_dir)
        else:
            report = finite_differences(rank, pair) if part == "fd" else leaf_grads(rank, pair, arch, out_dir)
    elif part == "steps":
        cases = [c + (shape,) for shape in ((1, 4), (2, 2)) for c in CASES]
        report = sharded_steps(rank, arch, out_dir, cases, lambda c: (Mesh(("data", "model"), c[4]), 4, False))
    elif part == "act_moe":
        report = each_arch(act_moe, rank, arch, out_dir)
    elif part == "multipod":
        cases = [c + (shape,) for shape in MULTIPOD_MESHES for c in CASES]
        report = sharded_steps(rank, arch, out_dir, cases,
                               lambda c: (Mesh(("pod", "data", "model"), c[4]), 4, False))
    else:
        report = each_arch(lambda r, a, o: sharded_steps(
            r, a, o, HIER_CASES, lambda c: (Mesh(("wk", "data", "model"), c[4]), c[5], False)), rank, arch, out_dir)
    gathered = [None] * WORLD
    dist.all_gather_object(gathered, report)
    if rank == 0:
        with open(os.path.join(out_dir, "report.pkl"), "wb") as f:
            pickle.dump(gathered, f)
    progress(out_dir, rank, "done")
    dist.destroy_process_group()


if __name__ == "__main__":
    part, arch, init, out_dir = sys.argv[1:]
    mp.spawn(worker, args=(part, arch, init, out_dir), nprocs=WORLD, join=True)


# ---------------------------------------------------------------------------
# the checks, one a test file's parametrized case
# ---------------------------------------------------------------------------

MOE = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
RESIDUE = 1e-6  # a leaf's max |g| below this share of the model's largest: rounding residue
# each part's time limit in seconds: at least 3x its time beside five other test workers (about 2x its
# time alone on an 8-core host: fd 9.5 s, leaves 12-18 s, steps 43-58 s, act_moe 34 s, multipod 37 s,
# hier 23 s)
TIMEOUT = {"fd": 180, "leaves": 240, "steps": 600, "act_moe": 360, "multipod": 360, "hier": 300, "whole": 360}


def check_backward(report, kind):
    """``gather_replicated`` (all-gather forward, the rank's block of the
    gradient backward) and ``exit_enter`` (all-reduce both ways) on a
    "model" axis of 2, float64: every input's gradient within 1e-6 of
    central differences, on every rank."""
    for rank, rep in enumerate(report):
        print(f"rank {rank}: {kind}, worst relative distance from finite differences {rep[kind]:.2e}")
        assert rep[kind] <= 1e-6


def check_leaves(report, arch, shape, leaf_rtol, loss_atol, floor_factor):
    """Every leaf within ``leaf_rtol`` of the single process's gradient, or,
    where its gradient is rounding residue, within ``floor_factor`` times
    the single process's own distance in the same run; the loss within
    ``loss_atol``; a moe config's expert ids those of the single process."""
    res = report[0][tuple(shape)]
    top = max(v[2] for v in res["leaves"].values())
    worst = max(res["leaves"].items(), key=lambda kv: kv[1][0])
    print(f"{arch} {shape}: loss |diff| {res['loss']:.3g} (OneRank {res['loss_onerank']:.3g}, one rounding of the "
          f"logits {res['floor']:.3g}); worst leaf {worst[0]} {worst[1][0]:.4g} (OneRank {worst[1][1]:.4g}, "
          f"max |g| {worst[1][2]:.3g} of the model's {top:.3g})")
    if arch in MOE:
        print(f"  routes: {res['routes']} top_k calls, expert ids equal to the single process's: "
              f"{res['routes_equal']} ({res['routes_moved']} ids moved)")
        assert res["routes"] > 0 and res["routes_equal"]
    assert res["loss"] <= loss_atol
    for name, (rel, floor, g) in res["leaves"].items():
        if rel > leaf_rtol:  # only a gradient that is zero but for rounding may need the floor
            print(f"  {name}: {rel:.4g} > {leaf_rtol}: max |g| {g:.3g} ({g / top:.2e} of the largest), "
                  f"held to {floor_factor} x OneRank's {floor:.4g}")
            assert g <= RESIDUE * top and rel <= floor_factor * floor, name


def check_steps(report, name, arch, shape):
    """:func:`check_case` of a tensor-parallel case (every rank its blocks):
    its 3 teacher-forced steps within ``sharded_check``'s bounds, and every
    kind of collective issued."""
    from repro_torch.train import sharded_check as SC
    check_case(report, (name, tuple(shape)), SC.bounds(True), 4)
    assert all(set(rep[(name, tuple(shape))]["moved"]) == {"all-gather", "reduce-scatter", "all-reduce"}
               for rep in report), arch


def check_case(report, key, bounds, n_workers):
    """One case of ``sharded_steps`` on every rank: within ``bounds``
    (``sharded_check.hold``; rank 0 holds the gathered state), the bytes
    handed to gloo equal to the dry-run's count and the round trip bit for
    bit on every rank (``run_case`` raised otherwise), a perm case through
    the block map on every rank where its rows are blocks."""
    from repro_torch.train import sharded_check as SC
    name = key[0]
    for rank in range(len(report)):
        res = report[rank][key]
        print(f"{key} rank {rank}: {dict(zip(SC.WORST_KEYS, res['worst']))}, floor {res['floor']}; bytes a "
              f"step {res['moved']}; d_rank {res['d_rank']} of {res['d']}; block-map launches "
              f"{res['block_launches']} ({res['two_level']} two-level)")
        SC.hold(name, res, bounds, n_workers)
        blocks = res["d_rank"] < res["d"]
        assert (res["block_launches"] > 0) == (name.startswith("marina:perm") and res["compressed"] > 0 and blocks)
