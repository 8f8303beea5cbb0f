"""Tensor parallelism over "model" in the sharded LM train step for the moe,
ssm and hybrid families (``train/sharded.py`` with the rank's blocks, the
reference's ``worker`` layout): one backward per kind of use, wherever a rank
reads a replicated or gathered value only in part, or uses a gathered value
whole (``launch/comm.py``'s ``enter`` / ``exit`` / ``gather`` and the two
added here, ``gather_replicated`` and ``exit_enter``; the calls in
``models/moe.py``, ``models/ssm.py`` and MLA through
``serve/sharded.ServeShard``).

In this process: every family is admitted at (1, 2), (1, 4) and (2, 2) on
the smoke configs and on the full configs' 16x16 production mesh too (their
model-local sizes); a bf16 replica differentiates as the fp32 row of its
values; the dry-run's train_4k records of the four architectures are
``per_rank``. What stays refused (``act_spec`` with experts, a product's
weight that "model" does not split) is held in
tests/test_torch_train_tp.py, tests/test_torch_train_sharded.py and the
serving tests of these families.

Four gloo ranks (one subprocess, ``torch.multiprocessing.spawn``):

* the two new backwards in float64, as finite differences on each pair of
  ranks (a "model" axis of 2): a gathered block used alike on both ranks,
  and a partial sum that each rank uses with its own block;
* each leaf's gradient at (1, 2) (the pairs) and (1, 4) against
  ``trainer.worker_value_and_grad``'s in one process, for the deepseek-v2,
  llama4, rwkv6 and zamba2 smoke configs: max |dg| / max |g| within
  LEAF_RTOL (measured at most 1.26e-2 for deepseek-v2, 2.22e-2 for rwkv6 and
  0.98e-2 for zamba2), or where that leaf's gradient is rounding residue
  (below 1e-6 of the model's largest), within FLOOR_FACTOR times the single
  process's own distance with the tensor-parallel summation order
  (``sharded_check.OneRank``): llama4's router at (1, 4), 0.132 against
  OneRank's 0.133. Its gradient is 1.7e-9 against 0.14 for the largest leaf:
  top-1 routing normalises each gate to p / p = 1, so the loss does not
  depend on the router and its computed gradient is what the rounding of
  that division leaves. No route flips: the expert ids equal the single
  process's at both meshes, which the test checks. The loss within
  LOSS_ATOL (llama4 at (1, 4): 3.4e-4, OneRank's too);
* 3 teacher-forced steps at (1, 4) and (2, 2) for deepseek-v2 (moe), rwkv6
  (ssm) and zamba2 (hybrid) under marina:perm (bf16 replicas) and ef21p
  against the single process, within ``sharded_check``'s bounds (``hold``:
  ACT_BOUNDS, or 1.5x ``OneRank``'s floor; rwkv6's backward amplifies the
  vocabulary-parallel CE's rounding into its grad norm, 1.08e-3 at (1, 4)
  and 1.98e-3 at (2, 2) under ef21p, past ACT_BOUNDS' 1e-3, against
  ``OneRank``'s 1.27e-3 and 1.7e-3 now that it runs that CE), the bytes
  handed to gloo equal to the dry-run's count of the same step on ``meta``
  each step, and each rank's perm steps launching ``rotk_apply_rows``
  through its block map (counted in a wrapper: the CPU path counts no
  launch).

The reference: its partitioned ``worker``-layout step (XLA on 4 CPU
devices, ``test_torch_train_sharded.reference_case``) against the port's
tensor-parallel step on (2, 2) for llama4 (moe) and rwkv6 (ssm).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.data import SyntheticLMData
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import TrainerConfig, make_downlink, trainer
from repro_torch.train import sharded as SH
from repro_torch.train import sharded_check as SC

from test_torch_train_sharded import reference_case
from test_torch_train_tp import LEAF_RTOL, LOSS_ATOL

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MOE = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
RECURRENT = ("rwkv6-1.6b", "zamba2-1.2b")
ARCHS = MOE + RECURRENT
RESIDUE = 1e-6  # a leaf's max |g| below this share of the model's largest: rounding residue
# the full configs' model-local values a rank holds on the 16x16 production mesh
D_LOCAL_16 = {"deepseek-v2-236b": 15_035_253_760, "llama4-maverick-400b-a17b": 24_856_212_480,
              "rwkv6-1.6b": 99_503_616, "zamba2-1.2b": 63_882_240}


def _layout(cfg, shape, rank=0, W=2):
    mesh = Mesh(("data", "model"), shape)
    return SH.Layout(mesh, rank, W, sum(P.leaf_sizes(lm.lm_spec(cfg))), SH.model_blocks(cfg, mesh, rank))


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_is_admitted(arch, shape):
    """The train step's tensor parallelism builds for the moe, ssm and
    hybrid smoke configs on every rank of the mesh; each rank holds less
    than the whole model, and the ranks' blocks of a split leaf tile it."""
    cfg = configs.get_smoke(arch)
    d = sum(P.leaf_sizes(lm.lm_spec(cfg)))
    tcfg = TrainerConfig(n_workers=2, attn_chunk=32)
    M = shape[1]
    for rank in range(shape[0] * M):
        layout = _layout(cfg, shape, rank)
        SH.check_tensor_parallel(cfg, layout)
        SH.make_sharded_train_step(cfg, tcfg, make_downlink("marina:perm", 2), make_optimizer("adamw"),
                                   constant_lr(SC.LR), layout, SH.CountingComm())
        assert layout.d_local < d
        split = [b for b in layout.blocks if b.chunk != b.stride]
        assert split and all(b.size * M == b.size // b.chunk * b.stride for b in split)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_split_on_the_production_mesh(arch):
    """Every product's weight of the full config splits over "model" on the
    16x16 production mesh, (1, 4) and (2, 2), so ``train_refusal`` admits
    them; a rank's model-local vector on 16x16 is D_LOCAL_16."""
    cfg = configs.get(arch)
    d = sum(P.leaf_sizes(lm.lm_spec(cfg)))
    for mesh in (make_production_mesh(), Mesh(("data", "model"), (1, 4)), Mesh(("data", "model"), (2, 2))):
        layout = SH.Layout(mesh, 0, mesh.shape["data"], d, SH.model_blocks(cfg, mesh, 0))
        SH.check_tensor_parallel(cfg, layout)
        assert specs.train_refusal(cfg, mesh) is None
        if mesh.size == 256:
            assert layout.d_local == D_LOCAL_16[arch]
            print(f"{arch}: d {d:,}, d_local on 16x16 {layout.d_local:,} ({layout.d_local / d:.4f} of d)")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_replicas_differentiate(arch):
    """A worker's loss and gradient at a bf16 replica (MARINA-P's
    ``weight_dtype`` bf16, which the dry-run's count and (w2) use) equal
    those at the fp32 row of the same values: the single process reads the
    leaves raw and promotes as jnp does (rwkv6's fp32 lora tanh times a bf16
    ``w_lora_b``: fp32), so only the gradient's last rounding to bf16
    differs."""
    cfg = configs.get_smoke(arch)
    spec = lm.lm_spec(cfg)
    row = lm.lm_init(cfg, device="cpu", seed=1).flat.detach().bfloat16()
    batch = {k: v[0] for k, v in SyntheticLMData(cfg, 1, 2, 64, device="cpu").batch(0).items()}
    kw = dict(chunk=32, remat=True, window_override=None, remat_policy=None)
    l16, g16 = trainer.worker_value_and_grad(cfg, spec, kw, row, batch)
    l32, g32 = trainer.worker_value_and_grad(cfg, spec, kw, row.float(), batch)
    assert float(l16) == float(l32)
    assert torch.equal(g16, g32.bfloat16().float())


@pytest.fixture
def smoke(monkeypatch):
    """``configs.get`` gives the smoke configs and train_4k is 256 sequences
    of 128 tokens (on (2, 2): W = 2 workers of 128 rows)."""
    monkeypatch.setattr(specs.configs, "get", configs.get_smoke)
    monkeypatch.setitem(specs.SHAPES, "train_4k", dict(kind="train", seq=128, global_batch=256))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_records_are_per_rank(smoke, arch):
    """The dry-run's train step of each of the four architectures is rank
    0 of the tensor-parallel step (``per_rank``), where it was split
    evenly: its count holds every kind of collective, the bytes its
    communicator tallied."""
    built = specs.build(arch, "train_4k", Mesh(("data", "model"), (2, 2)))
    assert built.meta["split"] == "per_rank" and built.meta["layout"].tp and "even_note" not in built.meta
    c = dryrun.count("train", built.fn, *built.args)
    assert dict(c.coll) == dict(built.meta["comm"].bytes)
    assert set(c.coll) == {"all-gather", "reduce-scatter", "all-reduce"} and min(c.coll.values()) > 0
    assert c.total_flops > 0


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

_RANKS = textwrap.dedent(
    """
    import pickle, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    WORLD = 4


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


    def leaf_grads(rank, pair, archs):
        # each leaf's gradient at (1, 2) (the pairs) and (1, 4) against the single process, the single
        # process's own distance with the tensor-parallel summation order (OneRank), and the routes
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
        out = {}
        for shape in ((1, 2), (1, 4)):
            M = shape[1]
            mesh = Mesh(("data", "model"), shape)
            r = rank % M
            comm = C.Comm({"model": pair if M == 2 else None})
            for arch in archs:
                cfg = configs.get_smoke(arch)
                spec = lm.lm_spec(cfg)
                layout = SH.Layout(mesh, r, 1, sum(P.leaf_sizes(spec)), SH.model_blocks(cfg, mesh, r))
                tp = SS.ServeShard(cfg, SS.ServeLayout(mesh, r, "tp"), comm)
                x = lm.lm_init(cfg, device="cpu", seed=1).flat.detach()
                batch = {k: v[0] for k, v in SyntheticLMData(cfg, 1, 2, 64, device="cpu").batch(0).items()}
                kw = dict(chunk=32, remat=True, window_override=None, remat_policy=None)
                del routes[:]
                l1, g1 = trainer.worker_value_and_grad(cfg, spec, kw, x, batch)
                ids1 = list(routes)
                del routes[:]
                l2, g2 = trainer.worker_value_and_grad(cfg, spec, dict(kw, tp=tp), layout.model_local(x), batch)
                ids2 = list(routes)
                lf, gf = trainer.worker_value_and_grad(cfg, spec, dict(kw, tp=SC.OneRank(cfg, M)), x, batch)
                parts = g2.new_empty(M * layout.d_local)
                comm.all_gather(parts, g2, "model")
                g2 = layout.whole(parts.reshape(M, -1))
                leaves, o = {}, 0
                for path, leaf in P.leaves_with_path(spec):
                    a, b, f = g1[o:o + leaf.size], g2[o:o + leaf.size], gf[o:o + leaf.size]
                    top = float(a.abs().max())
                    rel = [float((a - o).abs().max()) for o in (b, f)]  # a zero gradient must stay zero
                    rel = [v / top if top else (0.0 if v == 0 else float("inf")) for v in rel]
                    leaves[P.path_key(path)] = (*rel, top)
                    o += leaf.size
                floor = SC.loss_floor(cfg, [x], {k: v[None] for k, v in batch.items()}, chunk=32)
                # remat recomputes each forward: the first half of the routes are the forward's
                half = len(ids1) // 2
                out[(arch, shape)] = {
                    "loss": abs(float(l1) - float(l2)), "loss_onerank": abs(float(l1) - float(lf)),
                    "floor": floor, "leaves": leaves, "routes": len(ids1),
                    "routes_equal": len(ids1) == len(ids2) and all(torch.equal(a, b) for a, b in zip(ids1, ids2)),
                    "routes_moved": sum(int((a != b).sum()) for a, b in zip(ids1[:half], ids2[:half]))}
        MOE.top_k = real
        return out


    def worker(rank, init, cases_path, out_path):
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import Mesh
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
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        pair = pairs[rank // 2]
        cases = pickle.load(open(cases_path, "rb"))
        report = {"fd": finite_differences(rank, pair), "leaves": leaf_grads(rank, pair, cases["archs"])}
        W = 4
        for arch in cases["steps"]:
            cfg = configs.get_smoke(arch)
            d = sum(P.leaf_sizes(lm.lm_spec(cfg)))
            for shape in ((1, 4), (2, 2)):
                layout, comm = SH.connect(Mesh(("data", "model"), shape), W, d, cfg=cfg)
                aux = SH.Comm()
                for name, spec, dtype, forced in cases["cases"]:
                    del launches[:]
                    tcfg = TrainerConfig(n_workers=W, attn_chunk=32, weight_dtype=getattr(torch, dtype))
                    res = SC.run_case(cfg, tcfg, spec, layout, comm, aux, batch_rows=2, seq=64, device="cpu",
                                      forced=forced)
                    res["block_launches"] = len(launches)
                    report[(name, arch, shape)] = res
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, report)
        if rank == 0:
            pickle.dump(gathered, open(out_path, "wb"))
        dist.destroy_process_group()


    if __name__ == "__main__":
        init, cases_path, out_path = sys.argv[1:]
        mp.spawn(worker, args=(init, cases_path, out_path), nprocs=WORLD, join=True)
    """
)

CASES = [("marina:perm/bf16", "marina:perm", "bfloat16", False),
         ("ef21p/forced", "ef21p:16:64", "float32", True)]
STEP_ARCHS = ("deepseek-v2-236b", "rwkv6-1.6b", "zamba2-1.2b")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_families")
    script = tmp / "ranks.py"
    script.write_text(_RANKS)
    cases_path, out_path = tmp / "cases.pkl", tmp / "report.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump({"cases": CASES, "archs": ARCHS, "steps": STEP_ARCHS}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, str(script), f"file://{tmp / 'rdv'}", str(cases_path), str(out_path)],
                         env=env, capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("kind", ["gather_replicated", "exit_enter"])
def test_new_backwards_against_finite_differences(four_ranks, kind):
    """``gather_replicated`` (all-gather forward, the rank's block of the
    gradient backward) and ``exit_enter`` (all-reduce both ways) on a
    "model" axis of 2, float64: every input's gradient within 1e-6 of
    central differences, on every rank."""
    for rank, rep in enumerate(four_ranks):
        print(f"rank {rank}: {kind}, worst relative distance from finite differences {rep['fd'][kind]:.2e}")
        assert rep["fd"][kind] <= 1e-6


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_gradients_against_the_single_process(four_ranks, arch, shape):
    """Every leaf within LEAF_RTOL of the single process's gradient, or,
    where its gradient is rounding residue, within FLOOR_FACTOR times the
    single process's own distance in the same run; the loss within
    LOSS_ATOL; a moe config's expert ids those of the single process."""
    res = four_ranks[0]["leaves"][(arch, shape)]
    top = max(v[2] for v in res["leaves"].values())
    worst = max(res["leaves"].items(), key=lambda kv: kv[1][0])
    print(f"{arch} {shape}: loss |diff| {res['loss']:.3g} (OneRank {res['loss_onerank']:.3g}, one rounding of the "
          f"logits {res['floor']:.3g}); worst leaf {worst[0]} {worst[1][0]:.4g} (OneRank {worst[1][1]:.4g}, "
          f"max |g| {worst[1][2]:.3g} of the model's {top:.3g})")
    if arch in MOE:
        print(f"  routes: {res['routes']} top_k calls, expert ids equal to the single process's: "
              f"{res['routes_equal']} ({res['routes_moved']} ids moved)")
        assert res["routes"] > 0 and res["routes_equal"]
    assert res["loss"] <= LOSS_ATOL
    for name, (rel, floor, g) in res["leaves"].items():
        if rel > LEAF_RTOL:  # only a gradient that is zero but for rounding may need the floor
            print(f"  {name}: {rel:.4g} > {LEAF_RTOL}: max |g| {g:.3g} ({g / top:.2e} of the largest), "
                  f"held to {SC.FLOOR_FACTOR} x OneRank's {floor:.4g}")
            assert g <= RESIDUE * top and rel <= SC.FLOOR_FACTOR * floor, name


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_four_ranks_tensor_parallel_steps_against_single_process(four_ranks, name, arch, shape):
    """3 teacher-forced steps on every rank within ``sharded_check``'s
    bounds (``hold``), bytes handed = counted, the round trip bit for bit
    (``run_case``), perm through the block map on every rank."""
    for rank in range(4):
        res = four_ranks[rank][(name, arch, shape)]
        print(f"{name} {arch} {shape} rank {rank}: {dict(zip(SC.WORST_KEYS, res['worst']))}, floor "
              f"{res['floor']}; bytes a step {res['moved']}")
        SC.hold(name, res, SC.bounds(True), 4)
        assert (res["block_launches"] > 0) == (name.startswith("marina:perm") and res["compressed"] > 0)
        assert set(res["moved"]) == {"all-gather", "reduce-scatter", "all-reduce"}


# ---------------------------------------------------------------------------
# the reference's own sharded step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,spec", [("llama4-maverick-400b-a17b", "marina:perm"), ("rwkv6-1.6b", "ef21p:16:64")])
def test_four_ranks_against_the_reference_sharded_step(tmp_path, arch, spec):
    """The reference's default program, the ``worker`` layout through XLA on
    4 CPU devices (2, 2), one step from its state, against the port's tensor
    parallelism over "model" from the same state and draws
    (``test_torch_train_sharded.reference_case``'s bounds)."""
    reference_case(tmp_path, spec, False, arch, own=True)
