"""Tensor parallelism over "model" in the sharded LM train step (the
reference's ``worker`` layout): ``train/sharded.py`` with the rank's blocks,
``launch/comm.py``'s collectives with a backward, the layers' shard context
under autograd, the vocabulary-parallel loss, and ``rotk_apply_rows``' block
map.

In this process: the ``worker`` layout's inner specs equal the ``tp`` serving
layout's for every leaf of the ten architectures; a rank's replicas hold
W/D x d_local values (d_local = the sum of ``sharding.local_numel`` over the
worker layout's inner specs) and its master ceil(d_local / D); the blocks'
cut and reassembly; the plain block map of ``rotk_apply_rows`` against the
whole leaf's row, and the downlink on blocks against the whole downlink;
the refusals.

Four gloo ranks (one subprocess, ``torch.multiprocessing.spawn``):

* the collectives with a backward in float64, as finite differences: on each
  pair of ranks (a "model" axis of 2), a function of a replicated input and
  of per-rank blocks through ``enter``, a gathered weight and ``exit``; each
  input's analytic gradient against central differences of the loss
  (a replicated input moved on both ranks at once, a block on its rank);
* each leaf's gradient at (1, 2) (the pairs) and (1, 4) against
  ``trainer.worker_value_and_grad``'s in one process, for a dense, a vlm and
  an audio smoke config and gemma3-1b's (its one kv head cut over "model"):
  max |dg| / max |g| of every leaf within LEAF_RTOL (the port's bound against
  the reference's gradient, tests/test_torch_train_grad_a.py; measured at
  most 1.3e-2, pixtral's embedding at (1, 2)), and the loss within LOSS_ATOL
  (measured: equal but for pixtral, 1.6e-4 at (1, 4) and 4.3e-4 at (1, 2),
  where a bf16 rounding that the fp32 partial sums move in the first layer's
  MLP spreads through the second layer's attention to a third of the
  logits; its own loss floor there is 6e-5);
* 3 teacher-forced steps at (1, 4) and (2, 2) against the single process
  under marina:perm (bf16 replicas), marina:ind (a participation plan and a
  forced sync) and ef21p, within ``sharded_check.ACT_BOUNDS`` or
  ``FLOOR_FACTOR`` times the single process's own floor measured in the
  same run (``sharded_check.hold``; only the loss needs it), the bytes handed to gloo
  equal to the dry-run's count of the same step on ``meta`` every step, the
  state's shard / gather round trip bit for bit, and each rank's perm steps
  launching ``rotk_apply_rows`` through its block map (counted here in a
  wrapper: the CPU path counts no launch).
"""
import math
import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.data import batch_specs
from repro_torch.kernels import ops, ref
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.specs import compressed_draws
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.serve import sharded as SS
from repro_torch.train import TrainerConfig, make_downlink
from repro_torch.train import downlink as D
from repro_torch.train import sharded as SH
from repro_torch.train import sharded_check as SC

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ALL_ARCHS = list(configs.ALIASES)
PORTED = ["gemma3-1b", "gemma-2b", "minitron-4b", "starcoder2-7b", "pixtral-12b", "musicgen-large"]
LEAF_RTOL = 0.03  # tests/test_torch_train_grad_a.py's GRAD_RTOL: the port against the reference's gradient
LOSS_ATOL = 1e-3  # tests/test_torch_train_sharded.py's REF_LOSS_ATOL: against the reference's partitioned step
GRAD_ARCHS = ("gemma-2b", "pixtral-12b", "musicgen-large", "gemma3-1b")


def _bits(t):
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_worker_inner_specs_are_the_tp_specs(arch):
    """The reference's ``worker`` layout on a ("data", "model") mesh puts
    each replica's inner dims exactly where the ``tp`` serving layout puts
    the leaf's: ``shard_params(..., "tp")`` cuts one replica into the rank's
    blocks, and :func:`SH.model_blocks` cuts on the same dims."""
    tree = lm.lm_spec(configs.get(arch))
    W = 4
    for mesh in (Mesh(("data", "model"), (2, 2)), Mesh(("data", "model"), (1, 4)), make_production_mesh()):
        wtree = P.map_tree(lambda leaf: P.stacked(leaf, W), tree)
        worker = sh.spec_leaves(sh.param_specs(wtree, mesh, "worker"))
        tp = sh.spec_leaves(sh.param_specs(tree, mesh, "tp"))
        assert len(worker) == len(tp) == len(P.leaves(tree))
        for (pw, sw), (pt, st) in zip(worker, tp):
            assert pw == pt and sw[0] == "data" and tuple(sw[1:]) == tuple(st)
        blocks = SH.model_blocks(configs.get(arch), mesh, mesh.shape["model"] - 1)
        for leaf, (_, st), b in zip(P.leaves(tree), tp, blocks):
            assert b.size == sh.local_numel(leaf.shape, st, Mesh(("model",), (mesh.shape["model"],)))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["gemma3-1b", "pixtral-12b", "musicgen-large"])
def test_rank_state_holds_its_blocks(arch, shape):
    """A rank's replicas are W/D x d_local values, d_local the sum of
    ``local_numel`` over the worker layout's inner specs; its master and
    moments ceil(d_local / D); every rank's model-local vectors give the
    whole vector back bit for bit, and so do every rank's states."""
    cfg = configs.get_smoke(arch)
    tree = lm.lm_spec(cfg)
    d, W = sum(P.leaf_sizes(tree)), 4
    mesh = Mesh(("data", "model"), shape)
    Dn, M = shape
    wtree = P.map_tree(lambda leaf: P.stacked(leaf, W), tree)
    inner = [sh.Spec(*s[1:]) for _, s in sh.spec_leaves(sh.param_specs(wtree, mesh, "worker"))]
    d_local = sum(sh.local_numel(leaf.shape, s, mesh) for leaf, s in zip(P.leaves(tree), inner))
    assert d_local < d
    gen = torch.Generator().manual_seed(0)
    state = {"server": torch.randn(d, generator=gen), "opt": {"m": torch.randn(d, generator=gen), "count": 3},
             "workers": torch.randn(W, d, generator=gen).bfloat16(), "step": 2}
    ranks = []
    for r in range(mesh.size):
        lay = SH.Layout(mesh, r, W, d, SH.model_blocks(cfg, mesh, r))
        assert lay.d_local == d_local and lay.shard_len == -(-d_local // Dn)
        sp = SH.shard_state(state, lay)
        assert sp["workers"].shape == (W // Dn, d_local) and sp["workers"].numel() == W // Dn * d_local
        assert sp["server"].shape == sp["opt"]["m"].shape == (-(-d_local // Dn),) and sp["opt"]["count"] == 3
        ranks.append((lay, sp))
    x = state["server"]
    parts = torch.stack([lay.model_local(x) for lay, _ in ranks[:M]])
    assert torch.equal(ranks[0][0].whole(parts), x)
    # the all-gather of gather_state, by hand: rank order (data index, model index)
    lay0 = ranks[0][0]
    g = torch.stack([sp["server"] for _, sp in ranks]).reshape(Dn, M, -1)
    assert torch.equal(lay0.whole(g.movedim(1, 0).reshape(M, -1)[:, :d_local]), x)
    w = torch.stack([sp["workers"] for _, sp in ranks]).reshape(Dn, M, W // Dn, d_local)
    assert torch.equal(_bits(lay0.whole(w.movedim(1, 0)).reshape(W, d)), _bits(state["workers"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_rotk_rows_block_map_is_the_whole_rows_block(dtype):
    """``rotk_apply_rows_ref`` (and the wrapper's CPU path) with a block map
    gives the block of the unsharded rows bit for bit: column and row
    blocks, runs of 1, 3 and 33 values, every model index, rotations
    negative and past n, a broadcast row; the contiguous map is the plain
    call; a map that does not fit is refused."""
    gen = torch.Generator().manual_seed(3)
    for shape, dim, M in (((3, 10, 12), -1, 4), ((6, 16, 35), -2, 4), ((4, 9, 132), -1, 4), ((2, 12), -1, 12),
                          ((1, 64, 30), -2, 2), ((40, 6), 0, 2)):
        s = math.prod(shape)
        for m in range(M):
            b = SH.leaf_block(shape, dim, M, m)
            for n, r in ((4, -3), (4, 9), (3, 1)):
                W = torch.randn(3, s, generator=gen).to(dtype)
                delta = torch.randn(s, generator=gen).to(dtype)
                rot = torch.tensor([r], dtype=torch.int32)
                whole = ref.rotk_apply_rows_ref(W, delta, rot, n=n)
                w, dl = b.cut(W).contiguous(), b.cut(delta).contiguous()
                got = ref.rotk_apply_rows_ref(w, dl, rot, n=n, block=b.map)
                assert torch.equal(_bits(got), _bits(b.cut(whole))), (shape, dim, m, n, r)
                out = torch.empty(3, b.size, dtype=dtype)
                wrapped = ops.rotk_apply_rows(w, dl, rot, n=n, block=b.map, out=out)
                assert wrapped is out and torch.equal(_bits(out), _bits(got))
                one = w[0].expand(3, -1)  # a broadcast row
                assert torch.equal(_bits(ops.rotk_apply_rows(one, dl, rot, n=n, block=b.map)),
                                   _bits(b.cut(ref.rotk_apply_rows_ref(W[0].expand(3, -1), delta, rot, n=n))))
    w, delta, rot = torch.zeros(2, 12, dtype=dtype), torch.ones(12, dtype=dtype), torch.tensor([1], dtype=torch.int32)
    assert torch.equal(_bits(ops.rotk_apply_rows(w, delta, rot, n=4, block=(12, 12, 0))),
                       _bits(ops.rotk_apply_rows(w, delta, rot, n=4)))
    for bad in ((5, 12, 0), (4, 3, 0), (4, 12, 9), (0, 12, 0)):
        with pytest.raises(ValueError, match="does not map"):
            ops.rotk_apply_rows(w, delta, rot, n=4, block=bad)


@pytest.mark.parametrize("mode", ["perm", "ind", "same"])
def test_downlink_on_blocks_is_the_whole_downlinks_block(mode):
    """``round_rows`` on a rank's blocks ([R, d_local] rows, model-local
    x^{t+1} and delta) equals the rank's blocks of ``round``'s rows bit for
    bit, f32 and bf16 replicas, a sync too, at every rank of (2, 2), and of
    the hierarchical (wk, data, model) = (2, 2, 2), whose replica rows hold
    two-level blocks ([R, d_rank])."""
    cfg = configs.get_smoke("minitron-4b")
    sizes = P.leaf_sizes(lm.lm_spec(cfg))
    d, W = sum(sizes), 4
    meshes = (Mesh(("data", "model"), (2, 2)), Mesh(("wk", "data", "model"), (2, 2, 2)))
    g = torch.Generator().manual_seed(1)
    x_old = torch.randn(d, generator=g)
    x_new = x_old + 0.01 * torch.randn(d, generator=g)
    dl = D.MarinaPDownlink(W, mode, p=1e-12)
    for dtype in (torch.float32, torch.bfloat16):
        workers = (x_old + 0.001 * torch.randn(W, d, generator=g)).to(dtype)
        for coin in (False, True):
            draws = D.draw_round(dl, sizes, torch.Generator().manual_seed(3),
                                 torch.Generator().manual_seed(4))._replace(coin=coin)
            full, bits = dl.round(draws, sizes, x_new, x_old, workers)
            for mesh in meshes:
                for r in range(mesh.size):
                    lay = SH.make_layout(mesh, r, W, d, cfg)
                    rows, b = dl.round_rows(draws, sizes, lay.rank_local(x_new),
                                            None if coin else lay.rank_local(x_new - x_old),
                                            lay.rank_local(workers[lay.off:lay.off + lay.local]), lay.off,
                                            blocks=lay.rank_blocks)
                    assert b == bits
                    assert torch.equal(_bits(rows), _bits(lay.rank_local(full[lay.off:lay.off + lay.local])))
            assert any(b.inner for b in lay.rank_blocks)  # the hierarchical mesh's two-level blocks ran


@pytest.mark.parametrize("case", ["no blocks", "act_spec on blocks", "act_spec with experts", "odd weight"])
def test_tensor_parallel_refusals(case):
    """What the train step's tensor parallelism still refuses, each with its
    message: a layout without the rank's blocks where "model" > 1, act_spec
    on one with them on ("data", "model"). act_spec with experts on the
    hierarchical mesh is not refused: the step is built on a CountingComm,
    and one step on meta calls every kind of collective
    (``tests/test_torch_train_hier_act.py``; the moe family's tensor
    parallelism, ``tests/test_torch_train_tp_families.py``, and its act_spec
    on ("data", "model"), ``tests/test_torch_train_act_moe.py``); nor is a
    product's weight that "model" does not split: the smoke starcoder2's
    attention at M = 32 runs whole, alike on every rank
    (``tests/test_torch_train_whole.py``)."""
    mesh = Mesh(("data", "model"), (2, 2))
    tcfg = TrainerConfig(n_workers=2, attn_chunk=32)
    act = TrainerConfig(n_workers=2, attn_chunk=32, act_spec=SH.ACT_SPEC)
    cfg = configs.get_smoke("deepseek-v2-236b" if case == "act_spec with experts" else "gemma-2b")
    d = sum(P.leaf_sizes(lm.lm_spec(cfg)))
    if case == "odd weight":  # the smoke starcoder2's 48-column kv projection does not split
        wide = Mesh(("data", "model"), (1, 32))
        odd = configs.get_smoke("starcoder2-7b")
        lay = SH.Layout(wide, 0, 1, sum(P.leaf_sizes(lm.lm_spec(odd))), SH.model_blocks(odd, wide, 0))
        SH.check_tensor_parallel(odd, lay)
        SH.make_sharded_train_step(odd, TrainerConfig(n_workers=1, attn_chunk=32), make_downlink("marina:perm", 1),
                                   make_optimizer("adamw"), constant_lr(SC.LR), lay, SH.CountingComm())
        rank = SS.ServeLayout(wide, 5, "tp")
        attn = SS.shard_params(lm.lm_init(odd, device="meta"), rank).tree["stack"]["segments"][0]["attn"]
        assert tuple(attn["wk"].shape) == (144, 48) and tuple(attn["wo"].shape) == (144, 144)
        assert SS.ServeShard(odd, rank, SH.CountingComm()).core(attn, "wo").alike
        return
    if case == "act_spec with experts":
        lay = SH.make_layout(Mesh(("wk", "data", "model"), (1, 2, 2)), 0, 2, d, cfg, act=True)
        comm = SH.CountingComm()
        dl, opt = make_downlink("marina:perm", 2), make_optimizer("adamw")
        step = SH.make_sharded_train_step(cfg, act, dl, opt, constant_lr(SC.LR), lay, comm)
        state = SH.init_state(cfg, act, dl, opt, lay, device="meta")
        batch = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
                 for k, s in batch_specs(cfg, 2, 4, 64).items()}
        step(state, batch, compressed_draws(dl, P.leaf_sizes(lm.lm_spec(cfg))))
        assert set(comm.bytes) == {"all-gather", "reduce-scatter", "all-reduce"} and min(comm.bytes.values()) > 0
        return
    lay, tc, what = {"no blocks": (SH.Layout(mesh, 0, 2, d), tcfg, "holds the rank's blocks"),
                     "act_spec on blocks": (SH.Layout(mesh, 0, 2, d, SH.model_blocks(cfg, mesh, 0)), act,
                                            "whole replicas")}[case]
    with pytest.raises(ValueError, match=what):
        SH.make_sharded_train_step(cfg, tc, make_downlink("marina:perm", 2), make_optimizer("adamw"),
                                   constant_lr(SC.LR), lay, SH.CountingComm())


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
        # enter / gather / exit on a pair of ranks, float64: each input's analytic
        # gradient against central differences of the loss (the same on both ranks)
        from repro_torch.launch import comm as C
        comm = C.Comm({"model": pair})
        m = rank % 2
        g = torch.Generator().manual_seed(5)
        x = torch.randn(3, 4, generator=g, dtype=torch.float64)                  # replicated
        blocks = [torch.randn(2, 4, 2, generator=g, dtype=torch.float64) for _ in range(3)]
        wcol, wrow, wg = (b[m].clone() for b in blocks[:3])                    # rank m's blocks
        wrow = wrow.T.contiguous()                                             # [2, 4]: rows of [4, 4]
        wg = wg[:, :1].contiguous()                                            # [4, 1] of a gathered [4, 2]

        def loss(x, wcol, wrow, wg):
            h = C.enter(comm, x, "model")
            full = C.gather(comm, wg, 1, 2, "model")                          # [4, 2] on both ranks
            a = torch.tanh(h @ wcol) * (h @ full)[:, m:m + 1]                  # the rank's columns
            y = C.exit(comm, a @ wrow, "model")                                # replicated [3, 4]
            return (y * torch.sin(y)).sum() + (x * x).sum()  # x, not h: a replicated use

        args = [t.requires_grad_(True) for t in (x, wcol, wrow, wg)]
        loss(*args).backward()
        worst = 0.0
        eps = 1e-6
        for i, t in enumerate(args):
            for r in range(2):                        # a block is moved on its own rank, x on both
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
                        worst = max(worst, abs(num - mine) / max(abs(num), 1.0))
                if i == 0:
                    break
        return worst


    def leaf_grads(rank, pair, archs):
        # each leaf's gradient at (1, 2) (the pairs) and (1, 4) against the single process
        from repro_torch import configs
        from repro_torch.data import SyntheticLMData
        from repro_torch.launch import comm as C
        from repro_torch.launch.mesh import Mesh
        from repro_torch.models import lm, params as P
        from repro_torch.serve import sharded as SS
        from repro_torch.train import sharded as SH, sharded_check as SC, trainer

        # the single process's gradient and floor once an architecture, on rank 0, which compares
        out = {}
        for arch in archs:
            cfg = configs.get_smoke(arch)
            spec = lm.lm_spec(cfg)
            x = lm.lm_init(cfg, device="cpu", seed=1).flat.detach()
            batch = {k: v[0] for k, v in SyntheticLMData(cfg, 1, 2, 64, device="cpu").batch(0).items()}
            kw = dict(chunk=32, remat=True, window_override=None, remat_policy=None)
            if rank == 0:
                l1, g1 = trainer.worker_value_and_grad(cfg, spec, kw, x, batch)
                floor = SC.loss_floor(cfg, [x], {k: v[None] for k, v in batch.items()}, chunk=32)
            for shape in ((1, 2), (1, 4)):
                M = shape[1]
                mesh = Mesh(("data", "model"), shape)
                r = rank % M
                comm = C.Comm({"model": pair if M == 2 else None})
                layout = SH.Layout(mesh, r, 1, sum(P.leaf_sizes(spec)), SH.model_blocks(cfg, mesh, r))
                tp = SS.ServeShard(cfg, SS.ServeLayout(mesh, r, "tp"), comm)
                l2, g2 = trainer.worker_value_and_grad(cfg, spec, dict(kw, tp=tp), layout.model_local(x), batch)
                parts = g2.new_empty(M * layout.d_local)
                comm.all_gather(parts, g2, "model")
                if rank:
                    continue
                g2 = layout.whole(parts.reshape(M, -1))
                leaves, o = {}, 0
                for path, leaf in P.leaves_with_path(spec):
                    a, b = g1[o:o + leaf.size], g2[o:o + leaf.size]
                    leaves[P.path_key(path)] = float((a - b).abs().max() / a.abs().max())
                    o += leaf.size
                out[(arch, shape)] = {"loss": abs(float(l1) - float(l2)), "floor": floor, "leaves": leaves,
                                      "kv_whole": tp.heads.kv_whole}
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
        cfg = configs.get_smoke("gemma-2b")
        d, W = sum(P.leaf_sizes(lm.lm_spec(cfg))), 4
        for shape in ((1, 4), (2, 2)):
            layout, comm = SH.connect(Mesh(("data", "model"), shape), W, d, cfg=cfg)
            aux = SH.Comm()
            for name, spec, dtype, drop, forced in cases["cases"]:
                del launches[:]
                tcfg = TrainerConfig(n_workers=W, attn_chunk=32, weight_dtype=getattr(torch, dtype), drop_prob=drop)
                res = SC.run_case(cfg, tcfg, spec, layout, comm, aux, batch_rows=2, seq=64, device="cpu",
                                  forced=forced, check_rank=0)
                res["block_launches"] = len(launches)
                report[(name, shape)] = res
        # one step with only rank 0 holding the single process (chip_smoke's full-width gemma3-1b case)
        layout, comm = SH.connect(Mesh(("data", "model"), (1, 4)), W, d, cfg=cfg)
        report["check_rank"] = SC.run_case(cfg, TrainerConfig(n_workers=W, attn_chunk=32), "ef21p:16:64", layout,
                                           comm, SH.Comm(), batch_rows=2, seq=64, device="cpu", steps=1,
                                           check_rank=0)
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

CASES = [("marina:perm/bf16", "marina:perm", "bfloat16", 0.0, False),
         ("marina:ind/partial+forced", "marina:ind", "float32", 0.4, True),
         ("ef21p/forced", "ef21p:16:64", "float32", 0.0, True)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    script = tmp / "ranks.py"
    script.write_text(_RANKS)
    cases_path, out_path = tmp / "cases.pkl", tmp / "report.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump({"cases": CASES, "archs": GRAD_ARCHS}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, str(script), f"file://{tmp / 'rdv'}", str(cases_path), str(out_path)],
                         env=env, capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)


def test_collectives_with_a_backward_against_finite_differences(four_ranks):
    """enter (all-reduce backward), gather (reduce-scatter backward) and exit
    (identity backward) on a "model" axis of 2, float64: every input's
    gradient within 1e-6 of central differences, on every rank."""
    for rank, rep in enumerate(four_ranks):
        print(f"rank {rank}: finite differences, worst relative distance {rep['fd']:.2e}")
        assert rep["fd"] <= 1e-6


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_leaf_gradients_against_the_single_process(four_ranks, arch, shape):
    res = four_ranks[0]["leaves"][(arch, shape)]
    worst = max(res["leaves"].items(), key=lambda kv: kv[1])
    print(f"{arch} {shape}: loss |diff| {res['loss']:.3g} (floor {res['floor']:.3g}); worst leaf {worst}")
    assert res["loss"] <= LOSS_ATOL
    assert worst[1] <= LEAF_RTOL
    assert res["kv_whole"] == (arch in ("gemma3-1b", "gemma-2b") or (arch == "pixtral-12b" and shape == (1, 4)))


def test_one_rank_holds_the_single_process(four_ranks):
    """``run_case(check_rank=0)``: rank 0 alone runs the single-process step
    and its floor and is held to the bounds; the others hand the same bytes
    and report zeros."""
    res = [rep["check_rank"] for rep in four_ranks]
    SC.hold("ef21p", res[0], SC.bounds(True), 4)
    assert max(res[0]["worst"][:2]) > 0 and res[0]["floor"][0] > 0
    for r in res[1:]:
        assert not any(r["worst"]) and not any(r["floor"]) and r["moved"] == res[0]["moved"]
    layout = SH.Layout(Mesh(("data", "model"), (1, 1)), 0, 1, 1)
    with pytest.raises(ValueError, match="outside"):
        SC.run_case(None, None, "ef21p", layout, None, None, batch_rows=1, seq=1, device="cpu", check_rank=1)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_four_ranks_tensor_parallel_steps_against_single_process(four_ranks, name, shape):
    """3 teacher-forced steps within ACT_BOUNDS (the loss within
    FLOOR_FACTOR x the run's floor; rank 0 holds the single process and
    the gathered state, ``run_case(check_rank=0)``), bytes handed = counted,
    the round trip bit for bit (``run_case``), perm through the block map,
    on every rank."""
    for rank in range(4):
        res = four_ranks[rank][(name, shape)]
        print(f"{name} {shape} rank {rank}: {dict(zip(SC.WORST_KEYS, res['worst']))}, floor {res['floor']}; "
              f"bytes a step {res['moved']}")
        SC.hold(name, res, SC.bounds(True), 4)
        assert res["floor"][0] > 0 if rank == 0 else not any(res["floor"]) and not any(res["worst"])
        assert (res["block_launches"] > 0) == (name.startswith("marina:perm") and res["compressed"] > 0)
