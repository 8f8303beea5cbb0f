"""The serving step across a process group for the moe family
(``repro_torch.serve.sharded`` with ``models/moe.py``'s experts over
"model" and MLA on the rank's heads) against the single-process port.

* Four gloo ranks (one subprocess, ``torch.multiprocessing.spawn``) on
  (2, 2) ``serve`` (ZeRO-3 gathers over "data", the batch's rows over
  "data", the experts over "model"), (1, 4) ``tp`` (one expert a rank) and
  (4, 1) ``serve`` at B = 1 (the caches' sequence split over "data":
  deepseek-v2's MLA latent and llama4's k/v), for both moe smoke configs.
  Each case is a prefill and 3 teacher-forced decode steps held within
  ``serve/sharded_check.SMOKE_BOUNDS`` of ``lm.forward`` /
  ``lm.decode_step``, the bytes handed to gloo equal to the count of the
  same steps on ``meta``.
* The routed experts (``moe_apply`` without the shared experts) on every
  rank are the single process's rows bit for bit: at the smoke configs'
  capacity_factor 8 (no copy drops) and at 1.0, where copies drop and a
  capacity taken from a data rank's own tokens would drop other ones (the
  capacity and each copy's position are the call's global ones).
* The heads rule of MLA, the train step's own refusal of moe, the rank's
  blocks drawn from the seed, and what a rank sums over "model".

The one-rank bit-for-bit cases, the rank's parameter counts under the
reference's specs and the reference's own partitioned programs for these
configs are in tests/test_torch_serve_sharded.py.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import op_cost
from repro_torch.launch.comm import CountingComm
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe as MOE
from repro_torch.models.params import leaf_sizes, leaves, leaves_with_path
from repro_torch.serve import sharded as SS
from repro_torch.serve import sharded_check as SC
from repro_torch.train import sharded as SH

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]
MESHES = [("2x2", "serve", dict(batch=2, prompt=24, cache_len=40, steps=3, start=30)),
          ("1x4", "tp", dict(batch=2, prompt=24, cache_len=40, steps=3, start=30)),
          ("4x1", "serve", dict(batch=1, prompt=24, cache_len=64, steps=3, start=40))]
LOW_CAPACITY = 1.0

_RANKS = textwrap.dedent(
    """
    import pickle, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def worker(rank, init, job_path, out_dir):
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.launch.comm import Comm
        from repro_torch.launch.mesh import Mesh
        from repro_torch.models import lm
        from repro_torch.serve import sharded as SS, sharded_check as SC

        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
        job = pickle.load(open(job_path, "rb"))
        report = {}
        for arch in job["archs"]:
            for shape, name, kw in job["meshes"]:
                cfg = configs.get_smoke(arch)
                layout, comm = SS.connect(Mesh(("data", "model"), tuple(int(x) for x in shape.split("x"))), name)
                aux = Comm(comm.groups)  # the checks' collectives, apart from the step's tally
                res = SC.run_case(cfg, layout, comm, aux, chunk=8, **kw)
                # the routed part where copies drop
                low = SC.with_capacity(cfg, job["low_capacity"])
                want = SC.routed_single(low, lm.lm_init(low, device="cpu", seed=0), batch=kw["batch"],
                                        prompt=kw["prompt"], split=layout.rows_split(kw["batch"]))
                res["routed_low"] = SC.routed_rank(low, layout, aux, SS.init_params(low, layout, seed=0, device="cpu"),
                                                   want, batch=kw["batch"], prompt=kw["prompt"])
                report[f"{shape}/{name}/{arch}"] = res
        pickle.dump(report, open(f"{out_dir}/rank{rank}.pkl", "wb"))
        dist.destroy_process_group()


    if __name__ == "__main__":
        init, job_path, out_dir = sys.argv[1:]
        mp.spawn(worker, args=(init, job_path, out_dir), nprocs=4, join=True)
    """
)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_moe_ranks")
    (tmp / "ranks.py").write_text(_RANKS)
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump({"archs": ARCHS, "meshes": MESHES, "low_capacity": LOW_CAPACITY}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, str(tmp / "ranks.py"), f"file://{tmp / 'rdv'}", str(tmp / "job.pkl"),
                          str(tmp)], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    out = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("mesh", [m[:2] for m in MESHES], ids=lambda m: "/".join(m))
@pytest.mark.parametrize("arch", ARCHS)
def test_four_ranks_steps_within_smoke_bounds(four_ranks, arch, mesh):
    """Prefill and 3 decode steps on every rank within SMOKE_BOUNDS of the
    single process, greedy sampling its tokens, the bytes handed to gloo
    equal to the count on meta, the rank's parameters its specs' numel."""
    name = f"{mesh[0]}/{mesh[1]}/{arch}"
    for rank, rep in enumerate(four_ranks):
        res = rep[name]
        print(f"{name} rank {rank}: prefill {res['prefill']:.4g}, decode {max(res['decode']):.4g}, caches "
              f"{res['caches']:.4g}; bytes {res['moved']}; heads {res['heads']}; routed {res['routed']}")
        SC.hold(f"{name} rank {rank}", res, SC.SMOKE_BOUNDS)
        assert res["moved"] == res["counted"]
        assert sum(res["moved"]["decode"].values()) > 0
    moved = four_ranks[0][name]["moved"]["prefill"]
    if mesh == ("2x2", "serve"):  # ZeRO-3 gathers, the copies' positions over "data", the sums over "model"
        assert {"all-gather", "all-reduce"} <= set(moved)


@pytest.mark.parametrize("low", [False, True], ids=["capacity8", "capacity1"])
@pytest.mark.parametrize("mesh", [m[:2] for m in MESHES], ids=lambda m: "/".join(m))
@pytest.mark.parametrize("arch", ARCHS)
def test_routed_experts_bit_for_bit(four_ranks, arch, mesh, low):
    """The routed part of the first MoE layer on every rank equals the
    single process's rows bit for bit. At capacity_factor 1.0 copies drop;
    on (2, 2), where the batch's rows split over "data", a capacity taken
    from a rank's own tokens would drop other copies (the trap the global
    capacity and positions avoid)."""
    name = f"{mesh[0]}/{mesh[1]}/{arch}"
    for rank, rep in enumerate(four_ranks):
        r = rep[name]["routed_low" if low else "routed"]
        print(f"{name} rank {rank}: {r}")
        assert r["equal"], (name, rank, r)
        M = int(mesh[0].split("x")[1])
        assert r["experts"] == (None if M == 1 else (rank % M * 4 // M, 4 // M))  # the rank's block of E = 4
        assert (r["dropped"] > 0) == low, r
        # where nothing drops globally a local capacity drops nothing either
        assert r["local_drops_differ"] is (low if mesh == ("2x2", "serve") else None), r
    assert four_ranks[0][name]["routed"]["dropped"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_split_decode_4x1(four_ranks, arch):
    """B = 1 over 4 data ranks: each rank holds a quarter of every cache's
    slots (deepseek-v2's MLA latent [B, L, r] and [B, L, rd], llama4's
    k / v), the owner writes the new position, the partial softmaxes are
    combined over "data"; the prefill runs the single process's arithmetic."""
    name = f"4x1/serve/{arch}"
    res = four_ranks[3][name]
    assert res["cache_bytes"] * 4 == sum(r[name]["cache_bytes"] for r in four_ranks)
    assert res["cache_bytes"] == res["cache_bytes_specs"] and res["prefill_exact"]
    assert res["moved"]["decode"].get("all-reduce", 0) > 0


# ---------------------------------------------------------------------------
# single process
# ---------------------------------------------------------------------------


def test_mla_heads_rule():
    """MLA's q heads: the rank's H / M where M divides H (deepseek-v2's
    smoke config has 4 heads; its full config 128, 8 a rank at M = 16), all
    of them with wq gathered whole where it does not, all of them under
    tp_attn_rep (wq replicated, w_uk / w_uv read whole); no kv heads.
    llama4's 40 q / 8 kv heads are GQA, cut at M = 16."""
    ds = configs.get_smoke("deepseek-v2-236b")
    for M in (2, 4):
        mesh = Mesh(("data", "model"), (1, M))
        for r in range(M):
            assert SS.attention_heads(ds, SS.ServeLayout(mesh, r, "tp")) == L.Heads(r * 4 // M, 4 // M, 0, 0)
            assert SS.attention_heads(ds, SS.ServeLayout(mesh, r, "tp_attn_rep")) == L.Heads(0, 4, 0, 0)
    cut = Mesh(("data", "model"), (1, 8))  # 4 heads, 192 wq columns split 8 ways: a head is cut
    assert SS.attention_heads(ds, SS.ServeLayout(cut, 5, "tp")) == L.Heads(0, 4, 0, 0, True, False)
    prod = make_production_mesh()
    full = configs.get("deepseek-v2-236b")
    assert SS.attention_heads(full, SS.ServeLayout(prod, 3 * 16 + 5)) == L.Heads(40, 8, 0, 0)
    assert SS.attention_heads(configs.get("llama4-maverick-400b-a17b"), SS.ServeLayout(prod, 5)) == \
        L.Heads(0, 40, 0, 8, True, True)


def test_latent_caches_split_batch_or_sequence():
    """MLA's caches [.., B, L, r]: the batch at -3, the sequence at -2;
    cache_specs never splits them over "model"."""
    full = configs.get("deepseek-v2-236b")
    lay = SS.ServeLayout(make_production_mesh(), 0)
    assert SS.cache_layout(full, lay, 128, 32768).found == {"batch"}
    assert SS.cache_layout(full, lay, 1, 524288, window_override=8192).found == {"seq"}
    ds = configs.get_smoke("deepseek-v2-236b")  # 32-wide latent, 16-wide rope key
    # (B, slots, mesh, the dim cache_specs puts "data" on, the ranks it splits over)
    for B, L, shape, dim, D in ((2, 40, "2x2", 0, 2), (1, 64, "4x1", 1, 4), (2, 40, "1x4", 0, 1)):
        caches = lm.cache_init(ds, B, L, device="cpu")
        lay = SS.ServeLayout(Mesh(("data", "model"), tuple(int(x) for x in shape.split("x"))), 1)
        specs, kinds = SS.cache_split(caches, lay)
        assert set(leaves(kinds)) == ({"seq"} if dim == 1 else {"batch"} if D > 1 else {None})
        assert all(tuple(s) == tuple(None if i != dim else "data" for i in range(3))
                   for s in (specs[0]["c"], specs[1]["k_rope"]))
        mine = SS.shard_caches(caches, ds, lay)
        assert SS.cache_bytes(lay, caches) == sum(t.numel() * t.element_size() for t in leaves(mine))
        assert [t.shape[-1] for t in leaves(mine)] == [32, 16, 32, 16]
        assert sum(t.numel() for t in leaves(mine)) * D == sum(t.numel() for t in leaves(caches))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_still_refuses_moe(arch):
    """Serving admits the moe family, and so does the train step's tensor
    parallelism (tests/test_torch_train_tp_families.py), also where "model"
    does not split the experts (the smoke config's 4 at M = 16: the router
    and the experts whole on every rank, the routed part alike there,
    tests/test_torch_train_whole.py): nothing of it is refused."""
    cfg = configs.get_smoke(arch)
    SS.check_ported(cfg)
    assert "moe" not in SS.NOT_PORTED
    d = sum(leaf_sizes(lm.lm_spec(cfg)))
    mesh = Mesh(("data", "model"), (2, 2))
    SH.check_tensor_parallel(cfg, SH.Layout(mesh, 0, 2, d, SH.model_blocks(cfg, mesh, 0)))
    wide = Mesh(("data", "model"), (1, 16))
    blocks = SH.model_blocks(cfg, wide, 0)
    SH.check_tensor_parallel(cfg, SH.Layout(wide, 0, 1, d, blocks))
    whole = {p[-1] for (p, _), b in zip(leaves_with_path(lm.lm_spec(cfg)), blocks) if b.whole}
    assert {"router", "w_in", "w_gate", "w_out"} <= whole
    layout = SS.ServeLayout(wide, 3, "tp")
    node = SC._first_moe(SS.shard_params(lm.lm_init(cfg, device="meta"), layout).tree)
    tp = SS.ServeShard(cfg, layout, CountingComm())
    assert tp.core(node, "w_in", -3).alike and not tp.alike


@pytest.mark.parametrize("shape,layout_name", [("2x2", "serve"), ("1x4", "tp"), ("2x2", "tp_attn_rep"),
                                               ("4x1", "serve")])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_are_the_blocks_of_lm_init(arch, shape, layout_name):
    """``init_params`` draws the rank's blocks of ``lm_init(seed)`` leaf by
    leaf: ``shard_params(lm_init(seed))`` bit for bit on every rank."""
    cfg = configs.get_smoke(arch)
    params = lm.lm_init(cfg, device="cpu", seed=7)
    mesh = Mesh(("data", "model"), tuple(int(x) for x in shape.split("x")))
    for r in range(mesh.size):
        layout = SS.ServeLayout(mesh, r, layout_name)
        a, b = SS.init_params(cfg, layout, seed=7, device="cpu"), SS.shard_params(params, layout)
        assert torch.equal(a.flat.view(torch.int32), b.flat.view(torch.int32))
        assert torch.equal(a.flat_low.view(torch.int16), b.flat_low.view(torch.int16))


@pytest.mark.parametrize("M,summed", [(4, True), (8, False)])
def test_routed_sum_over_model_only_where_E_splits(M, summed):
    """The routed part's all-reduce over "model" (K·N·D bf16) runs where the
    spec splits E (4 experts at M = 4); at M = 8 E stays whole, every rank
    computes every expert and sums nothing (a sum would multiply by M)."""
    cfg = SC._routed_cfg(configs.get_smoke("deepseek-v2-236b"))
    layout = SS.ServeLayout(Mesh(("data", "model"), (1, M)), 1, "tp")
    comm = CountingComm()
    tp = SS.ServeShard(cfg, layout, comm)
    node = SC._first_moe(SS.shard_params(lm.lm_init(cfg, device="meta"), layout).tree)
    assert (tp.model_block(node, "w_in", -3) is not None) == summed
    with op_cost.counting() as c, torch.no_grad():
        MOE.moe_apply(cfg, node, torch.empty(2, 5, cfg.d_model, dtype=torch.bfloat16, device="meta"), tp=tp)
    K, E = cfg.moe.top_k, cfg.moe.num_experts
    # the router read whole where split (bf16 [D, E]) and the copies' K·N·D outputs in bf16
    assert dict(c.coll) == ({"all-gather": cfg.d_model * E * 2, "all-reduce": 2 * 5 * K * cfg.d_model * 2}
                            if summed else {})


def test_aux_losses_refuse_a_context_across_ranks():
    cfg = configs.get_smoke("llama4-maverick-400b-a17b")
    layout = SS.ServeLayout(Mesh(("data", "model"), (1, 2)), 0, "tp")
    node = SC._first_moe(SS.shard_params(lm.lm_init(cfg, device="meta"), layout).tree)
    with pytest.raises(ValueError, match="aux losses"):
        MOE.moe_apply(cfg, node, torch.empty(1, 3, cfg.d_model, dtype=torch.bfloat16, device="meta"),
                      return_aux=True, tp=SS.ServeShard(cfg, layout, CountingComm()))
