"""The serving step across a process group for the ssm and hybrid families
(``repro_torch.serve.sharded`` with ``models/ssm.py``'s RWKV-6 and Mamba2
on the rank's heads) against the single-process port, and its rules.

* One rank (a gloo group of one, mesh (1, 1)): the sharded prefill and
  decode of rwkv6's and zamba2's smoke configs equal ``lm.forward`` /
  ``lm.decode_step`` bit for bit (logits, caches, greedy tokens) under each
  serve layout.
* Four gloo ranks (one subprocess, ``torch.multiprocessing.spawn``) on
  (2, 2) ``serve`` (ZeRO-3 gathers over "data", the batch's rows over
  "data", the heads over "model"), (1, 4) ``tp`` and (2, 2) ``tp_attn_rep``:
  a prefill of 2 x 32 tokens and 3 teacher-forced decode steps within
  ``serve/sharded_check.SMOKE_BOUNDS`` of the single process, the bytes
  handed to gloo equal to the count of the same steps on ``meta``. The same
  steps on parameters whose constant leaves (``w0``, ``w_lora_b``, ``A_log``,
  ``D``, ``dt_bias``, ``conv_b``, the norms' scales) are drawn at random, so
  that a rank reading another head's slice of them would show; and with
  head widths that the "model" split cuts through (rwkv6's heads of 64 and
  zamba2's Mamba2 heads of 128 at M = 4: every head on every rank, the
  head-split weights gathered).
* The heads rule, the Mamba2 ``in_proj`` / ``conv_w`` cut across the
  segments, the cache rules leaf by leaf (long_500k's refusal among them),
  ``init_params``, and the train step's own refusal of both families.

The reference's own partitioned programs for these configs are in
tests/test_torch_serve_sharded.py (``REF_ARCHS``).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import sharding as sh
from repro_torch.launch.comm import CountingComm
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models import ssm as SSM
from repro_torch.models.params import leaf_sizes, leaves, leaves_with_path
from repro_torch.serve import sharded as SS
from repro_torch.serve import sharded_check as SC
from repro_torch.train import sharded as SH

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["rwkv6-1.6b", "zamba2-1.2b"]
# prompts are a multiple of rwkv's chunk of 32 and of zamba2's smoke Mamba2 chunk of 32
CASE = dict(batch=2, prompt=32, cache_len=40, steps=3, start=30)
MESHES = [("2x2", "serve"), ("1x4", "tp"), ("2x2", "tp_attn_rep")]
# head widths the "model" split at M = 4 cuts through: rwkv6's smoke D = 128 in 2 heads of 64, zamba2's smoke
# d_inner = 256 in 2 Mamba2 heads of 128
WIDE = ["rwkv6-1.6b@64", "zamba2-1.2b@128"]


def config(name: str):
    """The smoke config of ``arch``, or ``arch@w`` with recurrent heads of width w."""
    arch, _, width = name.partition("@")
    cfg = configs.get_smoke(arch)
    if not width:
        return cfg
    if cfg.rwkv is not None:
        return dataclasses.replace(cfg, rwkv=dataclasses.replace(cfg.rwkv, head_dim=int(width)))
    return dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba, head_dim=int(width)))


def _bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.uint8),
                                                                    b.reshape(-1).view(torch.uint8))


@pytest.fixture
def one_rank(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0, world_size=1)
    try:
        yield Mesh(("data", "model"), (1, 1))
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(n)


@pytest.mark.parametrize("layout_name", ["serve", "tp", "tp_attn_rep"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_equals_forward_and_decode_bit_for_bit(one_rank, arch, layout_name):
    cfg = configs.get_smoke(arch)
    layout, comm = SS.connect(one_rank, layout_name)
    params = lm.lm_init(cfg, device="cpu", seed=3)
    x = SC.inputs(cfg, batch=2, prompt=32, cache_len=40, steps=3, seed=4)
    with torch.no_grad():
        want = lm.forward(cfg, params, x["batch"], chunk=8, remat=False)
    sp = SS.shard_params(params, layout)
    assert _bits(SS.make_prefill_step(cfg, layout, comm, chunk=8)(sp, x["batch"]), want)
    decode = SS.make_decode_step(cfg, layout, comm, 2, 40)
    caches, mine = x["caches"], SS.shard_caches(x["caches"], cfg, layout)
    for i, tok in enumerate(x["tokens"]):
        with torch.no_grad():
            want, caches = lm.decode_step(cfg, params, caches, tok, 30 + i)
        got, mine = decode(sp, mine, tok, torch.tensor(30 + i))
        assert _bits(got, want), i
        assert all(_bits(a, b) for a, b in zip(leaves(mine), leaves(caches))), i
        assert torch.equal(SS.greedy(got, layout, comm, cfg.vocab_size), want.argmax(-1))
    # the recurrent states stay fp32, the token shifts and the conv window bf16
    assert {t.dtype for p, t in leaves_with_path(mine) if p[-1] in ("state", "ssm")} == {torch.float32}
    assert not comm.bytes  # an axis of one rank runs no collective
    assert _bits(SS.gather_params(sp, layout, comm).flat, params.flat)


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

_RANKS = textwrap.dedent(
    """
    import dataclasses, pickle, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def config(name):
        from repro_torch import configs
        arch, _, width = name.partition("@")
        cfg = configs.get_smoke(arch)
        if not width:
            return cfg
        if cfg.rwkv is not None:
            return dataclasses.replace(cfg, rwkv=dataclasses.replace(cfg.rwkv, head_dim=int(width)))
        return dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba, head_dim=int(width)))


    def perturbed(cfg):
        # lm_init(seed=0) with every constant leaf (w0, w_lora_b, A_log, D, dt_bias, conv_b, the scales) moved by
        # seeded N(0, 0.1) noise: a head's slice of them differs from another's
        from repro_torch.models import lm
        from repro_torch.models.params import leaves, leaves_with_path
        params = lm.lm_init(cfg, device="cpu", seed=0)
        g = torch.Generator().manual_seed(11)
        with torch.no_grad():
            for (_, leaf), view in zip(leaves_with_path(params.spec), leaves(params.tree)):
                if leaf.init == "full":
                    view.add_(torch.randn(view.shape, generator=g) * 0.1)
        return params.refresh()


    def against(cfg, layout, comm, params, case):
        # the sharded prefill and decode on the rank's blocks of params against the single process on params
        from repro_torch.models import lm
        from repro_torch.models.params import leaves
        from repro_torch.serve import sharded as SS, sharded_check as SC
        x = SC.inputs(cfg, batch=case["batch"], prompt=case["prompt"], cache_len=case["cache_len"],
                      steps=case["steps"], seed=1)
        sp = SS.shard_params(params, layout)
        with torch.no_grad():
            want = lm.forward(cfg, params, x["batch"], chunk=8, remat=False)
        got = SS.make_prefill_step(cfg, layout, comm, chunk=8)(sp, x["batch"])
        res = {"prefill": SC._dist(got, SC._block(want, got, layout)), "decode": []}
        decode = SS.make_decode_step(cfg, layout, comm, case["batch"], case["cache_len"])
        caches, mine = x["caches"], SS.shard_caches(x["caches"], cfg, layout)
        for i, tok in enumerate(x["tokens"]):
            with torch.no_grad():
                want, caches = lm.decode_step(cfg, params, caches, tok, case["start"] + i)
            got, mine = decode(sp, mine, tok, torch.tensor(case["start"] + i))
            res["decode"].append(SC._dist(got, SC._block(want, got, layout)))
        res["caches"] = max(SC._dist(a, b) for a, b in zip(leaves(mine), leaves(SS.shard_caches(caches, cfg, layout))))
        return res


    def worker(rank, init, job_path, out_dir):
        torch.set_num_threads(1)
        from repro_torch.launch.comm import Comm
        from repro_torch.launch.mesh import Mesh
        from repro_torch.serve import sharded as SS, sharded_check as SC

        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
        job = pickle.load(open(job_path, "rb"))
        report = {}
        for name, shape, lay in job["cases"]:
            cfg = config(name)
            layout, comm = SS.connect(Mesh(("data", "model"), tuple(int(x) for x in shape.split("x"))), lay)
            aux = Comm(comm.groups)  # the checks' collectives, apart from the step's tally
            res = SC.run_case(cfg, layout, comm, aux, chunk=8, **job["case"])
            res["perturbed"] = against(cfg, layout, aux, perturbed(cfg), job["case"])
            report[f"{shape}/{lay}/{name}"] = res
        pickle.dump(report, open(f"{out_dir}/rank{rank}.pkl", "wb"))
        dist.destroy_process_group()


    if __name__ == "__main__":
        init, job_path, out_dir = sys.argv[1:]
        mp.spawn(worker, args=(init, job_path, out_dir), nprocs=4, join=True)
    """
)

CASES = [(a, shape, lay) for a in ARCHS for shape, lay in MESHES] + [(a, "1x4", "tp") for a in WIDE]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_ssm_ranks")
    (tmp / "ranks.py").write_text(_RANKS)
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump({"cases": CASES, "case": CASE}, f)
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


@pytest.mark.parametrize("case", CASES, ids=lambda c: "/".join(c))
def test_four_ranks_steps_within_smoke_bounds(four_ranks, case):
    """Prefill and 3 decode steps on every rank within SMOKE_BOUNDS of the
    single process (on ``lm_init`` and on parameters with random constant
    leaves), greedy sampling its tokens, the bytes handed to gloo equal to
    the count on meta, the rank's parameters its specs' numel, the
    row-parallel partials rounded once."""
    name, shape, lay = case
    key = f"{shape}/{lay}/{name}"
    M = int(shape.split("x")[1])
    for rank, rep in enumerate(four_ranks):
        res = rep[key]
        pert = res["perturbed"]
        print(f"{key} rank {rank}: prefill {res['prefill']:.4g}, decode {max(res['decode']):.4g}, caches "
              f"{res['caches']:.4g}; perturbed {pert}; not rounded once {res['rounded_once']}; bytes {res['moved']}; "
              f"heads {res['ssm_heads']}")
        SC.hold(f"{key} rank {rank}", res, SC.SMOKE_BOUNDS)
        worst = {"prefill": pert["prefill"], "decode": max(pert["decode"]), "caches": pert["caches"]}
        assert all(worst[k] <= SC.SMOKE_BOUNDS[k] for k in worst), (key, rank, worst)
        assert res["moved"] == res["counted"] and sum(res["moved"]["decode"].values()) > 0
        hs = res["ssm_heads"]
        whole = "@" in name
        assert hs == ({"h0": 0, "n": 2, "whole": True} if whole else
                      {"h0": rank % M * hs["n"], "n": (4 if name.startswith("rwkv") else 8) // M, "whole": False})
    moved = four_ranks[0][key]["moved"]["prefill"]
    assert "all-reduce" in moved and (lay != "serve" or "all-gather" in moved)


def test_four_ranks_gather_what_the_split_cuts(four_ranks):
    """What a rank gathers over "model" besides the weights: rwkv6's tanh of
    the decay lora (16 lora columns, 4 a rank at M = 4) and the channel
    mix's gate, zamba2's in_proj product; counted in the step's bytes."""
    B, S = CASE["batch"], CASE["prompt"]
    r = configs.get_smoke("rwkv6-1.6b")
    z = configs.get_smoke("zamba2-1.2b")
    cols = 2 * 2 * z.d_model + 2 * z.mamba.state_dim + 2 * z.d_model // z.mamba.head_dim  # 552
    for name, per_layer in (("rwkv6-1.6b", B * S * (r.rwkv.decay_lora * 4 + r.d_model * 2)),
                            ("zamba2-1.2b", B * S * cols * 2)):
        cfg = configs.get_smoke(name)
        moved = four_ranks[1][f"1x4/tp/{name}"]["moved"]["prefill"]
        layers = sum(k == ("rwkv" if name.startswith("rwkv") else "mamba") for k in cfg.block_pattern)
        assert moved["all-gather"] >= layers * per_layer, (name, moved)


# ---------------------------------------------------------------------------
# single process: the rules
# ---------------------------------------------------------------------------


def test_recurrent_heads_rule():
    """H / M heads where the rank's "model" block of w_r's columns (rwkv6)
    or of out_proj's rows (Mamba2) is a whole number of heads; all of them,
    gathered, where it cuts one; all where the split is off. At full width
    both models split cleanly at M = 4 and M = 16 (rwkv6: 32 heads of 64;
    zamba2: 64 Mamba2 heads of 64, and 32 attention heads)."""
    prod = make_production_mesh()
    rw, zb = configs.get("rwkv6-1.6b"), configs.get("zamba2-1.2b")
    for rank in (0, 5, 16 * 3 + 15):
        m = rank % 16
        assert SS.recurrent_heads(rw, SS.ServeLayout(prod, rank)) == SSM.Heads(2 * m, 2)
        assert SS.recurrent_heads(zb, SS.ServeLayout(prod, rank)) == SSM.Heads(4 * m, 4)
        assert SS.attention_heads(zb, SS.ServeLayout(prod, rank)).nq == 2
    for M in (4, 16):
        lay = SS.ServeLayout(Mesh(("data", "model"), (1, M)), M - 1, "tp")
        assert SS.recurrent_heads(rw, lay) == SSM.Heads(32 - 32 // M, 32 // M)
        assert SS.recurrent_heads(zb, lay) == SSM.Heads(64 - 64 // M, 64 // M)
    assert SS.recurrent_heads(configs.get("gemma3-1b"), SS.ServeLayout(prod, 3)) is None
    rs = configs.get_smoke("rwkv6-1.6b")  # 4 heads of 32 over D = 128
    for M, want in ((2, SSM.Heads(2, 2)), (4, SSM.Heads(3, 1)), (8, SSM.Heads(0, 4, True)), (3, SSM.Heads(0, 4))):
        lay = SS.ServeLayout(Mesh(("data", "model"), (1, M)), M - 1, "tp")
        assert SS.recurrent_heads(rs, lay) == want, M
    assert SS.recurrent_heads(config("zamba2-1.2b@128"), SS.ServeLayout(Mesh(("data", "model"), (1, 4)), 1)) == \
        SSM.Heads(0, 2, True)


def test_mamba_in_proj_cut_across_segments():
    """zamba2's smoke in_proj has 552 columns [z 256 | x 256 | B 16 | C 16 |
    dt 8], 138 a rank at M = 4: the blocks cut through z, x and B. Every
    rank's heads read their z, x and dt columns and all of B and C out of
    the gathered product, and the conv's channels of them out of conv_w
    (288 columns, 72 a rank: read whole)."""
    cfg = configs.get_smoke("zamba2-1.2b")
    mesh = Mesh(("data", "model"), (1, 4))
    sp = SS.shard_params(lm.lm_init(cfg, device="cpu", seed=1), SS.ServeLayout(mesh, 0, "tp"))
    node = sp.tree["stack"]["segments"][0]["mamba"]
    assert tuple(node["in_proj"].shape) == (128, 138) and tuple(node["conv_w"].shape) == (4, 72)
    assert [SS.ServeLayout(mesh, r, "tp").coords[1] * 138 for r in range(4)] == [0, 138, 276, 414]  # 256, 512, 528
    cols = torch.arange(552)
    for r in range(4):
        hs = SS.recurrent_heads(cfg, SS.ServeLayout(mesh, r, "tp"))
        assert hs == SSM.Heads(2 * r, 2)
        want_z = cols[64 * r:64 * r + 64]
        want_x = cols[256 + 64 * r:256 + 64 * r + 64]
        want_bc = cols[512:544]
        want_dt = cols[544 + 2 * r:544 + 2 * r + 2]
        assert torch.equal(SSM._head_cols(cols[:256], hs, 32, 8), want_z)
        assert torch.equal(SSM._conv_channels(cols[256:544], cfg, hs), torch.cat([want_x, want_bc]))
        assert torch.equal(SSM._head_cols(cols[544:], hs, 1, 8), want_dt)
        assert torch.equal(SSM._conv_channels(torch.arange(288), cfg, hs),
                           torch.cat([torch.arange(64 * r, 64 * r + 64), torch.arange(256, 288)]))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_rules_per_leaf(arch):
    """Each leaf's batch dim from its name: rwkv6's state [B, H, k, v] and
    token shifts [B, D]; zamba2's ssm [B, H, N, hd], conv [B, W-1, C] and its
    shared attention's k / v [B, L, KV, hd] in one tree. Over "data" the
    batch; over "model" the rank's recurrent heads and kv heads, the rest
    whole. A rank holds the bytes ``cache_specs`` places on a device where
    "model" is one rank, fewer where it holds some of the heads (the
    reference's specs keep the states whole over "model")."""
    cfg = configs.get_smoke(arch)
    caches = lm.cache_init(cfg, 2, 40, device="cpu")
    for shape, lay_name in (("2x2", "serve"), ("1x4", "tp"), ("2x2", "tp_attn_rep"), ("2x1", "serve")):
        D, M = (int(v) for v in shape.split("x"))
        for r in range(D * M):
            lay = SS.ServeLayout(Mesh(("data", "model"), (D, M)), r, lay_name)
            specs, kinds = SS.cache_split(caches, lay)
            assert set(leaves(kinds)) == ({"batch"} if D > 1 else {None})
            mine = SS.shard_caches(caches, cfg, lay)
            rs, hs = SS.recurrent_heads(cfg, lay), SS.attention_heads(cfg, lay)
            held = sum(t.numel() * t.element_size() for t in leaves(mine))
            assert (SS.cache_bytes(lay, caches) == held) if M == 1 else (SS.cache_bytes(lay, caches) > held)
            for (path, t), (_, spec), g in zip(leaves_with_path(caches), sh.spec_leaves(specs), leaves(mine)):
                b = SS._batch_dim(path, t)
                assert [i for i, e in enumerate(spec) if e is not None] == [b]
                want = list(t.shape)
                want[b] //= D
                if path[-1] in ("state", "ssm"):
                    want[-3] = rs.n
                elif path[-1] in ("k", "v"):
                    want[-2] = hs.nkv
                assert list(g.shape) == want, (path, g.shape, want)
    # rows of every leaf, each on its own batch dim
    rows = SS.cache_rows(caches, 1, 1)
    assert all(t.shape[SS._batch_dim(p, t)] == 1 for p, t in leaves_with_path(rows))


@pytest.mark.parametrize("arch", ARCHS)
def test_long_500k_cache_split_refused(arch):
    """At long_500k (B = 1) cache_specs splits the recurrent states' v / hd,
    the token shifts' D and the conv window's C over the data axes (other)
    and zamba2's shared-attention rings on their slots (seq): the port runs
    it, so the dry-run counts that record per rank, with the gathers of the
    other leaves in its collective term; a batch of one on a data axis of
    one rank is no split."""
    cfg = configs.get(arch)
    from repro_torch.launch import specs as SP

    window = SP.long_ctx_window(cfg)
    caches = lm.cache_init(cfg, 1, 524288, window_override=window, device="meta")
    split = SS.cache_split(caches, SS.ServeLayout(make_production_mesh(), 0))
    # the dim over the data axes from the leaf's end: v, D, hd, C; a ring's slots
    want = {"state": (-1, "other"), "x_last": (-1, "other"), "cm_x_last": (-1, "other"), "ssm": (-1, "other"),
            "conv": (-1, "other"), "k": (-3, "seq"), "v": (-3, "seq")}
    for (path, t), (_, spec), kind in zip(leaves_with_path(caches), sh.spec_leaves(split.specs), leaves(split.kinds)):
        dim = [i - t.dim() for i, e in enumerate(spec) if e is not None]
        assert (dim, kind) == ([want[path[-1]][0]], want[path[-1]][1]), (path, spec, kind)
    assert split.found == ({"other"} if arch == "rwkv6-1.6b" else {"other", "seq"})
    assert SP.serving_refusal(cfg, make_production_mesh(), 1, 524288, window, "decode") is None
    small = configs.get_smoke(arch)
    assert "other" in SS.cache_layout(small, SS.ServeLayout(Mesh(("data", "model"), (4, 1)), 0), 1, 64).found
    assert SS.cache_layout(small, SS.ServeLayout(Mesh(("data", "model"), (1, 4)), 0, "tp"), 1, 64).found == set()
    for shape in ("prefill_32k", "decode_32k"):
        info = SP.SHAPES[shape]
        assert SP.serving_refusal(cfg, make_production_mesh(), info["global_batch"], info["seq"], None,
                                  info["kind"]) is None


@pytest.mark.parametrize("shape,layout_name", [("2x2", "serve"), ("1x4", "tp"), ("2x2", "tp_attn_rep")])
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


@pytest.mark.parametrize("layout_name", ["serve", "tp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_parameters_are_local_numel_of_the_specs(arch, layout_name):
    """Full width on ``meta``: ranks of the 16x16 mesh hold
    ``sharding.local_numel`` of each leaf under its spec."""
    cfg = configs.get(arch)
    params = lm.lm_init(cfg, device="meta")
    for rank in (0, 255):
        layout = SS.ServeLayout(make_production_mesh(), rank, layout_name)
        sp = SS.shard_params(params, layout)
        specs = sh.spec_leaves(layout.param_specs(params.spec))
        for leaf, view, (_, spec) in zip(leaves(params.spec), leaves(sp.tree), specs):
            assert view.numel() == sh.local_numel(leaf.shape, spec, layout.mesh), spec
        assert sp.flat.numel() == SS.param_numel(layout, params.spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_still_refuses_ssm_and_hybrid(arch):
    """Serving admits both families, and so does the train step's tensor
    parallelism (tests/test_torch_train_tp_families.py), also where a
    product's weight does not split over "model" (at M = 32: rwkv6's 16
    lora columns, zamba2's in_proj, read whole and entered into "model"):
    nothing of either is refused."""
    cfg = configs.get_smoke(arch)
    SS.check_ported(cfg)
    assert not SS.NOT_PORTED
    d = sum(leaf_sizes(lm.lm_spec(cfg)))
    mesh = Mesh(("data", "model"), (2, 2))
    SH.check_tensor_parallel(cfg, SH.Layout(mesh, 0, 2, d, SH.model_blocks(cfg, mesh, 0)))
    wide = Mesh(("data", "model"), (1, 32))
    blocks = SH.model_blocks(cfg, wide, 0)
    SH.check_tensor_parallel(cfg, SH.Layout(wide, 0, 1, d, blocks))
    whole = {p[-1] for (p, _), b in zip(leaves_with_path(lm.lm_spec(cfg)), blocks) if b.whole}
    assert whole & {"w_lora_a", "in_proj"}


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_gather_over_data_under_serve(arch):
    """Under ``serve`` at full width every leaf the recurrent blocks read
    raw in the single process (``dt_bias``, ``A_log``, ``w0``, ``w_lora_b``,
    ``u``, the norms' scales) is split over "data" on some rank and gathered
    back before its use: the decode step's count on meta gathers every
    parameter block the rank holds over "data"."""
    cfg = configs.get(arch)
    mesh = make_production_mesh()
    layout = SS.ServeLayout(mesh, 0, "serve")
    specs = layout.param_specs(lm.lm_spec(cfg))
    names = {"rwkv6-1.6b": ("w0", "w_lora_b", "u", "scale"), "zamba2-1.2b": ("dt_bias", "A_log", "D", "scale")}[arch]
    assert set(names) <= {p[-1] for p, s in sh.spec_leaves(specs) if "data" in s}
    comm = CountingComm()
    step = SS.make_decode_step(cfg, layout, comm, 128, 256)
    caches = SS.shard_caches(lm.cache_init(cfg, 128, 256, device="meta"), cfg, layout)
    with torch.no_grad():
        step(SS.shard_params(lm.lm_init(cfg, device="meta"), layout), caches,
             torch.empty((128, 1), dtype=torch.int32, device="meta"), torch.empty((), dtype=torch.int64, device="meta"))
    assert comm.bytes["all-gather"] > 0 and comm.bytes["all-reduce"] > 0
