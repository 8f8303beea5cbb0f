"""The serving step across a process group (``repro_torch.serve.sharded``)
against the single-process port (``lm.forward`` / ``lm.decode_step``) and
against the reference's own sharded prefill and decode.

* One rank (a gloo group of one, mesh (1, 1)): the sharded prefill and
  decode equal ``lm.forward`` / ``lm.decode_step`` bit for bit (logits and
  caches) for the five dense / vlm / audio smoke families and the two moe
  smoke configs under each serve layout, and ``gather_params(shard_params(p))``
  is ``p`` (the moe configs' 4-rank cases: tests/test_torch_serve_moe.py).
* Four gloo ranks (a subprocess, ``torch.multiprocessing.spawn``), one
  spawn for all cases: (2, 2) ``serve`` (ZeRO-3 gathers over "data", tensor
  parallelism over "model"), (1, 4) ``tp``, (2, 2) ``tp_attn_rep``, and
  (4, 1) ``serve`` at B = 1 with the caches' sequence split over "data"
  (windowed rings that wrap, and whole-length caches). Each case is a
  prefill and 4 teacher-forced decode steps held against the single
  process within ``serve/sharded_check.SMOKE_BOUNDS`` (2**-6 of the largest
  value; the largest distance measured: 0.0089), the bytes handed to gloo
  equal to the dry-run's
  count of the same step on ``meta``, greedy sampling over the vocabulary
  blocks equal to the argmax of the gathered logits, the shard / gather
  round trip bit for bit, and the rank's parameters equal in number to
  ``sharding.local_numel`` over its specs.
* The reference: its ``lm.forward`` (``act_spec = P("data", None, None)``
  under the mesh) and ``lm.decode_step`` jitted on a (2, 2) ("data",
  "model") mesh of 4 forced host devices with ``in_shardings`` from its
  ``param_specs(..., "serve")``, ``cache_specs`` and ``serve_batch_spec``
  (a subprocess, as tests/test_distributed.py runs its SPMD rounds; XLA's
  excess precision off, so a jitted bf16 chain rounds after every op as
  the port does), and the same programs jitted on one device, against the
  port's 4 gloo ranks on the same parameters, tokens and caches. The port
  is within the 0.024 of tests/test_torch_lm.py of the reference's
  one-device program. The reference's partitioned program is not: XLA
  rounds each row-parallel partial product to bf16 before it sums them
  (with that rounding, the port's prefill blocks equal XLA's bit for bit in
  most ranks), so it differs from its own one-device program by up to 0.047
  (prefill) and 0.057 (decode) on pixtral's smoke logits (|logit| <= 4.25).
  So the port is held to the reference's one-device program, and the
  partitioned program serves to tell the two arithmetics apart: at every
  step the port is nearer the one-device program (measured at most 0.0039
  from it) than the partitioned program is (at least 0.0105), which a port
  that rounds its partials as XLA does would not be. The moe smoke configs
  (and deepseek-v2's at capacity_factor 1.0, where copies drop): the port
  within 0.0157 of the one-device program; the partitioned program up to
  0.65 (deepseek-v2) and 2.04 (llama4) from it on a data rank's prefill,
  where its bf16 partials flip a route.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import sharding as sh
from repro_torch.launch.comm import CountingComm
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.params import leaf_sizes, leaves, leaves_with_path, path_key
from repro_torch.serve import sharded as SS
from repro_torch.serve import sharded_check as SC
from repro_torch.train import sharded as SH

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PORTED = ["gemma3-1b", "minitron-4b", "starcoder2-7b", "pixtral-12b", "musicgen-large"]
MOE = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]  # 4-rank cases: tests/test_torch_serve_moe.py
RECURRENT = ["rwkv6-1.6b", "zamba2-1.2b"]  # their 4-rank cases: tests/test_torch_serve_ssm.py
REF_ATOL = 0.024  # tests/test_torch_lm.py: the port against the reference, forward logits


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


def _bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.uint8),
                                                                    b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("layout_name", ["serve", "tp", "tp_attn_rep"])
@pytest.mark.parametrize("arch", PORTED + MOE)
def test_one_rank_equals_forward_and_decode_bit_for_bit(one_rank, arch, layout_name):
    cfg = configs.get_smoke(arch)
    layout, comm = SS.connect(one_rank, layout_name)
    params = lm.lm_init(cfg, device="cpu", seed=3)
    x = SC.inputs(cfg, batch=2, prompt=24, cache_len=40, steps=3, seed=4)
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
    assert _bits(SS.gather_params(sp, layout, comm).flat, params.flat)


@pytest.mark.parametrize("arch", RECURRENT)
def test_refuses_the_families_not_ported(arch):
    """rwkv6 (ssm) and zamba2 (hybrid): their serving steps across ranks are
    ported, and so is their train step's tensor parallelism, also where a
    product's weight does not split over "model" (at M = 32: rwkv6's 16
    lora columns, zamba2's in_proj), and a batch of one over 4 data ranks,
    where cache_specs splits their recurrent states' inner dims: nothing of
    either is refused."""
    cfg = configs.get_smoke(arch)
    layout = SS.ServeLayout(Mesh(("data", "model"), (2, 2)), 0)
    SS.check_ported(cfg)
    SS.make_prefill_step(cfg, layout, CountingComm())
    SS.make_decode_step(cfg, layout, CountingComm(), 2, 16)
    d = sum(leaf_sizes(lm.lm_spec(cfg)))
    SH.check_tensor_parallel(cfg, SH.Layout(layout.mesh, 0, 2, d, SH.model_blocks(cfg, layout.mesh, 0)))
    wide = Mesh(("data", "model"), (1, 32))
    blocks = SH.model_blocks(cfg, wide, 0)
    SH.check_tensor_parallel(cfg, SH.Layout(wide, 0, 1, d, blocks))
    whole = {path_key(p) for (p, _), b in zip(leaves_with_path(lm.lm_spec(cfg)), blocks) if b.whole}
    assert {"stack/segments/0/rwkv/w_lora_a", "stack/segments/0/mamba/in_proj"} & whole
    split = SS.cache_layout(cfg, SS.ServeLayout(Mesh(("data", "model"), (4, 1)), 0), 1, 16)
    assert "other" in split.found
    SS.make_decode_step(cfg, SS.ServeLayout(Mesh(("data", "model"), (4, 1)), 0), CountingComm(), 1, 16)


@pytest.mark.parametrize("layout_name", ["serve", "tp", "tp_attn_rep"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "starcoder2-7b", "musicgen-large"] + MOE)
def test_rank_parameters_are_local_numel_of_the_specs(arch, layout_name):
    """Full width on ``meta``: every rank of the 16x16 mesh we look at holds
    ``sharding.local_numel`` of each leaf under its spec, and no more."""
    cfg = configs.get(arch)
    params = lm.lm_init(cfg, device="meta")
    for rank in (0, 17, 255):
        layout = SS.ServeLayout(make_production_mesh(), rank, layout_name)
        sp = SS.shard_params(params, layout)
        specs = sh.spec_leaves(layout.param_specs(params.spec))
        for leaf, view, (_, spec) in zip(leaves(params.spec), leaves(sp.tree), specs):
            assert view.numel() == sh.local_numel(leaf.shape, spec, layout.mesh), spec
        assert sp.flat.numel() == SS.param_numel(layout, params.spec)
        assert SS.param_bytes(layout, params.spec)["port"] == 6 * sp.flat.numel()


def test_heads_and_cache_splits():
    """Which heads a rank computes, and which cache dim the reference's
    cache_specs split: gemma3-1b cuts its one kv head at M = 16 (and its 4
    q heads), minitron-4b splits 24 q / 8 kv heads; long_500k's B = 1 puts
    the sequence over "data"; where it splits another dim (the smoke ring's
    head dim at B = 1; gemma3-1b's 4 scan repetitions at B = 4, taken for the
    batch) that leaf is ``other``, beside the batch or sequence splits of the
    rest."""
    mesh = make_production_mesh()
    g, m = configs.get("gemma3-1b"), configs.get("minitron-4b")
    assert SS.attention_heads(g, SS.ServeLayout(mesh, 3)) == L.Heads(0, 4, 0, 1, True, True)
    assert SS.attention_heads(m, SS.ServeLayout(mesh, 3)) == L.Heads(0, 24, 0, 8, True, True)
    small = Mesh(("data", "model"), (2, 8))
    assert SS.attention_heads(m, SS.ServeLayout(small, 3)) == L.Heads(9, 3, 3, 1, False, False)
    assert SS.attention_heads(m, SS.ServeLayout(small, 3, "tp_attn_rep")) == L.Heads(0, 24, 0, 8)
    lay = SS.ServeLayout(mesh, 0)
    assert SS.cache_layout(g, lay, 128, 32768).found == {"batch"}
    assert SS.cache_layout(g, lay, 1, 524288).found == {"seq"}
    # the smoke window of 16 slots is shorter than a head of 32: its head dim splits; the global ring's slots
    smoke = SS.cache_layout(configs.get_smoke("gemma3-1b"), SS.ServeLayout(Mesh(("data", "model"), (4, 1)), 0), 1,
                            64)
    assert [k for k in leaves(smoke.kinds)] == ["other", "other", "seq", "seq"]
    assert [tuple(s) for _, s in sh.spec_leaves(smoke.specs)][:2] == [(None, None, None, "data")] * 2
    # gemma3-1b's scan segment has 4 repetitions: at B = 4 cache_specs splits them over "data" (other) and the
    # unrolled local layers' rows (batch), which is no split on a data axis of one rank
    reps = SS.cache_layout(g, SS.ServeLayout(Mesh(("data", "model"), (2, 2)), 0), 4, 520)
    assert reps.found == {"batch", "other"}
    assert {tuple(s)[:2] for k, (_, s) in zip(leaves(reps.kinds), sh.spec_leaves(reps.specs)) if k == "other"} == \
        {("data", None)}
    assert SS.cache_layout(g, SS.ServeLayout(Mesh(("data", "model"), (1, 4)), 0), 4, 520).found == set()
    assert SS.cache_layout(g, SS.ServeLayout(Mesh(("data", "model"), (2, 2)), 0), 2, 520).found == {"batch"}


@pytest.mark.parametrize("q0,nq", [(0, 6), (2, 2), (3, 3), (1, 1), (4, 2)])
def test_kv_for_picks_the_global_groups(q0, nq):
    """A rank's q heads attend with kv head h // G of the whole model,
    whatever slice of the heads it holds (whole groups, one group, or
    groups cut: one kv head a q head)."""
    cfg = configs.get_smoke("starcoder2-7b")  # 6 q heads, 2 kv heads: G = 3
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 6, cfg.head_dim, generator=g).bfloat16()
    k, v = (torch.randn(2, 5, 2, cfg.head_dim, generator=g).bfloat16() for _ in range(2))
    want = L.chunked_attention(q, k, v, chunk=4)[:, :, q0:q0 + nq]
    hs = L.Heads(q0, nq, 0, 2)
    got = L.chunked_attention(q[:, :, q0:q0 + nq].contiguous(), *L._kv_for(cfg, hs, k, v), chunk=4)
    assert torch.allclose(got.float(), want.float(), atol=1e-2)


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

# (mesh, serve layout, arch, run_case keywords)
_SMALL = dict(batch=2, prompt=24, cache_len=40, steps=4, start=30)
CASES = ([("2x2", "serve", a, _SMALL) for a in PORTED]
         + [("1x4", "tp", a, _SMALL) for a in PORTED]
         + [("2x2", "tp_attn_rep", a, _SMALL) for a in ("gemma3-1b", "starcoder2-7b", "musicgen-large")]
         + [("4x1", "serve", "starcoder2-7b", dict(batch=1, prompt=24, cache_len=64, steps=4, start=40,
                                                   window_override=32)),
            ("4x1", "serve", "minitron-4b", dict(batch=1, prompt=24, cache_len=64, steps=4, start=40))])

_RANKS = textwrap.dedent(
    """
    import pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    WORLD = 4


    def worker(rank, init, cases_path, out_dir):
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.launch.comm import Comm
        from repro_torch.launch.mesh import Mesh
        from repro_torch.models import lm
        from repro_torch.serve import sharded as SS, sharded_check as SC

        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
        job = pickle.load(open(cases_path, "rb"))
        report = {}
        for shape, name, arch, kw in job["cases"]:
            cfg = configs.get_smoke(arch)
            layout, comm = SS.connect(Mesh(("data", "model"), tuple(int(x) for x in shape.split("x"))), name)
            aux = Comm(comm.groups)  # the checks' collectives, apart from the step's tally
            res = SC.run_case(cfg, layout, comm, aux, chunk=8, **kw)
            params = lm.lm_init(cfg, device="cpu", seed=5)
            back = SS.gather_params(SS.shard_params(params, layout), layout, aux)
            res["round_trip"] = bool(torch.equal(back.flat.view(torch.int32), params.flat.view(torch.int32)))
            report[f"{shape}/{name}/{arch}"] = res
        if job.get("reference") is not None:
            report["reference"] = reference(job["reference"])
        pickle.dump(report, open(f"{out_dir}/rank{rank}.pkl", "wb"))
        dist.destroy_process_group()


    def reference(ref):
        # the reference's parameters, tokens and caches through the port's 4 ranks
        from repro_torch import configs, convert
        from repro_torch.launch.mesh import Mesh
        from repro_torch.serve import sharded as SS, sharded_check as SC

        from repro_torch.models import lm

        out = {}
        for arch, r in ref.items():
            name, _, cf = arch.partition("@")
            cfg = configs.get_smoke(name) if not cf else SC.with_capacity(configs.get_smoke(name), float(cf))
            layout, comm = SS.connect(Mesh(("data", "model"), (2, 2)), "serve")
            params = convert.lm_params_from_numpy(cfg, r["params"], "cpu")
            sp = SS.shard_params(params, layout)
            batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
            dist = lambda got, want: float((got.float() - SC._block(torch.from_numpy(want), got, layout)).abs().max())
            got = SS.make_prefill_step(cfg, layout, comm, chunk=8)(sp, batch)
            res = {k: [dist(got, r[k + "prefill"])] for k in ("", "one_")}
            with torch.no_grad():  # the single-process port on the same inputs
                res["single"] = [dist(lm.forward(cfg, params, batch, chunk=8, remat=False), r["one_prefill"])]
            caches = SS.shard_caches(convert.lm_caches_from_numpy(r["caches"], "cpu"), cfg, layout)
            whole = convert.lm_caches_from_numpy(r["caches"], "cpu")
            decode = SS.make_decode_step(cfg, layout, comm, r["B"], r["L"])
            for i, tok in enumerate(r["tokens"]):
                got, caches = decode(sp, caches, torch.from_numpy(tok), torch.tensor(r["start"] + i))
                for k in ("", "one_"):
                    res[k].append(dist(got, r[k + "decode"][i]))
                with torch.no_grad():
                    one, whole = lm.decode_step(cfg, params, whole, torch.from_numpy(tok), r["start"] + i)
                res["single"].append(dist(one, r["one_decode"][i]))
            out[arch] = {"sharded": res[""], "one": res["one_"], "single": res["single"]}
        return out


    if __name__ == "__main__":
        init, cases_path, out_dir = sys.argv[1:]
        mp.spawn(worker, args=(init, cases_path, out_dir), nprocs=WORLD, join=True)
    """
)


def _run_ranks(tmp_path, cases, reference=None) -> list:
    """Every rank's report of ``cases`` (and the reference's inputs) on 4 gloo ranks."""
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    cases_path = tmp_path / "cases.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump({"cases": cases, "reference": reference}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, str(script), f"file://{tmp_path / 'rdv'}", str(cases_path),
                          str(tmp_path)], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    out = []
    for r in range(4):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("serve_ranks"), CASES)


def _hold(reports, prefix):
    names = [k for k in reports[0] if k.startswith(prefix)]
    assert names
    for name in names:
        for rank, rep in enumerate(reports):
            res = rep[name]
            print(f"{name} rank {rank}: prefill {res['prefill']:.4g}, decode {max(res['decode']):.4g}, caches "
                  f"{res['caches']:.4g}; not rounded once {res['rounded_once']}; bytes {res['moved']}; heads "
                  f"{res['heads']}")
            SC.hold(f"{name} rank {rank}", res, SC.SMOKE_BOUNDS)
            assert res["round_trip"], (name, rank)
    return names


def test_four_ranks_serve_2x2(four_ranks):
    """ZeRO-3 gathers over "data" and tensor parallelism over "model"."""
    names = _hold(four_ranks, "2x2/serve/")
    for name in names:  # every rank gathers weights over "data" and sums partials over "model"
        assert {"all-gather", "all-reduce"} <= set(four_ranks[0][name]["moved"]["prefill"]), name


def test_four_ranks_tp_1x4(four_ranks):
    """Tensor parallelism over 4 "model" ranks; no gathers but cut heads'."""
    _hold(four_ranks, "1x4/tp/")
    # starcoder2's 6 heads cut at M = 4: wq / wk / wv gathered, heads computed whole
    res = four_ranks[1]["1x4/tp/starcoder2-7b"]
    assert res["heads"]["q_whole"] and res["heads"]["kv_whole"]
    assert four_ranks[0]["1x4/tp/musicgen-large"]["moved"]["prefill"].get("all-gather", 0) == 0


def test_four_ranks_tp_attn_rep_2x2(four_ranks):
    """Attention projections replicated: every rank computes all heads."""
    _hold(four_ranks, "2x2/tp_attn_rep/")
    assert four_ranks[2]["2x2/tp_attn_rep/gemma3-1b"]["heads"]["nq"] == 4


def test_four_ranks_sequence_split_cache_4x1(four_ranks):
    """B = 1 over 4 data ranks: each rank holds a quarter of every ring's
    slots (starcoder2 with a 32-slot window that wraps, minitron's 64-slot
    caches), the owner writes the new k/v, the softmax is combined."""
    _hold(four_ranks, "4x1/serve/")
    for name in ("4x1/serve/starcoder2-7b", "4x1/serve/minitron-4b"):
        res = four_ranks[3][name]
        assert res["cache_bytes"] * 4 == sum(r[name]["cache_bytes"] for r in four_ranks)
        assert res["cache_bytes"] == res["cache_bytes_specs"]


def test_counted_bytes_equal_the_bytes_handed_to_gloo(four_ranks):
    """Every case, every rank: the prefill's and a decode step's collective
    bytes by kind equal the dry-run's count of the same step on meta."""
    for rep in four_ranks:
        for name, res in rep.items():
            assert res["moved"] == res["counted"], name
            assert sum(res["moved"]["decode"].values()) > 0, name


# ---------------------------------------------------------------------------
# the reference's own sharded program
# ---------------------------------------------------------------------------

# "arch@f": the smoke config with the experts' capacity_factor f (copies drop)
REF_ARCHS = ("gemma3-1b", "pixtral-12b", "deepseek-v2-236b", "llama4-maverick-400b-a17b", "deepseek-v2-236b@1.0",
             "rwkv6-1.6b", "zamba2-1.2b")

_REFERENCE = textwrap.dedent(
    """
    import dataclasses, os, pickle, sys
    # XLA keeps a fused chain of bf16 ops in fp32 unless told not to; the port
    # (and the reference run op by op) rounds after every op
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 --xla_allow_excess_precision=false"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch import sharding as sh
    from repro.models import lm

    out_path = sys.argv[1]
    archs = sys.argv[2].split(",")
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t, is_leaf=lambda x: isinstance(x, P))
    B, L, START, STEPS = 2, 40, 30, 3
    out = {}
    for arch in archs:
        name, _, cf = arch.partition("@")
        cfg = configs.get_smoke(name)
        S = 32 if cfg.family in ("ssm", "hybrid") else 24  # rwkv's chunk and zamba2's smoke Mamba2 chunk: 32
        if cf:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cf)))
        params = jax.jit(lambda k: lm.lm_init(cfg, k))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(7)
        tok = (B, cfg.num_codebooks, S) if cfg.num_codebooks else (B, S)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, tok).astype(np.int32)}
        if cfg.num_patches:
            batch["patches"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
            batch["patches"] = np.asarray(jnp.asarray(batch["patches"], jnp.bfloat16).astype(jnp.float32))
        zeros = jax.eval_shape(lambda: lm.cache_init(cfg, B, L))
        caches = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype), zeros)
        one = (B, cfg.num_codebooks, 1) if cfg.num_codebooks else (B, 1)
        tokens = [rng.integers(0, cfg.vocab_size, one).astype(np.int32) for _ in range(STEPS)]
        p_sh = ns(sh.param_specs(params, mesh, "serve"))
        b_sh = ns(sh.serve_batch_spec(batch, mesh, B))
        c_sh = ns(sh.cache_specs(caches, mesh, B))
        t_sh = ns(sh.serve_batch_spec(tokens[0], mesh, B))
        prefill = jax.jit(lambda p, b: lm.forward(cfg, p, b, chunk=8, act_spec=P("data", None, None)),
                          in_shardings=(p_sh, b_sh))
        decode = jax.jit(lambda p, c, t, pos: lm.decode_step(cfg, p, c, t, pos),
                         in_shardings=(p_sh, c_sh, t_sh, NamedSharding(mesh, P())))
        with jax.set_mesh(mesh):
            pf = prefill(*jax.device_put((params, batch), (p_sh, b_sh)))
            c = jax.device_put(caches, c_sh)
            dec = []
            for i, t in enumerate(tokens):
                logits, c = decode(jax.device_put(params, p_sh), jax.device_put(c, c_sh), jax.device_put(t, t_sh),
                                   jnp.int32(START + i))
                dec.append(np.asarray(logits.astype(jnp.float32)))
        # the same program on one device
        one_pf = jax.jit(lambda p, b: lm.forward(cfg, p, b, chunk=8))(params, batch)
        one_decode = jax.jit(lambda p, c, t, pos: lm.decode_step(cfg, p, c, t, pos))  # one compile, all steps
        one_dec, c = [], caches
        for i, t in enumerate(tokens):
            logits, c = one_decode(params, c, t, jnp.int32(START + i))
            one_dec.append(np.asarray(logits.astype(jnp.float32)))
        out[arch] = {"params": jax.tree.map(np.asarray, params), "batch": batch,
                     "caches": jax.tree.map(np.asarray, caches), "tokens": tokens, "B": B, "L": L, "start": START,
                     "prefill": np.asarray(pf.astype(jnp.float32)), "decode": dec,
                     "one_prefill": np.asarray(one_pf.astype(jnp.float32)), "one_decode": one_dec}
    pickle.dump(out, open(out_path, "wb"))
    """
)


def test_four_ranks_against_the_reference_sharded_program(tmp_path):
    pytest.importorskip("jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    ref_path = tmp_path / "reference.pkl"
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(ref_path), ",".join(REF_ARCHS)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-6000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    reports = _run_ranks(tmp_path, [], reference=ref)
    for arch in REF_ARCHS:
        r = ref[arch]
        own = [float(np.abs(r["prefill"] - r["one_prefill"]).max())]  # the reference: sharded vs one device
        own += [float(np.abs(a - b).max()) for a, b in zip(r["decode"], r["one_decode"])]
        assert np.isfinite(r["prefill"]).all() and max(own) > 0
        for rank, rep in enumerate(reports):
            got = rep["reference"][arch]
            print(f"{arch} rank {rank}: port vs the reference's one-device program {got['one']}, vs its "
                  f"partitioned program {got['sharded']}; the reference's two programs differ by {own}; the "
                  f"single-process port vs the one-device program {got['single']}")
            if arch in RECURRENT:  # each step no farther than the single-process port is from the same program
                assert all(g <= max(REF_ATOL, s) for g, s in zip(got["one"], got["single"])), (arch, rank, got)
            else:
                assert max(got["one"]) <= REF_ATOL, (arch, rank, got)
            # fp32 partials: at every step nearer the one-device program than XLA's bf16 partials are
            assert all(g < o for g, o in zip(got["one"], own)), (arch, rank, got, own)
