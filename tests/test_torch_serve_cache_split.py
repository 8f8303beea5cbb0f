"""The serving step across a process group where the reference's
``cache_specs`` splits a cache off the batch (``serve/sharded.cache_split``'s
``other`` leaves: the recurrent states' v / hd, the token shifts' D, the conv
window's C, a ring's head dim, a scan segment's repetitions where their count
equals B), against the single-process port and the reference.

* Four gloo ranks (one subprocess, ``torch.multiprocessing.spawn``): the
  smoke rwkv6, zamba2 and gemma3-1b at B = 1 on (4, 1) and (2, 2) ``serve``
  (long_500k's split at smoke size: states, shifts and conv over "data",
  zamba2's and gemma3-1b's global rings on their slots, gemma3-1b's local
  ring of 16 slots on its head dim), and gemma3-1b with a scan segment of 4
  local layers (``gemma3-1b@reps``) at B = 4 on (2, 2) and (4, 1), where
  ``cache_specs`` takes the repetitions for the batch and the rows split over
  "data" too. A prefill of 32 tokens and 3 teacher-forced decode steps on
  every rank within ``serve/sharded_check.SMOKE_BOUNDS`` of the single
  process (``hold``: the bytes handed to gloo equal to the count of the same
  steps on ``meta``, greedy sampling its tokens), and rwkv6 on (4, 1) bit for
  bit: the gathered states and shifts are bit copies and a rank of M = 1
  with the whole batch runs the single process's arithmetic. Each rank's
  caches after the steps hold exactly its blocks: ``cache_bytes`` of the
  specs, less the kv and recurrent heads of the other "model" ranks.
* The reference: the same ranks on the reference's parameters, caches and
  tokens (rwkv6 on (4, 1), zamba2 on (2, 2), gemma3-1b@reps on (2, 2)),
  each decode step's logits against its jitted one-device ``lm.decode_step``
  on the CPU: within ``REF_ATOL``, or for the recurrent archs no farther
  than the single-process port is from the same program (zamba2's smoke
  port sits one bf16 ulp from it, tests/test_torch_serve_sharded.py).
* Single process: what one decode step gathers over "data" (the count on
  ``meta``) is the bytes of the ``other`` leaves (their rank's heads)
  beside the same step with nothing split off the batch.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import sharding as sh
from repro_torch.launch.comm import CountingComm
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models.params import leaves, leaves_with_path
from repro_torch.serve import sharded as SS
from repro_torch.serve import sharded_check as SC

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REF_ATOL = 0.024  # tests/test_torch_lm.py: the port against the reference, forward logits
# prompts of 32: rwkv's chunk and zamba2's smoke Mamba2 chunk
CASE = dict(prompt=32, cache_len=40, steps=3, start=30)
# (arch, mesh, batch)
CASES = [(a, shape, 1) for a in ("rwkv6-1.6b", "zamba2-1.2b", "gemma3-1b") for shape in ("4x1", "2x2")] + \
        [("gemma3-1b@reps", shape, 4) for shape in ("2x2", "4x1")]
# one case each against the reference's one-device program
REF_CASES = [("rwkv6-1.6b", "4x1", 1), ("zamba2-1.2b", "2x2", 1), ("gemma3-1b@reps", "2x2", 4)]
RECURRENT = ("rwkv6-1.6b", "zamba2-1.2b")


def config(name: str):
    """The smoke config of ``arch``, or ``gemma3-1b@reps``: its smoke config
    with 4 local layers (one scan segment of 4 repetitions), then a global one."""
    arch, _, which = name.partition("@")
    cfg = configs.get_smoke(arch)
    return dataclasses.replace(cfg, num_layers=5, block_pattern=("attn_local",) * 4 + ("attn",)) if which else cfg


_RANKS = textwrap.dedent(
    """
    import dataclasses, pickle, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def config(name):
        from repro_torch import configs
        arch, _, which = name.partition("@")
        cfg = configs.get_smoke(arch)
        return dataclasses.replace(cfg, num_layers=5, block_pattern=("attn_local",) * 4 + ("attn",)) if which else cfg


    def reference(layout, comm, cfg, r):
        # the reference's parameters, caches and tokens through the rank's decode steps: the distance of each
        # step's logits from the reference's one-device program, and the single-process port's
        from repro_torch import convert
        from repro_torch.models import lm
        from repro_torch.serve import sharded as SS, sharded_check as SC

        params = convert.lm_params_from_numpy(cfg, r["params"], "cpu")
        sp = SS.shard_params(params, layout)
        whole = convert.lm_caches_from_numpy(r["caches"], "cpu")
        caches = SS.shard_caches(whole, cfg, layout)
        decode = SS.make_decode_step(cfg, layout, comm, r["B"], r["L"])
        dist = lambda got, want: float((got.float() - SC._block(torch.from_numpy(want), got, layout)).abs().max())
        res = {"one": [], "single": []}
        for i, tok in enumerate(r["tokens"]):
            got, caches = decode(sp, caches, torch.from_numpy(tok), torch.tensor(r["start"] + i))
            res["one"].append(dist(got, r["one_decode"][i]))
            with torch.no_grad():
                one, whole = lm.decode_step(cfg, params, whole, torch.from_numpy(tok), r["start"] + i)
            res["single"].append(dist(one, r["one_decode"][i]))
        return res


    def worker(rank, init, job_path, out_dir):
        torch.set_num_threads(1)
        from repro_torch.launch.comm import Comm
        from repro_torch.launch.mesh import Mesh
        from repro_torch.serve import sharded as SS, sharded_check as SC

        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
        job = pickle.load(open(job_path, "rb"))
        report = {}
        for name, shape, batch in job["cases"]:
            cfg = config(name)
            layout, comm = SS.connect(Mesh(("data", "model"), tuple(int(x) for x in shape.split("x"))), "serve")
            aux = Comm(comm.groups)  # the checks' collectives, apart from the step's tally
            report[(name, shape, batch)] = SC.run_case(cfg, layout, comm, aux, chunk=8, batch=batch, **job["case"])
        for (name, shape, batch), r in job["reference"].items():
            layout, comm = SS.connect(Mesh(("data", "model"), tuple(int(x) for x in shape.split("x"))), "serve")
            report[("reference", name)] = reference(layout, comm, config(name), r)
        pickle.dump(report, open(f"{out_dir}/rank{rank}.pkl", "wb"))
        dist.destroy_process_group()


    if __name__ == "__main__":
        init, job_path, out_dir = sys.argv[1:]
        mp.spawn(worker, args=(init, job_path, out_dir), nprocs=4, join=True)
    """
)

_REFERENCE = textwrap.dedent(
    """
    import dataclasses, os, pickle, sys
    # XLA keeps a fused chain of bf16 ops in fp32 unless told not to; the port rounds after every op
    os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro import configs
    from repro.models import lm

    out_path, cases = sys.argv[1], [c.split(":") for c in sys.argv[2].split(",")]
    L, START, STEPS = 40, 30, 3
    out = {}
    for name, shape, B in cases:
        B = int(B)
        arch, _, which = name.partition("@")
        cfg = configs.get_smoke(arch)
        if which:
            cfg = dataclasses.replace(cfg, num_layers=5, block_pattern=("attn_local",) * 4 + ("attn",))
        params = jax.jit(lambda k: lm.lm_init(cfg, k))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(7)
        zeros = jax.eval_shape(lambda: lm.cache_init(cfg, B, L))
        caches = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype), zeros)
        tokens = [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32) for _ in range(STEPS)]
        decode = jax.jit(lambda p, c, t, pos: lm.decode_step(cfg, p, c, t, pos))  # one compile, all steps
        dec, c = [], caches
        for i, t in enumerate(tokens):
            logits, c = decode(params, c, t, jnp.int32(START + i))
            dec.append(np.asarray(logits.astype(jnp.float32)))
        out[(name, shape, B)] = {"params": jax.tree.map(np.asarray, params), "caches": jax.tree.map(np.asarray, caches),
                                 "tokens": tokens, "B": B, "L": L, "start": START, "one_decode": dec}
    pickle.dump(out, open(out_path, "wb"))
    """
)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    jax = pytest.importorskip("jax")
    del jax
    tmp = tmp_path_factory.mktemp("serve_cache_split")
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "reference.pkl"),
                          ",".join(f"{a}:{s}:{b}" for a, s, b in REF_CASES)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-6000:]
    with open(tmp / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    (tmp / "ranks.py").write_text(_RANKS)
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump({"cases": CASES, "case": CASE, "reference": ref}, f)
    res = subprocess.run([sys.executable, str(tmp / "ranks.py"), f"file://{tmp / 'rdv'}", str(tmp / "job.pkl"),
                          str(tmp)], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    out = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def rest_bytes(cfg, mesh, rank: int, batch: int) -> int:
    """``cache_bytes`` of the case's caches on ``rank``, each kv or recurrent
    leaf scaled by the rank's share of its heads where "model" narrows them."""
    layout = SS.ServeLayout(mesh, rank)
    caches = lm.cache_init(cfg, batch, CASE["cache_len"], device="meta")
    specs = SS.cache_split(caches, layout).specs
    hs, rs = SS.attention_heads(cfg, layout), SS.recurrent_heads(cfg, layout)
    total = 0
    for (path, t), (_, spec) in zip(leaves_with_path(caches), sh.spec_leaves(specs)):
        n = sh.local_numel(t.shape, spec, mesh) * t.element_size()
        if path[-1] in ("k", "v"):
            n = n * hs.nkv // t.shape[-2]
        elif path[-1] in ("state", "ssm"):
            n = n * rs.n // t.shape[-3]
        total += n
    assert total <= SS.cache_bytes(layout, caches)
    return total


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}/{c[1]}/B{c[2]}")
def test_four_ranks_decode_with_caches_split_off_the_batch(four_ranks, case):
    """Prefill and 3 decode steps on every rank within SMOKE_BOUNDS of the
    single process (rwkv6 on (4, 1): bit for bit), the bytes handed to gloo
    equal to the count on meta (``hold``), the caches at rest the rank's
    blocks: ``cache_bytes`` scaled by its share of the heads."""
    name, shape, batch = case
    cfg = config(name)
    mesh = Mesh(("data", "model"), tuple(int(x) for x in shape.split("x")))
    split = SS.cache_layout(cfg, SS.ServeLayout(mesh, 0), batch, CASE["cache_len"])
    assert "other" in split.found
    exact = name == "rwkv6-1.6b" and shape == "4x1"
    for rank, rep in enumerate(four_ranks):
        res = rep[case]
        print(f"{name} {shape} B={batch} rank {rank}: prefill {res['prefill']:.4g}, decode {res['decode']}, caches "
              f"{res['caches']:.4g}; bytes a decode step {res['moved']['decode']}; caches at rest "
              f"{res['cache_bytes']} (cache_specs {res['cache_bytes_specs']}); kinds {sorted(split.found)}")
        SC.hold(f"{case} rank {rank}", res, SC.SMOKE_BOUNDS)
        if exact:
            assert res["prefill"] == 0 and max(res["decode"]) == 0 and res["caches"] == 0, res
        assert res["moved"]["decode"]["all-gather"] > 0
        assert res["cache_bytes"] == rest_bytes(cfg, mesh, rank, batch)
        assert res["cache_bytes"] <= res["cache_bytes_specs"]


@pytest.mark.parametrize("case", REF_CASES, ids=lambda c: f"{c[0]}/{c[1]}/B{c[2]}")
def test_four_ranks_against_the_reference_one_device_decode(four_ranks, case):
    """Each decode step's logits on every rank against the reference's
    jitted one-device ``lm.decode_step`` on the same parameters, caches and
    tokens: within REF_ATOL (gemma3-1b), or for the recurrent archs no
    farther than the single-process port is from the same program."""
    name = case[0]
    for rank, rep in enumerate(four_ranks):
        got = rep[("reference", name)]
        print(f"{case} rank {rank}: the sharded decode vs the reference's one-device program {got['one']}; the "
              f"single-process port vs it {got['single']}")
        assert all(np.isfinite(got["one"]))
        if name in RECURRENT:
            assert all(g <= max(REF_ATOL, s) for g, s in zip(got["one"], got["single"])), (rank, got)
        else:
            assert max(got["one"]) <= REF_ATOL, (rank, got)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b", "gemma3-1b@reps"])
def test_decode_gathers_the_other_leaves(arch):
    """One decode step's all-gathers over "data", counted on ``meta`` at rank
    0 of (4, 1), less the same step's where every leaf splits on its batch
    (B = 4; gemma3-1b@reps B = 8, a count its 4 repetitions do not take):
    the ``other`` leaves whole, once (gemma3-1b@reps at B = 4: twice, since
    the rows each rank wrote are gathered back before it keeps its
    repetitions)."""
    cfg = config(arch)
    layout = SS.ServeLayout(Mesh(("data", "model"), (4, 1)), 0)
    params = SS.shard_params(lm.lm_init(cfg, device="meta"), layout)
    reps = arch.endswith("@reps")

    def gathered(B):
        comm = CountingComm()
        caches = lm.cache_init(cfg, B, CASE["cache_len"], device="meta")
        step = SS.make_decode_step(cfg, layout, comm, B, CASE["cache_len"])
        step(params, SS.shard_caches(caches, cfg, layout), torch.empty((B, 1), dtype=torch.int32, device="meta"),
             torch.empty((), dtype=torch.int64, device="meta"))
        kinds = leaves(SS.cache_split(caches, layout).kinds)
        return comm.bytes["all-gather"], sum(t.numel() * t.element_size() for t, k in zip(leaves(caches), kinds)
                                             if k == "other")

    got, other = gathered(4 if reps else 1)
    base, none = gathered(8 if reps else 4)
    assert none == 0 and other > 0
    assert got - base == (2 if reps else 1) * other, (got, base, other)
