"""The LM train step across a process group (``repro_torch.train.sharded``)
against the single-process port (``trainer.make_train_step``) and against
the reference's own sharded step.

* One rank (a gloo group of one, mesh (1, 1)): the sharded step equals
  ``make_train_step`` bit for bit (state, metrics, counters) over 3 steps
  from the same draws, for marina:perm / ind / same (fp32 and bf16
  replicas), ef21p and the exact broadcast, under a participation plan, and
  with a forced sync.
* Four gloo ranks (a subprocess, ``torch.multiprocessing.spawn``) on a
  (4, 1) mesh and on a (2, 2) mesh with ``act_spec``: each step, from the
  single-process state of that step (teacher-forced), against the
  single-process step. Only the order of the sums over workers (and, under
  ``act_spec``, over row blocks) differs, so the bound is the one already
  held against the reference (tests/test_torch_train_step.py) where that is
  tight enough, and tighter where the run shows it: loss within LOSS_ATOL,
  max |dg| / max |g| within G_RTOL (g recovered from AdamW's first moment),
  the new master within two AdamW updates a coordinate with all but
  BULK_FRAC of the coordinates within 0.1 lr, MARINA-P's replicas alike
  (times W, the weight of a kept coordinate), EF21-P's shift bit for bit
  the downlink of the ranks' own x^{t+1} (TopK's near-ties follow its last
  bit), and the counters exact. On every rank and
  step, the bytes the communicator handed to gloo equal the bytes the
  dry-run's ``CountingComm`` counts for the same step on ``meta``, and
  ``shard_state`` / ``gather_state`` give back the single-process state bit
  for bit.
* The reference: its ``make_train_step`` jitted on a (2, 2) ("data",
  "model") mesh of 4 forced host devices with its ``server`` / ``worker``
  specs and ``act_spec = P("model", None, None)`` (a subprocess, as
  tests/test_distributed.py runs its SPMD rounds), one step from its own
  state after a first, against the port's 4-rank gloo step from the same
  state with the same batch and draws, within the bound above. The
  reference's compiled collective bytes are printed beside the port's count
  and not compared (XLA runs "model" as tensor parallelism; the port does
  not).
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
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import TrainerConfig, init_state, make_downlink, make_train_step
from repro_torch.train import downlink as D
from repro_torch.train import sharded as SH
from repro_torch.train import sharded_check as SC

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LR = SC.LR
SPECS = ["marina:perm", "marina:ind", "marina:same", "ef21p:16:64", "none"]


@pytest.fixture
def one_rank(tmp_path):
    """A gloo group of one rank in this process, and its (1, 1) mesh."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0, world_size=1)
    try:
        yield Mesh(("data", "model"), (1, 1))
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(n)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(-1).view(torch.uint8),
                                                                        b.view(-1).view(torch.uint8))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("spec,dtype,part,forced", [(s, "float32", False, False) for s in SPECS]
                         + [("marina:perm", "bfloat16", False, False), ("marina:ind", "float32", True, True),
                            ("ef21p:16:64", "float32", True, True)])
def test_one_rank_equals_make_train_step_bit_for_bit(one_rank, spec, dtype, part, forced):
    cfg = configs.get_smoke("gemma-2b")
    sizes = P.leaf_sizes(lm.lm_spec(cfg))
    tcfg = TrainerConfig(n_workers=4, attn_chunk=32, weight_dtype=getattr(torch, dtype),
                         drop_prob=0.4 if part else 0.0)
    dl, opt = make_downlink(spec, 4), make_optimizer("adamw", weight_decay=0.01)
    single = make_train_step(cfg, tcfg, dl, opt, constant_lr(LR))
    layout, comm = SH.connect(one_rank, 4, sum(sizes))
    step = SH.make_sharded_train_step(cfg, tcfg, dl, opt, constant_lr(LR), layout, comm)
    state = init_state(cfg, tcfg, dl, opt, device="cpu", seed=1)
    sp = SH.shard_state(state, layout)
    data = SyntheticLMData(cfg, 4, 2, 64, device="cpu")
    gen, dgen, pgen = (torch.Generator().manual_seed(5) for _ in range(3))
    plan = SH.trainer.participation_plan(tcfg)
    coins = []
    for i in range(3):
        draws = D.draw_round(dl, sizes, gen, dgen)
        if part:
            draws = draws._replace(part=plan.draw(4, pgen, "cpu"))
        coins.append(draws.coin)
        state, m1 = single(state, data.batch(i), draws, forced and i == 1)
        sp, m2 = step(sp, data.batch(i), draws, forced and i == 1)
        assert _same(SH.gather_state(sp, layout, SH.Comm()), state), (spec, i)
        assert _same(m2, m1), (spec, i)
    if spec.startswith("marina"):
        assert True in coins and False in coins, coins  # both branches ran


def test_rows_at_an_offset_are_the_workers_rows():
    """``round_rows`` at row offset ``off`` gives rows ``off ...`` of
    ``round`` bit for bit in every mode (perm: ``rotk_apply_rows`` with the
    rotation (r + off) mod W, row i held against ``ops.rotk_apply(...,
    worker=off + i)`` on the CPU path), f32 and bf16 replicas, a sync too."""
    sizes = [37, 64, 5, 130]
    d, W = sum(sizes), 4
    g = torch.Generator().manual_seed(0)
    x_old = torch.randn(d, generator=g)
    x_new = x_old + 0.01 * torch.randn(d, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        workers = (x_old + 0.001 * torch.randn(W, d, generator=g)).to(dtype)
        for mode in ("perm", "ind", "same"):
            dl = D.MarinaPDownlink(W, mode, p=1e-12)  # draws no sync
            for coin in (False, True):
                draws = D.draw_round(dl, sizes, torch.Generator().manual_seed(3),
                                     torch.Generator().manual_seed(4))._replace(coin=coin)
                full, bits = dl.round(draws, sizes, x_new, x_old, workers)
                for off, R in ((0, 4), (1, 1), (2, 2), (3, 1)):
                    rows, b = dl.round_rows(draws, sizes, x_new, None if coin else x_new - x_old,
                                            workers[off:off + R], off)
                    assert b == bits and _same(rows, full[off:off + R]), (dtype, mode, coin, off)
                    if mode == "perm" and not coin:
                        rot = torch.remainder(draws.rot + off, W).to(torch.int32)
                        for li, (o, s) in enumerate(zip(np.cumsum([0] + sizes[:-1]), sizes)):
                            delta = (x_new[o:o + s] - x_old[o:o + s]).to(dtype)
                            got = ops.rotk_apply_rows(workers[off:off + R, o:o + s].contiguous(), delta,
                                                      rot[li:li + 1], n=W)
                            for i in range(R):
                                want = ops.rotk_apply(workers[off + i, o:o + s].contiguous(), delta,
                                                      draws.rot[li:li + 1], n=W, worker=off + i)
                                assert _same(got[i], want), (dtype, off, li, i)


def test_layout_slices_and_refusals():
    mesh = Mesh(("data", "model"), (2, 2))
    lay = SH.Layout(mesh, 3, 4, 10)
    assert (lay.coords, lay.local, lay.off, lay.shard_len, lay.padded) == ((1, 1), 2, 2, 3, 12)
    flat = torch.arange(10.0)
    assert torch.equal(torch.cat([SH.Layout(mesh, r, 4, 10).shard(flat) for r in range(4)])[:10], flat)
    assert torch.equal(lay.shard(flat), torch.tensor([9.0, 0.0, 0.0]))
    batch = {"tokens": torch.arange(4 * 4 * 3).reshape(4, 4, 3)}
    assert torch.equal(lay.local_batch(batch, 2)["tokens"], batch["tokens"][2:4, 2:4])
    assert torch.equal(lay.local_batch(batch, 1)["tokens"], batch["tokens"][2:4])
    with pytest.raises(ValueError, match="do not split over 'model'"):
        lay.local_batch({"tokens": torch.zeros(4, 3, 2)}, 2)
    with pytest.raises(ValueError, match="workers do not split"):
        SH.Layout(mesh, 0, 3, 10)
    with pytest.raises(ValueError, match="'data', 'model'"):
        SH.Layout(Mesh(("wk", "data", "model"), (2, 1, 2)), 0, 4, 10)


@pytest.mark.parametrize("arch,act,match", [
    ("deepseek-v2-236b", True, "experts"), ("llama4-maverick-400b-a17b", True, "experts"),
    ("rwkv6-1.6b", None, "holds the rank's blocks"), ("zamba2-1.2b", "blocks", "whole replicas"),
    ("gemma-2b", ("data", None, None), "realizes")])
def test_refusals_of_what_is_not_ported(arch, act, match):
    """act_spec with experts (MoE capacity spans all of a call's tokens), a
    mesh with "model" > 1 and neither act_spec nor the rank's blocks, and
    act_spec on a layout with them (``act`` "blocks") are refused, as is any
    other act_spec; lm.forward keeps refusing act_spec and names the
    sharded step."""
    cfg = configs.get_smoke(arch)
    d = sum(P.leaf_sizes(lm.lm_spec(cfg)))
    spec = SH.ACT_SPEC if act in (True, "blocks") else act
    tcfg = TrainerConfig(n_workers=2, attn_chunk=32, act_spec=spec)
    mesh = Mesh(("data", "model"), (2, 2))
    layout = SH.Layout(mesh, 0, 2, d, SH.model_blocks(cfg, mesh, 0) if act == "blocks" else None)
    with pytest.raises(ValueError, match=match):
        SH.make_sharded_train_step(cfg, tcfg, make_downlink("marina:perm", 2), make_optimizer("adamw"),
                                   constant_lr(LR), layout, SH.CountingComm())
    with pytest.raises(ValueError, match="make_sharded_train_step"):
        lm.forward(cfg, lm.lm_init(cfg, device="meta"), {"tokens": torch.zeros(1, 8, dtype=torch.int32)},
                   act_spec=SH.ACT_SPEC)


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

# the bounds of the 4-rank runs against the single-process port live beside the
# sharded step (train/sharded_check.py), which chip_smoke.py's card run holds too
DATA_BOUNDS, ACT_BOUNDS = SC.DATA_BOUNDS, SC.ACT_BOUNDS
# ... and against the reference's own sharded step (bf16 rounding differs)
REF_LOSS_ATOL, REF_GNORM_RTOL, REF_G_RTOL = 1e-3, 2e-2, 1.1e-2
PARAM_ATOL, BULK_ATOL, BULK_FRAC = 2.2 * LR, 0.1 * LR, 5e-3

_RANKS = textwrap.dedent(
    """
    import pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    WORLD = 4


    def worker(rank, init, shape, act, cases_path, out_path):
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.launch.mesh import Mesh
        from repro_torch.models import lm, params as P
        from repro_torch.train import TrainerConfig
        from repro_torch.train import sharded as SH, sharded_check as SC

        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
        cases = pickle.load(open(cases_path, "rb"))
        cfg = configs.get_smoke(cases["arch"])
        d, W = sum(P.leaf_sizes(lm.lm_spec(cfg))), 4
        layout, comm = SH.connect(Mesh(("data", "model"), shape), W, d, cfg=None if act else cfg)
        aux = SH.Comm()  # the checks' gathers, apart from the step's tally
        report = {}
        for name, spec, dtype, drop, forced in cases["cases"]:
            tcfg = TrainerConfig(n_workers=W, attn_chunk=32, weight_dtype=getattr(torch, dtype),
                                 drop_prob=drop, act_spec=SH.ACT_SPEC if act else None)
            report[name] = SC.run_case(cfg, tcfg, spec, layout, comm, aux, batch_rows=2, seq=64,
                                       device="cpu", forced=forced)
        if cases.get("reference") is not None:  # one step from the reference's state
            report["reference"] = reference_step(cfg, layout, comm, aux, cases["reference"], act)
        if rank == 0:
            pickle.dump(report, open(out_path, "wb"))
        dist.destroy_process_group()


    def reference_step(cfg, layout, comm, aux, ref, act):
        from repro_torch import convert
        from repro_torch.optim import constant_lr, make_optimizer
        from repro_torch.train import TrainerConfig, make_downlink
        from repro_torch.train import downlink as D, sharded as SH, sharded_check as SC

        W = layout.n_workers
        tcfg = TrainerConfig(n_workers=W, attn_chunk=32, act_spec=SH.ACT_SPEC if act else None)
        dl = make_downlink(ref["spec"], W)
        step = SH.make_sharded_train_step(cfg, tcfg, dl, make_optimizer("adamw"), constant_lr(SC.LR),
                                          layout, comm)
        state = convert.train_state_from_numpy(cfg, tcfg, ref["state"], "cpu")
        draws = D.DownlinkDraws(coin=ref["coin"], seed=ref["seed"],
                                rot=None if ref["rot"] is None else torch.tensor(ref["rot"], dtype=torch.int32),
                                masks=None if ref["masks"] is None else [torch.from_numpy(m) for m in ref["masks"]])
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in ref["batch"].items()}
        before = dict(comm.bytes)
        sp, m = step(SH.shard_state(state, layout), batch, draws)
        full = SH.gather_state(sp, layout, aux)
        return {"state": full, "metrics": {k: (v.item() if isinstance(v, torch.Tensor) else v)
                                           for k, v in m.items()},
                "coll": {k: v - before.get(k, 0) for k, v in comm.bytes.items()}}


    if __name__ == "__main__":
        init, shape, act, cases_path, out_path = sys.argv[1:]
        shape = tuple(int(x) for x in shape.split("x"))
        mp.spawn(worker, args=(init, shape, act == "act", cases_path, out_path), nprocs=WORLD, join=True)
    """
)

CASES = [("marina:perm", "marina:perm", "float32", 0.0, False),
         ("marina:perm/bf16", "marina:perm", "bfloat16", 0.0, False),
         ("marina:ind/partial+forced", "marina:ind", "float32", 0.4, True),
         ("marina:same", "marina:same", "float32", 0.0, False),
         ("ef21p/forced", "ef21p:16:64", "float32", 0.0, True)]


def _run_ranks(tmp_path, shape: str, act: bool, cases, reference=None, arch: str = "gemma-2b") -> dict:
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    cases_path, out_path = tmp_path / "cases.pkl", tmp_path / "report.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump({"cases": cases, "reference": reference, "arch": arch}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, str(script), f"file://{tmp_path / 'rdv'}", shape,
                          "act" if act else "-", str(cases_path), str(out_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)


def _hold(report, bounds):
    """Every case's worst step within ``bounds`` (``sharded_check.hold``)."""
    for name, res in report.items():
        print(f"{name}: {dict(zip(SC.WORST_KEYS, res['worst']))}; bytes a step {res['moved']}")
    for name, res in report.items():
        SC.hold(name, res, bounds, 4)


def test_four_ranks_data_axis_against_single_process(tmp_path):
    """Mesh (4, 1): one worker a rank, the server's state in 4 slices."""
    report = _run_ranks(tmp_path, "4x1", False, CASES)
    assert set(report) == {c[0] for c in CASES}
    _hold(report, DATA_BOUNDS)


def test_four_ranks_act_spec_against_single_process(tmp_path):
    """Mesh (2, 2) with act_spec: two workers a data index, each worker's
    two rows split over the two model ranks."""
    report = _run_ranks(tmp_path, "2x2", True, CASES)
    assert set(report) == {c[0] for c in CASES}
    _hold(report, ACT_BOUNDS)


# ---------------------------------------------------------------------------
# the reference's own sharded step
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent(
    """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np
    jax.config.update("jax_default_matmul_precision", "highest")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.data import SyntheticLMData
    from repro.launch import hlo_cost, sharding as sh
    from repro.optim import make_optimizer
    from repro.optim.schedules import constant_lr
    from repro.train import TrainerConfig, init_state, make_downlink, make_train_step

    spec, act, out, arch, own = sys.argv[1:]
    cfg = configs.get_smoke(arch)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    W = 4
    tcfg = TrainerConfig(n_workers=W, attn_chunk=32, act_spec=P("model", None, None) if act == "act" else None)
    dl, opt = make_downlink(spec, W), make_optimizer("adamw")
    state = init_state(cfg, tcfg, dl, opt, jax.random.PRNGKey(0))
    specs = {"server": sh.param_specs(state["server"], mesh, "server"),
             "opt": sh.param_specs(state["opt"], mesh, "server"),
             "step": P(), "bits_per_worker": P(), "uplink_bits_per_worker": P()}
    if "workers" in state:  # MARINA-P's replicas: the worker layout; EF21-P's shift: the server's
        specs["workers"] = sh.param_specs(state["workers"], mesh,
                                          "worker" if spec.startswith("marina") else "server")
    data = SyntheticLMData(cfg, W, 2, 64)
    ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t, is_leaf=lambda x: isinstance(x, P))
    shardings = (ns(specs), ns(sh.train_batch_spec(data.batch(0), mesh)), NamedSharding(mesh, P()))
    step = jax.jit(make_train_step(cfg, tcfg, dl, opt, constant_lr(2e-3)), in_shardings=shardings)
    keys = [jax.random.fold_in(jax.random.PRNGKey(9), i) for i in range(2)]
    tonp = lambda t: jax.tree.map(np.asarray, t)
    with jax.set_mesh(mesh):
        s1, _ = step(*jax.device_put((state, data.batch(0), keys[0]), shardings))
        args = jax.device_put((tonp(s1), data.batch(1), keys[1]), shardings)
        s2, m2 = step(*args)
        coll = hlo_cost.analyze(step.lower(*args).compile().as_text())["coll"]
    one = None
    if own == "own":  # the same step as one device's program, from the same state: the reference's own distance
        s2_one, m2_one = jax.jit(make_train_step(cfg, tcfg, dl, opt, constant_lr(2e-3)))(
            tonp(s1), data.batch(1), keys[1])
        one = {"new": tonp(s2_one), "metrics": tonp(m2_one)}
    sys.path.insert(0, os.path.dirname(out))
    from draws_of import draws_of
    shapes = [tuple(x.shape) for x in jax.tree.leaves(s1["server"])]
    pickle.dump({"spec": spec, "state": tonp(s1), "new": tonp(s2), "metrics": tonp(m2),
                 "batch": {k: np.asarray(v) for k, v in data.batch(1).items()},
                 "coll": {k: float(v) for k, v in coll.items()}, "one": one, **draws_of(dl, keys[1], shapes)},
                open(out, "wb"))
    """
)

_DRAWS_OF = textwrap.dedent(
    """
    import jax
    import numpy as np


    def draws_of(dl, key, shapes):
        # the reference downlink's draws from ``key`` (test_torch_train_parity.reference_draws), as numpy
        out = {"coin": False, "seed": 0, "rot": None, "masks": None}
        if not hasattr(dl, "mode"):
            return out
        k_bern, k_comp = jax.random.split(key)
        out["coin"] = bool(jax.random.bernoulli(k_bern, dl.sync_p))
        out["seed"] = int(np.asarray(k_comp).ravel()[-1])
        lks = [jax.random.fold_in(k_comp, li) for li in range(len(shapes))]
        if dl.mode == "perm":
            out["rot"] = [int(jax.random.randint(lk, (), 0, dl.n_workers)) for lk in lks]
        elif dl.mode == "ind":
            out["masks"] = [np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(lk, w), s)
                                                 < dl.frac).reshape(-1) for w in range(dl.n_workers)])
                            for lk, s in zip(lks, shapes)]
        else:
            out["masks"] = [np.asarray(jax.random.uniform(lk, s) < dl.frac).reshape(-1)
                            for lk, s in zip(lks, shapes)]
        return out
    """
)


@pytest.mark.parametrize("spec,act", [pytest.param(s, True, id=s) for s in ("marina:perm", "marina:ind", "ef21p:16:64")]
                         + [pytest.param(s, False, id=f"{s}-worker") for s in ("marina:perm", "marina:ind",
                                                                               "ef21p:16:64")])
def test_four_ranks_against_the_reference_sharded_step(tmp_path, spec, act):
    """``act``: the reference's act_spec program against the port's; else its
    default, the ``worker`` layout through XLA (act_spec None) against the
    port's tensor parallelism over "model"."""
    reference_case(tmp_path, spec, act)


def reference_case(tmp_path, spec: str, act: bool, arch: str = "gemma-2b", own: bool = False) -> None:
    """One step of the reference's sharded program on (2, 2) (XLA on 4 CPU
    devices; ``act``: act_spec, else the ``worker`` layout) from its state
    after one step, against the port's sharded step on 4 gloo ranks from
    the same state, batch and draws, the smoke ``arch``: the counters and
    lr exactly, the rest within REF_LOSS_ATOL, REF_GNORM_RTOL, REF_G_RTOL,
    PARAM_ATOL and BULK_FRAC."""
    pytest.importorskip("jax")
    from repro_torch import convert

    (tmp_path / "draws_of.py").write_text(_DRAWS_OF)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    ref_path = tmp_path / "reference.pkl"
    res = subprocess.run([sys.executable, "-c", _REFERENCE, spec, "act" if act else "-", str(ref_path), arch,
                          "own" if own else "-"], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-6000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    port = _run_ranks(tmp_path, "2x2", act, [], reference=ref, arch=arch)["reference"]
    cfg = configs.get_smoke(arch)
    tcfg = TrainerConfig(n_workers=4, attn_chunk=32)
    old = convert.train_state_from_numpy(cfg, tcfg, ref["state"], "cpu")
    want = convert.train_state_from_numpy(cfg, tcfg, ref["new"], "cpu")
    got, m, jm = port["state"], port["metrics"], ref["metrics"]
    print(f"{arch} {spec}: collective bytes a device, the reference's compiled step "
          f"{ {k: v for k, v in ref['coll'].items() if v} }, the port's count {port['coll']}")
    assert got["step"] == want["step"] and got["bits_per_worker"] == want["bits_per_worker"]
    assert got["uplink_bits_per_worker"] == want["uplink_bits_per_worker"]
    assert m["lr"] == float(jm["lr"])
    bounds = dict(REF_BOUNDS, workers=(4 if spec.startswith("marina") else 1) * PARAM_ATOL)
    dist = _ref_distances(got, {k: float(v) for k, v in m.items()}, want, jm, old)
    print(f"  the port from the reference's partitioned step: {dist}")
    if own:  # the reference's one-device program and the port's single process, from the same state
        one = _ref_distances(convert.train_state_from_numpy(cfg, tcfg, ref["one"]["new"], "cpu"),
                             {k: float(v) for k, v in ref["one"]["metrics"].items()}, want, jm, old)
        single, ms = make_train_step(cfg, tcfg, make_downlink(spec, 4), make_optimizer("adamw"),
                                     constant_lr(LR))(old, {k: torch.from_numpy(np.asarray(v))
                                                            for k, v in ref["batch"].items()}, _draws(ref))
        single = _ref_distances(single, {k: float(v) for k, v in ms.items()}, want, jm, old)
        print(f"  the reference's one-device program from its partitioned one: {one}\n"
              f"  the port's single process from the reference's partitioned step: {single}")
        bounds = {k: max(b, OWN_FACTOR * one[k], OWN_FACTOR * single[k]) for k, b in bounds.items()}
    for k, b in bounds.items():
        assert dist[k] <= b, (k, dist[k], b)


def _draws(ref) -> D.DownlinkDraws:
    """The round's draws of the reference's step (``draws_of``'s numpy)."""
    return D.DownlinkDraws(coin=ref["coin"], seed=ref["seed"],
                           rot=None if ref["rot"] is None else torch.tensor(ref["rot"], dtype=torch.int32),
                           masks=None if ref["masks"] is None else [torch.from_numpy(m) for m in ref["masks"]])


# the bounds against the reference's partitioned step (reference_case), by distance
REF_BOUNDS = dict(loss=REF_LOSS_ATOL, grad_norm=REF_GNORM_RTOL, g=REF_G_RTOL, server=PARAM_ATOL, bulk=BULK_FRAC,
                  drift=0.05)
# reference_case(own=True): each bound at least this times the reference's own distance (its one-device program
# from its partitioned one) and the port's single process's, from the same state
OWN_FACTOR = 1.5


def _ref_distances(got, m, want, jm, old) -> dict:
    """The distances ``reference_case`` bounds of a train state and metrics
    (``got``, ``m``) from the reference's (``want``, ``jm``), both one step
    from ``old``: the loss's, grad_norm's and the drift's (relative, 0 below
    1e-6), g's max |dg| / max |g| (g from AdamW's first moment), the master's
    max |diff| and the share of it past BULK_ATOL, and the replicas' max
    |diff|."""
    def g_of(s):
        return (s["opt"]["m"] - 0.9 * old["opt"]["m"]) / 0.1

    g_ref = g_of(want)
    ds = (got["server"] - want["server"]).abs()
    out = {"loss": abs(m["loss"] - float(jm["loss"])),
           "grad_norm": abs(m["grad_norm"] / float(jm["grad_norm"]) - 1),
           "g": float((g_of(got) - g_ref).abs().max() / g_ref.abs().max()),
           "server": float(ds.max()), "bulk": float((ds > BULK_ATOL).float().mean()), "workers": 0.0, "drift": 0.0}
    if "workers" in want:
        out["workers"] = float((got["workers"].float() - want["workers"].float()).abs().max())
        d = abs(m["drift"] - float(jm["drift"]))
        out["drift"] = 0.0 if d <= 1e-6 else d / abs(float(jm["drift"]))
    return out
