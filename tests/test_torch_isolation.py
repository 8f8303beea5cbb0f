"""The port stands alone: it runs with JAX and ml_dtypes unimportable
(the paper's runs, the harness, the LM serving and training paths, the
dry-run), imports nothing of
the JAX package ``repro`` or of the reference's ``benchmarks``, and its
entry points never default to the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
# each subprocess on one thread: beside five other test workers a run on every core's thread takes 9x as
# long as alone (the training run on an 8-core host: 111 s of its 120 against 12 s alone), on one thread a
# fair share
ONE_THREAD = "1"
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

# `import jax`, `from jax...`, `import ml_dtypes` (it comes with JAX),
# `import repro`/`repro.x`, `from repro(.x) import`, `import benchmarks`,
# `from benchmarks(.x) import`; `repro_torch` does not match.
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+ml_dtypes\b|from\s+ml_dtypes\b"
                       r"|import\s+repro\b(?!_)|from\s+repro\b(?!_)"
                       r"|import\s+benchmarks\b|from\s+benchmarks\b)")

JAX_FREE_RUN = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["ml_dtypes"] = None
import repro_torch
from repro_torch.core import marina_p, problems, stepsizes
prob = problems.generate_problem(n=4, d=32, noise_scale=1.0, seed=0, device="cpu")
h = marina_p.run(prob, mode="perm", k=8, p=0.25, stepsize=stepsizes.Constant(0.01), T=3)
assert h["ledger"].rounds == 3, h["ledger"].rounds
# the wire path, bf16 magnitudes, on the CPU problem: no ml_dtypes needed
h = marina_p.run(prob, mode="ind", k=8, p=0.25, stepsize=stepsizes.Constant(0.01), T=3,
                 measure_wire=True, wire_mag="bf16")
assert len(h["wire_bits"]) == 3 and h["wire_bits_total"] > 0, h["wire_bits"]
# the encode and kernel benchmarks' modules: bernk, rotk_apply, the fused
# encoders, the new compressors and the NATURAL codec
import torch
from repro_torch import kernel_bench, wire, wire_bench
from repro_torch.core import compressors as C
from repro_torch.kernels import encode as K, ops
x = torch.linspace(-1.0, 1.0, 300)
assert K.mask_encode(x, keep_prob=0.1, seed=3) == wire.encode_sparse(ops.bernk(x, keep_prob=0.1, seed=3))
assert K.topk_encode(x, k_per_block=8, block=128) == wire.encode_sparse(ops.block_topk(x, k_per_block=8, block=128))
assert len(K.encode_per_worker(x, n_workers=3, keep_prob=0.5, seed=1)) == 3
ops.rotk_apply(x, x, torch.tensor(1, dtype=torch.int32), n=3, worker=0)
gen = torch.Generator().manual_seed(0)
for comp in (C.RotK(n=3), C.BernK(k=30), C.NaturalCompression(), C.ScaledUnbiased(inner=C.RandK(k=30))):
    q = comp(x, comp.draw(300, gen, "cpu"))
    wire.encode(q, comp)
assert wire_bench.bench_encode(d=256, device="cpu")[-1][2] == 1.0
# tracing, the lossy transport and the fleet: the branches that hold the
# reference's lazy imports (link spans, fault specs of clients, encodes)
from repro_torch import obs, federated_l1, scenario_matrix, transport_bench
from repro_torch.obs import analyze
from repro_torch.core import ef21p
from repro_torch.fleet import BernoulliStragglerPlan, FleetL1Problem, fleet_run, make_fleet, make_sampler
from repro_torch.transport import FaultSpec
tr = obs.MemoryTracker()
h = marina_p.run(prob, mode="perm", k=8, p=0.25, stepsize=stepsizes.Constant(0.01), T=4,
                 transport=FaultSpec(drop=0.3, seed=1), tracker=tr, measure_wire=True,
                 participation=BernoulliStragglerPlan(drop_prob=0.3))
assert h["transport"]["transport/frames_sent"] > 0 and analyze.validate_spans(tr.events) == []
assert any(e["name"].startswith("link/worker") for e in tr.events if e["kind"] == "span")
h = ef21p.run(prob, C.TopK(k=8), stepsizes.Constant(0.01), T=4, transport=FaultSpec(drop=0.3, seed=1),
              tracker=obs.MemoryTracker())
spec = make_fleet("flaky_mobile", 256, seed=0)
h = fleet_run(FleetL1Problem(spec, d=16), make_sampler("uniform", spec, 4, seed=1),
              stepsizes.Constant(0.05), T=4, measure_wire=True, tracker=obs.MemoryTracker(), device="cpu")
assert h["wire_bits_total"] > 0 and h["participation"].rounds == 4
env = obs.environment(seed=0)
assert env["jax_version"] is None and env["torch_version"] == torch.__version__, env
assert transport_bench.framing_rows()[0][0] == "transport/frame_encode"
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print("ok")
"""


# the harness, the paper's remaining suites, the SPMD runner and the
# SEED/PERM decode, with `repro` and `benchmarks` blocked as well
HARNESS_RUN = """
import os, sys, tempfile, warnings
for mod in ("jax", "ml_dtypes", "repro", "benchmarks"):
    sys.modules[mod] = None  # any import of them now raises ImportError
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import bench_diff, comm_complexity, obs, run, stepsize_grid, table2_sigma, trace_smoke, wire
from repro_torch.core import distributed, jax_random, marina_p, problems, stepsizes
from repro_torch.obs import analyze
tmp = tempfile.mkdtemp()
assert run.main(["transport", "--device", "cpu", "--out", tmp]) == 0
failures, report = bench_diff.diff_dirs(os.path.join(sys.argv[1], "benchmarks", "baselines"), tmp,
                                        suites=["transport"])
assert all(f.endswith(")") and "us_per_call" in f for f in failures), failures
assert table2_sigma.bench(d=32, cells=[(10, 1.0)], device="cpu")[0][0] == "table2/sigmaA/n10/s1.0"
prob, eps = comm_complexity.setting("cpu")
assert comm_complexity.marina_ind_rounds(prob, 16, eps, T=3)[0] == -1
assert comm_complexity.ef21p_rounds(prob, 16, eps, T=3)[0] == -1
small = problems.generate_problem(n=4, d=16, noise_scale=1.0, seed=0, device="cpu")
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    assert len(stepsize_grid.bench(prob=small, T=4, factors=[1.0], methods=("perm", "ef21p"))) == 4
log = trace_smoke.run(os.path.join(tmp, "trace.jsonl"), rounds=3, device="cpu")
assert analyze.validate_spans(list(obs.read_jsonl(log))) == []
msg = wire.SeedMessage(wire.SeedFamily.PERM, 2**31 + 1, 3, 1.0, 4, 1)
out = wire.decode(wire.encode_seed(msg, 64), delta=np.ones(64, np.float32))
assert sorted(np.flatnonzero(out).tolist()) == sorted(jax_random.permutation(
    jax_random.fold_in(jax_random.PRNGKey(2**31 + 1), 3), 64)[16:32].tolist())
distributed.init_process_group("file://" + os.path.join(tmp, "rdv"), rank=0, world_size=1, device="cpu")
g = dist.group.WORLD
A = distributed.shard_problem(g, small.A, device="cpu")
step = distributed.make_marina_p_spmd_step(g, n=4, d=16, mode="perm", k=4, p=0.25,
                                           stepsize=stepsizes.Constant(0.01), device="cpu")
bc = marina_p.make_broadcast("perm", 4, 4)
st, m = step(distributed.init_marina_p(small.x0, 4), A, marina_p.draw_round(bc, 0.25, 16, torch.Generator(), "cpu"))
assert st.t == 1 and torch.isfinite(st.W).all()
dist.destroy_process_group()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("repro", "benchmarks") and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


# the LM serving path: configs, models, checkpoint, serve, with `repro`,
# `benchmarks`, jax and ml_dtypes blocked
SERVE_RUN = """
import os, sys, tempfile
for mod in ("jax", "ml_dtypes", "repro", "benchmarks"):
    sys.modules[mod] = None  # any import of them now raises ImportError
import numpy as np
import torch
from repro_torch import configs, obs, wire
from repro_torch import transport
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.models import lm
from repro_torch.serve import DecodeEngine
cfg = configs.get_smoke("gemma-2b")
assert configs.get("gemma3-1b").param_count() == 999812736
params = lm.lm_init(cfg, device="cpu", seed=0)
tr = obs.MemoryTracker()
eng = DecodeEngine(cfg, params, cache_len=12, batch_size=2, tracker=tr, device="cpu")
prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 4))
toks = eng.run(prompts, n_new_tokens=4)
assert toks.shape == (2, 4), toks.shape
before = params.flat.clone()
delta = np.zeros(params.size, np.float32)
delta[::97] = 0.5
eng.delta_sync(transport.encode_frame(transport.FrameType.DATA, 1, wire.encode_sparse(delta)))
assert torch.equal(params.flat, before + torch.from_numpy(delta))
path = os.path.join(tempfile.mkdtemp(), "ckpt.npz")
save_checkpoint(path, params, step=2)
back, meta = load_checkpoint(path, params)
assert meta["step"] == 2 and torch.equal(back.flat, params.flat)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("repro", "benchmarks") and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


# the LM training path: optim, data, train (both downlinks, measure_wire,
# the transport, participation, the sharded step and its check on one gloo
# rank) and
# `python -m repro_torch.train_lm`, with
# `repro`, `benchmarks`, jax and ml_dtypes blocked
TRAIN_RUN = """
import os, runpy, sys, tempfile
for mod in ("jax", "ml_dtypes", "repro", "benchmarks"):
    sys.modules[mod] = None  # any import of them now raises ImportError
import numpy as np
import torch
from repro_torch import configs, obs
from repro_torch.data import SyntheticLMData, batch_specs
from repro_torch.models import lm, params as P
from repro_torch.optim import constant_lr, cosine_warmup, make_optimizer
from repro_torch.train import TrainerConfig, make_downlink, train_loop
from repro_torch.train import downlink as D
from repro_torch.transport import FaultSpec
cfg = configs.get_smoke("gemma-2b")
assert batch_specs(cfg, 2, 1, 16)["tokens"].shape == (2, 1, 16)
for spec in ("marina:ind", "ef21p:16:64"):
    tcfg = TrainerConfig(n_workers=2, attn_chunk=16, drop_prob=0.3)
    state, m = train_loop(cfg, tcfg, make_downlink(spec, 2), make_optimizer("adamw"), cosine_warmup(1e-3, 1, 3),
                          SyntheticLMData(cfg, 2, 1, 16, device="cpu"), steps=3, device="cpu",
                          tracker=obs.MemoryTracker(), transport=FaultSpec(drop=0.2, seed=1))
    assert np.isfinite(float(m["loss"])) and m["transport"]["transport/frames_sent"] > 0, m
dl = make_downlink("marina:perm", 2)
sizes = P.leaf_sizes(lm.lm_spec(cfg))
draws = D.DownlinkDraws(rot=torch.zeros(len(sizes), dtype=torch.int32))
res = dl.measure_wire(draws, sizes, state["server"] + 0.01, state["server"], mag="bf16", device_encode=True)
assert res["bits_mean"] > 0 and not res["full_sync"], res
ckpt = os.path.join(tempfile.mkdtemp(), "ckpt.npz")
sys.argv = ["train_lm", "--device", "cpu", "--layers", "1", "--d-model", "64", "--seq", "32",
            "--steps", "2", "--workers", "2", "--downlink", "marina:same", "--ckpt", ckpt]
try:
    runpy.run_module("repro_torch.train_lm", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert os.path.exists(ckpt)
# the sharded train step, one gloo rank
import torch.distributed as dist
from repro_torch.launch.mesh import Mesh
from repro_torch.train import sharded as SH
dist.init_process_group("gloo", init_method="file://" + os.path.join(tempfile.mkdtemp(), "rdv"), rank=0,
                        world_size=1)
layout, comm = SH.connect(Mesh(("data", "model"), (1, 1)), 2, sum(sizes), act=True)
tcfg = TrainerConfig(n_workers=2, attn_chunk=16, act_spec=SH.ACT_SPEC)
opt = make_optimizer("adamw")
step = SH.make_sharded_train_step(cfg, tcfg, dl, opt, constant_lr(1e-3), layout, comm)
sp, m = step(SH.init_state(cfg, tcfg, dl, opt, layout, device="cpu"),
             SyntheticLMData(cfg, 2, 1, 16, device="cpu").batch(0), draws)
assert np.isfinite(float(m["loss"])) and set(comm.bytes) == {"reduce-scatter", "all-reduce", "all-gather"}
# ... and held against the single-process step as the 4-rank checks hold it
from repro_torch.train import sharded_check as SC
layout = SH.make_layout(Mesh(("data", "model"), (1, 1)), 0, 2, sum(sizes))  # without act_spec
res = SC.run_case(cfg, TrainerConfig(n_workers=2, attn_chunk=16), "marina:perm", layout, comm, SH.Comm(),
                  batch_rows=1, seq=16, device="cpu", steps=1)
SC.hold("marina:perm", res, SC.bounds(False), 2)
# the sharded serving step, one gloo rank, held as the 4-rank checks hold it
from repro_torch.serve import sharded as SS, sharded_check as SSC
slayout, scomm = SS.connect(Mesh(("data", "model"), (1, 1)), "serve")
res = SSC.run_case(cfg, slayout, scomm, SS.Comm(scomm.groups), batch=2, prompt=8, cache_len=16, steps=2, start=9,
                   chunk=8)
SSC.hold("serve", res, SSC.SMOKE_BOUNDS)
assert res["prefill"] == 0 and res["decode"] == [0.0, 0.0] and res["moved"] == {"prefill": {}, "decode": {}}, res
dist.destroy_process_group()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("repro", "benchmarks") and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


# the dry-run (launch/): a full-width count on meta, its record, reanalyze and
# the roofline report, and the act-sharded train count of one rank, with
# `repro`, `benchmarks`, jax and ml_dtypes blocked
LAUNCH_RUN = """
import os, sys, tempfile
for mod in ("jax", "ml_dtypes", "repro", "benchmarks"):
    sys.modules[mod] = None  # any import of them now raises ImportError
import json
from repro_torch import roofline_report
from repro_torch.launch import dryrun, mesh, reanalyze, sharding, specs
out = tempfile.mkdtemp()
dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--out", out])
recs = roofline_report.load(out)
assert len(recs) == 1 and dryrun.record_problems(recs[0]) == [], recs
assert recs[0]["split"] == "per_rank" and recs[0]["roofline"]["collective_s"] > 0, recs
assert reanalyze.reanalyze(out, tempfile.mkdtemp()) == recs
assert roofline_report.bench(out)[0][0] == "roofline/gemma3-1b/decode_32k/bound_s"
built = specs.build("gemma3-1b", "train_4k", mesh.make_production_mesh(multi_pod=True))
assert built.meta["W"] == 32 and built.specs[1]["tokens"][0] == ("pod", "data")
dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--train-act-model-sharded", "--out", out])
rec = json.load(open(os.path.join(out, "gemma3-1b__train_4k__16x16__act.json")))
assert rec["split"] == "per_rank" and rec["roofline"]["collective_s"] > 0, rec["roofline"]
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("repro", "benchmarks") and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


# the paper's grid (python -m repro_torch.federated_l1, its three
# modes) and `python -m repro_torch.wire_bench --smoke`, with `repro`,
# `benchmarks`, jax and ml_dtypes blocked; the grids run through the real
# run_suite at budgets cut 10,000x (the paper's d and n cut to 200 and 10)
PAPER_RUN = """
import os, sys, tempfile
for mod in ("jax", "ml_dtypes", "repro", "benchmarks"):
    sys.modules[mod] = None  # any import of them now raises ImportError
import torch
torch.set_num_threads(1)
from repro_torch import federated_l1, wire_bench
real = federated_l1.run_suite
federated_l1.run_suite = lambda *, d, n, budget_bits, **kw: real(d=min(d, 200), n=min(n, 10),
                                                             budget_bits=budget_bits / 10_000, **kw)
tmp = tempfile.mkdtemp()
for mode, cells in (([], 3), (["--paper"], 6)):
    out = os.path.join(tmp, f"grid{len(mode)}.csv")
    assert federated_l1.main([*mode, "--device", "cpu", "--out", out]) == 0
    rows = open(out).read().splitlines()
    assert rows[0] == "d,n,noise,method,final_subopt,rounds,bits_per_worker" and len(rows) == 1 + 8 * cells, rows
out = os.path.join(tmp, "fleet.csv")
assert federated_l1.main(["--fleet", "--device", "cpu", "--population", "256", "--cohort", "4", "-T", "2",
                          "--out", out]) == 0
assert open(out).read().startswith("method,final_f")
assert wire_bench.main(["--smoke", "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("repro", "benchmarks") and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def test_paper_grid_and_wire_smoke_run_without_jax_repro_or_benchmarks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS=ONE_THREAD)
    out = subprocess.run([sys.executable, "-c", PAPER_RUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_dry_run_runs_without_jax_repro_or_benchmarks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS=ONE_THREAD)
    out = subprocess.run([sys.executable, "-c", LAUNCH_RUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_training_path_runs_without_jax_repro_or_benchmarks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS=ONE_THREAD)
    out = subprocess.run([sys.executable, "-c", TRAIN_RUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_serving_path_runs_without_jax_repro_or_benchmarks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS=ONE_THREAD)
    out = subprocess.run([sys.executable, "-c", SERVE_RUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_default_to_the_card():
    """Every entry point of the port with a --device flag defaults to the
    card; serve_bench and serve_lm are among them."""
    flagged = {p.name for p in PORT_FILES
               if re.search(r'add_argument\("--device"', p.read_text())}
    assert {"serve_bench.py", "serve_lm.py", "run.py", "wire_bench.py", "train_lm.py"} <= flagged
    for p in PORT_FILES:
        for m in re.finditer(r'add_argument\("--device",\s*default="([a-z]+)"', p.read_text()):
            assert m.group(1) == "cuda", p.name


def test_harness_runs_without_jax_repro_or_benchmarks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS=ONE_THREAD)
    out = subprocess.run([sys.executable, "-c", HARNESS_RUN, str(ROOT)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_runs_without_jax_and_without_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS=ONE_THREAD)
    out = subprocess.run([sys.executable, "-c", JAX_FREE_RUN], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_file_of_the_port_imports_jax_or_repro():
    assert len(PORT_FILES) > 10
    offenders = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
                 for p in PORT_FILES
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if FORBIDDEN.match(line)]
    assert not offenders, offenders


def test_forbidden_pattern_itself():
    assert FORBIDDEN.match("import jax") and FORBIDDEN.match("  from jax.numpy import x")
    assert FORBIDDEN.match("from repro.core import problems") and FORBIDDEN.match("import repro")
    assert FORBIDDEN.match("import ml_dtypes") and FORBIDDEN.match("from ml_dtypes import bfloat16")
    assert FORBIDDEN.match("from benchmarks import bench_diff") and FORBIDDEN.match("import benchmarks.run")
    assert FORBIDDEN.match("from benchmarks.run import GATES")
    assert not FORBIDDEN.match("from repro_torch.core import problems")
    assert not FORBIDDEN.match("import repro_torch") and not FORBIDDEN.match("import jaxlib_x")


def test_default_device_is_the_card():
    """Without CUDA, the default device="cuda" raises; it never returns CPU
    tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from repro_torch import convert
    from repro_torch.core import problems

    with pytest.raises(RuntimeError, match="cuda"):
        problems.generate_problem(n=2, d=8, noise_scale=1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.ef21p_state_from_numpy([0.0], [0.0], 0)
    from repro_torch import configs, serve_bench, serve_lm
    from repro_torch.models import lm
    from repro_torch.serve import DecodeEngine

    cfg = configs.get_smoke("gemma-2b")
    with pytest.raises(RuntimeError, match="cuda"):
        lm.lm_init(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        DecodeEngine(cfg, lm.lm_init(cfg, device="cpu"), cache_len=8, batch_size=1)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_bench.bench()
    with pytest.raises(RuntimeError, match="cuda"):
        serve_lm.main(["--layers", "1", "--d-model", "64", "--ckpt", "no-such-file"])
    from repro_torch import train_lm
    from repro_torch.data import SyntheticLMData
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainerConfig, init_state

    with pytest.raises(RuntimeError, match="cuda"):
        init_state(cfg, TrainerConfig(n_workers=2), None, make_optimizer("sgd"))
    with pytest.raises(RuntimeError, match="cuda"):
        SyntheticLMData(cfg, 2, 1, 8).batch(0)
    with pytest.raises(RuntimeError, match="cuda"):
        train_lm.main(["--layers", "1", "--d-model", "64", "--steps", "1"])
