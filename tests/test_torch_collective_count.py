"""The roofline's collective term: the sharded train step's collectives
counted (``train/sharded.CountingComm`` into ``op_cost.OpCount.coll``),
priced by ``launch/roofline.roofline_terms`` over ``LINK_BW``, and carried by
the dry-run's ``per_rank`` records (``--train-act-model-sharded``), beside
the ``even`` records that keep ``collective_s: None`` and say why. The
bytes the real communicator hands to gloo are held equal to this count in
tests/test_torch_train_sharded.py."""
import json

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import runtime
from repro_torch.launch import dryrun, op_cost, reanalyze, roofline, sharding, specs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.train import sharded as SH

MESH = Mesh(("data", "model"), (2, 2))


@pytest.fixture
def smoke(monkeypatch):
    """``configs.get`` gives the smoke configs and train_4k is 256 sequences
    of 128 tokens (on MESH: W = 2 workers of 128 rows, 64 a model rank)."""
    monkeypatch.setattr(specs.configs, "get", configs.get_smoke)
    monkeypatch.setitem(specs.SHAPES, "train_4k", dict(kind="train", seq=128, global_batch=256))


def test_counting_comm_charges_the_count_and_calls_nothing():
    comm = SH.CountingComm()
    out = torch.empty(6, device="meta")
    with op_cost.counting() as c:
        comm.all_gather(torch.empty(24, device="meta"), out)
        comm.reduce_scatter(out, torch.empty(24, device="meta"))
        comm.all_reduce(torch.empty(3, dtype=torch.float64, device="meta"))
    assert dict(c.coll) == {"all-gather": 96, "reduce-scatter": 24, "all-reduce": 24} == dict(comm.bytes)
    assert c.total_bytes == 0 and c.total_coll == 144 and c.calls["all-gather"] == 1
    assert not runtime.COUNTS  # nothing left open
    snap = c.snapshot()
    comm.all_reduce(torch.empty(2, device="meta"))  # no count open: tallied, not charged
    assert c.since(snap)[3] == {} and comm.bytes["all-reduce"] == 32
    c.add(({}, {}, {}, {"all-reduce": 8}))
    assert c.coll["all-reduce"] == 32


def test_roofline_prices_collectives_over_nvlink():
    t = roofline.roofline_terms(989.4e12, 3.35e12, 900e9)
    assert t["compute_s"] == pytest.approx(1.0) and t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(2.0) and t["dominant"] == "collective_s"
    assert roofline.LINK_BW == 450e9
    assert roofline.roofline_terms(1.0, 2.0)["collective_s"] is None


def test_per_rank_count_of_the_act_sharded_step(smoke):
    """One rank of MESH: the dot FLOPs times the mesh's devices are the even
    split's global count, and the collectives are the step's: a
    reduce-scatter of the rank's slice, the W + 1 scalars and the drift, the
    gathers of x^{t+1} and of the delta (a compressed perm round)."""
    even = specs.build("gemma3-1b", "train_4k", MESH)
    act = specs.build("gemma3-1b", "train_4k", MESH, train_act_model_sharded=True)
    assert even.meta["split"] == "even" and act.meta["split"] == "per_rank"
    assert act.meta["act_spec"] == ("model", None, None)
    ce, ca = (dryrun.count("train", b.fn, *b.args) for b in (even, act))
    assert ca.total_flops * MESH.size == ce.total_flops > 0
    lay = act.meta["layout"]
    W = lay.n_workers
    assert lay.d == sum(P.leaf_sizes(lm.lm_spec(configs.get_smoke("gemma3-1b"))))
    assert dict(ca.coll) == {"reduce-scatter": 4 * lay.shard_len, "all-reduce": 4 * (W + 1) + 4,
                             "all-gather": 2 * 4 * lay.padded} == dict(act.meta["comm"].bytes)
    assert not ce.coll
    state = act.args[0]
    assert state["server"].shape == (lay.shard_len,) and state["workers"].shape == (lay.local, lay.d)


def test_dry_run_records_of_both_splits(smoke, tmp_path):
    """run_one: the per_rank record carries the collective bytes by kind, a
    collective term and both layouts' state bytes; the even record keeps
    collective_s None and says why; reanalyze gives both back; the file of
    the act-sharded count is tagged ``__act``."""
    dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--out", str(tmp_path)])
    dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--train-act-model-sharded",
                 "--out", str(tmp_path)])
    even = json.loads((tmp_path / "gemma3-1b__train_4k__16x16.json").read_text())
    act = json.loads((tmp_path / "gemma3-1b__train_4k__16x16__act.json").read_text())
    assert dryrun.record_problems(even) == [] and dryrun.record_problems(act) == []
    assert even["split"] == "even" and even["roofline"]["collective_s"] is None
    assert "tensor parallelism" in even["collective_note"] and even["collective_bytes_per_device"] is None
    assert act["split"] == "per_rank" and act["act_spec"] == ["model", None, None]
    coll = act["collective_bytes_per_device"]
    assert set(coll) == {"all-gather", "reduce-scatter", "all-reduce"} and min(coll.values()) > 0
    assert act["collective_total_per_device"] == sum(coll.values())
    assert act["roofline"]["collective_s"] == pytest.approx(sum(coll.values()) / roofline.LINK_BW)
    assert act["flops_per_device"] * 256 == even["flops_global"]
    sb = act["state_bytes_per_device"]
    assert sb["flat_zero1"] > 0 and sb["param_specs"] > 0
    out = tmp_path / "again"
    recs = reanalyze.reanalyze(str(tmp_path), str(out))
    assert sorted(r["split"] for r in recs) == ["even", "per_rank"]
    for name in ("gemma3-1b__train_4k__16x16.json", "gemma3-1b__train_4k__16x16__act.json"):
        assert json.loads((out / name).read_text()) == json.loads((tmp_path / name).read_text())


def test_state_bytes_of_both_layouts(smoke):
    """The rank's flat ZeRO-1 slices hold 1/(D·M) of the master and the
    moments (rounded up); its replica rows are whole, where the reference's
    worker layout also cuts their inner dims over "model"."""
    act = specs.build("gemma3-1b", "train_4k", MESH, train_act_model_sharded=True)
    lay, sb = act.meta["layout"], dryrun.state_bytes_per_device(act)
    assert sb["flat_zero1"] == 3 * 4 * lay.shard_len + lay.local * lay.d * 2  # fp32 x 3, bf16 rows
    tree = lm.lm_spec(act.meta["cfg"])
    server = sum(sharding.local_numel(leaf.shape, spec, MESH) for leaf, (_, spec) in
                 zip(P.leaves(tree), sharding.spec_leaves(act.specs[0]["server"])))
    assert lay.shard_len <= server
    assert sb["param_specs"] >= 3 * 4 * server


def test_local_numel():
    mesh = Mesh(("data", "model"), (4, 2))
    assert sharding.local_numel((8, 6), sharding.Spec("data", "model"), mesh) == 2 * 3
    assert sharding.local_numel((8, 6), sharding.Spec(("data", "model")), mesh) == 6
    assert sharding.local_numel((9, 6), sharding.Spec("data"), mesh) == 3 * 6
    assert sharding.local_numel((9,), sharding.Spec(), mesh) == 9


@pytest.mark.parametrize("arch,shape,match", [("deepseek-v2-236b", "train_4k", "experts"),
                                              ("gemma-2b", "tp", "tensor parallelism")])
def test_build_refuses_what_is_not_ported(smoke, monkeypatch, arch, shape, match):
    """act_spec with experts; a batch that does not split over "model" (the
    reference drops act_spec and runs tensor parallelism)."""
    if shape == "tp":
        monkeypatch.setitem(specs.SHAPES, "tp", dict(kind="train", seq=64, global_batch=6))
    with pytest.raises(ValueError, match=match):
        specs.build(arch, shape, MESH, train_act_model_sharded=True)


def test_full_width_act_sharded_dry_run(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch gemma3-1b --shape
    train_4k --train-act-model-sharded`` on the 16x16 mesh, counted on
    meta: a per_rank record with a collective term."""
    dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--train-act-model-sharded",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "gemma3-1b__train_4k__16x16__act.json").read_text())
    assert dryrun.record_problems(rec) == [] and rec["split"] == "per_rank"
    assert rec["chips"] == 256 and make_production_mesh().size == 256
    assert rec["roofline"]["collective_s"] > 0
    d = configs.get("gemma3-1b").param_count()
    c = -(-d // 256)
    assert rec["collective_bytes_per_device"] == {"all-gather": 2 * 4 * 256 * c, "reduce-scatter": 4 * c,
                                                  "all-reduce": 4 * 17 + 4}
