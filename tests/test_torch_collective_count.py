"""The roofline's collective term: the sharded train and serving steps'
collectives counted (``launch/comm.CountingComm`` into
``op_cost.OpCount.coll``), priced by ``launch/roofline.roofline_terms`` over
``LINK_BW``, and carried by the dry-run's ``per_rank`` records (a train shape
with ``--train-act-model-sharded``; the serving shapes of the dense, vlm and
audio families), beside the ``even`` records that keep ``collective_s:
None`` and say why. The bytes the real communicator hands to gloo are held
equal to this count in tests/test_torch_train_sharded.py and
tests/test_torch_serve_sharded.py."""
import json

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import runtime
from repro_torch import roofline_report
from repro_torch.launch import dryrun, op_cost, reanalyze, roofline, sharding, specs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.serve import sharded as SS
from repro_torch.train import sharded as SH

MESH = Mesh(("data", "model"), (2, 2))


@pytest.fixture
def smoke(monkeypatch):
    """``configs.get`` gives the smoke configs, train_4k is 256 sequences
    of 128 tokens (on MESH: W = 2 workers of 128 rows, 64 a model rank),
    the serving shapes 4 sequences of 64 (decode_32k: 32; long_500k: 1 of
    256)."""
    monkeypatch.setattr(specs.configs, "get", configs.get_smoke)
    monkeypatch.setitem(specs.SHAPES, "train_4k", dict(kind="train", seq=128, global_batch=256))
    monkeypatch.setitem(specs.SHAPES, "prefill_32k", dict(kind="prefill", seq=64, global_batch=4))
    monkeypatch.setitem(specs.SHAPES, "decode_32k", dict(kind="decode", seq=64, global_batch=32))
    monkeypatch.setitem(specs.SHAPES, "long_500k", dict(kind="decode", seq=256, global_batch=1))


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


# ---------------------------------------------------------------------------
# the sharded serving step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "musicgen-large", "starcoder2-7b"])
def test_per_rank_serve_flops_against_the_even_count(smoke, monkeypatch, arch, shape):
    """Rank 0's dot FLOPs times the mesh's devices are the even count's
    plus what the ranks compute more than once: on MESH (M = 2), gemma3's
    one kv head is cut, so wk and wv are gathered and their products
    computed M times (2 x 2 T D kv_dim a layer, T tokens, one more time);
    musicgen (4 kv heads) and starcoder2 (2) split whole heads: no gap."""
    per_rank = specs.build(arch, shape, MESH)
    monkeypatch.setattr(specs, "serving_refusal", lambda *a: "counted whole for the comparison")
    even = specs.build(arch, shape, MESH)
    assert per_rank.meta["split"] == "per_rank" and even.meta["split"] == "even"
    cr, ce = (dryrun.count(b.meta["kind"], b.fn, *b.args) for b in (per_rank, even))
    cfg = configs.get_smoke(arch)
    info = specs.SHAPES[shape]
    T = info["global_batch"] * (info["seq"] if info["kind"] == "prefill" else 1)  # rows: B % D == 0
    M = MESH.shape["model"]
    heads = SS.attention_heads(cfg, per_rank.meta["layout"])
    gap = (M - 1) * 2 * 2 * T * cfg.d_model * cfg.kv_dim * cfg.num_layers if heads.kv_whole else 0
    assert (arch == "gemma3-1b") == (gap > 0)
    assert cr.total_flops * MESH.size == ce.total_flops + gap
    assert not ce.coll and set(cr.coll) == {"all-gather", "all-reduce"}


def test_serve_dry_run_records(smoke, tmp_path):
    """On 16x16, the ported families' serving shapes give per_rank records
    with a collective term and the rank's parameter (and cache) bytes;
    rwkv6 (ssm) keeps the even split and says why, as does gemma3's smoke
    long_500k, whose 16-slot local ring cache_specs splits on the head dim."""
    for arch in ("minitron-4b", "rwkv6-1.6b"):
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            dryrun.main(["--arch", arch, "--shape", shape, "--serve-layout", "tp", "--out", str(tmp_path)])
    dryrun.main(["--arch", "gemma3-1b", "--shape", "long_500k", "--out", str(tmp_path / "gemma3")])
    rec = json.loads((tmp_path / "gemma3" / "gemma3-1b__long_500k__16x16.json").read_text())
    assert rec["split"] == "even" and "cache_specs splits a cache of shape" in rec["collective_note"]
    assert "family" not in rec["collective_note"]
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        rec = json.loads((tmp_path / f"minitron-4b__{shape}__16x16.json").read_text())
        assert dryrun.record_problems(rec) == [] and rec["split"] == "per_rank"
        assert rec["serve_layout"] == "tp" and rec["roofline"]["collective_s"] > 0
        assert rec["collective_total_per_device"] == sum(rec["collective_bytes_per_device"].values())
        sb = rec["state_bytes_per_device"]
        assert sb["params"]["port"] == 3 * sb["params"]["param_specs"] > 0
        assert ("caches" in sb) == (shape != "prefill_32k")
        even = json.loads((tmp_path / f"rwkv6-1.6b__{shape}__16x16.json").read_text())
        assert even["split"] == "even" and even["roofline"]["collective_s"] is None
        assert "(ssm): serving across a process group is not ported for the ssm family" in even["collective_note"]
        assert "moe" not in even["collective_note"] and "cache_specs" not in even["collective_note"]
        assert dryrun.record_problems(even) == []
    recs = reanalyze.reanalyze(str(tmp_path), str(tmp_path / "again"))
    assert sorted({r["split"] for r in recs}) == ["even", "per_rank"]
    for r in recs:
        assert json.loads((tmp_path / "again" / f"{r['arch']}__{r['shape']}__16x16.json").read_text()) == \
            json.loads((tmp_path / f"{r['arch']}__{r['shape']}__16x16.json").read_text())
    table = roofline_report.markdown_table(recs)
    assert "| split |" in table and "per_rank" in table and "collective_s" in table


def test_even_records_name_their_own_reason(smoke):
    """Each even record's note names what is not ported for its own step
    (from ``specs.build``'s ``even_note``), and nothing else."""
    train = dryrun.run_one("gemma3-1b", "train_4k", verbose=False)
    moe = dryrun.run_one("deepseek-v2-236b", "decode_32k", verbose=False)
    assert train["split"] == moe["split"] == "even"
    assert train["collective_note"] == dryrun.EVEN_NOTE + specs.build("gemma3-1b", "train_4k", MESH).meta["even_note"]
    assert "the train step's tensor parallelism over 'model'" in train["collective_note"]
    assert "serving" not in train["collective_note"]
    assert f"not ported for the moe family ({SS.NOT_PORTED['moe']})" in moe["collective_note"]
    assert "tensor parallelism" not in moe["collective_note"] and "ssm" not in moe["collective_note"]


def test_full_width_serve_counts():
    """gemma3-1b's decode_32k on 16x16, one rank counted on meta under
    serve and tp: the weights gathered over "data" (serve only) and over
    "model" where the heads are cut, the partial sums of B / 16 = 8 rows.
    chip_smoke.py (x3) holds the card's count to the same numbers."""
    for layout, coll in (("serve", {"all-gather": 254974464.0, "reduce-scatter": 0.0, "all-reduce": 1935360.0}),
                         ("tp", {"all-gather": 92012544.0, "reduce-scatter": 0.0, "all-reduce": 1935360.0})):
        rec = dryrun.run_one("gemma3-1b", "decode_32k", serve_layout=layout, verbose=False)
        assert rec["split"] == "per_rank" and rec["collective_bytes_per_device"] == coll
        assert dryrun.record_problems(rec) == []
    # 8 rows x 1152 values in fp32, two row-parallel sums a layer, and the embedding's bf16 sum
    assert coll["all-reduce"] == 8 * 1152 * (4 * 2 * 26 + 2)
    # 2x16x16: the data axes ("pod", "data") flattened, 4 rows a rank, the same gathered weights
    rec = dryrun.run_one("gemma3-1b", "decode_32k", multi_pod=True, verbose=False)
    assert rec["split"] == "per_rank" and rec["chips"] == 512 and dryrun.record_problems(rec) == []
    assert rec["collective_bytes_per_device"] == {"all-gather": 254974464.0, "reduce-scatter": 0.0,
                                                  "all-reduce": 1935360.0 / 2}
