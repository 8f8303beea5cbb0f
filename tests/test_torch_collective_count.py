"""The roofline's collective term: the sharded train and serving steps'
collectives counted (``launch/comm.CountingComm`` into
``op_cost.OpCount.coll``), priced by ``launch/roofline.roofline_terms`` over
``LINK_BW``, and carried by the dry-run's ``per_rank`` records (a train shape, with
tensor parallelism over "model" by default or with
``--train-act-model-sharded``; the serving shapes of every family, those
of the ssm and hybrid families at B = 1 aside), beside the ``even`` records that keep ``collective_s:
None`` and say why. The tensor-parallel train count is held equal to the
bytes 4 gloo ranks hand over in the same step here. The bytes the real communicator hands to gloo are held
equal to this count in tests/test_torch_train_sharded.py and
tests/test_torch_serve_sharded.py."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import runtime
from repro_torch import roofline_report
from repro_torch.launch import dryrun, op_cost, reanalyze, roofline, sharding, specs
from repro_torch.launch.mesh import Mesh, make_hierarchical_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.serve import sharded as SS
from repro_torch.train import sharded as SH

MESH = Mesh(("data", "model"), (2, 2))
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


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


def test_per_rank_count_of_the_act_sharded_step(smoke, monkeypatch):
    """One rank of MESH: the dot FLOPs times the mesh's devices are the even
    split's global count, and the collectives are the step's: a
    reduce-scatter of the rank's slice, the W + 1 scalars and the drift, the
    gathers of x^{t+1} and of the delta (a compressed perm round)."""
    act = specs.build("gemma3-1b", "train_4k", MESH, train_act_model_sharded=True)
    monkeypatch.setattr(specs, "train_refusal", lambda *a: "counted whole for the comparison")
    even = specs.build("gemma3-1b", "train_4k", MESH)
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


def test_dry_run_records_of_both_splits(smoke, tmp_path, monkeypatch):
    """run_one: the per_rank records (the default train count, tensor
    parallelism over "model", and the act-sharded one) carry the collective
    bytes by kind, a collective term and both layouts' state bytes; zamba2's
    smoke config on the multi-pod mesh, whose Mamba2 in_proj does not split
    over 'model' = 16, counts per rank too (read whole, entered into
    "model"); an even record, which no config gives any more (here a
    refusal put in ``specs.train_refusal``'s place), keeps collective_s None
    and says why; reanalyze gives all four back; the file of the
    act-sharded count is tagged ``__act``."""
    dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--out", str(tmp_path)])
    dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--train-act-model-sharded",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "zamba2-1.2b", "--shape", "train_4k", "--multi-pod", "--out", str(tmp_path)])
    with monkeypatch.context() as m:
        m.setattr(specs, "train_refusal", lambda cfg, mesh: "a step the port refuses (put in by the test)")
        dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k", "--multi-pod", "--out", str(tmp_path)])
    tp = json.loads((tmp_path / "gemma3-1b__train_4k__16x16.json").read_text())
    act = json.loads((tmp_path / "gemma3-1b__train_4k__16x16__act.json").read_text())
    whole = json.loads((tmp_path / "zamba2-1.2b__train_4k__2x16x16.json").read_text())
    even = json.loads((tmp_path / "gemma-2b__train_4k__2x16x16.json").read_text())
    for rec in (tp, act, whole, even):
        assert dryrun.record_problems(rec) == []
    assert even["split"] == "even" and even["roofline"]["collective_s"] is None
    assert "a step the port refuses" in even["collective_note"]
    assert even["collective_bytes_per_device"] is None
    assert act["split"] == "per_rank" and act["act_spec"] == ["model", None, None] and not act["tensor_parallel"]
    assert tp["split"] == whole["split"] == "per_rank" and tp["act_spec"] is None and tp["tensor_parallel"]
    assert whole["tensor_parallel"] and whole["roofline"]["collective_s"] > 0
    for rec in (tp, act):
        coll = rec["collective_bytes_per_device"]
        assert set(coll) == {"all-gather", "reduce-scatter", "all-reduce"} and min(coll.values()) > 0
        assert rec["collective_total_per_device"] == sum(coll.values())
        assert rec["roofline"]["collective_s"] == pytest.approx(sum(coll.values()) / roofline.LINK_BW)
        sb = rec["state_bytes_per_device"]
        assert sb["flat_zero1"] > 0 and sb["param_specs"] > 0
    # tensor parallelism computes the cut heads on every rank: more FLOPs in all than the act-sharded step
    assert tp["flops_per_device"] > act["flops_per_device"]
    out = tmp_path / "again"
    recs = reanalyze.reanalyze(str(tmp_path), str(out))
    assert sorted(r["split"] for r in recs) == ["even", "per_rank", "per_rank", "per_rank"]
    for name in ("gemma3-1b__train_4k__16x16.json", "gemma3-1b__train_4k__16x16__act.json",
                 "zamba2-1.2b__train_4k__2x16x16.json", "gemma-2b__train_4k__2x16x16.json"):
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


@pytest.mark.parametrize("arch,shape,match", [("deepseek-v2-236b", "train_4k", "hierarchical"),
                                              ("gemma-2b", "tp", "tensor parallelism")])
def test_build_refuses_what_is_not_ported(smoke, monkeypatch, arch, shape, match):
    """act_spec on the hierarchical mesh, with experts too (act_spec with
    experts on ("data", "model") is ported: tests/test_torch_train_act_moe.py);
    a batch that does not split over "model" (the reference drops act_spec
    and runs tensor parallelism)."""
    if shape == "tp":
        monkeypatch.setitem(specs.SHAPES, "tp", dict(kind="train", seq=64, global_batch=6))
    mesh = make_hierarchical_mesh(4) if match == "hierarchical" else MESH
    with pytest.raises(ValueError, match=match):
        specs.build(arch, shape, mesh, train_act_model_sharded=True)


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


def test_serve_dry_run_records(smoke, tmp_path, monkeypatch):
    """On 16x16, the ported families' serving shapes give per_rank records
    with a collective term and the rank's parameter (and cache) bytes:
    minitron's three and rwkv6's (ssm) three, its long_500k too (at B = 1
    cache_specs splits its states' inner dims over "data": gathered before
    the step reads them), as does gemma3's smoke long_500k, whose 16-slot
    local ring cache_specs splits on the head dim; an even record (a
    refusal put in ``specs.serving_refusal``'s place for musicgen's) keeps
    collective_s None and says why, and reanalyze gives both kinds back."""
    for arch in ("minitron-4b", "rwkv6-1.6b"):
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            dryrun.main(["--arch", arch, "--shape", shape, "--serve-layout", "tp", "--out", str(tmp_path)])
    with monkeypatch.context() as m:
        m.setattr(specs, "serving_refusal", lambda *a: "a step the port refuses (put in by the test)")
        dryrun.main(["--arch", "musicgen-large", "--shape", "decode_32k", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "musicgen-large__decode_32k__16x16.json").read_text())
    assert rec["split"] == "even" and rec["roofline"]["collective_s"] is None
    assert "a step the port refuses" in rec["collective_note"]
    dryrun.main(["--arch", "gemma3-1b", "--shape", "long_500k", "--out", str(tmp_path / "gemma3")])
    rec = json.loads((tmp_path / "gemma3" / "gemma3-1b__long_500k__16x16.json").read_text())
    assert rec["split"] == "per_rank" and rec["roofline"]["collective_s"] > 0 and dryrun.record_problems(rec) == []
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        rec = json.loads((tmp_path / f"minitron-4b__{shape}__16x16.json").read_text())
        assert dryrun.record_problems(rec) == [] and rec["split"] == "per_rank"
        assert rec["serve_layout"] == "tp" and rec["roofline"]["collective_s"] > 0
        assert rec["collective_total_per_device"] == sum(rec["collective_bytes_per_device"].values())
        sb = rec["state_bytes_per_device"]
        assert sb["params"]["port"] == 3 * sb["params"]["param_specs"] > 0
        assert ("caches" in sb) == (shape != "prefill_32k")
        rw = json.loads((tmp_path / f"rwkv6-1.6b__{shape}__16x16.json").read_text())
        assert dryrun.record_problems(rw) == []
        assert rw["split"] == "per_rank" and rw["serve_layout"] == "tp"
        assert rw["roofline"]["collective_s"] > 0 and rw["collective_total_per_device"] > 0
    recs = reanalyze.reanalyze(str(tmp_path), str(tmp_path / "again"))
    assert sorted({r["split"] for r in recs}) == ["even", "per_rank"]
    for r in recs:
        assert json.loads((tmp_path / "again" / f"{r['arch']}__{r['shape']}__16x16.json").read_text()) == \
            json.loads((tmp_path / f"{r['arch']}__{r['shape']}__16x16.json").read_text())
    table = roofline_report.markdown_table(recs)
    assert "| split |" in table and "per_rank" in table and "collective_s" in table


def test_even_records_name_their_own_reason(smoke):
    """No dry-run record is even any more: every smoke config's step on
    16x16, 2x16x16 and wk4x4x16, train and serving shapes, is one rank of
    the sharded step (neither ``train_refusal`` nor ``serving_refusal``
    names anything), and the three that were even count per rank with a
    collective term: zamba2's long_500k serving step (its Mamba2 states,
    conv windows and shared-attention rings split at B = 1), its train step
    on wk4x4x16 (in_proj (128, 552) whole over 'model' = 16) and
    deepseek-v2's on 16x16 (4 experts over 'model' = 16: the router and the
    experts whole, the routed part alike on every rank). act_spec on the
    hierarchical mesh still raises rather than give an even record."""
    meshes = (make_production_mesh(), make_production_mesh(multi_pod=True), make_hierarchical_mesh(4))
    for arch in configs.ALIASES:
        cfg = configs.get_smoke(arch)
        for mesh in meshes:
            assert specs.train_refusal(cfg, mesh) is None, (arch, mesh.sizes)
            for shape in ("prefill_32k", "decode_32k", "long_500k"):
                info = specs.SHAPES[shape]
                window = specs.long_ctx_window(cfg) if shape == "long_500k" else None
                assert specs.serving_refusal(cfg, mesh, info["global_batch"], info["seq"], window,
                                             info["kind"]) is None, (arch, shape, mesh.sizes)
    train = dryrun.run_one("zamba2-1.2b", "train_4k", hierarchical_workers=4, verbose=False)
    hybrid = dryrun.run_one("zamba2-1.2b", "long_500k", verbose=False)
    moe = dryrun.run_one("deepseek-v2-236b", "train_4k", verbose=False)
    for rec in (train, hybrid, moe):
        assert rec["split"] == "per_rank" and rec["roofline"]["collective_s"] is not None, rec["collective_note"]
        assert dryrun.record_problems(rec) == [] and "even_note" not in specs.build(
            rec["arch"], rec["shape"], make_hierarchical_mesh(4) if rec is train else make_production_mesh()).meta
    assert hybrid["collective_bytes_per_device"]["all-gather"] > 0
    with pytest.raises(ValueError, match="act_spec on the hierarchical mesh is not ported"):
        dryrun.run_one("gemma-2b", "train_4k", hierarchical_workers=4, train_act_model_sharded=True, verbose=False)


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


def test_full_width_moe_serve_counts():
    """deepseek-v2-236b's decode_32k on 16x16, rank 0 counted on meta under
    serve and tp: 8 rows a data rank, 10 of the 160 experts a model rank.
    chip_smoke.py (x3) holds the card's count to the same numbers."""
    cfg = configs.get("deepseek-v2-236b")
    D, E, K, r, rd = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k, cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim
    n, moe_layers = 8, cfg.num_layers - 1
    # a layer: MLA's wo partial (fp32), then the dense MLP's (layer 0) or the routed copies' K·N·D (bf16) and
    # the shared experts' partial (fp32); and the embedding's bf16 sum
    all_reduce = n * D * 4 * 2 + moe_layers * (n * D * 4 + K * n * D * 2 + n * D * 4) + n * D * 2
    # read whole on every model rank: the router (bf16 [D, E]) and the latent's w_dkv / w_krope; and the
    # ranks' [E] int32 counts of routed copies gathered over "data"
    whole = moe_layers * (D * E * 2 + 16 * E * 4) + cfg.num_layers * D * (r + rd) * 2
    for layout, coll in (("serve", {"all-gather": 30522972160.0, "reduce-scatter": 0.0, "all-reduce": 48742400.0}),
                         ("tp", {"all-gather": 451164160.0, "reduce-scatter": 0.0, "all-reduce": 48742400.0})):
        rec = dryrun.run_one("deepseek-v2-236b", "decode_32k", serve_layout=layout, verbose=False)
        assert rec["split"] == "per_rank" and rec["collective_bytes_per_device"] == coll
        assert dryrun.record_problems(rec) == [] and rec["roofline"]["collective_s"] > 0
    assert coll["all-reduce"] == all_reduce and coll["all-gather"] == whole


def test_full_width_recurrent_serve_counts():
    """rwkv6-1.6b's and zamba2-1.2b's decode_32k on 16x16, rank 0 counted
    on meta under serve and tp: 8 rows a data rank; rwkv6's 2 heads of 32
    and zamba2's 4 Mamba2 heads of 64 (2 of its 32 attention heads) a model
    rank. chip_smoke.py (x3) holds the card's count to the same numbers."""
    rw, zb = configs.get("rwkv6-1.6b"), configs.get("zamba2-1.2b")
    n, D = 8, rw.d_model
    # rwkv6, a layer: the w_out and cm_v partials (fp32); gathered, the decay lora's tanh (fp32) and the gate
    rw_reduce = rw.num_layers * 2 * n * D * 4 + n * D * 2
    rw_gather = rw.num_layers * (n * rw.rwkv.decay_lora * 4 + n * D * 2)
    # zamba2: a Mamba2 layer's out_proj partial and its rows' sums of squares (fp32), a shared block's wo and w_out
    # partials (fp32); gathered, a Mamba2 layer's in_proj product (bf16) and conv_w (read whole, bf16)
    m, mamba = zb.mamba, sum(k == "mamba" for k in zb.block_pattern)
    d_inner = m.expand * D
    zb_reduce = mamba * (n * D * 4 + n * 4) + (zb.num_layers - mamba) * 2 * n * D * 4 + n * D * 2
    zb_gather = mamba * (n * (2 * d_inner + 2 * m.state_dim + d_inner // m.head_dim) * 2
                         + m.conv_width * (d_inner + 2 * m.state_dim) * 2)
    for arch, coll in (("rwkv6-1.6b", {"serve": {"all-gather": 200636416.0, "reduce-scatter": 0.0,
                                                 "all-reduce": 3178496.0},
                                       "tp": {"all-gather": 835584.0, "reduce-scatter": 0.0, "all-reduce": 3178496.0}}),
                       ("zamba2-1.2b", {"serve": {"all-gather": 175509504.0, "reduce-scatter": 0.0,
                                                  "all-reduce": 2917376.0},
                                        "tp": {"all-gather": 5373952.0, "reduce-scatter": 0.0,
                                               "all-reduce": 2917376.0}})):
        for layout, want in coll.items():
            rec = dryrun.run_one(arch, "decode_32k", serve_layout=layout, verbose=False)
            assert rec["split"] == "per_rank" and rec["collective_bytes_per_device"] == want
            assert dryrun.record_problems(rec) == [] and rec["roofline"]["collective_s"] > 0
        reduce, gather = (rw_reduce, rw_gather) if arch == "rwkv6-1.6b" else (zb_reduce, zb_gather)
        assert coll["tp"]["all-reduce"] == reduce and coll["tp"]["all-gather"] == gather


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama4-maverick-400b-a17b"])
def test_moe_serve_records_are_per_rank(arch, shape):
    """The moe family's serving records at full width on 16x16 are rank 0's
    count (experts over "model" on E, 160 / 16 and 128 / 16 a rank), with a
    collective term and no problem; long_500k's B = 1 splits the caches'
    sequence over "data" (prefill_32k, ~30 s a record here, is held the
    same way by chip_smoke.py (u0))."""
    rec = dryrun.run_one(arch, shape, verbose=False)
    assert rec["split"] == "per_rank" and dryrun.record_problems(rec) == []
    assert rec["roofline"]["collective_s"] > 0 and rec["collective_total_per_device"] > 0
    assert "caches" in rec["state_bytes_per_device"]


_MOE_SERVE_RANKS = textwrap.dedent(
    """
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def worker(rank, init, out):
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.launch import dryrun, specs
        from repro_torch.launch.mesh import Mesh
        from repro_torch.models import lm
        from repro_torch.serve import sharded as SS

        specs.configs.get = configs.get_smoke
        specs.SHAPES["prefill_32k"] = dict(kind="prefill", seq=16, global_batch=4)
        specs.SHAPES["decode_32k"] = dict(kind="decode", seq=32, global_batch=4)
        mesh = Mesh(("data", "model"), (2, 2))
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
        res = {"rank": rank}
        for arch in ("deepseek-v2-236b", "llama4-maverick-400b-a17b"):
            cfg = configs.get_smoke(arch)
            layout, comm = SS.connect(mesh, "serve")
            params = SS.init_params(cfg, layout, seed=0, device="cpu")
            g = torch.Generator().manual_seed(1)
            for shape in ("prefill_32k", "decode_32k"):
                built = specs.build(arch, shape, mesh)  # rank 0's step, counted on meta
                counted = dryrun.count(built.meta["kind"], built.fn, *built.args).coll
                info = specs.SHAPES[shape]
                B, S = info["global_batch"], info["seq"]
                before = dict(comm.bytes)
                if shape == "prefill_32k":
                    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)}
                    SS.make_prefill_step(cfg, layout, comm, chunk=8)(params, batch)
                else:
                    caches = SS.shard_caches(lm.cache_init(cfg, B, S, device="cpu"), cfg, layout)
                    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, dtype=torch.int32)
                    SS.make_decode_step(cfg, layout, comm, B, S)(params, caches, tok, torch.tensor(S - 1))
                moved = {k: float(v - before.get(k, 0)) for k, v in comm.bytes.items()}
                res[f"{arch}/{shape}"] = {"moved": moved, "counted": {k: float(v) for k, v in counted.items()},
                                          "split": built.meta["split"]}
        gathered = [None] * 4
        dist.all_gather_object(gathered, res)
        if rank == 0:
            json.dump(gathered, open(out, "w"))
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(worker, args=tuple(sys.argv[1:]), nprocs=4, join=True)
    """
)


def test_moe_serve_count_equals_the_bytes_handed_to_gloo(tmp_path):
    """The dry-run's serving count of the moe smoke configs on (2, 2) under
    serve (rank 0 of the sharded prefill and decode, counted on meta:
    ZeRO-3 gathers, the router and latent read whole, the copies' counts
    over "data", the routed outputs and row-parallel partials over "model")
    equals, kind by kind, the bytes each of 4 gloo ranks hands to its
    groups in the same steps."""
    script = tmp_path / "ranks.py"
    script.write_text(_MOE_SERVE_RANKS)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = tmp_path / "out.json"
    res = subprocess.run([sys.executable, str(script), f"file://{tmp_path / 'rdv'}", str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    ranks = json.loads(out.read_text())
    for r in ranks:
        for name, step in r.items():
            if name == "rank":
                continue
            print(f"rank {r['rank']} {name}: handed {step['moved']}, counted {step['counted']}")
            assert step["split"] == "per_rank" and step["moved"] == step["counted"], (r["rank"], name)
            assert step["moved"]["all-gather"] > 0 and step["moved"]["all-reduce"] > 0


# ---------------------------------------------------------------------------
# the train step's tensor parallelism over "model"
# ---------------------------------------------------------------------------

_TP_RANKS = textwrap.dedent(
    """
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def worker(rank, init, out):
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.data import SyntheticLMData
        from repro_torch.launch import dryrun, specs
        from repro_torch.launch.mesh import Mesh
        from repro_torch.train import downlink as D, sharded as SH

        specs.configs.get = configs.get_smoke
        specs.SHAPES["train_4k"] = dict(kind="train", seq=64, global_batch=8)
        mesh = Mesh(("data", "model"), (2, 2))
        built = specs.build("gemma3-1b", "train_4k", mesh)  # rank 0's step, counted on meta
        counted = dryrun.count("train", built.fn, *built.args).coll
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
        cfg = built.meta["cfg"]
        W, bpw = built.meta["W"], built.meta["bpw"]
        _, dl, tcfg, opt = specs.train_parts(cfg, W)
        layout, comm = SH.connect(mesh, W, built.meta["layout"].d, cfg=cfg)
        step = SH.make_sharded_train_step(cfg, tcfg, dl, opt, specs.train_lr(), layout, comm)
        state = SH.init_state(cfg, tcfg, dl, opt, layout, seed=0, device="cpu")
        rot = torch.randint(0, W, (len(built.args[2].rot),), generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
        step(state, SyntheticLMData(cfg, W, bpw, 64, device="cpu").batch(0), D.DownlinkDraws(rot=rot))
        res = {"rank": rank, "moved": dict(comm.bytes), "counted": {k: float(v) for k, v in counted.items()},
               "tp": layout.tp, "d_local": layout.d_local}
        gathered = [None] * 4
        dist.all_gather_object(gathered, res)
        if rank == 0:
            json.dump(gathered, open(out, "w"))
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(worker, args=tuple(sys.argv[1:]), nprocs=4, join=True)
    """
)


def test_tensor_parallel_train_count_equals_the_bytes_handed_to_gloo(tmp_path):
    """The default train count of the dry-run on (2, 2) (rank 0 of the
    tensor-parallel step of gemma3-1b's smoke config, counted on meta:
    forward, backward and recomputed collectives) equals, kind by kind, the
    bytes each of 4 gloo ranks hands to its groups in a compressed perm
    step at the same shapes."""
    script = tmp_path / "ranks.py"
    script.write_text(_TP_RANKS)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = tmp_path / "out.json"
    res = subprocess.run([sys.executable, str(script), f"file://{tmp_path / 'rdv'}", str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    ranks = json.loads(out.read_text())
    for r in ranks:
        print(f"rank {r['rank']}: handed {r['moved']}, counted {r['counted']}")
        assert r["tp"] and r["moved"] == r["counted"]
        assert set(r["moved"]) == {"all-gather", "reduce-scatter", "all-reduce"} and min(r["moved"].values()) > 0
