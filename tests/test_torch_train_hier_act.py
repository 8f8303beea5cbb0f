"""``act_spec`` on the hierarchical mesh ("wk", "data", "model"): the
reference's ``build`` sets ``act_spec = P("model", None, None)`` wherever a
worker's rows split over "model", and its ``train_batch_spec`` also splits
them over "data" there, so each worker's B rows lie over its D·M ranks,
block ``fsdp_index * M + model_index``. The state keeps the hierarchical
layout (each replica row the rank's "data" block of its model-local
blocks, the ZeRO-1 slices over "dp"); a rank gathers its row over "data"
and "model" into [d], runs the whole weights on its rows, and sends its
gradient back by a reduce-scatter over "model" (block order) and one over
"dp", scaled by 1/(W·D·M).

Four gloo ranks (``tests/torch_ranks.py``, part ``hier_act``, the smoke
gemma-2b and deepseek-v2): each of ``HIER_ACT_CASES`` on (1, 2, 2) and (2,
1, 2), 3 teacher-forced steps against the single process within
``sharded_check.ACT_BOUNDS`` or 1.5x the run's own floor (the single process
with each worker's rows in the ranks' blocks, ``sharded_check.row_blocks``),
the bytes handed to gloo equal to the dry-run's count each step, EF21-P's
shift a ``shard_len`` slice at rest; deepseek-v2's expert ids, kept copies
and capacity of every moe call equal to the single process's, at the
config's capacity factor and at ``LOW_CF`` (copies drop). And the
reference's ``act_spec`` program on 4 CPU devices of the same axes
(``reference_case``): marina:perm on (1, 2, 2) with W = 1, ef21p on (2, 1,
2) with W = 2.

In this process: the rank's row block and batch rows, and the refusal of a
batch whose rows a worker's D·M ranks do not divide.
"""
import pytest
import torch

import torch_ranks as R
from repro_torch import configs
from repro_torch.data import batch_specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import TrainerConfig, make_downlink
from repro_torch.train import sharded as SH
from repro_torch.train import sharded_check as SC
from test_torch_train_sharded import reference_case

ARCHS = ("gemma-2b", "deepseek-v2-236b")


@pytest.fixture(scope="module")
def hier_act(tmp_path_factory):
    """Both architectures in one four-rank subprocess: {arch: each rank's report}."""
    report = R.run(tmp_path_factory.mktemp("hier_act"), "hier_act", ",".join(ARCHS), R.TIMEOUT["hier_act"])
    return lambda arch: [rep[arch] for rep in report]


@pytest.mark.parametrize("case", R.HIER_ACT_CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[4]))}" for c in R.HIER_ACT_CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_act_steps_against_single_process(hier_act, arch, case):
    """3 teacher-forced steps on every rank; EF21-P's shift at rest is the
    rank's slice of its model-local vector (``shard_len`` values)."""
    report = hier_act(arch)
    key = (case[0], case[4])
    R.check_case(report, key, SC.ACT_BOUNDS, case[5])
    for rep in report:
        res = rep[key]
        assert res["shift_bytes"] == (res["shard_len"] * 4 if case[1].startswith("ef21p") else None)
    if case[0].endswith("W2"):  # the compressed perm rounds ran the two-level block map on every rank
        assert all(rep[key]["two_level"] > 0 for rep in report)


@pytest.mark.parametrize("cf", [None, R.LOW_CF], ids=["config_cf", "low_cf"])
@pytest.mark.parametrize("shape", sorted({c[4] for c in R.HIER_ACT_CASES}), ids=lambda s: "x".join(map(str, s)))
def test_routes_are_the_single_process_routes(hier_act, shape, cf):
    """deepseek-v2: the row blocks' expert ids, kept copies and capacity, put
    together in block order, equal the single process's in every moe call
    of the step (each rank's rows at its worker's capacity, the copies'
    positions from the [E] counts gathered over the worker's D·M ranks);
    copies drop at the low capacity factor and none at the config's."""
    res = hier_act("deepseek-v2-236b")[0][("routes", shape, cf)]
    print(f"{shape} capacity factor {cf or 'of the config'}: {res['calls']} moe calls, equal to the single "
          f"process's: {res['equal']}; {res['dropped']} of {res['copies']} routed copies dropped")
    assert res["calls"] > 0 and res["equal"]
    assert (res["dropped"] > 0) == (cf is not None)


@pytest.mark.parametrize("spec,mesh,W", [("marina:perm", "wk,data,model:1x2x2", 1),
                                         ("ef21p:16:64", "wk,data,model:2x1x2", 2)])
def test_against_the_reference_act_program(tmp_path, spec, mesh, W):
    """The reference's act_spec program on the hierarchical mesh (XLA on 4
    CPU devices), one step from its state, against the port's step on 4
    gloo ranks from the same state, batch and draws: 4 rows a worker, so
    that they split over (data, model) on both meshes."""
    reference_case(tmp_path, spec, True, mesh=mesh, W=W, rows=4)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


def test_row_blocks_data_major():
    """On (2, 2, 2) with act_spec every rank of a worker holds one of its D·M
    = 4 row blocks, block ``fsdp_index * M + model_index``: the worker's rows
    in rank order, each once."""
    cfg = configs.get_smoke("gemma-2b")
    d = sum(P.leaf_sizes(lm.lm_spec(cfg)))
    mesh = Mesh(("wk", "data", "model"), (2, 2, 2))
    tcfg = TrainerConfig(n_workers=2, attn_chunk=32, act_spec=SH.ACT_SPEC)
    batch = {"tokens": torch.arange(2 * 8 * 3).reshape(2, 8, 3)}
    for wk in range(2):
        got = []
        for r in range(4):
            lay = SH.make_layout(mesh, wk * 4 + r, 2, d, cfg, act=True)
            SH.check_mode(cfg, tcfg, lay)
            assert (lay.row_split, lay.row_axis, lay.blocked, lay.tp) == (4, "worker", True, False)
            assert lay.row_block == lay.fsdp_index * 2 + lay.coords[1] == r
            plain = SH.make_layout(mesh, wk * 4 + r, 2, d, cfg)  # without act_spec: the "data" block
            assert (plain.row_split, plain.row_block, plain.row_axis, plain.tp) == (2, lay.fsdp_index, "data", True)
            got.append(lay.local_batch(batch)["tokens"])
        assert torch.equal(torch.cat(got, 1), batch["tokens"][wk:wk + 1])


def test_rows_that_do_not_split_over_data_and_model_are_refused():
    """6 rows a worker over (data, model) = (2, 2): the step names both sizes."""
    cfg = configs.get_smoke("gemma-2b")
    d = sum(P.leaf_sizes(lm.lm_spec(cfg)))
    mesh = Mesh(("wk", "data", "model"), (1, 2, 2))
    tcfg = TrainerConfig(n_workers=1, attn_chunk=32, act_spec=SH.ACT_SPEC)
    dl, opt = make_downlink("marina:perm", 1), make_optimizer("adamw")
    lay = SH.make_layout(mesh, 0, 1, d, cfg, act=True)
    step = SH.make_sharded_train_step(cfg, tcfg, dl, opt, constant_lr(SC.LR), lay, SH.CountingComm())
    state = SH.init_state(cfg, tcfg, dl, opt, lay, device="meta")
    batch = {k: torch.empty(s.shape, dtype=s.dtype, device="meta") for k, s in batch_specs(cfg, 1, 6, 64).items()}
    with pytest.raises(ValueError, match=r"6 rows a worker do not split over 'data' x 'model' = 2 x 2"):
        step(state, batch)


def test_row_split_floor_is_the_bf16_gradient(monkeypatch):
    """Why act_spec on the hierarchical mesh has a floor of its own (the
    single process with each worker's rows in the ranks' blocks,
    ``sharded_check.row_blocks``): a block's weight gradient leaves the
    model in bf16 (the products and the embedding lookup read bf16 copies),
    rounded once a block, so 4 blocks of the smoke gemma-2b's rows move g by
    about 1e-2 of its largest value, most of it in the embedding's gradient;
    with the model computing in fp32 the same split moves g by fp32
    rounding alone."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import layers as L
    from repro_torch.train import trainer

    cfg = configs.get_smoke("gemma-2b")
    spec = lm.lm_spec(cfg)
    tcfg = TrainerConfig(n_workers=1, attn_chunk=32)
    x = trainer.init_state(cfg, tcfg, make_downlink("marina:perm", 1), make_optimizer("adamw"), device="cpu",
                           seed=1)["server"]
    rows = {k: v[0] for k, v in SyntheticLMData(cfg, 1, 4, 64, device="cpu").batch(0).items()}
    kw = dict(chunk=32, remat=True, window_override=None, remat_policy=None)

    def moved():
        _, whole = trainer.worker_value_and_grad(cfg, spec, kw, x, rows)
        with SC.row_blocks(4):
            _, blocks = trainer.worker_value_and_grad(cfg, spec, kw, x, rows)
        d = (blocks - whole).abs()
        return float(d.max() / whole.abs().max()), int(d.argmax())

    g, at = moved()
    embed = P.leaf_sizes(spec)[0]  # the first leaf in ravel order: the embedding table
    assert P.path_key(P.leaves_with_path(spec)[0][0]) == "embed"
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    g32, _ = moved()
    print(f"4 row blocks move g {g:.3g} (at coordinate {at}, the embedding's first {embed}); in fp32 {g32:.3g}")
    assert g > 1e-3 and at < embed and g32 < 1e-5
