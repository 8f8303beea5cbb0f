"""``act_spec`` with experts in the sharded train step: each worker's rows
split over "model" route at the worker's whole capacity, each copy at its
global position (``models/moe.split_rows``, the [E] counts all-gathered over
"model"), so the same copies drop as in the worker's single call.

Four gloo ranks on (2, 2) under ``act_spec = Spec("model", None, None)``,
one subprocess (``tests/torch_ranks.py``, part ``act_moe``), for the
deepseek-v2 and llama4 smoke configs:

* every moe call of a step: the expert ids, the kept copies and the
  capacity of the ranks' row blocks put together equal the single
  process's, at the config's capacity factor (8: no copy drops) and at
  ``LOW_CF`` (1.0), where copies drop (the count is printed and held > 0);
* 3 teacher-forced steps each of ``ACT_CASES`` (marina:perm with bf16
  replicas, and at ``LOW_CF``) against the single process within
  ``sharded_check.ACT_BOUNDS``, the bytes handed to gloo equal to the
  dry-run's count each step.

And the reference's partitioned ``act_spec`` program (XLA on 4 CPU devices,
``test_torch_train_sharded.reference_case``) for deepseek-v2, whose bounds
are at least 1.5x the reference's own one-device distance and the port's
single process's (``own``), as for the other moe reference cases.

In this process: the reference's --train-act-model-sharded train_4k step of
the two moe configs on 16x16 is one rank of the act_spec step
(``per_rank``).
"""
import pytest

import torch_ranks as R
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import sharded as SH
from repro_torch.train import sharded_check as SC
from test_torch_train_sharded import reference_case

ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module")
def act_moe(tmp_path_factory):
    """Both architectures in one four-rank subprocess: {arch: each rank's report}."""
    report = R.run(tmp_path_factory.mktemp("act_moe"), "act_moe", ",".join(ARCHS), R.TIMEOUT["act_moe"])
    return lambda arch: [rep[arch] for rep in report]


@pytest.mark.parametrize("cf", [None, R.LOW_CF], ids=["config_cf", "low_cf"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routes_are_the_single_process_routes(act_moe, arch, cf):
    """The ranks' expert ids, kept copies and capacity, put together, equal
    the single process's in every moe call of the step; copies drop at the
    low capacity factor and none at the config's."""
    res = act_moe(arch)[0][("routes", cf)]
    print(f"{arch} capacity factor {cf or 'of the config'}: {res['calls']} moe calls, equal to the single "
          f"process's: {res['equal']}; {res['dropped']} of {res['copies']} routed copies dropped")
    assert res["calls"] > 0 and res["equal"]
    assert (res["dropped"] > 0) == (cf is not None)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", [c[0] for c in R.ACT_CASES])
def test_act_spec_steps_against_single_process(act_moe, arch, name):
    """3 teacher-forced steps within ACT_BOUNDS on every rank, the bytes
    handed to gloo equal to the dry-run's count."""
    R.check_case(act_moe(arch), (name, (2, 2)), SC.ACT_BOUNDS, 4)


def test_against_the_reference_act_spec_program(tmp_path):
    """The reference's act_spec program for deepseek-v2 on (2, 2), one step
    from its state, against the port's act_spec step on 4 gloo ranks."""
    reference_case(tmp_path, "marina:perm", True, "deepseek-v2-236b", own=True)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama4-maverick-400b-a17b"])
def test_act_spec_with_experts_is_per_rank(arch):
    """The reference's --train-act-model-sharded train_4k step of the two
    moe configs on 16x16 (16 rows a worker over "model" = 16) is one rank
    of the act_spec step: whole replicas, no blocks."""
    built = specs.build(arch, "train_4k", make_production_mesh(), train_act_model_sharded=True)
    assert built.meta["split"] == "per_rank" and built.meta["act_spec"] == SH.ACT_SPEC
    assert not built.meta["layout"].tp and built.meta["bpw"] % 16 == 0
