"""The sharded train step on the multi-pod mesh ("pod", "data", "model"):
the workers and the server's ZeRO-1 slices over the flattened ("pod",
"data") axes (the reference's ``dp_axes_of`` / ``worker_axis_of``), "model"
as tensor parallelism as on ("data", "model").

Four gloo ranks (``tests/torch_ranks.py``, part ``multipod``, the smoke
gemma-2b, W = 4) on (2, 1, 2) (tensor parallelism over "model") and (2, 2,
1) (four data indices): 3 teacher-forced steps of marina:perm (bf16
replicas) and ef21p (a forced sync) against the single process within
``sharded_check``'s bounds (ACT_BOUNDS or 1.5x ``OneRank``'s floor where
"model" splits, DATA_BOUNDS where it does not), the bytes handed to gloo
equal to the dry-run's count of the same step each step. And the
reference's program on a 4-device CPU mesh of the same axes
(``reference_case``) at (2, 1, 2).

In this process: the multi-pod layout is ("data", "model") with the data
axes flattened, pod major; ``specs.train_refusal`` admits every full config
on 2x16x16 and wk4x4x16, and ``specs.build``'s train_4k step there is one
rank's (``per_rank``) for all ten.
"""
import pytest

import torch_ranks as R
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh, make_hierarchical_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.train import sharded as SH
from repro_torch.train import sharded_check as SC
from test_torch_train_sharded import reference_case


def _smoke(arch="gemma-2b"):
    cfg = configs.get_smoke(arch)
    return cfg, lm.lm_spec(cfg), sum(P.leaf_sizes(lm.lm_spec(cfg)))


@pytest.fixture(scope="module")
def multipod(tmp_path_factory):
    return R.run(tmp_path_factory.mktemp("multipod"), "multipod", "gemma-2b", R.TIMEOUT["multipod"])


@pytest.mark.parametrize("shape", R.MULTIPOD_MESHES, ids=["2x1x2", "2x2x1"])
@pytest.mark.parametrize("name", [c[0] for c in R.CASES])
def test_multipod_steps_against_single_process(multipod, name, shape):
    R.check_case(multipod, (name, shape), SC.bounds(shape[2] > 1), 4)


def test_against_the_reference_multipod_program(tmp_path):
    """The reference's ``worker``-layout step on (pod, data, model) = (2, 1,
    2) of 4 CPU devices (workers over the flattened ("pod", "data"), tensor
    parallelism over "model"), marina:perm, one step from its state, against
    the port's."""
    reference_case(tmp_path, "marina:perm", False, mesh="pod,data,model:2x1x2")


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 1, 2), (2, 2, 1), (2, 16, 16)])
def test_multipod_layout_is_the_flattened_data_axis(shape):
    """("pod", "data", "model") is ("data", "model") with the data axes
    flattened, pod major: the same blocks, workers, slices and rows."""
    cfg, tree, d = _smoke()
    P_, D_, M = shape
    for rank in (0, shape[0] * shape[1] * M - 1):
        pod = SH.make_layout(Mesh(("pod", "data", "model"), shape), rank, 2 * P_ * D_, d, cfg)
        flat = SH.make_layout(Mesh(("data", "model"), (P_ * D_, M)), rank, 2 * P_ * D_, d, cfg)
        assert not pod.hier and pod.slice_axis == "data" and pod.fsdp is None
        for k in ("coords", "local", "off", "slices", "slice_index", "shard_len", "d_local", "d_rank", "tp"):
            assert getattr(pod, k) == getattr(flat, k), k
        assert pod.blocks == flat.blocks and pod.rank_blocks == flat.blocks


@pytest.mark.parametrize("arch", list(configs.ALIASES))
def test_full_configs_train_per_rank_on_both_meshes(arch):
    """``train_refusal`` admits every full config on 2x16x16 and wk4x4x16,
    and the dry-run's train_4k step there is rank 0's (``per_rank``): on the
    hierarchical mesh with the rank's replica blocks over "data" too."""
    for mesh in (make_production_mesh(multi_pod=True), make_hierarchical_mesh(4)):
        cfg = configs.get(arch)
        assert specs.train_refusal(cfg, mesh) is None
        built = specs.build(arch, "train_4k", mesh)
        layout = built.meta["layout"]
        assert built.meta["split"] == "per_rank" and "even_note" not in built.meta
        assert layout.n_workers == (32 if "pod" in mesh.axis_names else 4) and layout.tp
        if layout.hier:
            assert layout.d_rank < layout.d_local < layout.d and layout.local == 1
            assert built.args[0]["workers"].shape == (1, layout.d_rank)
