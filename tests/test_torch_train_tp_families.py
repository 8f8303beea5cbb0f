"""Tensor parallelism over "model" in the sharded LM train step for the moe,
ssm and hybrid families (``train/sharded.py`` with the rank's blocks, the
reference's ``worker`` layout): one backward per kind of use, wherever a rank
reads a replicated or gathered value only in part, or uses a gathered value
whole (``launch/comm.py``'s ``enter`` / ``exit`` / ``gather`` and the two
added here, ``gather_replicated`` and ``exit_enter``; the calls in
``models/moe.py``, ``models/ssm.py`` and MLA through
``serve/sharded.ServeShard``).

In this process: every family is admitted at (1, 2), (1, 4) and (2, 2) on
the smoke configs and on the full configs' 16x16 production mesh too (their
model-local sizes); a bf16 replica differentiates as the fp32 row of its
values; the dry-run's train_4k records of the four architectures are
``per_rank``. What stays refused (a product's weight that "model" does
not split, ``act_spec`` on the hierarchical mesh) is held in
tests/test_torch_train_tp.py, tests/test_torch_train_sharded.py and the
serving tests of these families; ``act_spec`` with experts runs in
tests/test_torch_train_act_moe.py.

Four gloo ranks, one subprocess a part and an architecture, each in a file
of its own (tests/test_torch_tp_deepseek.py, _llama4, _rwkv6, _zamba2,
through tests/torch_ranks.py): the two new backwards against finite
differences, each leaf's gradient at (1, 2) and (1, 4) against the single
process for the four smoke configs, and 3 teacher-forced steps at (1, 4)
and (2, 2) of deepseek-v2, rwkv6 and zamba2.

The reference: its partitioned ``worker``-layout step (XLA on 4 CPU
devices, ``test_torch_train_sharded.reference_case``) against the port's
tensor-parallel step on (2, 2) for llama4 (moe) and rwkv6 (ssm).
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.data import SyntheticLMData
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import TrainerConfig, make_downlink, trainer
from repro_torch.train import sharded as SH
from repro_torch.train import sharded_check as SC

from test_torch_train_sharded import reference_case

MOE = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
RECURRENT = ("rwkv6-1.6b", "zamba2-1.2b")
ARCHS = MOE + RECURRENT
# the full configs' model-local values a rank holds on the 16x16 production mesh
D_LOCAL_16 = {"deepseek-v2-236b": 15_035_253_760, "llama4-maverick-400b-a17b": 24_856_212_480,
              "rwkv6-1.6b": 99_503_616, "zamba2-1.2b": 63_882_240}


def _layout(cfg, shape, rank=0, W=2):
    mesh = Mesh(("data", "model"), shape)
    return SH.Layout(mesh, rank, W, sum(P.leaf_sizes(lm.lm_spec(cfg))), SH.model_blocks(cfg, mesh, rank))


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_is_admitted(arch, shape):
    """The train step's tensor parallelism builds for the moe, ssm and
    hybrid smoke configs on every rank of the mesh; each rank holds less
    than the whole model, and the ranks' blocks of a split leaf tile it."""
    cfg = configs.get_smoke(arch)
    d = sum(P.leaf_sizes(lm.lm_spec(cfg)))
    tcfg = TrainerConfig(n_workers=2, attn_chunk=32)
    M = shape[1]
    for rank in range(shape[0] * M):
        layout = _layout(cfg, shape, rank)
        SH.check_tensor_parallel(cfg, layout)
        SH.make_sharded_train_step(cfg, tcfg, make_downlink("marina:perm", 2), make_optimizer("adamw"),
                                   constant_lr(SC.LR), layout, SH.CountingComm())
        assert layout.d_local < d
        split = [b for b in layout.blocks if b.chunk != b.stride]
        assert split and all(b.size * M == b.size // b.chunk * b.stride for b in split)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_split_on_the_production_mesh(arch):
    """Every product's weight of the full config splits over "model" on the
    16x16 production mesh, (1, 4) and (2, 2), so ``train_refusal`` admits
    them; a rank's model-local vector on 16x16 is D_LOCAL_16."""
    cfg = configs.get(arch)
    d = sum(P.leaf_sizes(lm.lm_spec(cfg)))
    for mesh in (make_production_mesh(), Mesh(("data", "model"), (1, 4)), Mesh(("data", "model"), (2, 2))):
        layout = SH.Layout(mesh, 0, mesh.shape["data"], d, SH.model_blocks(cfg, mesh, 0))
        SH.check_tensor_parallel(cfg, layout)
        assert specs.train_refusal(cfg, mesh) is None
        if mesh.size == 256:
            assert layout.d_local == D_LOCAL_16[arch]
            print(f"{arch}: d {d:,}, d_local on 16x16 {layout.d_local:,} ({layout.d_local / d:.4f} of d)")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_replicas_differentiate(arch):
    """A worker's loss and gradient at a bf16 replica (MARINA-P's
    ``weight_dtype`` bf16, which the dry-run's count and (w2) use) equal
    those at the fp32 row of the same values: the single process reads the
    leaves raw and promotes as jnp does (rwkv6's fp32 lora tanh times a bf16
    ``w_lora_b``: fp32), so only the gradient's last rounding to bf16
    differs."""
    cfg = configs.get_smoke(arch)
    spec = lm.lm_spec(cfg)
    row = lm.lm_init(cfg, device="cpu", seed=1).flat.detach().bfloat16()
    batch = {k: v[0] for k, v in SyntheticLMData(cfg, 1, 2, 64, device="cpu").batch(0).items()}
    kw = dict(chunk=32, remat=True, window_override=None, remat_policy=None)
    l16, g16 = trainer.worker_value_and_grad(cfg, spec, kw, row, batch)
    l32, g32 = trainer.worker_value_and_grad(cfg, spec, kw, row.float(), batch)
    assert float(l16) == float(l32)
    assert torch.equal(g16, g32.bfloat16().float())


@pytest.fixture
def smoke(monkeypatch):
    """``configs.get`` gives the smoke configs and train_4k is 256 sequences
    of 128 tokens (on (2, 2): W = 2 workers of 128 rows)."""
    monkeypatch.setattr(specs.configs, "get", configs.get_smoke)
    monkeypatch.setitem(specs.SHAPES, "train_4k", dict(kind="train", seq=128, global_batch=256))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_records_are_per_rank(smoke, arch):
    """The dry-run's train step of each of the four architectures is rank
    0 of the tensor-parallel step (``per_rank``), where it was split
    evenly: its count holds every kind of collective, the bytes its
    communicator tallied."""
    built = specs.build(arch, "train_4k", Mesh(("data", "model"), (2, 2)))
    assert built.meta["split"] == "per_rank" and built.meta["layout"].tp and "even_note" not in built.meta
    c = dryrun.count("train", built.fn, *built.args)
    assert dict(c.coll) == dict(built.meta["comm"].bytes)
    assert set(c.coll) == {"all-gather", "reduce-scatter", "all-reduce"} and min(c.coll.values()) > 0
    assert c.total_flops > 0


# ---------------------------------------------------------------------------
# the reference's own sharded step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,spec", [("llama4-maverick-400b-a17b", "marina:perm"), ("rwkv6-1.6b", "ef21p:16:64")])
def test_four_ranks_against_the_reference_sharded_step(tmp_path, arch, spec):
    """The reference's default program, the ``worker`` layout through XLA on
    4 CPU devices (2, 2), one step from its state, against the port's tensor
    parallelism over "model" from the same state and draws
    (``test_torch_train_sharded.reference_case``'s bounds)."""
    reference_case(tmp_path, spec, False, arch, own=True)
