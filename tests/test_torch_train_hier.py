"""The sharded train step on the hierarchical mesh ("wk", "data", "model"),
the reference's ``make_hierarchical_mesh`` (§Perf C4): the workers on "wk",
each worker's replica FSDP-sharded over "data" (``train/sharded.fsdp_blocks``)
and its batch rows split over "data", the server and the moments ZeRO-1
over ("wk", "data") and "model".

Four gloo ranks (``tests/torch_ranks.py``, part ``hier``, the smoke
gemma-2b and deepseek-v2): (2, 2, 1) with marina:perm (bf16 replicas), W = 2, whose perm
downlink runs on each rank's "data" block of its worker's row through
``rotk_apply_rows``' block map, and (1, 2, 2) with ef21p, W = 1, with
tensor parallelism over "model" too: 3 teacher-forced steps against the
single process within ``sharded_check.ACT_BOUNDS`` (the rows split as under
``act_spec``) or 1.5x ``OneRank``'s floor, the bytes handed to gloo equal
to the dry-run's count each step. And the reference's program on a
4-device CPU mesh of the same axes for the first case (``reference_case``).

In this process: ``rotk_apply_rows``' two-level block map in its plain
version (the CUDA kernel: chip_smoke.py (w0)): a rank's block of a leaf cut
over two dims (dims (1, 2), (0, 2) and (0, 1) of a 3-d leaf) is
``train/sharded.two_cut_block``; its block coordinates are the leaf's own
indices of that block, and ``ops.rotk_apply_rows`` on the block with its
map equals the whole leaf's ``ref.rotk_apply_rows_ref`` cut to the block,
bit for bit, in f32, fp16 and bf16; the one-level map keeps its three
values; maps that do not fit a leaf are refused. And the layouts: every
leaf's blocks over the ranks of a worker tile it once, each cut on the
reference's FSDP dim (``sharding._add_fsdp`` of the ``worker`` layout on
("wk", "data", "model")); the rank's replica row, its counted-once weights
and its batch rows.
"""
import itertools
import math

import numpy as np
import pytest
import torch

import torch_ranks as R
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.train import sharded as SH
from repro_torch.train import sharded_check as SC
from repro_torch.train.downlink import LeafBlock
from test_torch_train_sharded import reference_case

SHAPE = (6, 12, 9)


def _block_indices(shape, cuts):
    """The leaf's flat indices of the block, in the block's order: numpy's."""
    idx = np.arange(math.prod(shape)).reshape(shape)
    sl = [slice(None)] * len(shape)
    for dim, n, i in cuts:
        c = shape[dim] // n
        sl[dim] = slice(i * c, (i + 1) * c)
    return idx[tuple(sl)].reshape(-1)


def _smoke(arch="gemma-2b"):
    cfg = configs.get_smoke(arch)
    return cfg, lm.lm_spec(cfg), sum(P.leaf_sizes(lm.lm_spec(cfg)))


ARCHS = ("gemma-2b", "deepseek-v2-236b")


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    """Both architectures in one four-rank subprocess: {arch: each rank's report}."""
    report = R.run(tmp_path_factory.mktemp("hier"), "hier", ",".join(ARCHS), R.TIMEOUT["hier"])
    return lambda arch: [rep[arch] for rep in report]


@pytest.mark.parametrize("case", R.HIER_CASES, ids=[f"{c[0]}-{'x'.join(map(str, c[4]))}" for c in R.HIER_CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_hierarchical_steps_against_single_process(hier, arch, case):
    """The dense smoke gemma-2b, and deepseek-v2 whose experts route each
    rank's rows at its worker's capacity (``moe.split_rows`` over "data")."""
    R.check_case(hier(arch), (case[0], case[4]), SC.ACT_BOUNDS, case[5])


def test_against_the_reference_hierarchical_program(tmp_path):
    """The reference's ``worker``-layout step on (wk, data, model) = (2, 2,
    1) of 4 CPU devices (each replica FSDP over "data", the rows split over
    "data"), marina:perm, W = 2, one step from its state, against the
    port's."""
    reference_case(tmp_path, "marina:perm", False, mesh="wk,data,model:2x2x1", W=2)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16], ids=["f32", "fp16", "bf16"])
@pytest.mark.parametrize("dims", [(1, 2), (0, 2), (0, 1)], ids=["dims12", "dims02", "dims01"])
def test_two_level_block_map_is_the_whole_rows_block(dims, dtype):
    """Every rank of a leaf cut in 2 along one dim and 3 along another: the
    block's coordinates are the leaf's indices of the block, and the plain
    rotk_apply_rows on the block with its two-level map equals the whole
    leaf's rows cut to the block, bit for bit (4 replicas, n = 5,
    rotations -3 .. 7)."""
    g = torch.Generator().manual_seed(3)
    size = math.prod(SHAPE)
    w = torch.randn(4, size, generator=g).to(dtype)
    delta = torch.randn(size, generator=g).to(dtype)
    seen = 0
    for i1, i2 in itertools.product(range(2), range(3)):
        cuts = [(dims[0], 2, i1), (dims[1], 3, i2)]
        b = SH.two_cut_block(SHAPE, cuts)
        want_idx = _block_indices(SHAPE, cuts)
        assert b.inner > 0 and len(b.map) == 5 and b.size == want_idx.size and b.leaf_size == size
        assert torch.equal(ref.block_coords(b.size, b.map, "cpu"), torch.from_numpy(want_idx))
        assert torch.equal(b.cut(torch.arange(size)), torch.from_numpy(want_idx))
        for r in (-3, 0, 2, 7):
            rot = torch.tensor([r], dtype=torch.int32)
            whole = ref.rotk_apply_rows_ref(w, delta, rot, n=5)
            got = ops.rotk_apply_rows(b.cut(w).contiguous(), b.cut(delta).contiguous(), rot, n=5, block=b.map)
            want = b.cut(whole).contiguous()
            assert got.dtype == dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        seen += b.size
    assert seen == size  # the six blocks tile the leaf


def test_one_level_maps_are_unchanged_and_bad_maps_refused():
    """A block cut on one dim keeps its three-value map (``inner`` 0, the
    kernel's one-level code); a five-value map with inner 0 is the same
    map; two-level maps that leave the leaf are refused."""
    b = SH.two_cut_block(SHAPE, [(2, 3, 1), (0, 1, 0)])
    assert b == SH.leaf_block(SHAPE, 2, 3, 1) and b.inner == 0 and len(b.map) == 3
    w, delta, rot = torch.randn(2, b.size), torch.randn(b.size), torch.tensor([1], dtype=torch.int32)
    assert torch.equal(ops.rotk_apply_rows(w, delta, rot, n=3, block=b.map),
                       ops.rotk_apply_rows(w, delta, rot, n=3, block=b.map + (0, 0)))
    two = SH.two_cut_block(SHAPE, [(1, 2, 1), (2, 3, 2)])
    w, delta = torch.randn(2, two.size), torch.randn(two.size)
    chunk, stride, offset, inner, ostride = two.map
    for bad in ((chunk, stride, offset + stride - chunk + 1, inner, ostride),  # a run across a row's end
                (chunk, stride, offset, inner, (inner - 1) * stride + chunk - 1 + offset),  # groups overlap
                (chunk, stride, offset, inner + 1, ostride)):  # s not whole groups
        with pytest.raises(ValueError, match="does not map"):
            ops.rotk_apply_rows(w, delta, rot, n=3, block=bad)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 2), (2, 2, 1), (1, 4, 2)])
@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-236b", "rwkv6-1.6b"])
def test_hierarchical_blocks_tile_each_leaf_once(arch, shape):
    """On ("wk", "data", "model"): the rank's replica row of each leaf is the
    cut of the reference's worker spec (its "model" dim, then ``_add_fsdp``'s
    "data" dim), the ranks of a worker hold each coordinate of its row once
    (``row_counted_once`` summing it once), ``fsdp_local`` of the
    model-local vector is the row, and ``sharded.join`` of the "data"
    blocks gives the model-local vector back."""
    cfg, tree, d = _smoke(arch)
    mesh = Mesh(("wk", "data", "model"), shape)
    Wk, Dd, M = shape
    x = torch.arange(d, dtype=torch.float64)
    specs_ = sh.spec_leaves(sh.param_specs(P.map_tree(lambda leaf: P.stacked(leaf, Wk), tree), mesh, "worker"))
    count = torch.zeros(d, dtype=torch.float64)
    for rank in range(Dd * M):  # the ranks of worker 0
        lay = SH.make_layout(mesh, rank, Wk, d, cfg)
        assert lay.hier and lay.worker_size == Wk and lay.fsdp_size == Dd and lay.off == 0
        row = lay.rank_local(x)
        assert row.shape == (lay.d_rank,) and torch.equal(row, lay.fsdp_local(lay.model_local(x)))
        for (path, leaf), (_, spec), b in zip(P.leaves_with_path(tree), specs_, lay.row_blocks):
            cuts = [(i - 1, Dd if e == "data" else M, lay.fsdp_index if e == "data" else lay.coords[1])
                    for i, e in enumerate(spec) if i and e is not None]
            want = torch.from_numpy(_block_indices(tuple(leaf.shape), cuts))
            assert torch.equal(ref.block_coords(b.size, b.map, "cpu"), want), P.path_key(path)
        count += torch.zeros(d, dtype=torch.float64).index_add_(
            0, row.long(), lay.row_counted_once("cpu").double())
        parts = torch.stack([SH.make_layout(mesh, (rank // M // Dd * Dd + a) * M + rank % M, Wk, d, cfg)
                             .rank_local(x) for a in range(Dd)])
        assert torch.equal(SH.join(parts, lay.fsdp), lay.model_local(x))
    assert torch.equal(count, torch.ones(d, dtype=torch.float64))
    lay = SH.make_layout(mesh, Dd * M * (Wk - 1), 2 * Wk, d, cfg)  # the last worker group's first rank
    assert (lay.local, lay.off) == (2, 2 * (Wk - 1))
    batch = {"tokens": torch.arange(2 * Wk * 4 * 3).reshape(2 * Wk, 4, 3)}
    assert torch.equal(lay.local_batch(batch)["tokens"], batch["tokens"][lay.off:lay.off + 2, :4 // Dd])


def test_leaf_block_second_level_fields():
    """A one-level block is whole where chunk = stride; two-level blocks are
    never whole and cut groups of runs."""
    assert LeafBlock(0, 6, 6, 6, 0).whole and not LeafBlock(0, 3, 3, 6, 3).whole
    b = LeafBlock(0, 4, 1, 3, 4, 2, 12)  # leaf [2, 4, 3]: rows 1 and 2 of each group, column 1
    assert b.cut(torch.arange(24)).tolist() == [4, 7, 16, 19] and not b.whole
