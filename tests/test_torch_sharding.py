"""The port's sharding rules (``repro_torch.launch.sharding``): the ports of
tests/test_sharding.py (every spec divides its leaf, tensor parallelism
covers the big leaves, cache specs, expert parallelism), every spec equal to
the reference's ``launch/sharding.py`` on the same trees (all ten
full-width architectures, both production meshes and the hierarchical one,
the six layouts; caches and batches at smoke width), and the specs applied
as DTensor placements on a (2, 2) ``DeviceMesh`` of four gloo ranks.
"""
import functools
import os
import subprocess
import sys
import textwrap

import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.data import batch_specs as j_batch_specs  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import batch_specs  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import leaves_with_path, map_tree, stacked  # noqa: E402

SINGLE = M.make_production_mesh()
MULTI = M.make_production_mesh(multi_pod=True)
HIER = M.make_hierarchical_mesh(4)
MESHES = [SINGLE, MULTI]
MESH_IDS = ["16x16", "2x16x16"]
LAYOUTS = ("worker", "server", "serve", "tp", "tp_attn_rep", "replicated")


def _axis_size(mesh, ax):
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= mesh.shape[a]
        return n
    return mesh.shape[ax]


def _check_specs(tree_shape, specs, mesh, expect_leading_worker=False):
    leaves_s = [leaf for _, leaf in leaves_with_path(tree_shape)]
    leaves_p = [spec for _, spec in sh.spec_leaves(specs)]
    assert len(leaves_s) == len(leaves_p)
    for leaf, spec in zip(leaves_s, leaves_p):
        assert isinstance(spec, sh.Spec)
        assert len(spec) <= len(leaf.shape), (spec, leaf.shape)
        for dim, ax in zip(leaf.shape, tuple(spec)):
            if ax is None:
                continue
            assert dim % _axis_size(mesh, ax) == 0, (spec, leaf.shape)
        if expect_leading_worker and leaf.shape:
            assert tuple(spec) and tuple(spec)[0] is not None


def _workers(tree, W):
    return map_tree(lambda leaf: stacked(leaf, W), tree)


# ---------------------------------------------------------------------------
# the ports of tests/test_sharding.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(configs.ALIASES))
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_param_specs_divisible(arch, mesh):
    tree = lm.lm_spec(configs.get(arch))
    for layout in ("server", "serve"):
        _check_specs(tree, sh.param_specs(tree, mesh, layout), mesh)
    wtree = _workers(tree, M.n_workers(mesh))
    _check_specs(wtree, sh.param_specs(wtree, mesh, "worker"), mesh, expect_leading_worker=True)


def test_tensor_parallel_covers_big_leaves():
    """The bulk of parameter bytes must actually be model-sharded."""
    tree = lm.lm_spec(configs.get("starcoder2-7b"))
    specs = [s for _, s in sh.spec_leaves(sh.param_specs(tree, SINGLE, "server"))]
    leaves = [leaf for _, leaf in leaves_with_path(tree)]
    sharded = sum(leaf.size for leaf, p in zip(leaves, specs) if any(a == "model" for a in p))
    assert sharded / sum(leaf.size for leaf in leaves) > 0.95


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_cache_specs(mesh):
    cfg = configs.get_smoke("gemma-2b")
    caches = lm.cache_init(cfg, 128, 1024, device="meta")  # decode_32k-style: batch divisible
    _check_specs(caches, sh.cache_specs(caches, mesh, 128), mesh)
    caches1 = lm.cache_init(cfg, 1, 8192, device="meta")  # long_500k-style: batch 1 -> sequence
    specs1 = sh.cache_specs(caches1, mesh, 1)
    _check_specs(caches1, specs1, mesh)
    assert any(any(a is not None for a in p) for _, p in sh.spec_leaves(specs1)), "seq dim should shard"


def test_moe_expert_parallel():
    tree = lm.lm_spec(configs.get("deepseek-v2-236b"))
    found = [tuple(spec) for path, spec in sh.spec_leaves(sh.param_specs(tree, SINGLE, "server"))
             if "moe" in sh.path_str(path) and "w_in" in sh.path_str(path)
             and "shared" not in sh.path_str(path)]
    assert found and all("model" in sp for sp in found), found


# ---------------------------------------------------------------------------
# every spec equal to the reference's
# ---------------------------------------------------------------------------


def _ref_leaves(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [(JSH._path_str(path), tuple(spec)) for path, spec in flat]


def _port_leaves(specs):
    return [(sh.path_str(path), tuple(spec)) for path, spec in sh.spec_leaves(specs)]


@functools.lru_cache(maxsize=None)
def _ref_params(arch, smoke=False):
    cfg = JCFG.get_smoke(arch) if smoke else JCFG.get(arch)
    return jax.eval_shape(lambda k: JLM.lm_init(cfg, k), jax.random.PRNGKey(0))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES + [HIER], ids=MESH_IDS + ["wk4x4x16"])
@pytest.mark.parametrize("arch", list(configs.ALIASES))
def test_param_specs_equal_reference(arch, mesh, layout):
    """The same leaves in the same order, each with the reference's spec
    (the reference's rules read only ``.shape`` / ``.axis_names``, so the
    port's mesh description serves both)."""
    ref_tree, tree = _ref_params(arch), lm.lm_spec(configs.get(arch))
    if layout == "worker":
        W = M.n_workers(mesh)
        ref_tree = jax.tree.map(lambda l: jax.ShapeDtypeStruct((W,) + l.shape, l.dtype), ref_tree)
        tree = _workers(tree, W)
    want = _ref_leaves(JSH.param_specs(ref_tree, mesh, layout))
    got = _port_leaves(sh.param_specs(tree, mesh, layout))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert got == want


@pytest.mark.parametrize("arch", list(configs.ALIASES))
def test_cache_and_batch_specs_equal_reference(arch):
    """cache_specs (decode_32k- and long_500k-style batches, the windowed
    cache too), train_batch_spec and serve_batch_spec at smoke width."""
    cj, ct = JCFG.get_smoke(arch), configs.get_smoke(arch)
    for mesh in MESHES + [HIER]:
        for B, L, window in ((128, 1024, None), (1, 8192, None), (1, 8192, 256)):
            ref = jax.eval_shape(lambda: JLM.cache_init(cj, B, L, window_override=window))
            port = lm.cache_init(ct, B, L, window_override=window, device="meta")
            assert _port_leaves(sh.cache_specs(port, mesh, B)) == _ref_leaves(JSH.cache_specs(ref, mesh, B))
        W = M.n_workers(mesh)
        ref_b, port_b = j_batch_specs(cj, W, 2, 64), batch_specs(ct, W, 2, 64)
        assert _port_leaves(sh.train_batch_spec(port_b, mesh)) == _ref_leaves(JSH.train_batch_spec(ref_b, mesh))
        for B in (32, 1):
            port_s = S.serve_batch(ct, B, 64)
            ref_s = {k: jax.ShapeDtypeStruct(tuple(v.shape), jax.numpy.int32 if v.dtype == torch.int32
                                             else jax.numpy.bfloat16) for k, v in port_s.items()}
            assert (_port_leaves(sh.serve_batch_spec(port_s, mesh, B))
                    == _ref_leaves(JSH.serve_batch_spec(ref_s, mesh, B)))
        assert _port_leaves(sh.scalar_specs(port_b)) == [(k, ()) for k in sorted(port_b)]


def test_train_state_specs_follow_the_reference_state():
    """specs.build's train state specs: the server and moments in the server
    layout, count replicated, the replicas in the worker layout, the batch
    over the workers, as the reference's build gives them."""
    built = S.build("gemma3-1b", "train_4k", SINGLE)
    state_specs, batch_spec, draws_spec = built.specs
    ref_tree = _ref_params("gemma3-1b")
    server = _ref_leaves(JSH.param_specs(ref_tree, SINGLE, "server"))
    assert _port_leaves(state_specs["server"]) == server
    assert _port_leaves(state_specs["opt"]["m"]) == server == _port_leaves(state_specs["opt"]["v"])
    assert state_specs["opt"]["count"] == ()
    W = built.meta["W"]
    wref = jax.tree.map(lambda l: jax.ShapeDtypeStruct((W,) + l.shape, l.dtype), ref_tree)
    assert _port_leaves(state_specs["workers"]) == _ref_leaves(JSH.param_specs(wref, SINGLE, "worker"))
    assert batch_spec["tokens"] == ("data", None, None) and draws_spec == ()
    state, batch, draws = built.args  # rank 0's: its worker's row of its blocks (tensor parallelism)
    lay = built.meta["layout"]
    wspecs = [sh.Spec(*s[1:]) for _, s in sh.spec_leaves(state_specs["workers"])]
    tree_leaves = [leaf for _, leaf in leaves_with_path(lm.lm_spec(configs.get("gemma3-1b")))]
    d_local = sum(sh.local_numel(leaf.shape, s, SINGLE) for leaf, s in zip(tree_leaves, wspecs))
    assert lay.tp and lay.d_local == d_local and state["workers"].shape == (1, d_local)
    assert state["server"].shape == (-(-d_local // 16),)
    assert state["workers"].device.type == "meta" and batch["tokens"].shape == (16, 16, 4096)


def test_spec_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert sh.Spec("data", None) == ("data", None) and repr(sh.Spec()) == "Spec()"
    assert sh.placements(sh.Spec(None, "model"), SINGLE) == (Replicate(), Shard(1))
    assert sh.placements(sh.Spec(("pod", "data"), "model"), MULTI) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements(sh.Spec(), MULTI) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements(sh.Spec(("data", "pod")), MULTI)
    with pytest.raises(ValueError, match="not in the mesh"):
        sh.placements(sh.Spec("pod"), SINGLE)
    with pytest.raises(ValueError, match="twice"):
        sh.placements(sh.Spec("data", "data"), SINGLE)
    with pytest.raises(ValueError, match="unknown layout"):
        sh.param_specs(lm.lm_spec(configs.get_smoke("gemma-2b")), SINGLE, "zero3")


# ---------------------------------------------------------------------------
# the specs applied: DTensor on a (2, 2) mesh of four gloo ranks
# ---------------------------------------------------------------------------

_SCRIPT = textwrap.dedent(
    """
    import sys
    import torch
    import torch.multiprocessing as mp

    WORLD = 4


    def local_block(t, spec, mesh, coord):
        # the reference's (jax) shard of ``t`` at mesh coordinate ``coord``:
        # a dim over several axes is split with the first axis major
        for dim, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,) if entry is not None else ()
            idx, n = 0, 1
            for a in axes:
                k = mesh.axis_names.index(a)
                idx, n = idx * mesh.sizes[k] + coord[k], n * mesh.sizes[k]
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
        return t


    def worker(rank, init):
        import torch.distributed as dist
        from torch.distributed.tensor import distribute_tensor
        from repro_torch import configs
        from repro_torch.core import distributed as SD
        from repro_torch.launch import mesh as M, sharding as sh
        from repro_torch.models import lm
        from repro_torch.models.params import leaves_with_path, map_tree, stacked

        SD.init_process_group(init, rank=rank, world_size=WORLD, device="cpu")
        desc = M.Mesh(("data", "model"), (2, 2))
        dm = desc.device_mesh("cpu")
        coord = dm.get_coordinate()
        cfg = configs.get_smoke("gemma-2b")
        tree = lm.lm_spec(cfg)
        cases = []
        for layout in ("server", "serve", "tp", "tp_attn_rep", "replicated"):
            specs = dict(sh.spec_leaves(sh.param_specs(tree, desc, layout)))
            cases += [(path, leaf.shape, specs[path]) for path, leaf in leaves_with_path(tree)]
        wtree = map_tree(lambda l: stacked(l, 2), tree)
        wspecs = dict(sh.spec_leaves(sh.param_specs(wtree, desc, "worker")))
        cases += [(path, leaf.shape, wspecs[path]) for path, leaf in leaves_with_path(wtree)]
        cases.append((("joint",), (8, 6), sh.Spec(("data", "model"), None)))
        sharded = 0
        gen = torch.Generator().manual_seed(0)
        for path, shape, spec in cases:
            full = torch.randn(shape, generator=gen)  # the same on every rank
            dt = distribute_tensor(full, dm, sh.placements(spec, dm))
            want = local_block(full, spec, desc, coord)
            got = dt.to_local()
            assert got.shape == want.shape, (path, spec, got.shape, want.shape)
            assert torch.equal(got, want), (path, spec)
            assert torch.equal(dt.full_tensor(), full), (path, spec)
            sharded += got.numel() < full.numel()
        assert sharded > 20, sharded
        # the 1-D workers mesh gives core/distributed its group
        wm = M.make_worker_mesh().device_mesh("cpu")
        assert dist.get_world_size(wm.get_group()) == WORLD and M.make_worker_mesh().size == WORLD
        try:
            M.make_production_mesh().device_mesh("cpu")
        except RuntimeError:
            pass
        else:
            raise AssertionError("a 256-device mesh built over 4 ranks")
        if rank == 0:
            print(f"DTENSOR OK {len(cases)} cases", flush=True)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(worker, args=(sys.argv[1],), nprocs=WORLD, join=True)
    """
)


def test_placements_on_a_gloo_device_mesh(tmp_path):
    """distribute_tensor with placements(spec) gives each rank the block the
    spec assigns it (the reference's layout, first axis major) and
    full_tensor() gives back the leaf bit for bit, for every leaf of a smoke
    model in every layout on a (2, 2) mesh."""
    script = tmp_path / "dtensor.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, str(script), f"file://{tmp_path / 'rendezvous'}"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "DTENSOR OK" in res.stdout
