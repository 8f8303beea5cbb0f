"""The port's dry-run (``repro_torch.launch``) against the reference's
``launch/``: the dot FLOPs the port's op count gives a step on ``meta`` equal
``hlo_cost.analyze`` of the reference's jitted step, exactly (forward,
decode_step and the marina:perm train step with remat off and on, all ten
smoke architectures); MODEL_FLOPS and the parameter counts; the roofline
formula; the W-fold shortcut of a train step's count against the full loop;
the hand kernels charged at their wrappers; ``reanalyze``; gemma3-1b's
full-width dry-run of all four shapes; the ``roofline`` suite; and the
entry points' default device.
"""
import inspect
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.data import batch_specs as j_batch_specs  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.optim.schedules import cosine_warmup as j_cosine_warmup  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.train import init_state as j_init_state  # noqa: E402
from repro.train import make_downlink as j_make_downlink  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs, obs, roofline_report, run  # noqa: E402
from repro_torch.data import SyntheticLMData, batch_specs  # noqa: E402
from repro_torch.kernels import ops, runtime  # noqa: E402
from repro_torch.launch import dryrun, mesh, op_cost, reanalyze, roofline, specs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import leaf_sizes  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import init_state, trainer  # noqa: E402
from repro_torch.train import downlink as D  # noqa: E402

ARCHS = list(configs.ALIASES)
B, S, CHUNK, CACHE, W = 2, 64, 32, 128, 2


def _jflops(fn, *args) -> float:
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def _jparams(cfg):
    return jax.eval_shape(lambda k: JLM.lm_init(cfg, k), jax.random.PRNGKey(0))


def _train_count(cfg, remat: bool, one_worker: bool = True, workers: int = W):
    step, dl, tcfg, opt = specs.train_parts(cfg, workers, remat=remat, attn_chunk=CHUNK)
    state = init_state(cfg, tcfg, dl, opt, device="meta")
    batch = {k: specs.empty(v.shape, v.dtype) for k, v in batch_specs(cfg, workers, B, S).items()}
    draws = specs.compressed_draws(dl, leaf_sizes(lm.lm_spec(cfg)))
    return dryrun.count("train", step, state, batch, draws, one_worker=one_worker)


# ---------------------------------------------------------------------------
# dot FLOPs equal to hlo_cost.analyze of the reference's jitted step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_flops_equal_reference(arch):
    cj, ct = JCFG.get_smoke(arch), configs.get_smoke(arch)
    batch = specs.serve_batch(ct, B, S)
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32 if v.dtype == torch.int32 else jnp.bfloat16)
              for k, v in batch.items()}
    want = _jflops(lambda p, b: JLM.forward(cj, p, b, chunk=CHUNK), _jparams(cj), jbatch)
    with torch.no_grad():
        got = dryrun.count("prefill", lambda p, b: lm.forward(ct, p, b, chunk=CHUNK),
                           lm.lm_init(ct, device="meta"), batch)
    assert got.total_flops == want > 0
    caches = jax.eval_shape(lambda: JLM.cache_init(cj, B, CACHE))
    tok = specs.decode_token(ct, B)
    want = _jflops(lambda p, c, t, q: JLM.decode_step(cj, p, c, t, q), _jparams(cj), caches,
                   jax.ShapeDtypeStruct(tuple(tok.shape), jnp.int32), jax.ShapeDtypeStruct((), jnp.int32))
    with torch.no_grad():
        got = dryrun.count("decode", lm.decode_step, ct, lm.lm_init(ct, device="meta"),
                           lm.cache_init(ct, B, CACHE, device="meta"), tok, specs.empty((), torch.int32))
    assert got.total_flops == want > 0


def xla_only_scan_flops(cfg) -> int:
    """Dots of the reference's backward that the port's does not run, for
    the two recurrent families (0 for the others), at this file's smoke
    shapes, per worker. Both come from how XLA differentiates, not from the
    model:

    * the inter-chunk scan: ``lax.scan``'s backward computes its body's VJP
      in every iteration, so also the gradient of the first chunk's zero
      initial state, a dot over the chunk (2 * B * H * k * v * Q); the
      port's loop does not differentiate that constant;
    * an outer-product step of a three-operand ``jnp.einsum`` is a
      ``dot_general`` with no contraction, whose VJP is a dot; torch
      broadcasts a multiply, whose VJP is a multiply and a sum. RWKV6's
      bonus contracts (r, u) first (u's gradient: 2 * H * hd * B * S);
      Mamba2's y_in contracts (C, exp L) first at these shapes, and its
      state_add (w, B): the gradients of both factors, per chunk.
    """
    if cfg.rwkv:
        H, hd, Q = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim, 32
        per_layer = 2 * B * H * hd * hd * Q + 2 * H * hd * B * S
        return per_layer * cfg.block_pattern.count("rwkv")
    if cfg.mamba:
        m = cfg.mamba
        H, N, hd, Q = m.expand * cfg.d_model // m.head_dim, m.state_dim, m.head_dim, m.chunk
        outer = 2 * (2 * B * Q * N * H)  # d(C), d(exp L) of one chunk's y_in; d(w), d(B) of a chunk's state_add
        per_layer = 2 * B * H * N * hd * Q + (S // Q) * 2 * outer
        return per_layer * cfg.block_pattern.count("mamba")
    return 0


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_flops_equal_reference(arch, remat):
    """The marina:perm train step (AdamW, cosine_warmup, bf16 replicas) at W
    = 2, B = 2, S = 64: the backward's and the recomputation's dots too,
    exactly, but for the recurrent families' XLA-only dots
    (:func:`xla_only_scan_flops`), which are named and counted exactly."""
    cj, ct = JCFG.get_smoke(arch), configs.get_smoke(arch)
    jt = JTrainerConfig(n_workers=W, remat=remat, attn_chunk=CHUNK, weight_dtype=jnp.bfloat16)
    jdl, jopt = j_make_downlink("marina:perm", W), j_make_optimizer("adamw")
    jstep = j_make_train_step(cj, jt, jdl, jopt, j_cosine_warmup(3e-4, 200, 20000))
    jstate = jax.eval_shape(lambda k: j_init_state(cj, jt, jdl, jopt, k), jax.random.PRNGKey(0))
    want = _jflops(jstep, jstate, j_batch_specs(cj, W, B, S), jax.eval_shape(lambda: jax.random.PRNGKey(0)))
    got = _train_count(ct, remat).total_flops
    assert got + W * xla_only_scan_flops(ct) == want > 0
    assert (xla_only_scan_flops(ct) > 0) == (arch in ("rwkv6-1.6b", "zamba2-1.2b"))


# ---------------------------------------------------------------------------
# the count itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-236b", "zamba2-1.2b"])
def test_one_worker_shortcut_equals_the_full_loop(arch):
    """W = 4 workers counted as one worker's pass charged four times: every
    op's FLOPs, bytes and calls as the loop over the four."""
    cfg = configs.get_smoke(arch)
    fast = _train_count(cfg, True, one_worker=True, workers=4)
    full = _train_count(cfg, True, one_worker=False, workers=4)
    assert fast.flops == full.flops and fast.bytes == full.bytes and fast.calls == full.calls
    assert full.calls["kernel:rotk_apply_rows"] == len(leaf_sizes(lm.lm_spec(cfg)))
    assert trainer.worker_value_and_grad.__name__ == "worker_value_and_grad"  # restored
    with pytest.raises(ValueError, match="meta"), op_cost.counting() as c, op_cost.one_worker_for_all(c):
        trainer.worker_value_and_grad(cfg, lm.lm_spec(cfg), {}, torch.zeros(3), {})


def test_count_on_cpu_equals_count_on_meta():
    """A smoke train step run for real on the CPU counts the dots its
    shapes on meta count, and the plain rotk_apply_rows is hidden and
    charged its kernel's (2R + 1) values a column either way. Meta follows
    the card's arithmetic: the CPU's bf16 products run in fp32
    (``params.mm``), which doubles their bytes and adds casts."""
    cfg = configs.get_smoke("gemma3-1b")
    step, dl, tcfg, opt = specs.train_parts(cfg, W, attn_chunk=CHUNK)
    sizes = leaf_sizes(lm.lm_spec(cfg))
    state = init_state(cfg, tcfg, dl, opt, seed=0, device="cpu")
    batch = SyntheticLMData(cfg, W, B, S, device="cpu").batch(0)
    draws = D.DownlinkDraws(rot=torch.arange(len(sizes), dtype=torch.int32))
    cpu = dryrun.count("train", step, state, batch, draws, one_worker=False)
    meta = _train_count(cfg, True, one_worker=False)
    assert cpu.flops == meta.flops and cpu.total_flops > 0
    assert cpu.bytes["mm"] == 2 * meta.bytes["mm"] and cpu.calls["mm"] == meta.calls["mm"]
    diff = {k for k in set(cpu.bytes) | set(meta.bytes) if cpu.bytes[k] != meta.bytes[k]}
    assert diff == {"mm", "_to_copy"}, diff
    assert cpu.bytes["kernel:rotk_apply_rows"] == meta.bytes["kernel:rotk_apply_rows"] == \
        sum((2 * W + 1) * s * 2 for s in sizes)  # bf16 replicas
    assert cpu.calls["kernel:rotk_apply_rows"] == len(sizes)


def test_kernel_wrappers_charge_their_bytes_and_hide_their_plain_version():
    x = torch.randn(1000)
    rot = torch.tensor([1], dtype=torch.int32)
    A, X, values = torch.randn(2, 8, 16), torch.randn(2, 16), torch.arange(40, dtype=torch.int32).reshape(2, 20)
    with op_cost.counting() as c:
        ops.block_topk(x, k_per_block=10, block=128)
        ops.rotk_apply(x, x, rot, n=3, worker=0)
        ops.rotk_apply_rows(x.expand(3, 1000), x, rot, n=3)
        ops.bernk(x, keep_prob=0.5, seed=1)
        ops.l1_subgrad(A, X)
        words = ops.pack_bits(values, 7)
        ops.unpack_bits(words, 7, 20)
    assert c.bytes == {"kernel:block_topk": 2 * 1024 * 4, "kernel:rotk_apply": 3 * 4000,
                       "kernel:rotk_apply_rows": (1 + 3 + 1) * 4000, "kernel:bernk": 2 * 4000,
                       "kernel:l1_subgrad": 4 * (2 * 8 * 16 + 2 * 2 * 16), "kernel:pack_bits": 4 * 2 * (20 + 5),
                       "kernel:unpack_bits": 4 * 2 * (5 + 20),
                       "constant_pad_nd": 4 * (1000 + 1024)}  # block_topk's zero padding runs as an op
    assert c.total_flops == 4 * 2 * 8 * 16 and set(c.calls.values()) == {1}
    with op_cost.counting() as c:  # on meta the plain version runs for the shapes
        out = ops.rotk_apply_rows(specs.empty((4, 10), torch.bfloat16), specs.empty((10,), torch.bfloat16),
                                  specs.empty((1,), torch.int32), n=4)
    assert out.shape == (4, 10) and out.device.type == "meta" and list(c.bytes) == ["kernel:rotk_apply_rows"]
    assert runtime.COUNTS == []


def test_views_and_allocations_are_free():
    x = specs.empty((4, 8), torch.float32)
    with op_cost.counting() as c:
        y = x.view(8, 4).t()[:, :2].detach()
        torch.empty_like(x)
        z = x.float() + 1.0
    assert c.calls == {"add": 1} and c.bytes["add"] == 2 * 128 and y.shape == (4, 2) and z.shape == x.shape


# ---------------------------------------------------------------------------
# model FLOPs, parameter counts, the roofline formula
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_param_counts_equal_reference(arch):
    cj, ct = JCFG.get(arch), configs.get(arch)
    assert ct.param_count() == cj.param_count() and ct.active_param_count() == cj.active_param_count()
    for shape, info in specs.SHAPES.items():
        args = (info["kind"], info["global_batch"], info["seq"])
        assert roofline.model_flops(ct, *args) == JR.model_flops(cj, *args)


def test_roofline_terms_follow_the_reference_formula(monkeypatch):
    """Given the reference's constants, the port's terms are the reference's;
    with its own, they are the H100's; a missing collective is no term."""
    for name, value in (("PEAK_FLOPS", JR.PEAK_FLOPS), ("HBM_BW", JR.HBM_BW), ("LINK_BW", JR.ICI_BW)):
        monkeypatch.setattr(roofline, name, value)
    for f, b, c in ((1e15, 1e12, 1e9), (1e9, 1e12, 1e8), (1e9, 1e6, 1e12)):
        assert roofline.roofline_terms(f, b, c) == JR.roofline_terms(f, b, c)
    monkeypatch.undo()
    t = roofline.roofline_terms(989.4e12, 3.35e12 / 2)
    assert t["collective_s"] is None and t["dominant"] == "compute_s" and t["bound_s"] == 1.0
    assert roofline.roofline_terms(0.0, 6.7e12)["bound_s"] == 2.0
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989.4e12, 3.35e12, 450e9)


def test_meshes():
    single, multi = mesh.make_production_mesh(), mesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert mesh.n_workers(single) == 16 and mesh.n_workers(multi) == 32
    hier = mesh.make_hierarchical_mesh(4)
    assert hier.shape == {"wk": 4, "data": 4, "model": 16} and mesh.worker_axes(hier) == ("wk",)
    assert mesh.make_worker_mesh(8).shape == {"workers": 8}
    with pytest.raises(ValueError):
        mesh.make_hierarchical_mesh(3)
    with pytest.raises(RuntimeError, match="256 ranks"):
        single.device_mesh("cpu")


# ---------------------------------------------------------------------------
# the records: gemma3-1b at full width, reanalyze, the roofline suite
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma3_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    dryrun.main(["--arch", "gemma3-1b", "--out", str(out)])
    return out


def test_gemma3_full_width_dry_run_of_all_four_shapes(gemma3_records):
    recs = {r["shape"]: r for r in roofline_report.load(str(gemma3_records))}
    assert sorted(recs) == sorted(specs.SHAPES)
    for shape, r in recs.items():
        assert dryrun.record_problems(r) == [], r
        assert r["chips"] == 256 and r["mesh"] == "16x16" and r["params_total"] == 999_812_736
        assert r["flops_per_device"] == r["flops_global"] / 256
    bad = dict(recs["decode_32k"], useful_flops_ratio=1.2, flops_global=float("nan"))
    assert len(dryrun.record_problems(bad)) == 2
    assert recs["train_4k"]["downlink"] == "marina:perm" and recs["long_500k"]["window_override"] is None
    # rank 0 of the tensor-parallel step: its bf16 replica's 1/16 of every split leaf, ZeRO-1 slices of those
    assert recs["train_4k"]["split"] == "per_rank" and recs["train_4k"]["tensor_parallel"]
    assert 2 * 999_812_736 / 16 < recs["train_4k"]["argument_bytes"] < 3 * 999_812_736 / 16
    assert sum(r["t_count_s"] for r in recs.values()) < 60
    # the count is a function of the shapes alone
    again = dryrun.run_one("gemma3-1b", "decode_32k", verbose=False)
    assert (again["flops_global"], again["bytes_global"]) == (recs["decode_32k"]["flops_global"],
                                                              recs["decode_32k"]["bytes_global"])


def test_reanalyze_returns_the_same_records(gemma3_records, tmp_path):
    recs = roofline_report.load(str(gemma3_records))
    measured = dict(recs[0], shape="measured_case")
    measured["measured"] = dryrun.derive_measured(
        {"ms": 12.5, "flops": 1e13, "bytes": 2e10, "model_flops": 5e12, "card": "x"}, measured["kind"])
    with open(os.path.join(gemma3_records, "measured.json"), "w") as f:
        json.dump(measured, f)
    again = reanalyze.reanalyze(str(gemma3_records), str(tmp_path))
    by_shape = lambda r: r["shape"]  # noqa: E731
    assert sorted(again, key=by_shape) == sorted(recs + [json.loads(json.dumps(measured))], key=by_shape)
    m = measured["measured"]
    assert m["roofline"]["bound_s"] == 1e13 / roofline.PEAK_FLOPS
    assert m["roofline_share"] == m["roofline"]["bound_s"] / 12.5e-3
    assert m["mfu"] == (5e12 / (12.5e-3 * roofline.PEAK_FLOPS) if measured["kind"] != "decode" else None)
    os.remove(os.path.join(gemma3_records, "measured.json"))


def test_roofline_suite_writes_a_valid_artifact(gemma3_records, tmp_path, monkeypatch):
    monkeypatch.setattr(roofline_report, "DEFAULT_DIR", str(gemma3_records))
    assert run.main(["roofline", "--out", str(tmp_path), "--device", "cpu"]) == 0
    doc = obs.load(os.path.join(tmp_path, "BENCH_roofline.json"))
    assert obs.validate(doc) == []
    assert {f"roofline/gemma3-1b/{s}/bound_s" for s in specs.SHAPES} <= set(doc["metrics"])
    table = roofline_report.markdown_table(roofline_report.load(str(gemma3_records)))
    assert table.count("| gemma3-1b |") == 4 and "roofline share" in table


# ---------------------------------------------------------------------------
# where things run
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card():
    """``meta`` only where asked for; every default is the card, which is
    absent here, so a default call raises instead of running on the CPU."""
    cfg = configs.get_smoke("gemma-2b")
    for fn in (lm.lm_init, lm.cache_init, init_state, dryrun.run_one, dryrun.measure_step):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    with pytest.raises(RuntimeError, match="cuda"):
        lm.lm_init(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.measure_step("gemma3-1b", "decode_32k")
    with pytest.raises(ValueError, match="on the card"):
        dryrun.measure_step("gemma3-1b", "decode_32k", device="cpu")
    with pytest.raises(ValueError, match="meta"):
        runtime.resolve_device("meta")
    assert lm.lm_init(cfg, device="meta").flat.device.type == "meta"


def test_decode_into_is_the_engines_step():
    """The step the engine's graph replays (and the measured decode counts):
    decode_step, its new caches written back into the static ones."""
    cfg = configs.get_smoke("gemma3-1b")
    params = lm.lm_init(cfg, device="cpu", seed=0)
    caches = lm.cache_init(cfg, 2, 16, device="cpu")
    tok = torch.tensor([[3], [5]])
    want, new = lm.decode_step(cfg, params, lm.cache_init(cfg, 2, 16, device="cpu"), tok, 0)
    got = engine.decode_into(cfg, params, caches, tok, 0)
    assert torch.equal(got, want)
    from repro_torch.models.params import leaves

    assert all(torch.equal(a, b) for a, b in zip(leaves(caches), leaves(new)))
    assert np.isfinite(got.float().numpy()).all()
