"""The LM training slice's host arithmetic against the reference, bit for
bit: ``jax_random.uniform``, the schedules, both optimizers (against the
reference jitted, as its train step runs them), the synthetic data's tokens
and ``batch_specs``; and ``forward``'s remat variants, which must not move a
gradient's bit. Shared helpers of the other ``test_torch_train_*`` files
live here (:func:`reference_draws`)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.data import batch_specs as j_batch_specs  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.optim import schedules as JS  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import jax_random  # noqa: E402
from repro_torch.data import SyntheticLMData, batch_specs  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.optim.libm import powf  # noqa: E402
from repro_torch.optim import schedules as TS  # noqa: E402
from repro_torch.train import downlink as TD  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(a) -> np.ndarray:
    """The uint32 patterns of a float32 array or tensor."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def reference_draws(dl, key, shapes, device="cpu") -> TD.DownlinkDraws:
    """The draws the reference's ``MarinaPDownlink.round`` takes from ``key``
    over leaves of ``shapes``, as the port's DownlinkDraws (EF21-P and None:
    nothing)."""
    if not isinstance(dl, TD.MarinaPDownlink):
        return TD.DownlinkDraws()
    k_bern, k_comp = jax.random.split(key)
    coin = bool(jax.random.bernoulli(k_bern, dl.sync_p))
    seed = int(np.asarray(k_comp).ravel()[-1])
    n = dl.n_workers
    lks = [jax.random.fold_in(k_comp, li) for li in range(len(shapes))]
    if dl.mode == "perm":
        rot = [int(jax.random.randint(lk, (), 0, n)) for lk in lks]
        return TD.DownlinkDraws(coin=coin, seed=seed,
                                rot=torch.tensor(rot, dtype=torch.int32, device=device))
    if dl.mode == "ind":
        masks = [np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(lk, w), shape)
                                      < dl.frac).reshape(-1) for w in range(n)])
                 for lk, shape in zip(lks, shapes)]
    else:
        masks = [np.asarray(jax.random.uniform(lk, shape) < dl.frac).reshape(-1)
                 for lk, shape in zip(lks, shapes)]
    return TD.DownlinkDraws(coin=coin, seed=seed,
                            masks=[torch.from_numpy(np.array(m)).to(device) for m in masks])


# -- jax_random.uniform ------------------------------------------------------------


@pytest.mark.parametrize("seed,step,shape", [(0, 0, (4, 2, 512)), (3, 17, (7,)), (0, 5, (2, 3, 4, 5)),
                                             (2**31 + 1, 9, (1000,)), (1, 2**31, (1,))])
def test_uniform_matches_jax_bit_for_bit(seed, step, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    got = jax_random.uniform(jax_random.fold_in(jax_random.PRNGKey(seed), step), shape)
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(bits(got), bits(jax.random.uniform(key, shape)))
    assert 0.0 <= got.min() and got.max() < 1.0


# -- schedules ------------------------------------------------------------------


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 50, 300), (1.0, 10, 100), (3e-4, 2, 10),
                                               (2e-3, 100, 10000), (3e-4, 0, 7), (3e-4, 75, 300)])
def test_cosine_warmup_matches_jitted_reference_bit_for_bit(peak, warmup, total):
    steps = np.arange(0, total + 5, dtype=np.int32)
    want = jax.vmap(jax.jit(JS.cosine_warmup(peak, warmup, total)))(jnp.asarray(steps))
    got = np.array([TS.cosine_warmup(peak, warmup, total)(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_constant_and_inv_sqrt_schedules():
    """constant: exact. inv_sqrt: exact against the reference op by op; its
    jitted form multiplies by XLA CPU's approximate rsqrt, within 2 ulp."""
    steps = np.arange(0, 2000, dtype=np.int32)
    for lr in (2e-3, 0.1, 1.0):
        assert bits(TS.constant_lr(lr)(7)) == bits(JS.constant_lr(lr)(jnp.int32(7)))
    for g0 in (2.0, 0.1):
        got = np.array([TS.inv_sqrt(g0)(int(s)) for s in steps], np.float32)
        eager = np.array([JS.inv_sqrt(g0)(jnp.int32(s)) for s in steps[:300]], np.float32)
        np.testing.assert_array_equal(bits(got[:300]), bits(eager))
        jitted = np.asarray(jax.vmap(jax.jit(JS.inv_sqrt(g0)))(jnp.asarray(steps)))
        assert np.abs(bits(got).astype(np.int64) - bits(jitted)).max() <= 2
    assert float(TS.make_schedule("cosine:1.0", warmup=10, total=100)(10)) == pytest.approx(1.0)
    assert TS.make_schedule("inv_sqrt:2.0")(3) == 1.0


def test_lr_schedules():
    """Port of tests/test_trainer.py::test_lr_schedules."""
    sch = TS.cosine_warmup(1.0, warmup=10, total=100)
    assert float(sch(0)) == 0.0
    assert float(sch(10)) == pytest.approx(1.0)
    assert float(sch(100)) == pytest.approx(0.1, abs=1e-3)
    assert float(TS.inv_sqrt(2.0)(3)) == pytest.approx(1.0)


# -- optimizers -----------------------------------------------------------------


def _opt_inputs(n=100_003, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    m = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 1e-5).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("count", [0, 1, 3, 5, 30, 300, 5000])
def test_adamw_matches_jitted_reference_bit_for_bit(wd, count):
    """m, v and the parameters, with a schedule's lr (a host float) and
    Polyak's (a 0-d tensor): the forms of optim/optimizers.py's docstring."""
    p, g, m, v = _opt_inputs()
    st = {"m": {"w": jnp.asarray(m)}, "v": {"w": jnp.asarray(v)}, "count": jnp.int32(count)}
    f = jax.jit(lambda g_, s_, p_, lr_: JO.adamw_update(g_, s_, p_, lr_, weight_decay=wd))
    lr = np.float32(3e-4)
    pj, sj = f({"w": jnp.asarray(g)}, st, {"w": jnp.asarray(p)}, jnp.float32(lr))
    for lr_t in (lr, torch.tensor(lr)):
        pt, stt = TO.adamw_update(torch.from_numpy(g),
                                  {"m": torch.from_numpy(m), "v": torch.from_numpy(v), "count": count},
                                  torch.from_numpy(p), lr_t, weight_decay=wd)
        np.testing.assert_array_equal(bits(pt), bits(pj["w"]))
        np.testing.assert_array_equal(bits(stt["m"]), bits(sj["m"]["w"]))
        np.testing.assert_array_equal(bits(stt["v"]), bits(sj["v"]["w"]))
        assert stt["count"] == int(sj["count"])


def test_adamw_bias_correction_pow_matches_xla_for_every_count():
    """1 - b ** count from the C library's powf equals XLA's for counts
    1..3000 (numpy's float32 power does not: counts 4 and 31 at b = 0.9)."""
    counts = jnp.arange(1, 3001, dtype=jnp.int32)
    for b in (0.9, 0.95):
        want = jax.jit(lambda c: 1 - b ** c.astype(jnp.float32))(counts)
        got = np.array([np.float32(1) - powf(b, c) for c in range(1, 3001)], np.float32)
        np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_sgd_matches_jitted_reference_bit_for_bit(momentum, wd):
    p, g, m, _ = _opt_inputs(seed=1)
    st = {"mu": {"w": jnp.asarray(m)}} if momentum else {}
    f = jax.jit(lambda g_, s_, p_, lr_: JO.sgd_update(g_, s_, p_, lr_, momentum=momentum,
                                                      weight_decay=wd))
    pj, sj = f({"w": jnp.asarray(g)}, st, {"w": jnp.asarray(p)}, jnp.float32(2e-3))
    pt, stt = TO.sgd_update(torch.from_numpy(g), {"mu": torch.from_numpy(m)} if momentum else {},
                            torch.from_numpy(p), np.float32(2e-3), momentum=momentum, weight_decay=wd)
    np.testing.assert_array_equal(bits(pt), bits(pj["w"]))
    if momentum:
        np.testing.assert_array_equal(bits(stt["mu"]), bits(sj["mu"]["w"]))


def test_optimizers_step():
    """Port of tests/test_trainer.py::test_optimizers_step, plus the registry."""
    params, grads = torch.ones(4), torch.ones(4)
    p2, st = TO.adamw_update(grads, TO.adamw_init(params), params, 0.1)
    assert float(p2[0]) < 1.0 and st["count"] == 1
    p3, _ = TO.sgd_update(grads, TO.sgd_init(params, momentum=0.9), params, 0.1, momentum=0.9)
    np.testing.assert_allclose(p3.numpy(), 0.9)
    assert TO.make_optimizer("sgd:0.9").init(params)["mu"].shape == (4,)
    assert TO.make_optimizer("adamw", weight_decay=0.01).name == "adamw"
    with pytest.raises(ValueError):
        TO.make_optimizer("lion")


# -- data -----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b", "musicgen-large", "pixtral-12b"])
def test_synthetic_tokens_match_reference_bit_for_bit(arch):
    """Tokens at a few steps and seeds (text, codebooks, vlm text); the vlm
    patches are the port's own draws, bf16 of the spec's shape."""
    for seed, step in ((0, 0), (1, 3), (0, 17), (5, 1000)):
        jb = JData(JCFG.get_smoke(arch), 4, 2, 64, seed=seed).batch(step)
        tb = SyntheticLMData(TCFG.get_smoke(arch), 4, 2, 64, seed=seed, device="cpu").batch(step)
        assert tb["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
        assert set(tb) == set(jb)
        if "patches" in tb:
            assert tb["patches"].dtype == torch.bfloat16 and tb["patches"].shape == jb["patches"].shape


def test_batch_specs_match_data_and_reference():
    """Port of tests/test_trainer.py::test_batch_specs_match_data."""
    for arch in ("gemma-2b", "musicgen-large", "pixtral-12b"):
        cfg = TCFG.get_smoke(arch)
        spec = batch_specs(cfg, 3, 2, 32)
        data = SyntheticLMData(cfg, 3, 2, 32, device="cpu").batch(0)
        jspec = j_batch_specs(JCFG.get_smoke(arch), 3, 2, 32)
        assert set(spec) == set(data) == set(jspec)
        for k in spec:
            assert spec[k].shape == tuple(data[k].shape) == jspec[k].shape
            assert spec[k].dtype == data[k].dtype
            assert str(spec[k].dtype).split(".")[-1] == str(jspec[k].dtype)


def test_data_deterministic_and_sharded():
    """Port of tests/test_trainer.py::test_data_deterministic_and_sharded."""
    cfg = TCFG.get_smoke("gemma-2b")
    data = SyntheticLMData(cfg, n_workers=3, batch_per_worker=2, seq_len=32, device="cpu")
    b1, b2 = data.batch(5), data.batch(5)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (3, 2, 32)
    assert not torch.equal(b1["tokens"], data.batch(6)["tokens"])
    assert int(b1["tokens"].max()) < cfg.vocab_size
    pix = SyntheticLMData(TCFG.get_smoke("pixtral-12b"), 2, 1, 32, device="cpu")
    assert torch.equal(pix.batch(2)["patches"], pix.batch(2)["patches"])
    with pytest.raises(ValueError, match="too short"):
        SyntheticLMData(TCFG.get_smoke("pixtral-12b"), 1, 1, 16, device="cpu").batch(0)


# -- forward's training arguments -------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-236b", "zamba2-1.2b"])
def test_remat_variants_give_the_same_gradient_bit_for_bit(arch):
    """remat=False, remat=True and remat_policy="dots" recompute the same
    arithmetic: loss and flat gradient equal bit for bit (unrolled blocks,
    MoE, Mamba2 + the shared block)."""
    cfg = TCFG.get_smoke(arch)
    spec = TLM.lm_spec(cfg)
    flat0 = TLM.lm_init(cfg, device="cpu", seed=3).flat.detach()
    batch = {k: v[0] for k, v in SyntheticLMData(cfg, 1, 2, 32, device="cpu").batch(0).items()}
    out = []
    for remat, policy in ((False, None), (True, None), (True, "full"), (True, "dots")):
        flat = flat0.clone().requires_grad_(True)
        loss = TLM.loss_fn(cfg, TP.grad_tree(spec, flat), batch, chunk=16, remat=remat,
                           remat_policy=policy)
        loss.backward()
        out.append((loss.detach(), flat.grad))
    for loss, grad in out[1:]:
        assert bits(loss) == bits(out[0][0])
        np.testing.assert_array_equal(bits(grad), bits(out[0][1]))
    assert out[0][1].abs().sum() > 0


def test_forward_refuses_act_spec_and_unknown_remat_policy():
    cfg = TCFG.get_smoke("gemma-2b")
    params = TLM.lm_init(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="mesh"):
        TLM.forward(cfg, params, batch, act_spec=("data", None))
    with pytest.raises(ValueError, match="remat_policy"):
        TLM.forward(cfg, params, batch, remat_policy="offload")


def test_grad_tree_views_one_row_without_a_bf16_copy():
    """Every leaf of the training view is a view of the row (ravel order, as
    ``convert.ravel_params``); there is no bf16 twin, and the serving
    FlatParams keeps its own."""
    cfg = TCFG.get_smoke("gemma-2b")
    params = TLM.lm_init(cfg, device="cpu", seed=1)
    row = params.flat.detach().clone().requires_grad_(True)
    tree = TP.grad_tree(TLM.lm_spec(cfg), row)
    assert tree.low is None and params.tree.low is not None
    assert torch.equal(torch.cat([t.reshape(-1) for t in TP.leaves(tree)]), convert.ravel_params(params))
    assert all(t._base is row for t in TP.leaves(tree))
    assert sum(TP.leaf_sizes(TLM.lm_spec(cfg))) == TLM.count_params(cfg) == TD.tree_size(tree)
    with pytest.raises(ValueError, match="does not fit"):
        TP.grad_tree(TLM.lm_spec(cfg), row[:-1])
