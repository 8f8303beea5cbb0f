"""The port's downlinks (``repro_torch.train.downlink``) against the
reference's ``repro.train.downlink``, bit for bit: each MARINA-P mode's
``round`` (jitted, as the train step runs it) with the reference's draws
injected, fp32 and bf16 replicas; EF21-P's; ``measure_wire``'s bits and
buffers (the device path's plain versions and the host codec against the
reference's host codec); plus ports of the downlink tests of
tests/test_trainer.py and tests/test_transport.py."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import downlink as JD  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.train import downlink as TD  # noqa: E402
from repro_torch.train import make_downlink  # noqa: E402
from repro_torch.transport import FaultSpec, Fleet, LoopbackChannel  # noqa: E402
from test_torch_train_parity import _one_thread, bits, reference_draws  # noqa: E402,F401

W = 3  # leaf sizes are not multiples of W, and 1/W is inexact
ARCH = "gemma3-1b"  # local and global attention layers


@pytest.fixture(scope="module")
def model():
    """(cfgs, reference server, server_new, leaf shapes, sizes) with
    server_new = server + a numpy-seeded delta, some of it exactly zero."""
    jcfg, tcfg = JCFG.get_smoke(ARCH), TCFG.get_smoke(ARCH)
    server = jax.jit(lambda k: JLM.lm_init(jcfg, k))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree.flatten(server)
    new = [np.asarray(x) + (rng.standard_normal(x.shape) * 1e-3
                            * (rng.random(x.shape) < 0.9)).astype(np.float32) for x in leaves]
    server_new = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in new])
    shapes = [tuple(x.shape) for x in leaves]
    return jcfg, tcfg, server, server_new, shapes, TP.leaf_sizes(TLM.lm_spec(tcfg))


def _flat(tree) -> torch.Tensor:
    return torch.from_numpy(np.concatenate([np.asarray(x, np.float32).reshape(-1)
                                            for x in jax.tree.leaves(tree)]))


def _rows(tree, dtype) -> torch.Tensor:
    """A tree of [W, ...] leaves as [W, d] in ``dtype`` (bf16 by bit pattern)."""
    return torch.cat([convert._tensor(np.asarray(x), "cpu").reshape(x.shape[0], -1)
                      for x in jax.tree.leaves(tree)], dim=1).to(dtype)


def _workers(dl, server, dtype, seed=1):
    """Replicas that differ from the server and from each other, with -0.0
    in a few coordinates (kept and dropped ones alike)."""
    rng = np.random.default_rng(seed)

    def one(x):
        w = np.broadcast_to(np.asarray(x)[None], (W,) + x.shape).copy()
        w += (rng.standard_normal(w.shape) * 1e-3).astype(np.float32)
        w.reshape(W, -1)[:, :5] = -0.0
        return jnp.asarray(w).astype(dtype)

    return jax.tree.map(one, server)


def _key(p_sync: bool, seed: int, dl) -> jax.Array:
    """A key whose coin is ``p_sync``."""
    for i in range(1000):
        key = jax.random.PRNGKey(seed * 1000 + i)
        if bool(jax.random.bernoulli(jax.random.split(key)[0], dl.sync_p)) == p_sync:
            return key
    raise AssertionError("no key")


DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("mode,keep,sync", [("perm", 0.0, False), ("ind", 0.0, False),
                                            ("same", 0.0, False), ("ind", 0.1, False),
                                            ("perm", 0.0, True)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_marina_round_matches_jitted_reference_bit_for_bit(model, mode, keep, sync, dtypes):
    """rotk_apply (perm) and the Bernoulli masks (ind/same; keep 0.1: XLA's
    reciprocal product) on every leaf, -0.0 turned +0.0 where dropped, the
    sync branch's cast (the same in every mode), and the bits, from the
    reference's draws."""
    jcfg, tcfg, server, server_new, shapes, sizes = model
    jdt, tdt = dtypes
    jdl = JD.MarinaPDownlink(n_workers=W, mode=mode, keep_frac=keep)
    tdl = TD.MarinaPDownlink(n_workers=W, mode=mode, keep_frac=keep)
    workers = _workers(jdl, server, jdt)
    key = _key(sync, 3, jdl)
    want, want_bits = jax.jit(jdl.round)(key, server_new, server, workers)
    draws = reference_draws(tdl, key, shapes)
    assert draws.coin == sync
    got, got_bits = tdl.round(draws, sizes, _flat(server_new), _flat(server), _rows(workers, tdt))
    assert got.dtype == tdt and got.shape == (W, sum(sizes))
    want = _rows(want, tdt)
    np.testing.assert_array_equal(got.view(torch.int16 if tdt == torch.bfloat16 else torch.int32).numpy(),
                                  want.view(torch.int16 if tdt == torch.bfloat16 else torch.int32).numpy())
    assert bits(got_bits) == bits(want_bits)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("force_sync", [False, True])
def test_ef21p_round_matches_jitted_reference_bit_for_bit(model, dtypes, force_sync):
    """block_topk per leaf (the leaf's own padded last block), the shift in
    its dtype, force_sync's re-anchor, and the bits."""
    jcfg, tcfg, server, server_new, shapes, sizes = model
    jdt, tdt = dtypes
    jdl, tdl = JD.EF21PDownlink(W, 16, 64), TD.EF21PDownlink(W, 16, 64)
    shift = jax.tree.map(lambda x: x.astype(jdt), server)
    want, want_bits = jax.jit(jdl.round)(jax.random.PRNGKey(0), server_new, shift, force_sync)
    got, got_bits = tdl.round(TD.DownlinkDraws(), sizes, _flat(server_new),
                              _flat(shift).to(tdt), force_sync)
    assert got.dtype == tdt and torch.equal(got.float(), _flat(want))
    assert bits(got_bits) == bits(want_bits)
    np.testing.assert_allclose(tdl.worker_drift(_flat(server_new), got).item(),
                               float(jdl.worker_drift(server_new, want)), rtol=1e-5)


def _ref_bufs(jdl, key, server_new, server, mag):
    k_bern, k_comp = jax.random.split(key)
    return jdl._sparse_bufs(k_comp, server_new, server, mag, device_encode=False)


@pytest.mark.parametrize("mode,keep", [("perm", 0.0), ("ind", 0.0), ("same", 0.0), ("ind", 0.1)])
@pytest.mark.parametrize("mag", ["fp32", "bf16"])
def test_marina_wire_buffers_and_bits_match_reference(model, mode, keep, mag):
    """The per-worker messages, byte for byte: the host codec and the device
    path (the encode kernels' plain versions on the CPU) against the
    reference's host codec; measure_wire's bits against the reference's."""
    jcfg, tcfg, server, server_new, shapes, sizes = model
    jdl = JD.MarinaPDownlink(n_workers=W, mode=mode, keep_frac=keep)
    tdl = TD.MarinaPDownlink(n_workers=W, mode=mode, keep_frac=keep)
    key = _key(False, 5, jdl)
    draws = reference_draws(tdl, key, shapes)
    want = _ref_bufs(jdl, key, server_new, server, mag)
    for device_encode in (False, True):
        got = tdl._sparse_bufs(draws, sizes, _flat(server_new), _flat(server), mag, device_encode)
        assert got == want
    res = tdl.measure_wire(draws, sizes, _flat(server_new), _flat(server), mag=mag)
    ref = jdl.measure_wire(key, server_new, server, mag=mag, device_encode=False)
    assert res == ref


def test_marina_sync_and_ef21p_wire_match_reference(model):
    """A sync round's DENSE buffer, and EF21-P's block-TopK message, host and
    device paths against the reference's host codec."""
    jcfg, tcfg, server, server_new, shapes, sizes = model
    jdl = JD.MarinaPDownlink(n_workers=W, mode="perm")
    tdl = TD.MarinaPDownlink(n_workers=W, mode="perm")
    key = _key(True, 7, jdl)
    draws = reference_draws(tdl, key, shapes)
    for mag in ("fp32", "fp16"):
        ref = jdl.measure_wire(key, server_new, server, mag=mag, device_encode=False)
        for de in (False, True):
            assert tdl.measure_wire(draws, sizes, _flat(server_new), _flat(server), mag=mag,
                                    device_encode=de) == ref
    jef, tef = JD.EF21PDownlink(W, 16, 64), TD.EF21PDownlink(W, 16, 64)
    want = jef._delta_buf(server_new, server, "fp32", device_encode=False)
    for de in (False, True):
        assert tef._delta_buf(sizes, _flat(server_new), _flat(server), "fp32", de) == want
    assert (tef.measure_wire(TD.DownlinkDraws(), sizes, _flat(server_new), _flat(server))
            == jef.measure_wire(jax.random.PRNGKey(0), server_new, server, device_encode=False))


def test_draw_round_shapes_and_branches():
    """The port's own draws: the coin on the host, nothing more on a sync
    round, one int32 rotation a leaf (perm), bool masks [W, size] (ind) or
    [size] (same), nothing for EF21-P and None."""
    sizes = (10, 7, 33)
    gen, dgen = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    coins = []
    for _ in range(40):
        d = TD.draw_round(TD.MarinaPDownlink(W, "perm"), sizes, gen, dgen)
        coins.append(d.coin)
        assert d.rot is None if d.coin else (d.rot.dtype == torch.int32 and d.rot.shape == (3,))
        assert 0 <= d.seed < 2**32
    assert 0 < sum(coins) < 40
    d = TD.draw_round(TD.MarinaPDownlink(W, "ind", p=1e-9), sizes, gen, dgen)
    assert [tuple(m.shape) for m in d.masks] == [(W, s) for s in sizes]
    d = TD.draw_round(TD.MarinaPDownlink(W, "same", p=1e-9), sizes, gen, dgen)
    assert [tuple(m.shape) for m in d.masks] == [(s,) for s in sizes]
    assert all(m.dtype == torch.bool for m in d.masks)
    assert TD.draw_round(TD.EF21PDownlink(W), sizes, gen, dgen) == TD.DownlinkDraws()
    assert TD.draw_round(None, sizes, gen, dgen) == TD.DownlinkDraws()


def test_make_downlink_specs():
    assert make_downlink("none", 2) is None
    dl = make_downlink("marina:ind:0.0625", 4)
    assert (dl.mode, dl.frac, dl.omega(), dl.sync_p) == ("ind", 0.0625, 15.0, 0.25)
    assert make_downlink("marina", 3).omega() == 2.0
    ef = make_downlink("ef21p:16:64", 2)
    assert (ef.k_per_block, ef.block) == (16, 64)
    with pytest.raises(ValueError):
        make_downlink("qsgd", 2)


# -- ports of tests/test_trainer.py ------------------------------------------------


@pytest.fixture(scope="module")
def small():
    cfg = TCFG.get_smoke("gemma-2b")
    flat = TLM.lm_init(cfg, device="cpu", seed=0).flat.detach()
    return cfg, flat, TP.leaf_sizes(TLM.lm_spec(cfg))


def test_marina_workers_average_tracks_server(small):
    """RotK exact-mean: mean_i w_i == x after a no-sync round."""
    cfg, server, sizes = small
    dl = TD.MarinaPDownlink(n_workers=4, mode="perm", p=1e-9)  # never full-sync
    workers = dl.init_workers(server)
    server_new = server + 0.01
    draws = TD.draw_round(dl, sizes, torch.Generator().manual_seed(1), torch.Generator().manual_seed(1))
    new_workers, b = dl.round(draws, sizes, server_new, server, workers)
    assert (new_workers.mean(0) - server_new).abs().max().item() < 1e-5
    assert float(b) > 0


def test_ef21p_downlink_drift_contracts(small):
    """Repeated rounds at a fixed server point must contract the shift error."""
    cfg, server, sizes = small
    dl = TD.EF21PDownlink(n_workers=2, k_per_block=16, block=64)
    target = server + 0.1
    shift = dl.init_shift(server)
    drifts = []
    for _ in range(6):
        shift, _ = dl.round(TD.DownlinkDraws(), sizes, target, shift)
        drifts.append(float(dl.worker_drift(target, shift)))
    assert drifts[-1] < 0.3 * drifts[0]


# -- port of tests/test_transport.py::test_downlink_broadcast_via_resync_promotion --


def test_downlink_broadcast_via_resync_promotion():
    """A fleet whose delivery fails reports resync_needed; the next
    broadcast_via(force_sync=True) ships a SYNC that clears it."""
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(arch_id="t", family="gqa", num_layers=1, d_model=32, num_heads=2,
                      num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
    sizes = TP.leaf_sizes(TLM.lm_spec(cfg))
    params = TLM.lm_init(cfg, device="cpu").flat.detach()
    new = params + 0.01
    dl = TD.MarinaPDownlink(n_workers=2, mode="perm")
    gen = torch.Generator().manual_seed(1)
    draws = TD.draw_round(dl, sizes, gen, gen)
    while draws.coin:
        draws = TD.draw_round(dl, sizes, gen, gen)

    fleet = Fleet.make(2, FaultSpec(drop=1.0, seed=0), timeout=1, max_retries=0)
    res = dl.broadcast_via(fleet, draws, sizes, new, params)
    assert res["resync_needed"]
    assert res["delivered_frac"] == 0.0

    for link in fleet:  # the links heal: swap the faulty channels for clean ones
        link.data = link.sender.data = LoopbackChannel()
    res = dl.broadcast_via(fleet, draws, sizes, new, params, force_sync=True)
    assert res["full_sync"] and all(res["oks"])
    assert not res["resync_needed"]
    assert fleet.stats().forced_syncs == 2
