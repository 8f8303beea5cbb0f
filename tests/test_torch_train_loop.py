"""Ports of the reference's trainer tests to ``repro_torch.train``:
tests/test_trainer.py (all but the serve tests, which
tests/test_torch_serve.py holds), the trainer tests of tests/test_fleet.py
and tests/test_transport.py, and the port's own draw and act_spec checks.
The port runs on the CPU with its own draws; the reference's state and
draws: tests/test_torch_train_step.py."""
import math
import os

import numpy as np
import pytest
import torch

from repro_torch import configs as TCFG
from repro_torch import obs
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.data import SyntheticLMData
from repro_torch.fleet import AvailabilityWindowPlan, BernoulliStragglerPlan
from repro_torch.models import lm as TLM
from repro_torch.models import params as TP
from repro_torch.models.config import ModelConfig
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import TrainerConfig, init_state, make_downlink, make_train_step, train_loop
from repro_torch.train import downlink as TD
from repro_torch.transport import FaultSpec

LR = 2e-3
SPECS = ["marina:perm", "marina:ind", "marina:same", "ef21p:16:64", "none"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- ports of tests/test_trainer.py ----------------------------------------------------


@pytest.fixture(scope="module")
def small():
    return TCFG.get_smoke("gemma-2b"), TrainerConfig(n_workers=2, attn_chunk=32)


def _run(cfg, tcfg, spec, steps=8, polyak=0.0, opt="adamw"):
    if polyak:
        tcfg = TrainerConfig(n_workers=tcfg.n_workers, attn_chunk=tcfg.attn_chunk, polyak_factor=polyak)
    dl = make_downlink(spec, tcfg.n_workers)
    optimizer = make_optimizer(opt)
    state = init_state(cfg, tcfg, dl, optimizer, seed=0, device="cpu")
    step = make_train_step(cfg, tcfg, dl, optimizer, constant_lr(LR))
    data = SyntheticLMData(cfg, tcfg.n_workers, 2, 64, device="cpu")
    sizes = TP.leaf_sizes(TLM.lm_spec(cfg))
    gen = torch.Generator().manual_seed(9)
    hist = []
    for i in range(steps):
        state, m = step(state, data.batch(i), TD.draw_round(dl, sizes, gen, gen))
        hist.append(float(m["loss"]))
    return state, hist, m


@pytest.mark.parametrize("spec", SPECS)
def test_loss_decreases_all_downlinks(small, spec):
    cfg, tcfg = small
    _, hist, _ = _run(cfg, tcfg, spec, steps=10)
    assert hist[-1] < hist[0], (spec, hist)
    assert not any(np.isnan(hist))


def test_polyak_lr_runs(small):
    cfg, tcfg = small
    _, hist, m = _run(cfg, tcfg, "marina:perm", steps=6, polyak=0.5)
    assert float(m["lr"]) > 0 and not np.isnan(hist[-1])


def test_bits_accounting_formula(small):
    cfg, tcfg = small
    d = TLM.count_params(cfg)
    _, _, m = _run(cfg, tcfg, "marina:perm", steps=4)
    bits = float(m["bits_per_worker"])
    # between 4 sparse rounds and 4 dense rounds
    lo = 4 * (65 + math.log2(d)) * d / 2 * 0.9
    hi = 4 * 64.0 * d * 1.1
    assert lo <= bits <= hi


def test_checkpoint_roundtrip(tmp_path, small):
    """Port of test_checkpoint_roundtrip on a trained server (the path
    train_lm.py saves): the reference's file format, every leaf exact."""
    cfg, tcfg = small
    state, _, _ = _run(cfg, tcfg, "marina:perm", steps=2)
    tree = TP.grad_tree(TLM.lm_spec(cfg), state["server"])
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, tree, step=7, extra={"arch": cfg.arch_id})
    restored, meta = load_checkpoint(path, TLM.lm_init(cfg, device="cpu"))
    assert meta["step"] == 7 and meta["extra"]["arch"] == cfg.arch_id
    assert torch.equal(restored.flat, state["server"])


def test_train_loop_tracker_and_uplink_bits(small):
    """train_loop logs step timers + metrics; uplink accrues dense bits/step."""
    cfg, tcfg = small
    tr = obs.MemoryTracker()
    data = SyntheticLMData(cfg, tcfg.n_workers, 2, 64, device="cpu")
    state, m = train_loop(cfg, tcfg, make_downlink("marina:perm", tcfg.n_workers), make_optimizer("adamw"),
                          constant_lr(LR), data, steps=3, seed=0, device="cpu", tracker=tr)
    timers = [e for e in tr.events if e["kind"] == "timer"]
    assert [t["name"] for t in timers] == ["train/step"] * 3
    assert all(t["seconds"] > 0 for t in timers)
    mets = [e for e in tr.events if e["kind"] == "metrics"]
    d = state["server"].numel()
    assert float(m["uplink_bits_per_worker"]) == pytest.approx(3 * 64.0 * d, rel=1e-6)
    assert mets[-1]["metrics"]["train/uplink_bits_per_worker"] == pytest.approx(
        float(m["uplink_bits_per_worker"]), rel=1e-6)
    assert "train/loss" in mets[0]["metrics"]
    rounds = [e for e in tr.events if e["kind"] == "span" and e["name"] == "round"]
    assert len(rounds) == 3 and all("loss" in r["attrs"] for r in rounds)


def test_train_loop_draws_through_the_monkeypatchable_draw_round(small, monkeypatch):
    """train_loop takes every round's draws from downlink.draw_round, so a
    test can inject them: forcing a sync every round keeps the replicas
    equal to the server."""
    cfg, tcfg = small
    monkeypatch.setattr(TD, "draw_round", lambda dl, sizes, g, dg: TD.DownlinkDraws(coin=True))
    data = SyntheticLMData(cfg, tcfg.n_workers, 2, 64, device="cpu")
    state, m = train_loop(cfg, tcfg, make_downlink("marina:ind", 2), make_optimizer("sgd"),
                          constant_lr(LR), data, steps=2, device="cpu")
    assert torch.equal(state["workers"], state["server"].expand(2, -1))
    assert float(m["drift"]) == 0.0 and float(m["bits_per_worker"]) == 2 * 64.0 * state["server"].numel()


def test_trainer_refuses_act_spec(small):
    cfg, _ = small
    tcfg = TrainerConfig(n_workers=2, attn_chunk=32, act_spec=("data", None, None))
    dl = make_downlink("none", 2)
    opt = make_optimizer("sgd")
    step = make_train_step(cfg, tcfg, dl, opt, constant_lr(LR))
    state = init_state(cfg, tcfg, dl, opt, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        step(state, SyntheticLMData(cfg, 2, 1, 16, device="cpu").batch(0))


# -- ports of tests/test_fleet.py's trainer tests ------------------------------------------


def _train(tcfg, steps=4, inject=None):
    """tests/test_fleet.py::_train: sgd, marina:perm, the plan's draws from
    the port's generators (or ``inject(i)``)."""
    cfg = TCFG.get_smoke("gemma-2b")
    dl = make_downlink("marina:perm", tcfg.n_workers)
    opt = make_optimizer("sgd")
    state = init_state(cfg, tcfg, dl, opt, seed=0, device="cpu")
    step = make_train_step(cfg, tcfg, dl, opt, constant_lr(LR))
    data = SyntheticLMData(cfg, tcfg.n_workers, 2, 64, device="cpu")
    sizes = TP.leaf_sizes(TLM.lm_spec(cfg))
    plan = tcfg.participation or BernoulliStragglerPlan(tcfg.drop_prob, tcfg.straggler_cutoff)
    gen, pgen = torch.Generator().manual_seed(9), plan.generator(9)
    losses = []
    for i in range(steps):
        draws = TD.draw_round(dl, sizes, gen, gen)._replace(part=plan.draw(tcfg.n_workers, pgen, "cpu"))
        state, m = step(state, data.batch(i), draws)
        losses.append(float(m["loss"]))
    return state, losses, m


def test_trainer_legacy_knobs_bit_identical_to_plan():
    """Identical seeds must give identical cohorts — and therefore
    bit-identical trajectories — via the legacy shim or the explicit plan."""
    legacy = TrainerConfig(n_workers=2, attn_chunk=32, drop_prob=0.4)
    plan = TrainerConfig(n_workers=2, attn_chunk=32, participation=BernoulliStragglerPlan(drop_prob=0.4))
    s1, l1, m1 = _train(legacy)
    s2, l2, m2 = _train(plan)
    assert l1 == l2
    assert torch.equal(s1["server"], s2["server"])
    assert float(m1["participants"]) == float(m2["participants"])


def test_trainer_availability_plan_smoke():
    tcfg = TrainerConfig(n_workers=2, attn_chunk=32,
                         participation=AvailabilityWindowPlan(phases=(0, 12), period=24, open_ticks=12))
    _, losses, m = _train(tcfg)
    assert np.isfinite(losses).all()
    assert float(m["participants"]) == 1.0  # anti-phased: one worker per round


def test_trainer_conflicting_participation_config_raises():
    cfg = TCFG.get_smoke("gemma-2b")
    tcfg = TrainerConfig(n_workers=2, drop_prob=0.1, participation=BernoulliStragglerPlan(drop_prob=0.1))
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(cfg, tcfg, None, make_optimizer("sgd"), constant_lr(1e-2))


# -- ports of tests/test_transport.py's trainer tests ----------------------------------------


# tests/test_transport.py's acceptance fault model
ACCEPT_SPEC = FaultSpec(drop=0.10, corrupt=0.02, reorder=0.10, reorder_window=4, seed=0)


@pytest.fixture(scope="module")
def tiny_lm():
    return ModelConfig(arch_id="t", family="gqa", num_layers=1, d_model=32, num_heads=2,
                       num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)


def test_train_loop_degraded_transport(tiny_lm):
    n = 4
    tcfg = TrainerConfig(n_workers=n, remat=False, attn_chunk=32, drop_prob=0.25, straggler_cutoff=2.0)
    data = SyntheticLMData(tiny_lm, n, 2, 64, device="cpu")
    state, m = train_loop(tiny_lm, tcfg, make_downlink("marina:perm", n), make_optimizer("adamw"),
                          constant_lr(LR), data, steps=5, seed=0, device="cpu",
                          transport=ACCEPT_SPEC.with_seed(3))
    assert np.isfinite(float(m["loss"]))
    assert 1 <= float(m["participants"]) <= n
    tr = m["transport"]
    assert tr["transport/delivered_frames"] > 0
    assert 0.0 < tr["transport/goodput"] <= 1.0


def test_trainer_full_participation_unchanged(tiny_lm):
    """drop_prob=0, no transport: no participants metric."""
    n = 2
    tcfg = TrainerConfig(n_workers=n, remat=False, attn_chunk=32)
    dl = make_downlink("marina:perm", n)
    opt = make_optimizer("adamw")
    state = init_state(tiny_lm, tcfg, dl, opt, device="cpu")
    step = make_train_step(tiny_lm, tcfg, dl, opt, constant_lr(LR))
    gen = torch.Generator().manual_seed(1)
    draws = TD.draw_round(dl, TP.leaf_sizes(TLM.lm_spec(tiny_lm)), gen, gen)
    state, m = step(state, SyntheticLMData(tiny_lm, n, 2, 64, device="cpu").batch(0), draws)
    assert "participants" not in m
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("spec", ["marina:perm", "ef21p:16:64"])
def test_train_loop_through_a_lossy_fleet_resyncs(tiny_lm, spec):
    """Every degraded round promotes the next to a full sync, which repairs
    the receivers: forced syncs counted, a SYNC frame per promotion."""
    tcfg = TrainerConfig(n_workers=3, remat=False, attn_chunk=32)
    tr = obs.MemoryTracker()
    state, m = train_loop(tiny_lm, tcfg, make_downlink(spec, 3), make_optimizer("adamw"), constant_lr(LR),
                          SyntheticLMData(tiny_lm, 3, 1, 32, device="cpu"), steps=8, seed=1, device="cpu",
                          tracker=tr, transport=FaultSpec(drop=0.5, seed=2))
    t = m["transport"]
    assert t["transport/frames_sent"] > 0 and t["transport/forced_syncs"] > 0
    names = {e["name"] for e in tr.events if e["kind"] == "span"}
    assert {"round", "broadcast", "encode"} <= names
