"""The port's trainer (``repro_torch.train.trainer``) against the
reference's: one ``make_train_step`` from the reference's own train state
(``convert.train_state_from_numpy``) with its batch and its draws, for every
downlink and bf16 replicas, and the participation cohort from the
reference's draws. The ports of the reference's trainer tests:
tests/test_torch_train_loop.py; the ten architectures' smoke steps:
tests/test_torch_train_smoke.py.

The reference's step is jitted (its train loop's form), which rounds its
bf16 forward elsewhere than the port (and than itself op by op: ROADMAP
Queue 3), so the loss, the gradient and everything downstream of the
gradient are held to tolerances. AdamW's second update is at most ~1.05 lr a
coordinate, so where a coordinate's tiny gradient differs in sign the two
servers may differ by up to 2.1 lr, and a replica by W times that (it adds
W times the server's delta where kept); the bulk must agree far closer.
Measured here on the CPU (gemma-2b smoke, lr 2e-3, W = 2): server max 1.31
lr (ef21p 1.44, bf16 replicas 1.65), 0.10-0.11% of coordinates beyond 0.1
lr; replicas max 2.63 lr (bf16 3.30); m within 0.2 of a percent of max|m|.
The bit counters, the step count and lr are exact.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402

import repro.fleet as JF  # noqa: E402
from repro import configs as JCFG  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.optim.schedules import constant_lr as j_constant_lr  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.train import init_state as j_init_state  # noqa: E402
from repro.train import make_downlink as j_make_downlink  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim import constant_lr, make_optimizer  # noqa: E402
from repro_torch.train import TrainerConfig, make_downlink, make_train_step  # noqa: E402
from repro_torch.train import downlink as TD  # noqa: E402
from test_torch_train_parity import _one_thread, reference_draws  # noqa: E402,F401

LR = 2e-3
LOSS_ATOL, GNORM_RTOL = 1e-3, 2e-2
PARAM_ATOL = 2.2 * LR      # two AdamW updates of opposite sign
BULK_ATOL, BULK_FRAC = 0.1 * LR, 5e-3  # all but BULK_FRAC of the server's coordinates
SPECS = ["marina:perm", "marina:ind", "marina:same", "ef21p:16:64", "none"]


def _np(state):
    return jax.tree.map(np.asarray, state)


def _close(got: torch.Tensor, want: torch.Tensor, atol=PARAM_ATOL) -> np.ndarray:
    """|got - want| (as float32), all within ``atol``."""
    diff = (got.float() - want.float()).abs().numpy()
    assert diff.max() <= atol, (diff.max(), atol)
    return diff


@pytest.mark.parametrize("spec,dtype", [(s, "float32") for s in SPECS] + [("marina:perm", "bfloat16")])
def test_train_step_from_reference_state(spec, dtype):
    """Reference: two jitted steps from its init. Port: the second step from
    the reference's state after the first, with the reference's batch and
    draws; the new state and metrics against the reference's second."""
    cfg_j, cfg_t = JCFG.get_smoke("gemma-2b"), TCFG.get_smoke("gemma-2b")
    jt = JTrainerConfig(n_workers=2, attn_chunk=32, weight_dtype=getattr(jax.numpy, dtype))
    tt = TrainerConfig(n_workers=2, attn_chunk=32, weight_dtype=getattr(torch, dtype))
    jdl, tdl = j_make_downlink(spec, 2), make_downlink(spec, 2)
    jstate = j_init_state(cfg_j, jt, jdl, j_make_optimizer("adamw"), jax.random.PRNGKey(0))
    jstep = jax.jit(j_make_train_step(cfg_j, jt, jdl, j_make_optimizer("adamw"), j_constant_lr(LR)))
    data = JData(cfg_j, 2, 2, 64)
    keys = [jax.random.fold_in(jax.random.PRNGKey(9), i) for i in range(2)]
    jstate, _ = jstep(jstate, data.batch(0), keys[0])
    state = convert.train_state_from_numpy(cfg_t, tt, _np(jstate), "cpu")
    jstate2, jm = jstep(jstate, data.batch(1), keys[1])

    sizes = TP.leaf_sizes(TLM.lm_spec(cfg_t))
    shapes = [tuple(x.shape) for x in jax.tree.leaves(jstate["server"])]
    draws = reference_draws(tdl, keys[1], shapes)
    batch = {k: convert._tensor(np.asarray(v), "cpu") for k, v in data.batch(1).items()}
    step = make_train_step(cfg_t, tt, tdl, make_optimizer("adamw"), constant_lr(LR))
    new, m = step(state, batch, draws)
    want = convert.train_state_from_numpy(cfg_t, tt, _np(jstate2), "cpu")

    assert new["step"] == want["step"] == 2 and new["opt"]["count"] == want["opt"]["count"]
    assert new["bits_per_worker"] == want["bits_per_worker"] == np.float32(jm["bits_per_worker"])
    assert new["uplink_bits_per_worker"] == want["uplink_bits_per_worker"]
    assert set(m) == set(jm)
    assert abs(m["loss"].item() - float(jm["loss"])) <= LOSS_ATOL
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=GNORM_RTOL)
    assert float(m["lr"]) == float(jm["lr"])
    assert (_close(new["server"], want["server"]) > BULK_ATOL).mean() <= BULK_FRAC
    _close(new["opt"]["m"], want["opt"]["m"], atol=2e-2 * want["opt"]["m"].abs().max().item())
    if "workers" in new:
        assert new["workers"].dtype == want["workers"].dtype and new["workers"].shape == want["workers"].shape
        bf16_ulp = 2**-8 * want["workers"].float().abs().max().item() if dtype == "bfloat16" else 0.0
        atol = (2 if isinstance(tdl, TD.MarinaPDownlink) else 1) * PARAM_ATOL + bf16_ulp
        _close(new["workers"], want["workers"], atol=atol)
        assert m["drift"].item() == pytest.approx(float(jm["drift"]), rel=0.05, abs=1e-6)


def test_trainer_participation_mask_from_reference_draws():
    """The reference's BernoulliStragglerPlan draws (fold_in(key,
    PARTICIPATION_FOLD)) give the port's step the reference's cohort and
    the same participants count and loss weighting."""
    cfg_j, cfg_t = JCFG.get_smoke("gemma-2b"), TCFG.get_smoke("gemma-2b")
    jt = JTrainerConfig(n_workers=4, attn_chunk=32, drop_prob=0.4, straggler_cutoff=1.0)
    tt = TrainerConfig(n_workers=4, attn_chunk=32, drop_prob=0.4, straggler_cutoff=1.0)
    jdl, tdl = j_make_downlink("none", 4), make_downlink("none", 4)
    jstate = j_init_state(cfg_j, jt, jdl, j_make_optimizer("sgd"), jax.random.PRNGKey(0))
    jstep = jax.jit(j_make_train_step(cfg_j, jt, jdl, j_make_optimizer("sgd"), j_constant_lr(LR)))
    state = convert.train_state_from_numpy(cfg_t, tt, _np(jstate), "cpu")
    step = make_train_step(cfg_t, tt, tdl, make_optimizer("sgd"), constant_lr(LR))
    data = JData(cfg_j, 4, 1, 32)
    seen = set()
    for i in range(4):
        key = jax.random.PRNGKey(100 + i)
        k_drop, k_lat = jax.random.split(jax.random.fold_in(key, JF.PARTICIPATION_FOLD))
        part = (torch.from_numpy(np.array(jax.random.uniform(k_drop, (4,)))),
                torch.from_numpy(np.array(jax.random.exponential(k_lat, (4,)))))
        _, jm = jstep(jstate, data.batch(i), key)
        batch = {k: convert._tensor(np.asarray(v), "cpu") for k, v in data.batch(i).items()}
        _, m = step(state, batch, TD.DownlinkDraws(part=part))
        assert float(m["participants"]) == float(jm["participants"])
        assert abs(m["loss"].item() - float(jm["loss"])) <= LOSS_ATOL
        seen.add(float(jm["participants"]))
    assert len(seen) > 1
