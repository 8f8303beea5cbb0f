"""Port of tests/test_models_smoke.py::test_smoke_train_step_no_nan: three
MARINA-P (perm) train steps of every smoke architecture on the CPU, with the
port's own draws: finite losses on a sane trajectory."""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import SyntheticLMData
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import TrainerConfig, init_state, make_downlink, make_train_step
from repro_torch.train import downlink as D

ARCHS = list(configs.ALIASES)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step_no_nan(arch):
    cfg = configs.get_smoke(arch)
    tcfg = TrainerConfig(n_workers=2, attn_chunk=32)
    dl = make_downlink("marina:perm", 2)
    opt = make_optimizer("adamw")
    state = init_state(cfg, tcfg, dl, opt, seed=0, device="cpu")
    step = make_train_step(cfg, tcfg, dl, opt, constant_lr(1e-3))
    data = SyntheticLMData(cfg, 2, 2, 64, device="cpu")
    sizes = P.leaf_sizes(lm.lm_spec(cfg))
    gen = torch.Generator().manual_seed(1)
    l0 = None
    for i in range(3):
        state, m = step(state, data.batch(i), D.draw_round(dl, sizes, gen, gen))
        assert not np.isnan(float(m["loss"]))
        if l0 is None:
            l0 = float(m["loss"])
    assert float(m["loss"]) < l0 + 1.0  # sane trajectory (not exploding)
    assert torch.isfinite(state["workers"]).all() and state["step"] == 3
