"""The port's ``loss_fn`` and its flat gradient (autograd through
``params.grad_tree``, remat on, as the trainer runs it) against the
reference's ``jax.value_and_grad(loss_fn)`` run op by op (not jitted: its
jitted form fuses bf16 chains and, on llama4's smoke config, flips an expert
route, ROADMAP Queue 3), from the same parameters and batch, for five of
the ten smoke architectures; the other five: tests/test_torch_train_grad_b.py
(each file ~50 s on one core: the reference op by op is the cost).

The forward is bf16, so the backward's bf16 products round where the two
packages order their reductions differently. Measured on this CPU (B = 2,
S = 32, the reference's first synthetic batch), loss |diff|, max|dg| /
max|g| and ||dg|| / ||g||: zamba2 1.4e-6 / 1.02e-2 / 3.2e-3, starcoder2 0 /
7.0e-3 / 3.0e-3, gemma-2b 9.5e-7 / 4.1e-3 / 3.1e-3, deepseek-v2 9.5e-7 /
1.10e-2 / 8.6e-3, musicgen 1.9e-6 / 8.3e-3 / 3.2e-3, llama4 4.8e-7 / 1.06e-2
/ 5.4e-3, gemma3 9.5e-7 / 4.4e-4 / 6.0e-5, pixtral 9.5e-7 / 6.5e-3 / 3.4e-3,
rwkv6 9.5e-7 / 8.7e-3 / 6.6e-3, minitron 4.8e-7 / 1.1e-3 / 7.0e-4. The bounds
below hold each with a margin of about three.
"""
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.flatten_util  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

LOSS_ATOL = 1e-5   # |loss_port - loss_ref|
GRAD_RTOL = 0.03   # max |g_port - g_ref| / max |g_ref|
NORM_RTOL = 0.03   # ||g_port - g_ref|| / ||g_ref||
ARCHS = ["zamba2-1.2b", "starcoder2-7b", "gemma-2b", "musicgen-large", "gemma3-1b"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_loss_and_grad(arch):
    jcfg, tcfg = JCFG.get_smoke(arch), TCFG.get_smoke(arch)
    jp = jax.jit(functools.partial(JLM.lm_init, jcfg))(jax.random.PRNGKey(0))
    jb = {k: v[0] for k, v in JData(jcfg, 1, 2, 32).batch(0).items()}
    want_loss, want_g = jax.value_and_grad(
        lambda p: JLM.loss_fn(jcfg, p, jb, chunk=32, remat=True))(jp)
    want_g = np.asarray(jax.flatten_util.ravel_pytree(want_g)[0])
    row = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu").flat.detach()
    row = row.clone().requires_grad_(True)
    tb = {k: convert._tensor(np.asarray(v), "cpu") for k, v in jb.items()}
    loss = TLM.loss_fn(tcfg, TP.grad_tree(TLM.lm_spec(tcfg), row), tb, chunk=32, remat=True)
    loss.backward()
    got_g = row.grad.numpy()
    assert got_g.shape == want_g.shape and np.isfinite(got_g).all()
    assert abs(loss.item() - float(want_loss)) <= LOSS_ATOL, (loss.item(), float(want_loss))
    diff = got_g - want_g
    assert np.abs(diff).max() <= GRAD_RTOL * np.abs(want_g).max(), np.abs(diff).max()
    assert np.linalg.norm(diff) <= NORM_RTOL * np.linalg.norm(want_g)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_flat_gradient_match_reference(arch):
    check_loss_and_grad(arch)
