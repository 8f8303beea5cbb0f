"""The port's dry-run count of the marina:perm train step against
``hlo_cost.analyze`` of the reference's jitted step, exactly, for the last
five smoke architectures (tests/test_torch_launch.py's ``_train_count`` and
``xla_only_scan_flops``; each case compiles the reference's whole train
step, so the ten architectures are two files that the suite's workers run
side by side).
"""
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.data import batch_specs as j_batch_specs  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.optim.schedules import cosine_warmup as j_cosine_warmup  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.train import init_state as j_init_state  # noqa: E402
from repro.train import make_downlink as j_make_downlink  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from test_torch_launch import ARCHS, B, CHUNK, S, W, _jflops, _train_count, xla_only_scan_flops  # noqa: E402

HALF = ARCHS[5:]


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("arch", HALF)
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
