"""The port's whole LM (``repro_torch.models.lm``) against the reference's
``repro.models.lm`` for all ten smoke architectures: ``forward`` on the same
tokens (patches for pixtral), with the parameters from
``convert.lm_params_from_numpy(lm_init(...))``. ``decode_step``:
tests/test_torch_lm_decode.py, which shares :func:`_setup`.

The reference runs op by op (its jitted form fuses bf16 chains and rounds
elsewhere: on llama4's smoke config that alone flips an expert route and
moves a logit by 2.06). Most architectures then agree bit for bit; the rest
differ by the reductions' order (see tests/test_torch_models.py), measured
at most 0.024 on forward logits of |logit| <= 4.8 (pixtral) and 0.033 on a
decode step (rwkv6). ``RTOL``/``ATOL`` hold them three times tighter than
the reference's own decode-vs-forward bound (rtol = atol = 0.12).
"""
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402

RTOL, ATOL = 0.02, 0.04
ALL_ARCHS = list(JCFG.ALIASES)
B, S, PREFIX = 2, 32, 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(cfgs, reference params, port params, tokens, patches) of one arch."""
    jcfg, tcfg = JCFG.get_smoke(arch), TCFG.get_smoke(arch)
    jp = jax.jit(functools.partial(JLM.lm_init, jcfg))(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    shape = (B, jcfg.num_codebooks, S) if jcfg.num_codebooks else (B, S)
    tokens = rng.integers(0, jcfg.vocab_size, shape).astype(np.int32)
    patches = (rng.standard_normal((B, jcfg.num_patches, jcfg.d_model)).astype(np.float32)
               if jcfg.num_patches else None)
    return jcfg, tcfg, jp, tp, tokens, patches


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp, tokens, patches = _setup(arch)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens).long()}
    if patches is not None:
        jb["patches"], tb["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
    want = JLM.forward(jcfg, jp, jb, chunk=8, remat=False)
    got = TLM.forward(tcfg, tp, tb, chunk=8)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.bfloat16
    _close(got, want)
