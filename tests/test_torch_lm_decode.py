"""The port's ``decode_step`` against the reference's for all ten smoke
architectures, from the reference's own decode caches
(``convert.lm_caches_from_numpy``) (tolerances: tests/test_torch_lm.py).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as JLM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from test_torch_lm import ALL_ARCHS, ATOL, B, PREFIX, RTOL, S, _close, _one_thread, _setup  # noqa: E402,F401


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_step_matches_reference_from_its_caches(arch):
    """The reference decodes PREFIX tokens (jitted); its caches, converted,
    feed one port step and one reference step at position PREFIX: logits and
    every new cache leaf agree, the caches' dtypes kept."""
    jcfg, tcfg, jp, tp, tokens, _ = _setup(arch)
    step = jax.jit(lambda p, c, t, i: JLM.decode_step(jcfg, p, c, t, i))
    jc = JLM.cache_init(jcfg, B, S)
    for i in range(PREFIX):
        _, jc = step(jp, jc, jnp.asarray(tokens[..., i:i + 1]), jnp.int32(i))
    tc = convert.lm_caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    tok = tokens[..., PREFIX:PREFIX + 1]
    jl, jn = JLM.decode_step(jcfg, jp, jc, jnp.asarray(tok), jnp.int32(PREFIX))
    tl, tn = TLM.decode_step(tcfg, tp, tc, torch.from_numpy(tok).long(), PREFIX)
    _close(tl, jl)
    want = TP.leaves_with_path(jax.tree.map(np.asarray, jn))
    got = TP.leaves_with_path(tn)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == (torch.bfloat16 if w.dtype.name == "bfloat16" else torch.float32), path
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=RTOL, atol=ATOL,
                                   err_msg=TP.path_key(path))
