"""The port's copy of the reference's configs (``repro_torch.configs``,
``models/config.py``): every field of the ten full and smoke configs, the
stacking plan, and the parameter count and parameter tree of the full
configs from shapes alone, against ``jax.eval_shape`` of the reference's
``lm_init``.
"""
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ALL_ARCHS = list(JCFG.ALIASES)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_and_spec_match_reference_full_configs(arch):
    """count_params (total and active) and every parameter's path and shape
    equal the reference's eval_shape of lm_init, at full width, with no
    allocation."""
    jcfg, tcfg = JCFG.get(arch), TCFG.get(arch)
    assert tcfg == TCFG.get(arch) and tcfg.block_pattern == jcfg.block_pattern
    assert tcfg.param_count() == jcfg.param_count() == JLM.count_params(jcfg)
    assert tcfg.active_param_count() == jcfg.active_param_count()
    shapes = jax.eval_shape(lambda k: JLM.lm_init(jcfg, k), jax.random.PRNGKey(0))
    want = [("/".join(jax.tree_util.keystr((p,)).strip("[]'\".") for p in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [(TP.path_key(p), leaf.shape) for p, leaf in TP.leaves_with_path(TLM.lm_spec(tcfg))]
    assert got == want
    if arch == "gemma3-1b":
        assert tcfg.param_count() == 999_812_736


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_plan_stack_and_configs_match_reference(arch):
    for get in ("get", "get_smoke"):
        jcfg, tcfg = getattr(JCFG, get)(arch), getattr(TCFG, get)(arch)
        assert {f.name: getattr(tcfg, f.name) for f in tcfg.__dataclass_fields__.values()
                if f.name not in ("moe", "mla", "mamba", "rwkv")} == \
            {f.name: getattr(jcfg, f.name) for f in jcfg.__dataclass_fields__.values()
             if f.name not in ("moe", "mla", "mamba", "rwkv")}
        for sub in ("moe", "mla", "mamba", "rwkv"):
            a, b = getattr(tcfg, sub), getattr(jcfg, sub)
            assert (a is None) == (b is None) and (a is None or vars(a) == vars(b))
        assert [tuple(vars(s).values()) for s in TT.plan_stack(tcfg.block_pattern)] == \
            [tuple(vars(s).values()) for s in JT.plan_stack(jcfg.block_pattern)]
