"""The port's LM layers (``repro_torch.models``) against the reference's
``repro.models``, module by module, on the same numpy-seeded inputs, plus
ports of
``tests/test_decode_consistency.py`` (the port's decode against its own
forward). The configs, counts and plans: tests/test_torch_configs.py; the
whole LM against the reference: tests/test_torch_lm.py (forward) and
tests/test_torch_lm_decode.py (decode).

The reference runs op by op, as its functions read. The port's bf16
matmuls run on the CPU as an fp32 product rounded once to bf16, which is
what XLA's CPU backend computes, so most modules agree bit for bit. Where
the two packages reduce in another order (the fp32 sums of a norm's
variance, a softmax, an einsum, RoPE's ``pow``), a bf16 output can round one
ulp apart and the next op carries that on: ``RTOL``/``ATOL`` below, one bf16
ulp relative plus a small absolute term, ten times tighter than the
reference's own decode-vs-forward bound (rtol = atol = 0.12).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.config import MambaConfig, MLAConfig, ModelConfig, MoEConfig, RWKVConfig  # noqa: E402

RTOL, ATOL = 2**-7, 1e-3  # module outputs against the reference (see the docstring)

ALL_ARCHS = list(JCFG.ALIASES)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _bf16(rng, shape, scale=1.0):
    """(jax, torch) bf16 copies of one numpy-seeded normal array."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _params(spec, seed):
    """A parameter tree drawn with numpy in the spec's shapes: (jax tree, port tree)."""
    rng = np.random.default_rng(seed)
    tree = TP.map_tree(lambda leaf: (rng.standard_normal(leaf.shape) * leaf.scale
                                     if leaf.init != "uniform" else rng.random(leaf.shape))
                       .astype(np.float32), spec)
    return jax.tree.map(jnp.asarray, tree), TP.map_tree(torch.from_numpy, tree)


def _cfg(**kw):
    base = dict(arch_id="t", family="dense", num_layers=1, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, d_ff=96, vocab_size=64, block_pattern=("attn",))
    base.update(kw)
    return ModelConfig(**base)


# -- layers ------------------------------------------------------------------


def test_rmsnorm():
    rng = np.random.default_rng(0)
    xj, xt = _bf16(rng, (3, 5, 96), scale=3.0)
    scale = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    _close(TL.rmsnorm({"scale": torch.from_numpy(scale)}, xt, 1e-6),
           JL.rmsnorm({"scale": jnp.asarray(scale)}, xj, 1e-6), atol=0)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_rotates_halves_like_reference(theta):
    rng = np.random.default_rng(1)
    xj, xt = _bf16(rng, (2, 7, 3, 32))
    pos = rng.integers(0, 700, (2, 7))
    got = TL.apply_rope(xt, torch.from_numpy(pos), theta)
    _close(got, JL.apply_rope(xj, jnp.asarray(pos), theta))
    # halves, not interleaved pairs: position 0 is the identity
    assert torch.equal(TL.apply_rope(xt, torch.zeros(2, 7, dtype=torch.long), theta), xt)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_kinds(kind):
    jp, tp = _params(TL.mlp_spec(64, 96, kind), seed=2)
    xj, xt = _bf16(np.random.default_rng(3), (2, 5, 64))
    _close(TL.mlp_apply(tp, xt, kind), JL.mlp_apply(jp, xj, kind))


@pytest.mark.parametrize("window,q_offset,kv", [(None, 0, 2), (5, 0, 1), (None, 6, 4), (9, 4, 2)])
def test_chunked_attention(window, q_offset, kv):
    rng = np.random.default_rng(4)
    qj, qt = _bf16(rng, (2, 11 if q_offset else 17, 4, 16))
    kj, kt = _bf16(rng, (2, 17, kv, 16))
    vj, vt = _bf16(rng, (2, 17, kv, 16))
    _close(TL.chunked_attention(qt, kt, vt, q_offset=q_offset, window=window, chunk=4),
           JL.chunked_attention(qj, kj, vj, q_offset=q_offset, window=window, chunk=4))


@pytest.mark.parametrize("window,chunk", [(5, 4), (16, 8), (3, 8)])
def test_windowed_attention(window, chunk):
    rng = np.random.default_rng(5)
    qj, qt = _bf16(rng, (2, 21, 4, 16))
    kj, kt = _bf16(rng, (2, 21, 2, 16))
    vj, vt = _bf16(rng, (2, 21, 2, 16))
    _close(TL.windowed_attention(qt, kt, vt, window=window, chunk=chunk),
           JL.windowed_attention(qj, kj, vj, window=window, chunk=chunk))


def test_decode_attention():
    rng = np.random.default_rng(6)
    qj, qt = _bf16(rng, (3, 1, 4, 16))
    kj, kt = _bf16(rng, (3, 9, 2, 16))
    vj, vt = _bf16(rng, (3, 9, 2, 16))
    valid = rng.random((3, 9)) < 0.6
    valid[:, 0] = True
    _close(TL.decode_attention(qt, kt, vt, torch.from_numpy(valid)),
           JL.decode_attention(qj, kj, vj, jnp.asarray(valid)))


def _cache_pair(rng, shapes: dict):
    cj, ct = {}, {}
    for k, shape in shapes.items():
        cj[k], ct[k] = _bf16(rng, shape)
    return cj, ct


@pytest.mark.parametrize("pos,window", [(3, None), (13, None), (21, 6), (8, 8)])
def test_attention_decode_ring_buffer(pos, window):
    """slot = pos % L with the absolute positions rebuilt per slot: an 8-slot
    cache at positions past 8 (wrapped), with and without a window."""
    cfg = _cfg()
    jp, tp = _params(TL.attention_spec(cfg), seed=7)
    rng = np.random.default_rng(8)
    xj, xt = _bf16(rng, (2, 1, cfg.d_model))
    cj, ct = _cache_pair(rng, {"k": (2, 8, 2, 16), "v": (2, 8, 2, 16)})
    yj, nj = JL.attention_decode(cfg, jp, xj, cj, jnp.int32(pos), window=window)
    yt, nt = TL.attention_decode(cfg, tp, xt, ct, pos, window=window)
    _close(yt, yj)
    for k in ("k", "v"):
        _close(nt[k], nj[k])


def _mla_cfg():
    return _cfg(num_heads=4, num_kv_heads=4, head_dim=16,
                mla=MLAConfig(kv_lora_rank=24, rope_head_dim=8, nope_head_dim=16, v_head_dim=12))


@pytest.mark.parametrize("window", [None, 6])
def test_mla_apply(window):
    cfg = _mla_cfg()
    jp, tp = _params(TL.mla_spec(cfg), seed=9)
    xj, xt = _bf16(np.random.default_rng(10), (2, 13, cfg.d_model))
    _close(TL.mla_apply(cfg, tp, xt, window=window, chunk=4),
           JL.mla_apply(cfg, jp, xj, window=window, chunk=4))


@pytest.mark.parametrize("pos", [2, 11])
def test_mla_absorbed_decode(pos):
    cfg = _mla_cfg()
    jp, tp = _params(TL.mla_spec(cfg), seed=11)
    rng = np.random.default_rng(12)
    xj, xt = _bf16(rng, (2, 1, cfg.d_model))
    cj, ct = _cache_pair(rng, {"c": (2, 8, 24), "k_rope": (2, 8, 8)})
    yj, nj = JL.mla_decode(cfg, jp, xj, cj, jnp.int32(pos))
    yt, nt = TL.mla_decode(cfg, tp, xt, ct, pos)
    _close(yt, yj)
    for k in ("c", "k_rope"):
        _close(nt[k], nj[k])


# -- MoE -----------------------------------------------------------------------


def _moe_cfg(E=4, K=3, cap=0.5, shared=1):
    return _cfg(family="moe", block_pattern=("moe",),
                moe=MoEConfig(num_experts=E, top_k=K, d_ff_expert=48, num_shared=shared,
                              d_ff_shared=32, capacity_factor=cap))


def test_top_k_keeps_lower_index_on_ties():
    rng = np.random.default_rng(13)
    probs = rng.choice([0.1, 0.2, 0.3], size=(50, 6)).astype(np.float32)  # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = TMOE.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_group_by_expert_matches_reference():
    ids = np.random.default_rng(14).integers(0, 5, 40).astype(np.int32)
    js, jk = JMOE._group_by_expert(jnp.asarray(ids), 5, 3)
    ts, tk = TMOE._group_by_expert(torch.from_numpy(ids).long(), 5, 3)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("K,cap,tie", [(3, 0.5, False), (1, 8.0, True), (2, 0.25, True), (3, 2.0, False)])
def test_moe_apply_drops_and_ties(K, cap, tie):
    """Capacity drops (cap < 1 drops copies), tied router probabilities (two
    experts' router columns equal: the lower index wins, as lax.top_k), and
    K = 3 copies summed in bf16 in the reference's order."""
    cfg = _moe_cfg(K=K, cap=cap)
    jp, tp = _params(TMOE.moe_spec(cfg), seed=15)
    if tie:
        for tree in (jp, tp):
            r = tree["router"]
            tree["router"] = r.at[:, 2].set(r[:, 1]) if isinstance(r, jax.Array) else \
                torch.cat([r[:, :2], r[:, 1:2], r[:, 3:]], dim=1)
    xj, xt = _bf16(np.random.default_rng(16), (2, 12, cfg.d_model))
    yj, auxj = JMOE.moe_apply(cfg, jp, xj, return_aux=True)
    yt, auxt = TMOE.moe_apply(cfg, tp, xt, return_aux=True)
    _close(yt, yj)
    assert float(auxt["dropped_frac"]) == pytest.approx(float(auxj["dropped_frac"]), abs=0)
    assert float(auxt["load_balance_loss"]) == pytest.approx(float(auxj["load_balance_loss"]), rel=1e-6)
    if cap < 1:
        assert float(auxt["dropped_frac"]) > 0


def test_moe_decode_shape_drops_copies():
    """At decode N = B tokens, so capacity is tiny (here one slot an
    expert) and copies are dropped."""
    cfg = _moe_cfg(E=4, K=2, cap=0.5)
    jp, tp = _params(TMOE.moe_spec(cfg), seed=17)
    xj, xt = _bf16(np.random.default_rng(18), (3, 1, cfg.d_model))
    yj, auxj = JMOE.moe_apply(cfg, jp, xj, return_aux=True)
    yt, auxt = TMOE.moe_apply(cfg, tp, xt, return_aux=True)
    _close(yt, yj)
    assert float(auxt["dropped_frac"]) == float(auxj["dropped_frac"]) > 0


# -- SSMs --------------------------------------------------------------------


def _mamba_cfg(chunk=8):
    return _cfg(family="ssm", block_pattern=("mamba",), head_dim=32, num_heads=2,
                mamba=MambaConfig(state_dim=8, head_dim=32, expand=2, chunk=chunk, conv_width=4))


def _rwkv_cfg():
    return _cfg(family="ssm", block_pattern=("rwkv",), use_rope=False, num_heads=2,
                head_dim=32, rwkv=RWKVConfig(head_dim=32, decay_lora=8))


def test_mamba_apply():
    cfg = _mamba_cfg()
    jp, tp = _params(TSSM.mamba_spec(cfg), seed=19)
    xj, xt = _bf16(np.random.default_rng(20), (2, 16, cfg.d_model), scale=0.5)
    _close(TSSM.mamba_apply(cfg, tp, xt), JSSM.mamba_apply(cfg, jp, xj))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TSSM.mamba_apply(cfg, tp, xt[:, :12])


def test_mamba_decode():
    cfg = _mamba_cfg()
    jp, tp = _params(TSSM.mamba_spec(cfg), seed=21)
    rng = np.random.default_rng(22)
    xj, xt = _bf16(rng, (2, 1, cfg.d_model), scale=0.5)
    ssm0 = (rng.standard_normal((2, 4, 8, 32)) * 0.1).astype(np.float32)
    cj, ct = _bf16(rng, (2, 3, 2 * 64 + 16), scale=0.5)  # the conv window: cache dtype
    yj, nj = JSSM.mamba_decode(cfg, jp, xj, {"ssm": jnp.asarray(ssm0), "conv": cj}, jnp.int32(5))
    yt, nt = TSSM.mamba_decode(cfg, tp, xt, {"ssm": torch.from_numpy(ssm0), "conv": ct}, 5)
    _close(yt, yj)
    _close(nt["ssm"], nj["ssm"], atol=1e-6, rtol=1e-6)  # the fp32 state
    assert nt["conv"].dtype == torch.bfloat16 and nt["ssm"].dtype == torch.float32
    _close(nt["conv"], nj["conv"], atol=0, rtol=0)


def test_rwkv_apply():
    cfg = _rwkv_cfg()
    jp, tp = _params(TSSM.rwkv_spec(cfg), seed=23)
    xj, xt = _bf16(np.random.default_rng(24), (2, 64, cfg.d_model), scale=0.5)
    _close(TSSM.rwkv_timemix_apply(cfg, tp, xt), JSSM.rwkv_timemix_apply(cfg, jp, xj))
    _close(TSSM.rwkv_chanmix_apply(cfg, tp, xt), JSSM.rwkv_chanmix_apply(cfg, jp, xj))


def test_rwkv_decode():
    cfg = _rwkv_cfg()
    jp, tp = _params(TSSM.rwkv_spec(cfg), seed=25)
    rng = np.random.default_rng(26)
    xj, xt = _bf16(rng, (2, 1, cfg.d_model), scale=0.5)
    state = (rng.standard_normal((2, 2, 32, 32)) * 0.1).astype(np.float32)
    lj, lt = _bf16(rng, (2, cfg.d_model), scale=0.5)
    yj, nj = JSSM.rwkv_timemix_decode(cfg, jp, xj, {"state": jnp.asarray(state), "x_last": lj}, 3)
    yt, nt = TSSM.rwkv_timemix_decode(cfg, tp, xt, {"state": torch.from_numpy(state), "x_last": lt}, 3)
    _close(yt, yj)
    _close(nt["state"], nj["state"], atol=1e-6, rtol=1e-6)
    _close(nt["x_last"], nj["x_last"], atol=0, rtol=0)
    _close(TSSM.rwkv_chanmix_apply(cfg, tp, xt, x_last=lt), JSSM.rwkv_chanmix_apply(cfg, jp, xj, x_last=lj))


# -- ports of tests/test_decode_consistency.py (the port alone) ---------------

CONSISTENCY_ARCHS = [
    "gemma-2b",          # MQA + GeGLU
    "starcoder2-7b",     # GQA
    "deepseek-v2-236b",  # MLA absorbed decode + MoE
    "zamba2-1.2b",       # mamba2 recurrence + shared attn
    "rwkv6-1.6b",        # rwkv6 recurrence
    "gemma3-1b",         # sliding-window ring buffer
    "musicgen-large",    # codebooks
    "llama4-maverick-400b-a17b",  # MoE top-1
]


def _decode_all(cfg, params, tokens, S):
    caches = TLM.cache_init(cfg, tokens.shape[0], S, device="cpu")
    outs = []
    for i in range(S):
        logits, caches = TLM.decode_step(cfg, params, caches, tokens[..., i:i + 1], i)
        outs.append(logits)
    return torch.stack(outs, dim=-2)


@pytest.mark.parametrize("arch", CONSISTENCY_ARCHS)
def test_decode_matches_forward(arch):
    """Decode == prefill forward, teacher-forced, with the reference's
    bound for this comparison (rtol = atol = 0.12, top-1 agreeing > 90%)."""
    cfg = TCFG.get_smoke(arch)
    params = TLM.lm_init(cfg, device="cpu", seed=0)
    B, S = 2, 32
    rng = np.random.default_rng(0)
    shape = (B, cfg.num_codebooks, S) if cfg.num_codebooks else (B, S)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
    a = TLM.forward(cfg, params, {"tokens": tokens}, chunk=8).float().numpy()
    b = _decode_all(cfg, params, tokens, S).float().numpy()
    np.testing.assert_allclose(a, b, rtol=0.12, atol=0.12)
    assert (a.argmax(-1) == b.argmax(-1)).mean() > 0.9, arch


def test_sliding_window_ring_buffer_consistency():
    """Decode beyond the window length keeps matching the windowed forward."""
    cfg = TCFG.get_smoke("gemma3-1b")  # window 16
    params = TLM.lm_init(cfg, device="cpu", seed=1)
    B, S = 1, 48  # 3x the window
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    a = TLM.forward(cfg, params, {"tokens": tokens}, chunk=8).float().numpy()[:, -8:]
    b = _decode_all(cfg, params, tokens, S).float().numpy()[:, -8:]
    np.testing.assert_allclose(a, b, rtol=0.12, atol=0.12)
    assert TLM.cache_init(cfg, B, S, device="cpu")[0]["k"].shape[1] == 16  # the local layer's ring


def test_long_context_window_override():
    """The SWA serving variant: window_override shrinks dense-arch caches."""
    cfg = TCFG.get_smoke("starcoder2-7b")
    caches_full = TLM.cache_init(cfg, 1, 1024, device="cpu")
    caches_swa = TLM.cache_init(cfg, 1, 1024, window_override=64, device="cpu")

    def size(c):
        return sum(t.numel() for t in TP.leaves(c))

    assert size(caches_swa) * 8 <= size(caches_full)
    jsize = sum(x.size for x in jax.tree.leaves(JLM.cache_init(JCFG.get_smoke("starcoder2-7b"), 1, 1024,
                                                                window_override=64)))
    assert size(caches_swa) == jsize


def test_lm_init_is_seeded_and_on_the_card_by_default():
    cfg = TCFG.get_smoke("gemma-2b")
    a = TLM.lm_init(cfg, device="cpu", seed=3)
    b = TLM.lm_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a.flat, b.flat) and a.size == cfg.param_count()
    assert torch.equal(a.flat_low, a.flat.to(torch.bfloat16))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TLM.lm_init(cfg)
