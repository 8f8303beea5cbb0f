"""The port's serving path against the reference's: the wire's flat vector
(``convert.ravel_params`` = ``ravel_pytree``), checkpoints read across in
both directions, ``apply_wire_delta`` / ``apply_wire_sync`` for every
payload codec with the reference's rejections, the device decode's torch
path against the host codec, ``DecodeEngine.delta_sync``'s sequence gate,
and the engine's logits, greedy tokens, sampling and telemetry against
``repro.serve.DecodeEngine``.

Parameters come from the reference's ``lm_init`` through
``convert.lm_params_from_numpy``; logits are held with tests/test_torch_lm.py's
tolerance, and a greedy token is compared only where the reference's top-2
logit margin exceeds twice that tolerance (a closer call may go either way).
"""
import functools
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro import obs as JOBS  # noqa: E402
from repro import wire as JW  # noqa: E402
from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serve import DecodeEngine as JEngine  # noqa: E402
from repro.serve import engine as JENG  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch import convert, obs, serve_bench  # noqa: E402
from repro_torch import wire as W  # noqa: E402
from repro_torch import transport as TR  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.kernels import encode as K  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models.config import MambaConfig, ModelConfig  # noqa: E402
from repro_torch.serve import DecodeEngine, apply_wire_delta, apply_wire_sync, temperature_sample  # noqa: E402
from repro_torch.serve import engine as TENG  # noqa: E402

RTOL, ATOL = 0.02, 0.04  # tests/test_torch_lm.py's
MARGIN = 2 * ATOL


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_cfgs():
    """Configs whose plan has scan segments (stacked [count, ...] leaves),
    a weight-tied shared block inside one, and unrolled tails."""
    gemma3 = dict(arch_id="g3", family="dense", num_layers=14, d_model=32, num_heads=2, num_kv_heads=1,
                  head_dim=16, d_ff=48, vocab_size=64, mlp_kind="geglu", tie_embeddings=True,
                  sliding_window=8, block_pattern=tuple("attn" if i % 6 == 5 else "attn_local"
                                                        for i in range(14)))
    zamba = dict(arch_id="z2", family="hybrid", num_layers=13, d_model=32, num_heads=2, num_kv_heads=2,
                 head_dim=16, d_ff=48, vocab_size=64, block_pattern=tuple(
                     "shared" if i % 6 == 5 else "mamba" for i in range(13)),
                 mamba=None)
    return {"gemma3": gemma3, "zamba2": zamba}


def _pair(name):
    """(reference cfg, port cfg) of a scan config or a smoke arch."""
    if name in _scan_cfgs():
        kw = _scan_cfgs()[name]
        if name == "zamba2":
            from repro.models.config import MambaConfig as JMamba

            return (JModelConfig(**dict(kw, mamba=JMamba(state_dim=8, head_dim=16, chunk=8))),
                    ModelConfig(**dict(kw, mamba=MambaConfig(state_dim=8, head_dim=16, chunk=8))))
        return JModelConfig(**kw), ModelConfig(**kw)
    return JCFG.get_smoke(name), TCFG.get_smoke(name)


@functools.lru_cache(maxsize=None)
def _params(name):
    jcfg, tcfg = _pair(name)
    jp = jax.jit(functools.partial(JLM.lm_init, jcfg))(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp


def _port(name):
    """A fresh port copy of the reference's parameters of ``name``."""
    jcfg, tcfg, jp = _params(name)
    return convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# -- the wire's flat vector and checkpoints ----------------------------------


@pytest.mark.parametrize("name", ["gemma3", "zamba2", "deepseek-v2-236b", "musicgen-large"])
def test_ravel_params_equals_ravel_pytree(name):
    jcfg, tcfg, jp = _params(name)
    tp = _port(name)
    want = np.asarray(jax.flatten_util.ravel_pytree(jp)[0])
    np.testing.assert_array_equal(_bits(convert.ravel_params(tp)), _bits(want))
    tree = TP.map_tree(torch.from_numpy, jax.tree.map(lambda a: np.array(a), jp))
    np.testing.assert_array_equal(_bits(convert.ravel_params(tree)), _bits(want))
    back = convert.unravel_params(torch.from_numpy(want.copy()), tree)
    for (pa, a), (pb, b) in zip(TP.leaves_with_path(back), TP.leaves_with_path(tree)):
        assert pa == pb and torch.equal(a, b)
    with pytest.raises(ValueError, match="does not fit"):
        convert.unravel_params(torch.zeros(want.size + 1), tree)
    assert torch.equal(tp.flat_low, tp.flat.to(torch.bfloat16))


def test_scan_segments_hold_stacked_leaves():
    jcfg, tcfg, jp = _params("zamba2")
    tp = _port("zamba2")
    seg = tp.tree["stack"]["segments"][0]
    assert seg["b5"] == {} and seg["b0"]["mamba"]["in_proj"].shape[0] == 2  # (5 mamba + shared) x 2
    assert "shared_blk" in tp.tree["stack"]


@pytest.mark.parametrize("name", ["gemma3", "zamba2"])
def test_checkpoint_reads_across_both_ways(tmp_path, name):
    jcfg, tcfg, jp = _params(name)
    tp = _port(name)
    # the reference writes, the port reads (into FlatParams and into a tree)
    j_save(os.path.join(tmp_path, "j.npz"), jp, step=7, extra={"arch": jcfg.arch_id})
    like = TLM.lm_init(tcfg, device="cpu", seed=1)
    got, meta = load_checkpoint(os.path.join(tmp_path, "j.npz"), like)
    assert meta["step"] == 7 and meta["extra"] == {"arch": jcfg.arch_id}
    assert torch.equal(got.flat, tp.flat) and torch.equal(got.flat_low, tp.flat_low)
    tree, _ = load_checkpoint(os.path.join(tmp_path, "j.npz"), TP.map_tree(torch.zeros_like, tp.tree))
    assert torch.equal(convert.ravel_params(tree), tp.flat)
    # the port writes, the reference reads
    save_checkpoint(os.path.join(tmp_path, "t.npz"), tp, step=3)
    restored, meta = j_load(os.path.join(tmp_path, "t.npz"), jp)
    assert meta["step"] == 3
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(os.path.join(tmp_path, "t.npz")) as zt, np.load(os.path.join(tmp_path, "j.npz")) as zj:
        assert sorted(zt.files) == sorted(zj.files)
    wrong = TP.map_tree(torch.zeros_like, tp.tree)
    wrong["ln_f"]["scale"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(os.path.join(tmp_path, "j.npz"), wrong)


# -- wire deltas and syncs -----------------------------------------------------


def _tiny():
    kw = dict(arch_id="t", family="gqa", num_layers=1, d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
              d_ff=64, vocab_size=64)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = JLM.lm_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")


def _payloads(d, rng):
    sparse = np.zeros(d, np.float32)
    idx = rng.choice(d, 40, replace=False)
    sparse[idx] = rng.standard_normal(40).astype(np.float32)
    nat = np.zeros(d, np.float32)
    nat[idx] = np.ldexp(np.sign(rng.standard_normal(40)), rng.integers(-12, -2, 40)).astype(np.float32)
    dense = (rng.standard_normal(d) * 1e-2).astype(np.float32)
    bufs = {f"sparse_{m}": JW.encode_sparse(sparse, mag=m) for m in ("fp32", "fp16", "bf16")}
    bufs["natural"] = JW.encode_natural(nat)
    bufs.update({f"dense_{m}": JW.encode_dense(dense, mag=m) for m in ("fp32", "fp16", "bf16")})
    return bufs


@pytest.mark.parametrize("kind", ["sparse_fp32", "sparse_fp16", "sparse_bf16", "natural",
                                  "dense_fp32", "dense_fp16", "dense_bf16"])
def test_apply_wire_delta_and_sync_match_reference(kind):
    jcfg, tcfg, jp, tp = _tiny()
    d = tp.size
    buf = _payloads(d, np.random.default_rng(1))[kind]
    want = np.asarray(jax.flatten_util.ravel_pytree(JENG.apply_wire_delta(jp, buf))[0])
    got = apply_wire_delta(tp, buf)
    assert got is tp  # in place
    np.testing.assert_array_equal(_bits(tp.flat), _bits(want))
    assert torch.equal(tp.flat_low, tp.flat.to(torch.bfloat16))  # the bf16 copy refreshed
    want = np.asarray(jax.flatten_util.ravel_pytree(JENG.apply_wire_sync(jp, buf))[0])
    np.testing.assert_array_equal(_bits(convert.ravel_params(apply_wire_sync(tp, buf))), _bits(want))


def _sparse_buf(d, idx, vals, mag=0):
    """A SPARSE buffer written field by field (the encoder never writes a
    repeated or out-of-range index)."""
    from repro.wire import bitstream as jbs

    idx = np.asarray(idx, np.uint32)
    return b"".join([JW.spec.pack_header(JW.CodecID.SPARSE, d), bytes([mag, 0, 0, 0]),
                     np.array([idx.size], "<u4").tobytes(),
                     jbs.to_bytes(jbs.pack_u32(idx, JW.index_width(d))),
                     jbs.to_bytes(jbs.pack_u32(np.zeros(idx.size, np.uint32), 1)),
                     jbs.to_bytes(jbs.pack_u32(np.asarray(vals, np.float32).view(np.uint32), 32))])


def _malformed(d):
    """(name, buffer) pairs that the host codec rejects."""
    good = JW.encode_sparse(np.eye(1, d, 3, dtype=np.float32)[0])
    bad_mag = bytearray(good)
    bad_mag[8] = 7
    big_count = bytearray(good)
    big_count[12:16] = (d + 1).to_bytes(4, "little")
    top = (1 << JW.index_width(d)) - 1  # fits the index width, and >= d
    assert top >= d
    dense = JW.encode_dense(np.ones(d, np.float32))
    return [("truncated_sparse", good[:-4]), ("no_payload", good[:10]), ("bad_mag", bytes(bad_mag)),
            ("count_gt_d", bytes(big_count)), ("index_ge_d", _sparse_buf(d, [1, top], [1.0, 2.0])),
            ("truncated_dense", dense[:-8]), ("dense_bad_mag", dense[:8] + b"\x09" + dense[9:]),
            ("truncated_natural", JW.encode_natural(np.ones(d, np.float32))[:-4]),
            ("bad_magic", b"\x00" * 16)]


def test_rejections_match_reference():
    """Each malformed buffer: the reference's apply_wire_delta, the port's,
    and the port's torch decode path raise the same exception type, and the
    port's parameters are untouched."""
    jcfg, tcfg, jp, tp = _tiny()
    before = tp.flat.clone()
    for name, buf in _malformed(tp.size):
        with pytest.raises(Exception) as jdec:
            JW.decode(buf)
        for port_decode in (W.decode, lambda b: K._decode_streams(b, torch.device("cpu"))):
            with pytest.raises(Exception) as tdec:
                port_decode(buf)
            assert type(tdec.value).__name__ == type(jdec.value).__name__, name
            assert str(tdec.value) == str(jdec.value), name
        with pytest.raises(Exception) as jerr:
            JENG.apply_wire_delta(jp, buf)
        with pytest.raises(Exception) as terr:
            apply_wire_delta(tp, buf)
        assert type(terr.value).__name__ == type(jerr.value).__name__, name
        assert isinstance(terr.value, W.WireError) == isinstance(jerr.value, JW.WireError), name
        assert torch.equal(tp.flat, before), name
    seed = JW.encode_seed(JW.SeedMessage(JW.SeedFamily.BERN, 0, 0, 1.0, 1, 0, 0.5), tp.size)
    for fn in (apply_wire_delta, apply_wire_sync):
        with pytest.raises(ValueError, match="SEED"):
            fn(tp, seed)
    with pytest.raises(ValueError, match="dimension"):
        apply_wire_delta(tp, JW.encode_sparse(np.zeros(7, np.float32)))
    bad = np.zeros(tp.size, np.float32)
    bad[5] = np.nan
    for buf in (JW.encode_dense(bad), JW.encode_sparse(bad)):
        with pytest.raises(W.CorruptFrame, match="non-finite"):
            apply_wire_delta(tp, buf)
        with pytest.raises(JW.CorruptFrame):
            JENG.apply_wire_delta(jp, buf)
    assert torch.equal(tp.flat, before)


def test_pack_kernels_refuse_sizes_past_int():
    """The kernels take counts as C int: the launchers refuse a larger one
    rather than let ctypes cut it (checked before any launch)."""
    from repro_torch.kernels import pack

    pack._check_sizes("unpack_bits", 999_812_736, 1)
    with pytest.raises(ValueError, match="int range"):
        pack._check_sizes("unpack_bits", 2**31, 1)


@pytest.mark.parametrize("d", [1, 7, 1000, 4097])
def test_device_decode_path_equals_host_codec(d):
    """The torch decode behind decode_device (streams through ops.unpack_bits,
    fp16/bf16 -> fp32 on bit patterns) against the host codec, bit for bit,
    IEEE corners included; on the CPU decode_device is the host codec."""
    rng = np.random.default_rng(d)
    x = np.where(rng.random(d) < 0.3, rng.standard_normal(d), 0).astype(np.float32)
    corners = np.array([np.nan, np.inf, -np.inf, -0.0, 1e-42, 6e-8, 65504.0, 1e38], np.float32)
    x[:min(d, corners.size)] = corners[:min(d, corners.size)]
    bufs = [JW.encode_sparse(x, mag=m) for m in ("fp32", "fp16", "bf16")]
    bufs += [JW.encode_dense(x, mag=m) for m in ("fp32", "fp16", "bf16")]
    bufs.append(JW.encode_natural(np.ldexp(np.ones(d, np.float32), rng.integers(-20, 20, d))))
    for buf in bufs:
        want = _bits(JW.decode(buf))
        np.testing.assert_array_equal(_bits(K._decode_streams(buf, torch.device("cpu")).numpy()), want)
        np.testing.assert_array_equal(_bits(K.decode_device(buf, "cpu").numpy()), want)


def test_device_decode_duplicate_indices_keep_the_last_write():
    """A malformed but accepted SPARSE buffer with repeated indices: numpy's
    out[idx] = vals keeps the last; the torch path gives the same bits."""
    d, idx, vals = 50, [3, 9, 3, 3, 40, 9], np.arange(1, 7, dtype=np.float32)
    buf = _sparse_buf(d, idx, vals)
    want = JW.decode(buf)
    assert want[3] == 4.0 and want[9] == 6.0
    np.testing.assert_array_equal(_bits(K._decode_streams(buf, torch.device("cpu")).numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(W.decode(buf)), _bits(want))


# -- the engine -------------------------------------------------------------------


@pytest.fixture
def engine():
    jcfg, tcfg, jp, tp = _tiny()
    return DecodeEngine(tcfg, tp, cache_len=16, batch_size=1, device="cpu")


def test_delta_sync_sequence_gating(engine):
    """tests/test_transport.py::test_delta_sync_sequence_gating on the port."""
    flat0 = engine.params.flat.clone()
    d = flat0.numel()
    delta = np.zeros(d, np.float32)
    delta[:5] = 0.25
    buf = W.encode_sparse(delta, mag="fp32")
    f1 = TR.encode_frame(TR.FrameType.DATA, 1, buf)
    engine.delta_sync(f1)
    np.testing.assert_array_equal(_bits(engine.params.flat), _bits(flat0.numpy() + delta))
    with pytest.raises(TR.StaleDelta):
        engine.delta_sync(f1)
    with pytest.raises(TR.SequenceGap):
        engine.delta_sync(TR.encode_frame(TR.FrameType.DATA, 3, buf))
    np.testing.assert_array_equal(_bits(engine.params.flat), _bits(flat0.numpy() + delta))
    with pytest.raises(TR.StaleDelta):  # a SYNC behind the gate is stale too
        engine.delta_sync(TR.encode_frame(TR.FrameType.SYNC, 1, W.encode_dense(flat0.numpy())))
    engine.delta_sync(TR.encode_frame(TR.FrameType.SYNC, 5, W.encode_dense(flat0.numpy(), mag="fp32")))
    assert torch.equal(engine.params.flat, flat0)
    engine.delta_sync(TR.encode_frame(TR.FrameType.DATA, 6, buf))
    with pytest.raises(ValueError):
        engine.delta_sync(TR.encode_frame(TR.FrameType.ACK, 7, b""))
    engine.delta_sync(buf)  # unframed buffers are applied, ungated
    np.testing.assert_array_equal(_bits(engine.params.flat), _bits(flat0.numpy() + delta + delta))


def test_delta_sync_validates_before_mutating(engine):
    before = engine.params.flat.clone()
    bad = np.zeros(before.numel(), np.float32)
    bad[0] = np.inf
    with pytest.raises(W.CorruptFrame):
        engine.delta_sync(TR.encode_frame(TR.FrameType.SYNC, 1000, W.encode_dense(bad, mag="fp32")))
    assert torch.equal(engine.params.flat, before)
    buf = bytearray(TR.encode_frame(TR.FrameType.DATA, 2000, W.encode_sparse(np.zeros(before.numel(),
                                                                                     np.float32))))
    buf[TR.HEADER_BYTES + 2] ^= 0x10
    with pytest.raises(W.WireError):
        engine.delta_sync(bytes(buf))
    assert torch.equal(engine.params.flat, before)


def test_delta_sync_traces_a_span(engine):
    tr = obs.MemoryTracker()
    engine.tracker = tr
    engine.delta_sync(TR.encode_frame(TR.FrameType.DATA, 1, W.encode_sparse(np.zeros(engine.params.size,
                                                                                      np.float32))))
    spans = [e for e in tr.events if e["kind"] == "span"]
    assert [s["name"] for s in spans] == ["serve/delta_sync"]
    assert spans[0]["attrs"]["ftype"] == "DATA" and spans[0]["attrs"]["seq"] == 1


def test_delta_changes_the_served_logits():
    """The bf16 copy the matmuls read follows the masters: after a delta the
    engine's logits move, and equal those of a model built with the new
    masters from scratch."""
    tcfg = TCFG.get_smoke("gemma-2b")
    tp = _port("gemma-2b")
    eng = DecodeEngine(tcfg, tp, cache_len=8, batch_size=2, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 6)))
    before = eng.prefill(eng._stepper(), prompts)
    delta = (np.random.default_rng(4).standard_normal(tp.size) * 1e-2).astype(np.float32)
    eng.delta_sync(W.encode_dense(delta))
    after = eng.prefill(eng._stepper(), prompts)
    assert not torch.equal(before, after)
    fresh = TP.FlatParams(TLM.lm_spec(tcfg), "cpu").load_flat(tp.flat.clone())
    ref = DecodeEngine(tcfg, fresh, cache_len=8, batch_size=2, device="cpu")
    assert torch.equal(ref.prefill(ref._stepper(), prompts), after)


def _reference_greedy(jcfg, jp, prompts, n):
    """The reference's greedy path step by step, run op by op (see
    tests/test_torch_lm.py): tokens and each step's logits."""
    step = jax.disable_jit()(lambda p, c, t, i: JLM.decode_step(jcfg, p, c, t, i))
    c = JLM.cache_init(jcfg, prompts.shape[0], prompts.shape[-1] + n)
    for i in range(prompts.shape[-1]):
        logits, c = step(jp, c, jnp.asarray(prompts[..., i:i + 1]), jnp.int32(i))
    toks, all_logits = [], [np.asarray(logits, np.float32)]
    for i in range(n):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[..., None]
        logits, c = step(jp, c, tok, jnp.int32(prompts.shape[-1] + i))
        toks.append(np.asarray(tok[..., 0]))
        all_logits.append(np.asarray(logits, np.float32))
    return np.stack(toks, -1), all_logits


@pytest.mark.parametrize("arch", ["gemma-2b", "llama4-maverick-400b-a17b"])
def test_engine_logits_and_greedy_tokens_match_reference(arch):
    """Prefill's last logits against the reference engine's; then the greedy
    path teacher-forced on the reference's tokens: each step's logits within
    tolerance, and the port's argmax equal to the reference's token wherever
    the reference's top-2 margin exceeds MARGIN. The port's own greedy run
    follows the reference's tokens up to the first closer call."""
    jcfg, tcfg, jp = _params(arch)
    tp = _port(arch)
    B, P, N = 2, 8, 6
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    jeng = JEngine(jcfg, jp, cache_len=P + N, batch_size=B)
    with jax.disable_jit():
        _, jlast = jeng._prefill(jp, jeng.fresh_caches(), jnp.asarray(prompts))
    eng = DecodeEngine(tcfg, tp, cache_len=P + N, batch_size=B, device="cpu")
    step = eng._stepper()
    last = eng.prefill(step, torch.from_numpy(prompts).long())
    np.testing.assert_allclose(last.float().numpy(), np.asarray(jlast, np.float32), rtol=RTOL, atol=ATOL)
    jtoks, jlogits = _reference_greedy(jcfg, jp, prompts, N)
    first_close, compared = N, 0
    for i in range(N):
        srt = np.sort(jlogits[i], axis=-1)
        safe = srt[..., -1] - srt[..., -2] > MARGIN
        compared += int(safe.sum())
        port_tok = last.float().argmax(-1).numpy() if i == 0 else logits.float().argmax(-1).numpy()
        assert (port_tok[safe] == jtoks[..., i][safe]).all(), (arch, i)
        if not safe.all():
            first_close = min(first_close, i)
        logits = step(torch.from_numpy(jtoks[..., i:i + 1]).long(), P + i)
        np.testing.assert_allclose(logits.float().numpy(), jlogits[i + 1], rtol=RTOL, atol=ATOL)
    assert compared > 0
    toks = eng.run(torch.from_numpy(prompts), N).numpy()
    np.testing.assert_array_equal(toks[..., :first_close], jtoks[..., :first_close])
    np.testing.assert_array_equal(toks, eng.run(torch.from_numpy(prompts), N).numpy())  # deterministic


def test_temperature_sample_with_injected_draws_matches_categorical(monkeypatch):
    """The Gumbel-max sampler fed the reference's draws picks
    jax.random.categorical's token (same logits, same key)."""
    logits = (np.random.default_rng(6).standard_normal((3, 40)) * 2).astype(np.float32)
    for temp in (0.7, 1.0, 2.5):
        for seed in range(4):
            key = jax.random.PRNGKey(seed)
            want = np.asarray(JENG.temperature_sample(temp)(key, jnp.asarray(logits)))
            noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
            monkeypatch.setattr(TENG, "gumbel", lambda g, shape, device: torch.from_numpy(noise.copy()))
            got = temperature_sample(temp)(None, torch.from_numpy(logits)).numpy()
            np.testing.assert_array_equal(got, want)


def test_engine_samples_with_the_reference_draws(monkeypatch):
    """A whole run with temperature sampling: the port's engine, fed the
    reference engine's per-step draws (its key split each step), samples the
    reference's tokens wherever the reference's noisy top-2 margin is safe."""
    arch = "gemma-2b"
    jcfg, tcfg, jp = _params(arch)
    B, P, N, temp, seed = 2, 8, 5, 0.8, 3
    prompts = np.random.default_rng(7).integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    jeng = JEngine(jcfg, jp, cache_len=P + N, batch_size=B, sample_fn=JENG.temperature_sample(temp))
    with jax.disable_jit():
        jtoks = np.asarray(jeng.run(jnp.asarray(prompts), N, seed=seed))
    key, draws = jax.random.PRNGKey(seed), []
    for _ in range(N):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, (B, jcfg.vocab_size), jnp.float32)))
    it = iter(draws)
    monkeypatch.setattr(TENG, "gumbel", lambda g, shape, device: torch.from_numpy(next(it)))
    eng = DecodeEngine(tcfg, _port(arch), cache_len=P + N, batch_size=B,
                       sample_fn=temperature_sample(temp), device="cpu")
    toks = eng.run(torch.from_numpy(prompts), N, seed=seed).numpy()
    # the noisy scores along the reference's path, teacher-forced
    _, jlogits = _reference_greedy_with(jcfg, jp, prompts, jtoks)
    compared = 0
    for i in range(N):
        scores = np.sort(jlogits[i] / temp + draws[i], axis=-1)
        if not (scores[..., -1] - scores[..., -2] > MARGIN / temp).all():
            break
        np.testing.assert_array_equal(toks[..., i], jtoks[..., i])
        compared += 1
    assert compared > 0


def _reference_greedy_with(jcfg, jp, prompts, toks):
    """The reference's logits along given tokens (teacher-forced, op by op)."""
    step = jax.disable_jit()(lambda p, c, t, i: JLM.decode_step(jcfg, p, c, t, i))
    c = JLM.cache_init(jcfg, prompts.shape[0], prompts.shape[-1] + toks.shape[-1])
    for i in range(prompts.shape[-1]):
        logits, c = step(jp, c, jnp.asarray(prompts[..., i:i + 1]), jnp.int32(i))
    out = [np.asarray(logits, np.float32)]
    for i in range(toks.shape[-1]):
        logits, c = step(jp, c, jnp.asarray(toks[..., i:i + 1]), jnp.int32(prompts.shape[-1] + i))
        out.append(np.asarray(logits, np.float32))
    return toks, out


def test_serve_engine_greedy_deterministic():
    """tests/test_trainer.py::test_serve_engine_greedy_deterministic on the port."""
    cfg = TCFG.get_smoke("gemma-2b")
    eng = DecodeEngine(cfg, TLM.lm_init(cfg, device="cpu"), cache_len=64, batch_size=2, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    t1 = eng.run(prompts, n_new_tokens=6)
    t2 = eng.run(prompts, n_new_tokens=6)
    assert torch.equal(t1, t2) and t1.shape == (2, 6) and t1.dtype == torch.int32


def test_serve_engine_latency_telemetry():
    """tests/test_trainer.py::test_serve_engine_latency_telemetry on the port,
    and the span tree the reference's engine emits for the same requests."""
    cfg = TCFG.get_smoke("gemma-2b")
    tr = obs.MemoryTracker()
    eng = DecodeEngine(cfg, TLM.lm_init(cfg, device="cpu"), cache_len=64, batch_size=2, tracker=tr,
                       device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    eng.run(prompts, n_new_tokens=4)
    eng.run(prompts, n_new_tokens=4)
    timers = [e["name"] for e in tr.events if e["kind"] == "timer"]
    assert timers == ["serve/prefill", "serve/decode"] * 2
    mets = [e for e in tr.events if e["kind"] == "metrics"]
    assert len(mets) == 2
    assert mets[0]["metrics"]["serve/tokens_per_s"] > 0
    assert mets[0]["metrics"]["serve/batch"] == 2
    jtr = JOBS.MemoryTracker()
    jcfg = JCFG.get_smoke("gemma-2b")
    jeng = JEngine(jcfg, JLM.lm_init(jcfg, jax.random.PRNGKey(0)), cache_len=64, batch_size=2, tracker=jtr)
    jeng.run(jnp.asarray(prompts), n_new_tokens=4)
    jeng.run(jnp.asarray(prompts), n_new_tokens=4)

    def shape(events):
        return [(e["kind"], e.get("name"), e.get("parent") is None, sorted(e.get("attrs", {})),
                 sorted(e.get("metrics", {}))) for e in events]

    assert shape(tr.events) == shape(jtr.events)


def test_serve_bench_rows_and_harness_artifact(tmp_path):
    """The serve suite on the CPU: the reference's five rows, and a BENCH
    artifact carrying the reference's serve gates (timings are the CPU's and
    are not compared here: the card's run is chip_smoke.py phase (s4))."""
    from benchmarks import run as jrun  # the reference's harness (gates)
    from repro_torch import run

    assert run.main(["serve", "--device", "cpu", "--out", str(tmp_path)]) == 0
    doc = obs.load(os.path.join(tmp_path, "BENCH_serve.json"))
    assert obs.validate(doc) == [] and doc["gates"] == jrun.GATES["serve"]
    assert {"serve/prefill_p50_ms", "serve/prefill_p99_ms", "serve/decode_p50_ms",
            "serve/decode_p99_ms", "serve/tokens_per_s"} <= set(doc["metrics"])
    assert doc["metrics"]["serve/new_tokens"]["value"] == serve_bench.NEW_TOKENS
    assert doc["env"]["platform"] == "cpu"
