"""The port's transport (``repro_torch.transport``) and the ``transport``
argument of its runs against the JAX reference.

Frames, CRCs and seeded fault plans are numpy / ``struct`` code in both, so
they must be bit-identical, and so must every link counter when both sides
are driven with the same payloads. The runs are held as
``test_torch_algorithms.py`` holds them: the reference's own draws are
injected into the port's run, f_x within 1e-4 relative, and the transport
counters and the forced-sync rounds equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.transport as JT  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import compressors as JC  # noqa: E402
from repro.core import ef21p as JE  # noqa: E402
from repro.core import marina_p as JM  # noqa: E402
from repro.core import problems as JP  # noqa: E402
from repro.core import stepsizes as JS  # noqa: E402
from repro_torch import convert, obs, transport, wire  # noqa: E402
from repro_torch.core import compressors as C  # noqa: E402
from repro_torch.core import ef21p as E  # noqa: E402
from repro_torch.core import marina_p as M  # noqa: E402
from repro_torch.core import problems, stepsizes  # noqa: E402
from repro_torch.obs import analyze  # noqa: E402
from repro_torch.transport import (  # noqa: E402
    FAULT_CLASSES,
    FaultInjector,
    FaultSpec,
    FaultyChannel,
    Fleet,
    FrameType,
    Link,
    LoopbackChannel,
    crc32c,
    decode_frame,
    encode_frame,
    is_frame,
)

N, D = 8, 64
K = D // N
P = K / D
TRAJ_RTOL = 1e-4
# the acceptance fault model of benchmarks/transport_bench.py
CHAOS = dict(drop=0.10, corrupt=0.02, reorder=0.10, reorder_window=4, seed=7)


def both_specs(**kw):
    return JT.FaultSpec(**kw), FaultSpec(**kw)


# ---------------------------------------------------------------------------
# CRC32C + frame codec
# ---------------------------------------------------------------------------


def test_crc32c_reference_vector():
    """RFC 3720 B.4: crc32c("123456789") == 0xE3069283."""
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0


def test_crc32c_incremental_matches_oneshot():
    data = bytes(range(256)) * 5
    assert crc32c(data[100:], crc32c(data[:100])) == crc32c(data)


@pytest.mark.parametrize("seed", range(4))
def test_crc32c_and_frames_equal_the_reference(seed):
    """Random payloads of every length class: equal CRCs, equal frame bytes
    for every frame type, equal decodes."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, 7, 8, 9, 63, 64, 1000, int(rng.integers(1, 5000))):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c(payload) == JT.crc32c(payload)
        for ftype in FrameType:
            seq = int(rng.integers(0, 2**32))
            buf = encode_frame(ftype, seq, payload)
            assert buf == JT.encode_frame(JT.FrameType(int(ftype)), seq, payload)
            frame, end = decode_frame(buf)
            jframe, jend = JT.decode_frame(buf)
            assert (int(frame.ftype), frame.seq, frame.payload, end) == (
                int(jframe.ftype), jframe.seq, jframe.payload, jend)


def _decode_error(decode, buf):
    try:
        decode(buf)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("seed", range(3))
def test_damaged_frames_raise_the_reference_errors(seed):
    """Bit flips, truncations, bad magic/version/type/length: the same typed
    error with the same message as the reference."""
    rng = np.random.default_rng(100 + seed)
    payload = rng.integers(0, 256, int(rng.integers(1, 200)), dtype=np.uint8).tobytes()
    buf = encode_frame(FrameType.DATA, int(rng.integers(0, 2**32)), payload)
    damaged = []
    for _ in range(40):
        b = bytearray(buf)
        i = int(rng.integers(0, len(b)))
        b[i] ^= 1 << int(rng.integers(0, 8))
        damaged.append(bytes(b))
    damaged += [buf[: int(rng.integers(0, len(buf)))] for _ in range(10)]
    damaged += [b"\x00" * 20, buf[:2] + bytes([9]) + buf[3:], buf[:3] + bytes([77]) + buf[4:]]
    for b in damaged:
        got, want = _decode_error(decode_frame, b), _decode_error(JT.decode_frame, b)
        assert got is not None and got == want, (got, want)


def test_frame_roundtrip_all_types():
    for ftype in FrameType:
        buf = encode_frame(ftype, 42, b"payload")
        assert is_frame(buf)
        frame, end = decode_frame(buf)
        assert frame.ftype == ftype
        assert frame.seq == 42
        assert frame.payload == b"payload"
        assert end == len(buf)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_frame_single_bitflip_never_decodes(seed):
    """Any one flipped bit is caught — CorruptFrame or TruncatedFrame,
    never a silently wrong Frame."""
    rng = np.random.default_rng(seed)
    payload = bytes(rng.integers(0, 256, size=int(rng.integers(1, 64)), dtype=np.uint8))
    buf = bytearray(encode_frame(FrameType.DATA, int(rng.integers(0, 2**32)), payload))
    i = int(rng.integers(0, len(buf)))
    buf[i] ^= 1 << int(rng.integers(0, 8))
    with pytest.raises(wire.WireError):
        decode_frame(bytes(buf))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_frame_truncation_never_decodes(seed):
    rng = np.random.default_rng(seed)
    buf = encode_frame(FrameType.SYNC, 7, bytes(33))
    cut = int(rng.integers(0, len(buf)))
    with pytest.raises(wire.TruncatedFrame):
        decode_frame(buf[:cut])


def test_wire_error_hierarchy():
    """Transport reuses the port's wire exception tree; all are ValueError."""
    assert issubclass(wire.CorruptFrame, wire.WireError)
    assert issubclass(wire.TruncatedFrame, wire.WireError)
    assert issubclass(wire.WireError, ValueError)


# ---------------------------------------------------------------------------
# channels + fault injection
# ---------------------------------------------------------------------------


def test_loopback_channel_orders_by_tick():
    ch = LoopbackChannel()
    ch.send(b"late", delay=3)
    ch.send(b"now")
    assert ch.poll() == [b"now"]
    assert ch.poll() == []
    assert ch.poll() == [b"late"]


def test_fault_injector_deterministic():
    spec = FaultSpec(drop=0.2, corrupt=0.2, duplicate=0.2, reorder=0.2, seed=11)
    plans = []
    for _ in range(2):
        inj = FaultInjector(spec)
        plans.append([inj.plan(bytes(range(32))) for _ in range(200)])
    assert plans[0] == plans[1]


@pytest.mark.parametrize("fault", FAULT_CLASSES + ("all",))
def test_fault_plans_equal_the_reference(fault):
    """Each fault class alone at a high rate, and all together: the same
    plans, draw for draw, over payloads of varying length, and the same
    counters."""
    kw = dict(drop=0.2, corrupt=0.2, truncate=0.2, duplicate=0.2, reorder=0.2,
              straggler=0.2) if fault == "all" else {fault: 0.4}
    jspec, tspec = both_specs(**kw, straggler_ticks=5, seed=13)
    jinj, tinj = JT.FaultInjector(jspec), FaultInjector(tspec)
    rng = np.random.default_rng(5)
    for _ in range(300):
        buf = rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
        assert tinj.plan(buf) == jinj.plan(buf)
    assert tinj.counts == jinj.counts
    assert sum(tinj.counts.values()) > 0


def test_faulty_channel_counts_drops():
    spec = FaultSpec(drop=1.0, seed=0)
    ch = FaultyChannel(LoopbackChannel(), spec)
    for _ in range(5):
        ch.send(b"x")
    assert all(ch.poll() == [] for _ in range(4))
    assert ch.counts["drop"] == 5


# ---------------------------------------------------------------------------
# link recovery behaviour
# ---------------------------------------------------------------------------


# derandomized: at a 0.4 drop rate a send exhausts its 8 retries with
# probability 0.4**9 per payload, so an unseeded search finds such seeds
@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(fault=st.sampled_from(FAULT_CLASSES), seed=st.integers(min_value=0, max_value=999))
def test_link_reliable_under_each_fault_class(fault, seed):
    """Under every single fault class at high rate, a Link still delivers
    all payloads, intact and in order, as the reference's does."""
    spec = FaultSpec(**{fault: 0.4}, seed=seed)
    link = Link(fault_spec=spec, timeout=4, max_retries=8)
    jlink = JT.Link(fault_spec=JT.FaultSpec(**{fault: 0.4}, seed=seed), timeout=4, max_retries=8)
    payloads = [bytes([i]) * (i + 1) for i in range(12)]
    oks = [link.send(p) for p in payloads]
    assert oks == [jlink.send(p) for p in payloads]
    link.settle()
    assert all(oks)
    assert link.recv() == payloads


@pytest.mark.parametrize("ack_faults", [False, True])
@pytest.mark.parametrize("pipelined", [False, True])
def test_link_stats_equal_the_reference(pipelined, ack_faults):
    """Both links driven with the same payloads under heavy faults (on the
    ack channel too): the same deliveries and every LinkStats counter equal."""
    kw = dict(drop=0.15, corrupt=0.1, truncate=0.05, duplicate=0.1, reorder=0.2,
              reorder_window=4, straggler=0.05, straggler_ticks=6, seed=1234)
    jspec, tspec = both_specs(**kw)
    jack, tack = both_specs(**dict(kw, seed=99)) if ack_faults else (None, None)
    lk = dict(timeout=4, max_retries=8, window=64, replay_depth=64)
    jl = JT.Link(fault_spec=jspec, ack_fault_spec=jack, **lk)
    tl = Link(fault_spec=tspec, ack_fault_spec=tack, **lk)
    payloads = [f"msg{i}".encode() * (i % 5 + 1) for i in range(60)]
    if pipelined:
        for p in payloads:
            jl.send_nowait(p)
            tl.send_nowait(p)
        assert tl.flush() == jl.flush()
    else:
        assert [tl.send(p) for p in payloads] == [jl.send(p) for p in payloads]
    jl.settle(16)
    tl.settle(16)
    assert tl.recv() == jl.recv()
    assert dataclasses.asdict(tl.stats) == dataclasses.asdict(jl.stats)
    assert tl.stats.retries > 0


def test_link_heavy_faults_in_order_delivery():
    spec = FaultSpec(drop=0.15, corrupt=0.1, truncate=0.05, duplicate=0.1,
                     reorder=0.2, reorder_window=4, straggler=0.05,
                     straggler_ticks=6, seed=1234)
    link = Link(fault_spec=spec, timeout=4, max_retries=8)
    payloads = [f"msg{i}".encode() for i in range(60)]
    assert all(link.send(p) for p in payloads)
    link.settle(16)
    assert link.recv() == payloads
    assert link.stats.retries > 0
    assert link.stats.corrupt_detected + link.stats.truncated_detected > 0


def test_link_pipelined_gap_detection_and_replay():
    """send_nowait keeps frames in flight so a dropped one is noticed as a
    gap by its successor, NAKed, and repaired from the replay ring."""
    spec = FaultSpec(drop=0.2, reorder=0.3, reorder_window=4, seed=7)
    link = Link(fault_spec=spec, timeout=4, max_retries=8, window=64,
                replay_depth=64)
    payloads = [bytes([i % 256]) * 8 for i in range(50)]
    for p in payloads:
        link.send_nowait(p)
    assert link.flush()
    link.settle(16)
    assert link.recv() == payloads
    assert link.stats.gaps_detected > 0


def test_link_delivery_failure_flags_resync():
    link = Link(fault_spec=FaultSpec(drop=1.0, seed=0), timeout=2, max_retries=2)
    assert link.send(b"doomed") is False
    assert link.resync_needed
    assert link.stats.delivery_failures == 1
    assert link.stats.resyncs == 1


def test_sync_frame_repairs_any_gap():
    """A SYNC is self-contained: the receiver accepts it at any forward seq
    and resumes in-sequence delivery right after it."""
    link = Link()
    rx = link.receiver
    rx.on_frame(encode_frame(FrameType.DATA, 0, b"a"))
    rx.on_frame(encode_frame(FrameType.SYNC, 7, b"FULL"))
    rx.on_frame(encode_frame(FrameType.DATA, 8, b"b"))
    assert list(rx.delivered) == [b"a", b"FULL", b"b"]
    assert rx.expected == 9


def test_replay_ring_miss_escalates_to_resync():
    """A NAK for a seq already evicted from the bounded replay ring cannot
    be repaired by retransmission — the link must flag resync."""
    link = Link(replay_depth=2)
    for i in range(5):
        link.send_nowait(bytes([i]))
    link.sender.on_control(encode_frame(FrameType.NAK, 0))
    assert link.resync_needed
    assert link.stats.resyncs == 1


def test_duplicates_dropped_once_delivered():
    spec = FaultSpec(duplicate=1.0, seed=3)
    link = Link(fault_spec=spec, timeout=4, max_retries=4)
    payloads = [b"a", b"b", b"c"]
    assert all(link.send(p) for p in payloads)
    link.settle(8)
    assert link.recv() == payloads
    assert link.stats.duplicates_dropped > 0


def test_fleet_seeded_determinism_and_reference_counters():
    kw = dict(drop=0.1, corrupt=0.05, reorder=0.1, seed=42)

    def run(mod, spec):
        fleet = mod.Fleet.make(4, spec, timeout=3, max_retries=4, ack_faults=True)
        oks = []
        for i in range(20):
            oks.append(fleet.broadcast(bytes([i]) * 16, sync=i % 7 == 0))
            oks.append(fleet.send_per_worker([bytes([i, w]) * 9 for w in range(4)]))
        return oks, fleet.drain(), dataclasses.asdict(fleet.stats()), fleet.injected_counts()

    jspec, tspec = both_specs(**kw)
    assert run(transport, tspec) == run(transport, tspec)
    assert run(transport, tspec) == run(JT, jspec)


# ---------------------------------------------------------------------------
# the runs' transport argument against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def probs():
    jp = JP.generate_problem(n=N, d=D, noise_scale=1.0, seed=0)
    tp = convert.problem_from_numpy(np.asarray(jp.A), np.asarray(jp.x0), np.asarray(jp.L0i),
                                    jp.sigma_A, device="cpu")
    return jp, tp


def reference_marina_draws(monkeypatch, mode, seed, n=N, k=K, d=D):
    """Make the port's run draw each round what the reference's run draws:
    key = PRNGKey(seed), then key, sub = split(key) per round."""
    key = jax.random.PRNGKey(seed)

    def draw_round(bcast, p, d_, generator, device):
        nonlocal key
        key, sub = jax.random.split(key)
        k_bern, k_comp = jax.random.split(sub)
        coin = bool(jax.random.bernoulli(k_bern, p))
        masks = np.asarray(JM.make_broadcast(mode, n, k)[0](k_comp, jnp.ones(d))) != 0
        idx = (np.flatnonzero(masks[0]) if mode == "same" else
               np.stack([np.flatnonzero(m) for m in masks]) if mode == "ind" else
               np.concatenate([np.flatnonzero(m) for m in masks]))
        return M.MarinaPDraws(coin=coin, idx=torch.from_numpy(idx.astype(np.int64)))

    monkeypatch.setattr(M, "draw_round", draw_round)


def round_schedule(tracker):
    """Per round: (round, full_sync, force_sync) of the round span and
    (delivered, resync_next) of its broadcast span."""
    out = []
    for r in analyze.build_tree(tracker.events):
        b = [c for c in r.children if c.name == "broadcast"][0]
        out.append((r.attrs["round"], r.attrs["full_sync"], r.attrs["force_sync"],
                    b.attrs["delivered"], b.attrs["resync_next"]))
    return out


def chaos_pair(how):
    """The run's ``transport`` argument for the reference and the port: the
    FaultSpec itself (the runs build Fleet.make(n, spec, timeout=2,
    max_retries=2)), or fleets with one retry, as transport_bench builds
    them, where failed deliveries force syncs."""
    if how == "spec":
        return JT.FaultSpec(**CHAOS), FaultSpec(**CHAOS)
    return (JT.Fleet.make(N, JT.FaultSpec(**CHAOS), timeout=2, max_retries=1),
            Fleet.make(N, FaultSpec(**CHAOS), timeout=2, max_retries=1))


@pytest.mark.parametrize("how", ["spec", "fleet"])
@pytest.mark.parametrize("kind", ["const", "polyak"])
@pytest.mark.parametrize("mode", ["perm", "ind", "same"])
def test_marina_p_chaos_run_against_the_reference(probs, monkeypatch, mode, kind, how):
    """MARINA-P through the chaos fault model for 40 rounds: f_x within 1e-4,
    hist["transport"] and the ledger equal, the same rounds forced to a
    full sync and the same deliveries."""
    jp, tp = probs
    omega = float(N - 1) if mode == "perm" else D / K - 1.0
    if kind == "const":
        js, ts = JS.Constant(0.01), stepsizes.Constant(0.01)
    else:
        js, ts = JS.MarinaPPolyak(omega=omega, p=P), stepsizes.MarinaPPolyak(omega=omega, p=P)
    jt, tt = jobs.MemoryTracker(), obs.MemoryTracker()
    jtr, ttr = chaos_pair(how)
    want = JM.run(jp, mode=mode, k=K, p=P, stepsize=js, T=40, seed=3, transport=jtr, tracker=jt)
    reference_marina_draws(monkeypatch, mode, 3)
    got = M.run(tp, mode=mode, k=K, p=P, stepsize=ts, T=40, seed=3, transport=ttr, tracker=tt)
    np.testing.assert_allclose(got["f_x"], want["f_x"], rtol=TRAJ_RTOL)
    assert got["transport"] == want["transport"]
    assert dataclasses.asdict(got["transport_stats"]) == dataclasses.asdict(want["transport_stats"])
    assert got["s2w_bits"] == want["s2w_bits"] and got["w2s_bits"] == want["w2s_bits"]
    assert round_schedule(tt) == round_schedule(jt)
    if how == "fleet":
        assert any(r[2] for r in round_schedule(tt)), "no forced sync"
    assert set(got) == set(want)


@pytest.mark.parametrize("how", ["spec", "fleet"])
@pytest.mark.parametrize("comp", ["topk", "block_topk"])
def test_ef21p_chaos_run_against_the_reference_constant(probs, comp, how):
    """EF21-P, constant gamma (TopK draws nothing), through the same fleet:
    f_x within 1e-4, the transport counters, the ledger and the re-anchor
    rounds equal."""
    jp, tp = probs
    jc, tc = ((JC.TopK(k=K), C.TopK(k=K)) if comp == "topk" else
              (JC.BlockTopK(k_per_block=2, block=16), C.BlockTopK(k_per_block=2, block=16)))
    jt, tt = jobs.MemoryTracker(), obs.MemoryTracker()
    jtr, ttr = chaos_pair(how)
    want = JE.run(jp, jc, JS.Constant(0.05), T=40, transport=jtr, tracker=jt)
    got = E.run(tp, tc, stepsizes.Constant(0.05), T=40, transport=ttr, tracker=tt)
    np.testing.assert_allclose(got["f_x"], want["f_x"], rtol=TRAJ_RTOL)
    assert got["transport"] == want["transport"]
    assert got["s2w_bits"] == want["s2w_bits"]
    assert round_schedule(tt) == round_schedule(jt)
    if how == "fleet":
        assert any(r[2] for r in round_schedule(tt)), "no forced re-anchor"
    assert set(got) == set(want)


def test_runs_with_measure_wire_and_transport_against_the_reference(probs, monkeypatch):
    """Both arguments at once: the measured wire bits per round equal too."""
    jp, tp = probs
    want = JM.run(jp, mode="ind", k=K, p=P, stepsize=JS.Constant(0.01), T=25, seed=5,
                  transport=JT.FaultSpec(**CHAOS), measure_wire=True)
    reference_marina_draws(monkeypatch, "ind", 5)
    got = M.run(tp, mode="ind", k=K, p=P, stepsize=stepsizes.Constant(0.01), T=25, seed=5,
                transport=FaultSpec(**CHAOS), measure_wire=True)
    assert got["wire_bits"] == want["wire_bits"]
    assert got["transport"] == want["transport"]
    want = JE.run(jp, JC.TopK(k=K), JS.Constant(0.05), T=25, transport=JT.FaultSpec(**CHAOS),
                  measure_wire=True, wire_mag="bf16")
    got = E.run(tp, C.TopK(k=K), stepsizes.Constant(0.05), T=25, transport=FaultSpec(**CHAOS),
                measure_wire=True, wire_mag="bf16")
    assert got["wire_bits"] == want["wire_bits"]
    assert got["transport"] == want["transport"]


def test_transport_of_the_wrong_size_raises(probs):
    _, tp = probs
    with pytest.raises(ValueError, match="links"):
        M.run(tp, mode="perm", k=K, p=P, stepsize=stepsizes.Constant(0.01), T=2,
              transport=Fleet.make(N - 1, None))


# ---------------------------------------------------------------------------
# degraded-mode training on the port alone (the reference's acceptance cases)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def prob():
    return problems.generate_problem(n=N, d=D, noise_scale=1.0, seed=0, device="cpu")


def test_marina_p_converges_under_faults(prob):
    """MARINA-P through a degraded fleet (10% drop, 2% corruption, reorder
    window 4) completes, logs nonzero retry/resync counters through the
    tracker, and reaches the clean run's loss target within 1.5x the clean
    rounds; degradation shows as forced full syncs."""
    p = K / prob.d
    ss = stepsizes.MarinaPPolyak(omega=prob.n - 1, p=p, f_star=prob.f_star)
    clean = M.run(prob, mode="perm", k=K, p=p, stepsize=ss, T=200, seed=1)
    target = 0.25 * clean["f_x"][0]
    r_clean = next(t for t, f in zip(clean["t"], clean["f_x"]) if f < target)
    tracker = obs.MemoryTracker()
    fleet = Fleet.make(prob.n, FaultSpec(**dict(CHAOS, seed=7)), timeout=2, max_retries=1)
    T = int(np.ceil(1.5 * r_clean)) + 5
    h = M.run(prob, mode="perm", k=K, p=p, stepsize=ss, T=T, seed=1, transport=fleet,
              tracker=tracker)
    r_faulty = next(t for t, f in zip(h["t"], h["f_x"]) if f < target)
    assert r_faulty <= 1.5 * r_clean, (r_faulty, r_clean)
    tr = h["transport"]
    assert tr["transport/retries"] > 0 and tr["transport/resyncs"] > 0
    assert 0.0 < tr["transport/goodput"] <= 1.0
    logged = {}
    for e in tracker.events:
        if e["kind"] == "metrics":
            logged.update(e["metrics"])
    assert logged["transport/retries"] > 0 and logged["transport/resyncs"] > 0
    assert tr["transport/forced_syncs"] > 0


def test_ef21p_completes_under_faults(prob):
    ss = stepsizes.EF21PPolyak(alpha=8 / prob.d, f_star=prob.f_star)
    fleet = Fleet.make(prob.n, FaultSpec(**dict(CHAOS, seed=5)), timeout=2, max_retries=1)
    h = E.run(prob, C.TopK(k=8), ss, T=120, transport=fleet)
    assert np.isfinite(h["f_x"]).all()
    assert h["f_x"][-1] < h["f_x"][0]
    tr = h["transport"]
    assert tr["transport/retries"] > 0
    assert tr["transport/delivered_frames"] > 0


def test_marina_p_faulty_matches_clean_when_all_delivered(prob):
    """With no faults the transport path is a pure pass-through: the same
    trajectory, bit for bit, as the clean run of the same seed."""
    ss = stepsizes.MarinaPPolyak(omega=prob.n - 1, p=P, f_star=prob.f_star)
    clean = M.run(prob, mode="perm", k=K, p=P, stepsize=ss, T=40, seed=2)
    faulty = M.run(prob, mode="perm", k=K, p=P, stepsize=ss, T=40, seed=2,
                   transport=Fleet.make(prob.n, None))
    assert clean["f_x"] == faulty["f_x"]
    tr = faulty["transport"]
    assert tr["transport/retries"] == tr["transport/resyncs"] == 0
    assert tr["transport/delivery_failures"] == 0
    assert tr["transport/goodput"] > 0.8  # < 1 only by the 16-byte framing
