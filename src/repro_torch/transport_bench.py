"""Transport benchmark of the port (counterpart of
``benchmarks/transport_bench.py``): framing cost + degraded-mode training
overhead.

    PYTHONPATH=src python -m repro_torch.transport_bench [--device cpu]
    PYTHONPATH=src python -m repro_torch.run transport [--device cpu]   (the harness: :func:`bench`)

Two sections (DESIGN.md §8.6):

* **framing** (:func:`framing_rows`) — frame encode/decode and CRC32C
  throughput on the host (the per-message cost the transport adds on top of
  the wire codecs; the same pure-Python code as the reference's);
* **chaos** (:func:`chaos_metrics`) — MARINA-P on the paper's L1 workload
  (n = 8, d = 64, PermK, Polyak), on ``--device`` (default the card), clean
  vs through a degraded fleet (the acceptance fault model :data:`CHAOS_SPEC`:
  10% drop, 2% corruption, reorder window 4, seed 7). Reports goodput,
  retry/resync counters, and ``rounds_ratio`` = faulty/clean rounds to the
  same loss target — the end-to-end price of the fault model. Seeded
  injectors + a seeded run: the counters are deterministic, and equal on the
  card and the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .core import marina_p, problems, stepsizes
from .transport import FaultSpec, Fleet, FrameType, crc32c, decode_frame, encode_frame

CHAOS_SPEC = FaultSpec(drop=0.10, corrupt=0.02, reorder=0.10, reorder_window=4, seed=7)


def _time(fn, iters=5):
    fn()  # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def framing_rows():
    """(name, us_per_call, GB/s) of frame encode, decode and CRC32C over a
    64 KiB payload (host code; no device involved)."""
    payload = np.random.default_rng(0).integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    buf = encode_frame(FrameType.DATA, 1, payload)
    gb = len(payload) / 1e9
    rows = []
    dt = _time(lambda: encode_frame(FrameType.DATA, 1, payload))
    rows.append(("transport/frame_encode", dt * 1e6, round(gb / dt, 4)))
    dt = _time(lambda: decode_frame(buf))
    rows.append(("transport/frame_decode", dt * 1e6, round(gb / dt, 4)))
    dt = _time(lambda: crc32c(payload))
    rows.append(("transport/crc32c", dt * 1e6, round(gb / dt, 4)))
    return rows


def chaos_metrics(*, T=120, seed=1, device="cuda"):
    """Clean vs degraded MARINA-P on ``device``; returns the gateable
    scalars (``transport/chaos_run_s`` is host-clock seconds of the faulty
    run, which ends in a host read of f_x every round). Raises
    ``StopIteration``, as the reference does, when the clean run never gets
    below its target (the faulty run may: it then counts its last round)."""
    prob = problems.generate_problem(n=8, d=64, noise_scale=1.0, seed=0, device=device)
    k = prob.d // prob.n
    p = k / prob.d
    ss = stepsizes.MarinaPPolyak(omega=prob.n - 1, p=p, f_star=prob.f_star)

    clean = marina_p.run(prob, mode="perm", k=k, p=p, stepsize=ss, T=T, seed=seed)
    target = 0.25 * clean["f_x"][0]
    r_clean = next((t for t, f in zip(clean["t"], clean["f_x"]) if f < target), None)
    if r_clean is None:  # the reference's bare next() raises StopIteration here
        raise StopIteration(f"the clean run never reached 0.25 * f_x[0] = {target:g} in {T} rounds: "
                            "rounds_ratio would be meaningless")

    fleet = Fleet.make(prob.n, CHAOS_SPEC, timeout=2, max_retries=1)
    t0 = time.perf_counter()
    h = marina_p.run(prob, mode="perm", k=k, p=p, stepsize=ss, T=T, seed=seed, transport=fleet)
    chaos_s = time.perf_counter() - t0
    r_faulty = next((t for t, f in zip(h["t"], h["f_x"]) if f < target), h["t"][-1])
    tr = h["transport"]
    return {
        "transport/goodput": round(tr["transport/goodput"], 4),
        "transport/rounds_ratio": round(r_faulty / max(r_clean, 1), 4),
        "transport/retries": tr["transport/retries"],
        "transport/resyncs": tr["transport/resyncs"],
        "transport/forced_syncs": tr["transport/forced_syncs"],
        "transport/recovery_ticks_mean": round(tr["transport/recovery_ticks_mean"], 3),
        "transport/chaos_run_s": round(chaos_s, 3),
    }


def bench(tracker=None, *, device="cuda"):
    """``repro_torch.run`` adapter: the framing rows (name, µs, GB/s); the
    chaos-run scalars (goodput, rounds_ratio, counters) go through
    ``tracker``, so that the BENCH artifact can gate on them."""
    rows = framing_rows()
    metrics = chaos_metrics(device=device)
    if tracker is not None:
        tracker.log(metrics)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("== framing throughput, host (GB/s) ==")
    for name, us, gbs in framing_rows():
        print(f"{name:28s} {us:10.1f} us/call   {gbs:8.4f} GB/s")
    print(f"\n== chaos run on {args.device} (10% drop, 2% corrupt, reorder w=4) ==")
    for name, v in chaos_metrics(device=args.device).items():
        print(f"{name:32s} {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
