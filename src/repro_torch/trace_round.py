"""Where a round's time goes: a ``torch.profiler`` trace of the main path.

    PYTHONPATH=src python -m repro_torch.trace_round [--d 1000] [--n 10] [--rounds 50]

For MARINA-P/PermK and EF21-P/TopK (Polyak stepsizes, the paper's setup),
and MARINA-P/ind without and with ``measure_wire=True`` (device encode: the
wire path's cost), it runs a few warm-up rounds, times ``rounds`` rounds,
traces ``rounds`` more, and prints the wall time per round, the device time
per round summed over kernels and copies (one stream, so they do not
overlap), the device's busy share of the wall time, and the kernels that
took the most device time. Runs on the card.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .core import compressors as C
from .core import ef21p, marina_p, problems, stepsizes


def _device_us(evt) -> float:
    # renamed from self_cuda_time_total in newer PyTorch
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def trace(run, rounds: int, device: torch.device, top: int = 8) -> dict:
    """Wall time of ``rounds`` rounds without the profiler, then device time
    of the same rounds under it (the profiler slows the host, not the card)."""
    run(5)  # warm-up: kernel build and load, cuBLAS handles
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run(rounds)
    torch.cuda.synchronize(device)
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(rounds)
        torch.cuda.synchronize(device)
    # device activity only (kernels, copies): an aten:: op's row repeats the
    # device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    events.sort(key=_device_us, reverse=True)
    device_us = sum(_device_us(e) for e in events)
    # host side: the torch ops with the most self CPU time (inflated by the
    # profiler's own cost per op, so read them as shares, not as times)
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    host.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "wall_us_per_round": wall_us / rounds,
        "device_us_per_round": device_us / rounds,
        "device_busy_share": device_us / wall_us,
        "top": [(e.key, _device_us(e) / rounds, e.count // rounds) for e in events[:top]],
        "top_host": [(e.key, e.self_cpu_time_total / rounds, e.count / rounds) for e in host[:top]],
    }


def main(d=1000, n=10, rounds=50, seed=0, device="cuda"):
    dev = torch.device(device)
    prob = problems.generate_problem(n=n, d=d, noise_scale=1.0, seed=seed, device=dev)
    k = max(1, d // n)
    p = k / d
    runs = {
        "marina_perm_polyak": lambda T: marina_p.run(
            prob, mode="perm", k=k, p=p,
            stepsize=stepsizes.MarinaPPolyak(omega=float(n - 1), p=p), T=T, seed=seed),
        "ef21p_topk_polyak": lambda T: ef21p.run(
            prob, C.TopK(k=k), stepsizes.EF21PPolyak(alpha=k / d), T=T, seed=seed),
    }
    for name, wire in (("marina_ind_polyak", False), ("marina_ind_polyak_measure_wire", True)):
        runs[name] = lambda T, wire=wire: marina_p.run(
            prob, mode="ind", k=k, p=p, stepsize=stepsizes.MarinaPPolyak(omega=d / k - 1.0, p=p),
            T=T, seed=seed, measure_wire=wire)
    out = {}
    for name, run in runs.items():
        r = out[name] = trace(run, rounds, dev)
        print(f"{name} d={d} n={n}: wall {r['wall_us_per_round']:.1f} us/round, device "
              f"{r['device_us_per_round']:.1f} us/round, busy share {r['device_busy_share']:.3f}")
        for key, us, count in r["top"]:
            print(f"  {us:9.2f} us/round  x{count:<3d} {key}")
        print("  host self time under the profiler:")
        for key, us, count in r["top_host"]:
            print(f"  {us:9.2f} us/round  x{count:<5.2f} {key}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=1000)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=50)
    args = ap.parse_args()
    main(d=args.d, n=args.n, rounds=args.rounds)
