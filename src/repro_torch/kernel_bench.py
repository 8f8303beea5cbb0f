"""Kernel microbenchmarks of the port (counterpart of
``benchmarks/kernel_bench.py::bench``).

    PYTHONPATH=src python -m repro_torch.kernel_bench [--device cpu]

At the reference's shapes, inputs made with numpy from fixed seeds:

* ``block_topk``: d = 2**16, k = 64 per block of 1024;
* ``bernk``: d = 2**16, keep_prob 0.1, seed 3;
* ``rotk_apply``: d = 2**16, n = 16, worker 3, r = 2 (a device int32);
* ``l1_subgrad``: A [1024, 1024], x [1024].

Each kernel is timed through its public wrapper (``ops.*``: the CUDA kernel
on a card, its plain version on the CPU) and as its plain version
(``ref.*``), median milliseconds per call over ``REPS`` calls after warm-up.
On a card: CUDA events around each call, queued behind a spin of
``HOLD_CYCLES`` clock cycles and a read of 256 MiB that evicts the 50 MB L2
and leaves it clean (so the inputs come from device memory, and the time is
the card's: the call is queued before the card reaches it, even where the
host is slow to launch it); on the CPU: the host clock. (A flush that
writes the 256 MiB leaves the L2 dirty: the timed call then also pays the
write-back; chip_smoke.py phase (d) times a 40 MB read both ways.)
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .kernels import ops, ref, runtime

D = 1 << 16
TOPK_K, TOPK_BLOCK = 64, 1024
BERNK_KEEP, BERNK_SEED = 0.1, 3
ROTK_N, ROTK_WORKER, ROTK_R = 16, 3, 2
L1_M = L1_D = 1024
FLUSH_BYTES = 256 * 2**20
HOLD_CYCLES = 1_000_000  # the card's spin before each timed call: longer than the host takes to queue it
REPS = 20


def median_ms(fn, reps: int = REPS, flush=None, device=None) -> float:
    """Median milliseconds of one call of ``fn`` over ``reps`` calls, after
    three warm-up calls. With ``flush`` (a tensor on the card): CUDA events
    around each call, queued behind a spin of ``HOLD_CYCLES`` and
    ``flush.sum()`` (a read: the L2 holds no dirty lines that the call would
    have to write back), so that no wait for the host falls between them;
    without: the host clock around each call, ended by a sync of ``device``
    where it is a card."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            flush.sum()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def inputs(device) -> dict:
    """The benchmark's tensors on ``device`` (numpy, fixed seeds)."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return {
        "x": t(rng.standard_normal(D)),
        "w": t(rng.standard_normal(D)),
        "rotation": torch.tensor([ROTK_R], dtype=torch.int32, device=device),
        "A": t(rng.standard_normal((L1_M, L1_D))),
        "xx": t(rng.standard_normal(L1_D)),
    }


def cases(v: dict):
    """(name, size, wrapper call, plain call) of each kernel."""
    return (
        ("block_topk", D,
         lambda: ops.block_topk(v["x"], k_per_block=TOPK_K, block=TOPK_BLOCK),
         lambda: ref.block_topk_ref(v["x"], k_per_block=TOPK_K, block=TOPK_BLOCK)),
        ("bernk", D,
         lambda: ops.bernk(v["x"], keep_prob=BERNK_KEEP, seed=BERNK_SEED),
         lambda: ref.bernk_ref(v["x"], keep_prob=BERNK_KEEP, seed=BERNK_SEED)),
        ("rotk_apply", D,
         lambda: ops.rotk_apply(v["w"], v["x"], v["rotation"], n=ROTK_N, worker=ROTK_WORKER),
         lambda: ref.rotk_apply_ref(v["w"], v["x"], v["rotation"], n=ROTK_N, worker=ROTK_WORKER)),
        ("l1_subgrad", L1_D,
         lambda: ops.l1_subgrad(v["A"], v["xx"]),
         lambda: ref.l1_subgrad_ref(v["A"], v["xx"])),
    )


def bench(device="cuda"):
    """[(name, ms per call, size)]: ``kernels/<kernel>/ops`` (the wrapper)
    and ``kernels/<kernel>/plain`` for each kernel."""
    dev = runtime.resolve_device(device)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev) if dev.type == "cuda" else None
    rows = []
    for name, size, wrapper, plain in cases(inputs(dev)):
        rows.append((f"kernels/{name}/ops", median_ms(wrapper, flush=flush), size))
        rows.append((f"kernels/{name}/plain", median_ms(plain, flush=flush), size))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = runtime.resolve_device(args.device)
    what = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU (plain versions)"
    print(f"== kernels on {what}: median ms per call over {REPS} calls ==")
    for name, ms, size in bench(dev):
        print(f"{name:32s} {ms:10.5f} ms   (size {size})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
