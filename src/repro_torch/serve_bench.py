"""Serve latency benchmark of the port (counterpart of
``benchmarks/serve_bench.py``): prefill / decode p50 / p99 and tokens/s.

    PYTHONPATH=src python -m repro_torch.serve_bench [--device cpu]
    PYTHONPATH=src python -m repro_torch.run serve [--device cpu]   (the harness: :func:`bench`)

Drives :class:`repro_torch.serve.DecodeEngine` on the gemma-2b smoke config
(random weights from a seed) for the reference's fixed schedule: one warm-up
request (on the card it captures the decode step's CUDA graph), then 12
requests of batch 2, prompt 8, 16 new tokens. The emitted ``serve/request``
span tree is reduced to the reference's five gated rows:

  serve/prefill_p50_ms / serve/prefill_p99_ms
  serve/decode_p50_ms  / serve/decode_p99_ms
  serve/tokens_per_s

The percentiles come from the span durations (linear interpolation,
``obs.hist``), as in the reference. ``repro_torch.run`` bakes the
reference's gates (``GATES["serve"]``) into ``BENCH_serve.json``, and
``repro_torch.bench_diff`` holds it against
``benchmarks/baselines/BENCH_serve.json``.
"""
from __future__ import annotations

import argparse

import numpy as np

from . import configs, obs
from .models import lm
from .obs import analyze
from .obs.hist import percentile
from .serve import DecodeEngine

N_REQUESTS = 12
BATCH = 2
PROMPT_LEN = 8
NEW_TOKENS = 16


def _span_durations(events, name):
    return sorted(float(e["t1"]) - float(e["t0"])
                  for e in analyze.span_events(events) if e["name"] == name)


def bench(tracker=None, device="cuda"):
    """The five rows."""
    cfg = configs.get_smoke("gemma-2b")
    params = lm.lm_init(cfg, device=device, seed=0)
    mem = obs.MemoryTracker()
    # span / timer events also stream into the harness sink (span/* timers
    # in the BENCH artifact) while the local MemoryTracker feeds the reduction
    eng_tracker = obs.CompositeTracker(mem, tracker) if tracker is not None else mem
    eng = DecodeEngine(cfg, params, cache_len=PROMPT_LEN + NEW_TOKENS, batch_size=BATCH,
                       tracker=eng_tracker, device=device)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN))
    eng.run(prompts, n_new_tokens=NEW_TOKENS)  # warm-up (graph capture on the card)
    warm = len(mem.events)
    for i in range(N_REQUESTS):
        eng.run(prompts, n_new_tokens=NEW_TOKENS, seed=i)
    events = mem.events[warm:]

    rows = []
    for phase in ("prefill", "decode"):
        durs = _span_durations(events, phase)
        assert len(durs) == N_REQUESTS, (phase, len(durs))
        for q, tag in ((0.50, "p50"), (0.99, "p99")):
            ms = percentile(durs, q) * 1e3
            rows.append((f"serve/{phase}_{tag}_ms", ms * 1e3, round(ms, 4)))
    toks = sorted(float(e["attrs"]["tokens_per_s"])
                  for e in analyze.span_events(events) if e["name"] == "serve/request")
    assert len(toks) == N_REQUESTS
    decode_durs = _span_durations(events, "decode")
    rows.append(("serve/tokens_per_s", percentile(decode_durs, 0.50) * 1e6,
                 round(percentile(toks, 0.50), 2)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default the card; 'cpu' runs eagerly on the host)")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for name, us, derived in bench(device=args.device):
        print(f"{name},{us:.1f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
