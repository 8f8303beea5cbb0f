"""Seeded fault injection for transport channels (DESIGN.md §8.2).

A :class:`FaultSpec` names the failure model — per-frame probabilities for
every fault class the paper's WAN setting implies (lossy links, flaky
clients, stragglers) — and a :class:`FaultInjector` turns it into a
deterministic plan: given one outbound buffer, which (possibly damaged)
copies reach the channel and with what extra latency. Everything derives
from one ``numpy`` Generator seeded by ``spec.seed``, so a chaos run is
exactly reproducible and CI can assert on its counters.

Fault classes:

* **drop** — the frame never arrives;
* **corrupt** — one random bit is flipped (caught by the frame CRC32C);
* **truncate** — the tail is cut at a random byte (caught by the length
  prefix);
* **duplicate** — a second copy arrives one tick later;
* **reorder** — delivery is delayed 1..reorder_window ticks, so later
  sends overtake it;
* **straggler** — delivery is delayed ``straggler_ticks`` ticks, modeling
  a slow client link (the sender's retry timeout decides whether the
  round waits or proceeds without it).

A copy of ``repro/transport/faults.py`` (numpy only): the same seed gives the
same plan, draw for draw.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-frame fault probabilities + the RNG seed that fixes the run."""

    drop: float = 0.0
    corrupt: float = 0.0
    truncate: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    reorder_window: int = 4
    straggler: float = 0.0
    straggler_ticks: int = 8
    seed: int = 0

    def with_seed(self, seed: int) -> "FaultSpec":
        return dataclasses.replace(self, seed=seed)

    @property
    def any_faults(self) -> bool:
        return any(
            p > 0
            for p in (self.drop, self.corrupt, self.truncate, self.duplicate,
                      self.reorder, self.straggler)
        )


#: fault classes reported in ``FaultInjector.counts``
FAULT_CLASSES = ("drop", "corrupt", "truncate", "duplicate", "reorder", "straggler")


class FaultInjector:
    """Deterministic per-frame fault planner for one channel direction."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self.counts: Dict[str, int] = {k: 0 for k in FAULT_CLASSES}

    def plan(self, buf: bytes) -> List[Tuple[int, bytes]]:
        """Map one outbound buffer to [(delay_ticks, delivered_bytes), ...].

        An empty list means the frame was dropped. Corruption and
        truncation are mutually exclusive (one damage event per frame);
        delays compose (a duplicated straggler arrives late twice).
        """
        s, rng = self.spec, self.rng
        if s.drop > 0 and rng.random() < s.drop:
            self.counts["drop"] += 1
            return []
        out = buf
        if s.corrupt > 0 and rng.random() < s.corrupt:
            self.counts["corrupt"] += 1
            out = self._flip_bit(out)
        elif s.truncate > 0 and rng.random() < s.truncate:
            self.counts["truncate"] += 1
            out = out[: int(rng.integers(0, max(len(out), 1)))]
        delay = 0
        if s.reorder > 0 and rng.random() < s.reorder:
            self.counts["reorder"] += 1
            delay += int(rng.integers(1, s.reorder_window + 1))
        if s.straggler > 0 and rng.random() < s.straggler:
            self.counts["straggler"] += 1
            delay += s.straggler_ticks
        deliveries = [(delay, out)]
        if s.duplicate > 0 and rng.random() < s.duplicate:
            self.counts["duplicate"] += 1
            deliveries.append((delay + 1, bytes(out)))
        return deliveries

    def _flip_bit(self, buf: bytes) -> bytes:
        if not buf:
            return buf
        i = int(self.rng.integers(0, len(buf)))
        bit = 1 << int(self.rng.integers(0, 8))
        out = bytearray(buf)
        out[i] ^= bit
        return bytes(out)
