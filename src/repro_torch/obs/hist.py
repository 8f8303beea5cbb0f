"""Streaming percentile estimation (DESIGN.md §7.2 / §10.4).

Two pieces, shared by the BENCH sink (bench_json.py) and the trace
analyzer (analyze.py):

* :func:`percentile` — linear-interpolation percentile over a sorted
  list (the R-7 / numpy default). Replaces the old nearest-rank
  rounding, which is biased for small n (p50 of [0, 1] must be 0.5,
  not one of the endpoints).
* :class:`StreamingHistogram` — a fixed-bin, sign-aware log-spaced
  histogram with O(1) memory per distinct bin and O(1) updates. Up to
  ``exact_cap`` samples the quantiles are exact (linear interpolation
  over the retained sample list); past the cap the estimate comes from
  the histogram, which has seen *every* sample — unlike the old
  first-N-capped reservoir, whose p99 was biased toward warm-up because
  only the first 4096 observations were ever retained.

Bin layout: |v| is bucketed geometrically with ``bins_per_decade`` bins
per power of ten between 1e-12 and 1e12 (clamped outside), mirrored for
negative values, with one dedicated zero bin. At the default 64 bins
per decade the worst-case relative quantile error past the exact cap is
10^(1/64) - 1 ≈ 3.7%.

A copy of ``repro/obs/hist.py`` (standard library only), kept so that the
port imports nothing of ``repro``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

_LO_EXP = -12   # |v| <= 10^LO_EXP lands in the innermost bin
_HI_EXP = 12    # |v| >= 10^HI_EXP lands in the outermost bin


def percentile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolation percentile of an ascending-sorted list."""
    n = len(sorted_vals)
    if n == 0:
        return float("nan")
    pos = q * (n - 1)
    lo = max(0, min(n - 1, int(math.floor(pos))))
    hi = min(n - 1, lo + 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class StreamingHistogram:
    """Fixed-bin streaming histogram over arbitrary reals.

    ``add`` is O(1); memory is bounded by ``exact_cap`` retained samples
    plus one counter per non-empty bin (itself bounded by the fixed bin
    grid). ``quantile`` is exact while n <= exact_cap and a <=~4%
    relative-error estimate afterwards — computed over *all* samples,
    not a warm-up prefix.
    """

    def __init__(self, *, bins_per_decade: int = 64, exact_cap: int = 4096) -> None:
        assert bins_per_decade > 0 and exact_cap >= 0
        self.bins_per_decade = bins_per_decade
        self.exact_cap = exact_cap
        self._counts: Dict[int, int] = {}
        self._exact: Optional[List[float]] = [] if exact_cap > 0 else None
        self._sorted = True
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- bin mapping ----------------------------------------------------------

    def _bin_of(self, v: float) -> int:
        """Signed bin index: 0 for (near-)zero, ±(1 + offset) otherwise."""
        if v == 0.0 or not math.isfinite(v):
            return 0
        e = math.log10(abs(v))
        e = min(max(e, _LO_EXP), _HI_EXP - 1e-9)
        idx = 1 + int(math.floor((e - _LO_EXP) * self.bins_per_decade))
        return idx if v > 0 else -idx

    def _bin_edges(self, b: int) -> tuple:
        """(lo, hi) value edges of signed bin b, lo <= hi."""
        if b == 0:
            eps = 10.0 ** _LO_EXP
            return (-eps, eps)
        k = abs(b) - 1
        lo = 10.0 ** (_LO_EXP + k / self.bins_per_decade)
        hi = 10.0 ** (_LO_EXP + (k + 1) / self.bins_per_decade)
        return (lo, hi) if b > 0 else (-hi, -lo)

    # -- updates --------------------------------------------------------------

    def add(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        self.n += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        b = self._bin_of(v)
        self._counts[b] = self._counts.get(b, 0) + 1
        if self._exact is not None:
            if len(self._exact) < self.exact_cap:
                self._exact.append(v)
                self._sorted = False
            else:  # past the cap the histogram takes over
                self._exact = None

    def extend(self, vals) -> None:
        for v in vals:
            self.add(v)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")

    # -- quantiles ------------------------------------------------------------

    def quantile(self, q: float) -> float:
        if self.n == 0:
            return float("nan")
        if self._exact is not None:
            if not self._sorted:
                self._exact.sort()
                self._sorted = True
            return percentile(self._exact, q)
        # histogram estimate: find the bin holding the target rank, then
        # interpolate linearly across the bin's value edges
        target = q * (self.n - 1)
        seen = 0
        for b in sorted(self._counts):
            c = self._counts[b]
            if seen + c > target:
                lo, hi = self._bin_edges(b)
                frac = (target - seen) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def summary(self, suffix: str = "") -> Dict[str, float]:
        """n / total / mean / p50 / p99 block (key suffix e.g. ``_s``)."""
        return {
            "n": self.n,
            f"total{suffix}": self.total,
            f"mean{suffix}": self.mean,
            f"p50{suffix}": self.quantile(0.50),
            f"p99{suffix}": self.quantile(0.99),
        }
