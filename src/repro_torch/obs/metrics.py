"""Zero-dependency metrics registry for the serving stack.

Three metric kinds, one registry:

* ``Counter``   — monotonic (``inc`` rejects negative deltas). Counts
  events (decode steps, admitted requests) and accumulates durations
  (``engine.t_decode_s``).
* ``Gauge``     — a point-in-time value (slot occupancy, queue depth,
  packed/cache bytes, prefill shapes compiled).
* ``Histogram`` — fixed upper-bound buckets plus an overflow bucket,
  with running count/sum/min/max. ``percentile`` interpolates linearly
  inside the winning bucket (edges clamped to the observed min/max, so
  a single-sample histogram reports that exact sample).

``MetricsRegistry`` is get-or-create by name: the instrumented call sites
(``launch.engine``, ``launch.scheduler``, ``runtime.dispatch``, ...)
never need to know whether a metric exists yet, and ``snapshot()``
renders the whole registry to one JSON-able dict for ``serve
--metrics-out`` and the bench artifacts. Registries are cheap; the
engine makes a fresh one per ``reset()`` so counters stay monotonic
within a serving epoch while old snapshots stay frozen.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional, Tuple

# log-ish spaced latency buckets in milliseconds: 10 us .. 60 s covers a
# CPU smoke decode step and a GPU decode step on one scale
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0, 30000.0, 60000.0,
)


class Counter:
    """Monotonic counter (float-valued, so it can accumulate seconds)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name!r} is monotonic: inc({n}) rejected")
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value; ``set`` may move in either direction."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``buckets`` are ascending finite upper bounds; one overflow bucket
    (+inf) is implicit. ``observe`` is O(buckets) with no allocation, so
    the engine can call it per decode step without showing up in the
    step time it is measuring.
    """

    def __init__(self, name: str, buckets: Iterable[float] = DEFAULT_MS_BUCKETS,
                 help: str = ""):
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"histogram {name!r} needs ascending buckets")
        if not all(math.isfinite(b) for b in bs):
            raise ValueError(f"histogram {name!r}: buckets must be finite "
                             "(the overflow bucket is implicit)")
        self.name = name
        self.help = help
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)  # last = overflow
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self._sum += v
        self._count += 1
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) from the bucket counts.

        Linear interpolation inside the winning bucket, with the bucket
        edges clamped to the observed min/max — so an empty histogram
        reports 0.0, a single sample reports itself exactly, and the
        overflow bucket reports the observed max.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"percentile wants q in [0,1], got {q}")
        if self._count == 0:
            return 0.0
        rank = q * self._count
        cum = 0.0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            lo = self.buckets[i - 1] if i > 0 else self._min
            hi = self.buckets[i] if i < len(self.buckets) else self._max
            lo = max(lo, self._min)
            hi = min(hi, self._max)
            if rank <= cum + n:
                frac = (rank - cum) / n
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
            cum += n
        return self._max

    def as_dict(self) -> Dict[str, Any]:
        return {
            "count": self._count,
            "sum": self._sum,
            "min": self._min if self._count else 0.0,
            "max": self._max if self._count else 0.0,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "buckets": {("+inf" if i == len(self.buckets)
                         else repr(self.buckets[i])): n
                        for i, n in enumerate(self.counts) if n},
        }


class MetricsRegistry:
    """Name -> metric store with get-or-create accessors (module doc)."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, kind, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind(name, **kw)
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_MS_BUCKETS,
                  help: str = "") -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(name, buckets, help=help)
        elif not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not Histogram")
        return m

    def value(self, name: str, default: float = 0.0) -> float:
        """Scalar read of a counter/gauge (0.0 when never registered)."""
        m = self._metrics.get(name)
        return m.value if m is not None and hasattr(m, "value") else default

    def get(self, name: str) -> Optional[Any]:
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Any]:
        """The whole registry as one JSON-able dict: scalars for
        counters/gauges, the bucket/percentile dict for histograms."""
        out: Dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            out[name] = m.as_dict() if isinstance(m, Histogram) else m.value
        return out

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)
