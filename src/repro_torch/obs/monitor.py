"""Threshold watchers over the metrics registry -> structured alerts.

Copied from the reference package's ``obs/monitor.py`` with its imports
renamed.

A ``Watcher`` names one registry metric, a comparison, and a threshold.
``Monitor.check`` evaluates every watcher against the current registry
values and, on a False -> True transition (edge-triggered, so a
persistently bad value alerts once until it clears), raises a structured
``Alert``: appended to ``Monitor.alerts``, counted in the registry
(``alerts.fired`` plus ``alerts.fired.<name>``), and — when a
``TraceRecorder`` is attached — emitted as an ``alert`` instant event on
the engine track so Perfetto shows *when* the threshold tripped relative
to the request lifecycle.

Comparisons are inclusive (``>=`` / ``<=``): a value exactly at the
threshold fires. A watcher whose metric has never been registered is
skipped (not fired) — the page-pool watcher must not trip before the
first admission publishes the gauge.

Stock watchers cover the health signals:

* ``pool_pressure_watcher``   — paged-KV ``engine.kv_pool_free_pages``
  drops to/below one slot's worst-case page need.
* ``saturation_watcher``      — pack-time ``quant.saturation_rate_max``
  reaches the ceiling (trained scales clipping at serving time).
* ``roofline_drift_watcher``  — ``roofline.drift_max`` (worst
  modeled-vs-measured phase ratio, as max(r, 1/r)) exceeds the factor.

Everything is host-side python over already-recorded values; nothing
here touches the model's forward.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry

ALERTS_FIRED = "alerts.fired"


@dataclass(frozen=True)
class Alert:
    """One threshold trip: which watcher, what it saw, when."""

    name: str
    metric: str
    op: str
    threshold: float
    value: float
    ts: float
    severity: str = "warning"
    message: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "metric": self.metric, "op": self.op,
            "threshold": self.threshold, "value": self.value, "ts": self.ts,
            "severity": self.severity, "message": self.message,
        }


_OPS = {
    ">=": lambda v, t: v >= t,
    "<=": lambda v, t: v <= t,
}


@dataclass
class Watcher:
    """One inclusive threshold over one registry metric."""

    name: str
    metric: str
    op: str
    threshold: float
    severity: str = "warning"
    message: str = ""
    firing: bool = field(default=False, init=False)

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"watcher {self.name!r}: op must be one of "
                             f"{sorted(_OPS)}, got {self.op!r}")

    def evaluate(self, registry: MetricsRegistry) -> Optional[float]:
        """Current metric value when the condition holds, else None.
        Unregistered metrics never fire."""
        if self.metric not in registry:
            return None
        v = registry.value(self.metric)
        return v if _OPS[self.op](v, self.threshold) else None


class Monitor:
    """Edge-triggered watcher set; records alerts into registry + trace."""

    def __init__(self, watchers: Optional[List[Watcher]] = None):
        self.watchers: List[Watcher] = list(watchers or [])
        self.alerts: List[Alert] = []

    def add(self, watcher: Watcher) -> "Monitor":
        self.watchers.append(watcher)
        return self

    def check(self, registry: MetricsRegistry, trace=None,
              now: Optional[float] = None) -> List[Alert]:
        """Evaluate all watchers; return (and record) newly-fired alerts."""
        fired: List[Alert] = []
        for w in self.watchers:
            v = w.evaluate(registry)
            if v is None:
                w.firing = False
                continue
            if w.firing:  # still in violation, already alerted
                continue
            w.firing = True
            ts = (trace.now() if trace is not None and now is None
                  else (now if now is not None else 0.0))
            alert = Alert(name=w.name, metric=w.metric, op=w.op,
                          threshold=w.threshold, value=v, ts=ts,
                          severity=w.severity, message=w.message)
            fired.append(alert)
            self.alerts.append(alert)
            registry.counter(
                ALERTS_FIRED, help="threshold alerts raised").inc()
            registry.counter(f"{ALERTS_FIRED}.{w.name}").inc()
            if trace is not None:
                # "name"/"ts" collide with instant()'s own params
                args = alert.as_dict()
                args["watcher"] = args.pop("name")
                args.pop("ts")
                trace.instant("alert", ts=ts, **args)
        return fired

    @property
    def fired_count(self) -> int:
        return len(self.alerts)

    def as_dicts(self) -> List[Dict[str, Any]]:
        return [a.as_dict() for a in self.alerts]


def pool_pressure_watcher(min_free_pages: float,
                          metric: str = "engine.kv_pool_available_pages"
                          ) -> Watcher:
    """Fires when obtainable pages (free + LRU-evictable; the same number
    the scheduler's deferral check uses) drop to/below the floor. Watching
    raw ``free_count`` instead would trip whenever the prefix registry is
    merely full even though an admission could evict its way through —
    pass ``metric="engine.kv_pool_free_pages"`` to watch that anyway."""
    return Watcher(
        name="pool_pressure", metric=metric,
        op="<=", threshold=float(min_free_pages), severity="warning",
        message="paged-KV obtainable pages below one slot's worst-case "
                "need — admissions are deferring")


def saturation_watcher(ceiling: float = 0.25) -> Watcher:
    return Watcher(
        name="saturation_ceiling", metric="quant.saturation_rate_max",
        op=">=", threshold=float(ceiling), severity="critical",
        message="a packed layer clips above the saturation ceiling — "
                "trained scales do not cover the served weights")


def roofline_drift_watcher(max_factor: float = 8.0) -> Watcher:
    return Watcher(
        name="roofline_drift", metric="roofline.drift_max",
        op=">=", threshold=float(max_factor), severity="warning",
        message="modeled-vs-measured step cost drifted past the factor "
                "the elastic controller can trust")


def default_monitor(*, pool_min_free: Optional[float] = None,
                    saturation_ceiling: float = 0.25,
                    roofline_max_factor: float = 8.0) -> Monitor:
    """The stock watcher set (pool watcher only when a floor is given)."""
    mon = Monitor([saturation_watcher(saturation_ceiling),
                   roofline_drift_watcher(roofline_max_factor)])
    if pool_min_free is not None:
        mon.add(pool_pressure_watcher(pool_min_free))
    return mon
