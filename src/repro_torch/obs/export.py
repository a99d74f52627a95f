"""Export surfaces for the metrics registry: Prometheus text + JSONL.

Copied from the reference package's ``obs/export.py`` with its imports
renamed (the metric prefix stays ``repro``, so both packages expose the
same names).

Two consumers, two formats, one source of truth (``MetricsRegistry``):

* ``prometheus_text`` renders the registry in the Prometheus text
  exposition format (``# HELP`` / ``# TYPE`` lines, ``_total`` suffix on
  counters, cumulative ``_bucket{le=...}`` series for histograms).
  Registry names use dots (``engine.decode_step_ms``); Prometheus wants
  ``[a-zA-Z_:][a-zA-Z0-9_:]*``, so names are sanitized through
  ``prom_name`` and prefixed (default ``repro``) to keep the scrape
  namespace clean. ``parse_prometheus_text`` is the inverse used by the
  line-format test: every exposition line must round-trip.

* ``MetricsStreamer`` appends periodic JSONL snapshots (one
  ``{"ts", "seq", "metrics"}`` object per line) for ``serve
  --metrics-stream``. It is pull-driven: the engine calls ``tick``
  once per scheduler iteration and the streamer decides whether the
  interval has elapsed. ``close`` force-emits a final snapshot so even
  a sub-interval smoke run yields >= 2 lines (first tick + close).

Everything here reads already-materialized host-side values — no device
sync, nothing on the hot path.
"""
from __future__ import annotations

import json
import re
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)$")
_LABEL_RE = re.compile(r'^(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>[^"]*)"$')


def prom_name(name: str, prefix: str = "repro") -> str:
    """Sanitize a dotted registry name into a Prometheus metric name."""
    san = _NAME_RE.sub("_", name)
    if prefix:
        san = f"{prefix}_{san}"
    if not re.match(r"^[a-zA-Z_:]", san):
        san = "_" + san
    return san


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(registry: MetricsRegistry, prefix: str = "repro") -> str:
    """Render the whole registry in Prometheus text exposition format."""
    lines: List[str] = []
    for name in sorted(registry._metrics):
        m = registry._metrics[name]
        base = prom_name(name, prefix)
        if isinstance(m, Counter):
            full = base if base.endswith("_total") else base + "_total"
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            lines.append(f"# TYPE {full} counter")
            lines.append(f"{full} {_fmt(m.value)}")
        elif isinstance(m, Gauge):
            if m.help:
                lines.append(f"# HELP {base} {m.help}")
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {_fmt(m.value)}")
        elif isinstance(m, Histogram):
            if m.help:
                lines.append(f"# HELP {base} {m.help}")
            lines.append(f"# TYPE {base} histogram")
            cum = 0
            for edge, n in zip(m.buckets, m.counts):
                cum += n
                lines.append(f'{base}_bucket{{le="{_fmt(edge)}"}} {cum}')
            lines.append(f'{base}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{base}_sum {_fmt(m.sum)}")
            lines.append(f"{base}_count {m.count}")
        else:  # pragma: no cover - registry only holds the three kinds
            raise TypeError(f"unknown metric kind for {name!r}: {type(m)}")
    return "\n".join(lines) + "\n"


Sample = Tuple[str, Dict[str, str], float]


def parse_prometheus_text(text: str) -> List[Sample]:
    """Parse exposition text into (name, labels, value) samples.

    Raises ValueError on any line that is neither a comment nor a valid
    sample — this is the line-format check the tests gate on.
    """
    samples: List[Sample] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            raise ValueError(f"bad prometheus line {lineno}: {raw!r}")
        labels: Dict[str, str] = {}
        if m.group("labels"):
            for part in m.group("labels").rstrip(",").split(","):
                lm = _LABEL_RE.match(part.strip())
                if lm is None:
                    raise ValueError(
                        f"bad prometheus label on line {lineno}: {part!r}")
                labels[lm.group("k")] = lm.group("v")
        v = m.group("value")
        value = float("inf") if v == "+Inf" else (
            float("-inf") if v == "-Inf" else float(v))
        samples.append((m.group("name"), labels, value))
    return samples


def samples_as_dict(samples: List[Sample]) -> Dict[str, Any]:
    """Fold samples into {name: value} / {name: {le: count}} for tests."""
    out: Dict[str, Any] = {}
    for name, labels, value in samples:
        if labels:
            out.setdefault(name, {})[tuple(sorted(labels.items()))] = value
        else:
            out[name] = value
    return out


def write_prometheus(registry: MetricsRegistry, path: str,
                     prefix: str = "repro") -> str:
    text = prometheus_text(registry, prefix=prefix)
    with open(path, "w") as f:
        f.write(text)
    return text


class MetricsStreamer:
    """Periodic JSONL snapshot writer for ``serve --metrics-stream``.

    ``tick(registry)`` emits at most one line per ``interval_s`` (the
    first tick always emits). ``close(registry)`` force-emits a final
    snapshot and flushes, so every run produces >= 2 snapshots: one at
    the first scheduler iteration, one at drain.
    """

    def __init__(self, path: str, interval_s: float = 0.5):
        if interval_s < 0:
            raise ValueError(f"interval_s must be >= 0, got {interval_s}")
        self.path = path
        self.interval_s = float(interval_s)
        self.seq = 0
        self._last_emit: Optional[float] = None
        self._f = open(path, "w")

    def _emit(self, registry: MetricsRegistry, now: float) -> None:
        rec = {"ts": now, "seq": self.seq, "metrics": registry.snapshot()}
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        self.seq += 1
        self._last_emit = now

    def tick(self, registry: MetricsRegistry,
             now: Optional[float] = None) -> bool:
        if self._f.closed:
            return False
        t = time.monotonic() if now is None else now
        if self._last_emit is not None and t - self._last_emit < self.interval_s:
            return False
        self._emit(registry, t)
        return True

    def close(self, registry: Optional[MetricsRegistry] = None,
              now: Optional[float] = None) -> None:
        if self._f.closed:
            return
        if registry is not None:
            self._emit(registry, time.monotonic() if now is None else now)
        self._f.close()


def read_jsonl_snapshots(path: str) -> List[Dict[str, Any]]:
    """Load and validate a --metrics-stream file (every line must be a
    snapshot object with ts/seq/metrics; seq must be contiguous)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            for key in ("ts", "seq", "metrics"):
                if key not in obj:
                    raise ValueError(
                        f"{path}:{lineno}: snapshot missing {key!r}")
            if obj["seq"] != len(out):
                raise ValueError(
                    f"{path}:{lineno}: seq {obj['seq']} != {len(out)}")
            out.append(obj)
    return out
