"""repro_torch.obs — observability for the quantized serving stack.

The reference package's ``obs`` modules, copied (``metrics``, ``trace``,
``calibrate``, ``export``, ``monitor``) or ported (``health``), all host
side (stdlib + numpy; ``health`` also reads torch tensors):

* ``obs.metrics``   — a metrics registry (monotonic counters, gauges,
  fixed-bucket histograms, snapshot-to-dict). The engine, scheduler,
  session and dispatch report through one registry.
* ``obs.trace``     — per-request lifecycle event traces
  (admit → prefix_hit → prefill → first-token → decode ticks →
  complete/evict) with fenced ``time.perf_counter`` timestamps,
  exportable as JSONL or Chrome-trace/Perfetto JSON
  (``serve --trace-out``).
* ``obs.calibrate`` — replays measured per-phase engine timings against
  the ``dist.roofline`` step-cost model and emits a measured-vs-modeled
  table plus a device-table stanza the ``ChipSpec`` can be updated from
  (``serve --chip-table``).
* ``obs.health``    — quantization health from already-materialized
  artifacts: pack-time code saturation and scale utilization per site,
  KV-scale drift across decode ticks, per-route latency attribution,
  roofline drift. Never touches the model's forward, so greedy-token
  identity is untouched.
* ``obs.export``    — Prometheus text exposition of a registry snapshot
  plus a periodic JSONL snapshot streamer (``serve --metrics-stream``).
* ``obs.monitor``   — threshold watchers over the registry raising
  structured ``Alert`` records into the trace and the engine stats
  (page-pool pressure, saturation ceiling, roofline drift).
"""
from repro_torch.obs.export import (  # noqa: F401
    MetricsStreamer,
    parse_prometheus_text,
    prometheus_text,
    read_jsonl_snapshots,
    write_prometheus,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.monitor import (  # noqa: F401
    Alert,
    Monitor,
    Watcher,
    default_monitor,
)
from repro_torch.obs.trace import TraceRecorder  # noqa: F401
