"""Quantization health: is the packed model actually healthy at serving?

Ported from the reference package's ``obs/health.py``. Two changes:
``site_health`` also takes torch tensors, and then computes the same
float64 values on the tensors' device (the full-width models' weights
would be slow to copy to the host), and ``kv_scale_leaves`` reads the
port's torch KV caches (ring and page pool) into numpy, in one
device-to-host copy.

Host-side reads of already-materialized artifacts — the packed weights,
their trained scales, and the int8 KV cache's write-time scales. Nothing
here enters the model's forward, so greedy-token identity is untouched by
construction; the engine simply *reads* what packing and the KV write
path already produced.

Signals:

* **code-saturation rate** — fraction of weight values whose grid image
  would round OUTSIDE ``[qmin, qmax]`` (i.e. the clip in
  ``quantize_to_grid`` engaged): ``mean(w/s > qmax + 0.5  or
  w/s < qmin - 0.5)``. A policy packed from its own calibration data
  (scale >= max|w|/qmax) has exactly zero saturation — the property the
  tests pin. Values landing exactly ON the grid edge are *not*
  saturated; that distinction is why this reads ``w`` and ``s`` rather
  than counting extreme codes.
* **scale utilization** — ``max|w| / (scale * qmax)`` per site: ~1.0
  means the trained scale tightly covers the weights; << 1 wastes grid
  resolution; > 1 means clipping (saturation above becomes nonzero).
* **KV-scale drift** — per-row write-time scales are write-once, so
  "drift across decode ticks" is the drift of the *population*: the
  relative change of the mean nonzero scale between consecutive
  samples. A stationary decode drifts ~0; a distribution shift in the
  keys/values shows up immediately.
* **per-route latency attribution** — the engine's fenced
  phase timings attributed to the dispatch route that actually ran
  (``dispatch.latency_ms.<family>.<route>`` histograms), so a route
  regression is visible per route, not just in the aggregate.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantizer import bit_range
from repro_torch.obs.metrics import MetricsRegistry

SCALE_EPS = 1e-9  # keep in sync with runtime.packing.SCALE_EPS

# rate-style histograms (fractions in [0, 1] and small relative drifts)
RATE_BUCKETS: Tuple[float, ...] = (
    1e-6, 1e-5, 1e-4, 1e-3, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0)
# scale-utilization histogram: 1.0 is ideal, > 1 means clipping
UTIL_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.5, 2.0)


def site_health(w, w_bits: int, scale) -> Dict[str, float]:
    """Saturation + utilization for one packed site, from weight + scale.

    ``scale`` may be scalar or per-channel over the last dim (the same
    broadcast ``packing.quantize_to_grid`` applies). A torch ``w`` is
    measured on its own device, in float64 as here.
    """
    if isinstance(w, torch.Tensor):
        return _site_health_tensor(w, w_bits, scale)
    w = np.asarray(w, np.float64)
    s = np.maximum(np.asarray(scale, np.float64), SCALE_EPS)
    if s.ndim == 1 and w.ndim >= 1 and s.shape[0] == w.shape[-1]:
        s = s.reshape((1,) * (w.ndim - 1) + (-1,))
    qmin, qmax = bit_range(int(w_bits), True)
    x = w / s
    saturated = np.logical_or(x > qmax + 0.5, x < qmin - 0.5)
    n = int(w.size)
    sat_rate = float(np.count_nonzero(saturated)) / n if n else 0.0
    util = float(np.max(np.abs(x))) / qmax if n else 0.0
    return {
        "saturation_rate": sat_rate,
        "scale_utilization": util,
        "n_values": n,
        "n_saturated": int(np.count_nonzero(saturated)),
        "w_bits": int(w_bits),
    }


def _site_health_tensor(w: torch.Tensor, w_bits: int,
                        scale) -> Dict[str, float]:
    """``site_health`` on ``w``'s device: the same float64 quotient and
    comparisons, so counts and ratios equal the numpy version's. One host
    read per site."""
    w = w.detach().to(torch.float64)
    s = torch.clamp(torch.as_tensor(scale, device=w.device).detach()
                    .to(torch.float64), min=SCALE_EPS)
    if s.dim() == 1 and w.dim() >= 1 and s.shape[0] == w.shape[-1]:
        s = s.reshape((1,) * (w.dim() - 1) + (-1,))
    qmin, qmax = bit_range(int(w_bits), True)
    n = int(w.numel())
    n_sat, peak = 0, 0.0
    if n:
        x = w / s
        saturated = torch.logical_or(x > qmax + 0.5, x < qmin - 0.5)
        n_sat, peak = torch.stack([saturated.sum().to(torch.float64),
                                   x.abs().max()]).tolist()
    return {
        "saturation_rate": float(n_sat) / n if n else 0.0,
        "scale_utilization": peak / qmax if n else 0.0,
        "n_values": n,
        "n_saturated": int(n_sat),
        "w_bits": int(w_bits),
    }


def pack_summary(sites: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Aggregate per-site health into the bench/gate scalars."""
    if not sites:
        return {"saturation_rate_max": 0.0, "scale_utilization_p50": 0.0,
                "scale_utilization_min": 0.0, "sites": 0}
    sats = [h["saturation_rate"] for h in sites.values()]
    utils = sorted(h["scale_utilization"] for h in sites.values())
    return {
        "saturation_rate_max": max(sats),
        "scale_utilization_p50": utils[len(utils) // 2],
        "scale_utilization_min": utils[0],
        "sites": len(sites),
    }


def publish_pack_health(registry: MetricsRegistry,
                        sites: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Record per-site gauges + aggregate histograms into the registry.

    Names: ``quant.saturation_rate.<site>`` / ``quant.scale_utilization
    .<site>`` gauges, ``quant.saturation_rate`` / ``quant
    .scale_utilization`` histograms over sites, and the summary gauges
    ``quant.saturation_rate_max`` / ``quant.scale_utilization_p50`` the
    monitor and bench read.
    """
    h_sat = registry.histogram(
        "quant.saturation_rate", buckets=RATE_BUCKETS,
        help="per-site fraction of weight values clipped by the grid")
    h_util = registry.histogram(
        "quant.scale_utilization", buckets=UTIL_BUCKETS,
        help="per-site max|w| / (scale*qmax)")
    for name, h in sites.items():
        registry.gauge(f"quant.saturation_rate.{name}").set(
            h["saturation_rate"])
        registry.gauge(f"quant.scale_utilization.{name}").set(
            h["scale_utilization"])
        h_sat.observe(h["saturation_rate"])
        h_util.observe(h["scale_utilization"])
    summary = pack_summary(sites)
    registry.gauge(
        "quant.saturation_rate_max",
        help="worst per-site saturation rate (monitor ceiling input)",
    ).set(summary["saturation_rate_max"])
    registry.gauge("quant.scale_utilization_p50").set(
        summary["scale_utilization_p50"])
    registry.gauge("quant.scale_utilization_min").set(
        summary["scale_utilization_min"])
    return summary


# ---------------------------------------------------------------------------
# int8 KV write path: write-time scale population drift
# ---------------------------------------------------------------------------
def kv_scale_leaves(tree) -> List[np.ndarray]:
    """Materialize every quantized cache's (k_scale, v_scale) host-side.

    Walks plain containers; any node exposing ``k_scale``/``v_scale``
    (QuantKVCache, PagedKVCache — NamedTuples, so check before tuple
    recursion) contributes both arrays. Torch tensors are concatenated on
    their device and read to the host in one copy. Fp caches and recurrent
    site state contribute nothing.
    """
    leaves: List = []

    def visit(x) -> None:
        if hasattr(x, "k_scale") and hasattr(x, "v_scale"):
            leaves.extend((x.k_scale, x.v_scale))
            return
        if isinstance(x, (list, tuple)):
            for y in x:
                visit(y)
        elif isinstance(x, dict):
            for y in x.values():
                visit(y)

    visit(tree)
    tensors = [a for a in leaves if isinstance(a, torch.Tensor)]
    if tensors:
        flat = torch.cat([a.detach().reshape(-1).to(torch.float32)
                          for a in tensors]).cpu().numpy()
        host, off = {}, 0
        for a in tensors:
            host[id(a)] = flat[off:off + a.numel()].reshape(tuple(a.shape))
            off += a.numel()
    return [host[id(a)] if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32) for a in leaves]


class KVScaleDrift:
    """Sampled drift of the KV write-time scale population.

    The engine calls ``update(state)`` every few decode ticks (host-side,
    after the step's device fence, outside its timer). Each call summarizes the nonzero
    scales (mean/max) and returns the relative change of the mean since
    the previous sample — the drift signal — or None on the first sample
    or an empty cache.
    """

    def __init__(self):
        self.prev_mean: Optional[float] = None
        self.last: Dict[str, float] = {}

    def update(self, tree) -> Optional[float]:
        leaves = kv_scale_leaves(tree)
        if not leaves:
            return None
        flat = np.concatenate([x.reshape(-1) for x in leaves])
        nz = flat[flat > 0.0]
        if nz.size == 0:
            return None
        mean = float(nz.mean())
        self.last = {"mean": mean, "max": float(nz.max()),
                     "rows": int(nz.size)}
        drift: Optional[float] = None
        if self.prev_mean is not None and self.prev_mean > 0.0:
            drift = abs(mean - self.prev_mean) / self.prev_mean
        self.prev_mean = mean
        return drift

    def publish(self, registry: MetricsRegistry,
                drift: Optional[float]) -> None:
        if not self.last:
            return
        registry.gauge("quant.kv_scale_mean").set(self.last["mean"])
        registry.gauge("quant.kv_scale_max").set(self.last["max"])
        if drift is not None:
            registry.histogram(
                "quant.kv_scale_drift", buckets=RATE_BUCKETS,
                help="relative change of the mean KV write scale "
                     "between samples").observe(drift)
            g = registry.gauge("quant.kv_scale_drift_max")
            g.set(max(g.value, drift))


# ---------------------------------------------------------------------------
# per-route dispatch latency attribution (host-side phase timings)
# ---------------------------------------------------------------------------
def attribute_latency(registry: MetricsRegistry, family: str, route: str,
                      seconds: float) -> None:
    """Attribute one fenced phase duration to the route that served it."""
    registry.histogram(
        f"dispatch.latency_ms.{family}.{route}",
        help=f"fenced {family} phase time attributed to route {route}",
    ).observe(seconds * 1e3)


def roofline_drift(rows: Sequence[Dict[str, Any]]) -> float:
    """Worst modeled-vs-measured factor from calibrate() rows:
    max over finite ratios of max(r, 1/r). 1.0 == perfect model."""
    worst = 1.0
    for row in rows:
        r = row.get("ratio")
        if r is None or not np.isfinite(r) or r <= 0:
            continue
        worst = max(worst, r, 1.0 / r)
    return float(worst)
