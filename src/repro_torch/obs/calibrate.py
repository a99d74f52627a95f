"""Roofline calibration: measured engine phase timings vs the step-cost
model.

Copied from the reference package's ``obs/calibrate.py`` with its imports
renamed.

``dist.roofline.decode_step_cost`` / ``suggest_prefill_chunk`` are the
scheduler's (and the ROADMAP's elastic-serving controller's) trusted
step-time oracle — but until something replays *measured* timings against
them, "trusted" is aspirational. This module closes that loop:

* :func:`calibrate` takes an ``EngineStats.as_dict()`` snapshot (whose
  timers stop after the engine's device fence)
  and the same workload shape the engine budgeted with, and returns a
  measured-vs-modeled row per phase (decode step, prefill token, TTFT)
  plus a **device-table stanza**: the effective HBM bandwidth and FLOP
  rate this host *actually delivered*, in ``ChipSpec`` field names, so
  ``dist.roofline.chip_from_table`` can build a calibrated chip.
* :func:`render_table` prints the rows as the fixed-width table the
  serve CLI emits.

The ratios are diagnostic, not gated — a CPU run is orders of magnitude
off the H100 envelope by design, and a host-bound decode step is far off
it on the card too. What IS checked (serve smoke and ``--compare``) is
that every ratio is finite and positive: the model and the measurement
describe the same phases of the same run.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from repro_torch.dist import roofline


def _phase_rows(cfg, stats: Dict[str, Any], *, slots: int,
                cache_tokens: int, kv_bits: float, kv_attend: str,
                w_bits_total: Optional[float], avg_weight_bits: float,
                tp_size: int, chip: roofline.ChipSpec) -> List[Dict[str, Any]]:
    from repro_torch.models import lm  # local import: lm imports dist.axes

    cost = roofline.decode_step_cost(
        cfg, slots, cache_tokens=cache_tokens, tp_size=tp_size,
        avg_weight_bits=avg_weight_bits, kv_bits=kv_bits,
        kv_attend=kv_attend, w_bits_total=w_bits_total, chip=chip)
    macs = sum(q.macs_per_token * q.n_mats for q in lm.enumerate_qlayers(cfg))
    per_token_s = 2.0 * macs / max(tp_size, 1) / chip.peak_flops

    rows: List[Dict[str, Any]] = []

    def row(phase: str, measured: float, modeled: float, note: str) -> None:
        ratio = measured / modeled if modeled else math.inf
        rows.append({"phase": phase, "measured_s": measured,
                     "modeled_s": modeled, "ratio": ratio, "note": note})

    decode_steps = max(int(stats.get("decode_steps", 0)), 1)
    row("decode_step", stats.get("t_decode_s", 0.0) / decode_steps,
        cost["step_s"],
        f"{cost['dominant']}-bound model, {cost['hbm_bytes']:.0f} B/step")

    prefill_tokens = max(int(stats.get("prefill_tokens", 0)), 1)
    row("prefill_token", stats.get("t_prefill_s", 0.0) / prefill_tokens,
        per_token_s, f"compute model, {2.0 * macs:.2e} flops/token")

    prefill_calls = max(int(stats.get("prefill_calls", 0)), 1)
    mean_prompt = prefill_tokens / prefill_calls
    ttft_p50_s = stats.get("ttft_p50_ms", 0.0) / 1e3
    row("ttft", ttft_p50_s, mean_prompt * per_token_s + cost["step_s"],
        f"p50 over {stats.get('admitted', 0)} requests, "
        f"mean prompt {mean_prompt:.1f} tok")
    return rows


def calibrate(cfg, stats: Dict[str, Any], *, slots: int, cache_tokens: int,
              kv_bits: float = 16.0, kv_attend: str = "fused",
              w_bits_total: Optional[float] = None,
              avg_weight_bits: float = 8.0, tp_size: int = 1,
              chip: roofline.ChipSpec = roofline.DEFAULT_CHIP
              ) -> Dict[str, Any]:
    """Measured-vs-modeled phase table + device-table stanza (module doc).

    ``stats`` is ``EngineStats.as_dict()`` from a *measured* run (warmed
    up: first-use costs in the timers, such as kernel builds, would
    calibrate those, not the device). The keyword shape must match what
    the engine budgeted with — the same arguments it passed to
    ``suggest_prefill_chunk``.
    """
    rows = _phase_rows(cfg, stats, slots=slots, cache_tokens=cache_tokens,
                       kv_bits=kv_bits, kv_attend=kv_attend,
                       w_bits_total=w_bits_total,
                       avg_weight_bits=avg_weight_bits, tp_size=tp_size,
                       chip=chip)
    cost = roofline.decode_step_cost(
        cfg, slots, cache_tokens=cache_tokens, tp_size=tp_size,
        avg_weight_bits=avg_weight_bits, kv_bits=kv_bits,
        kv_attend=kv_attend, w_bits_total=w_bits_total, chip=chip)

    # effective device envelope this run delivered: the decode step moved
    # cost["hbm_bytes"] bytes in measured time (decode is memory-bound on
    # every chip the model knows), the prefill executed 2*macs flops per
    # token in measured time — both in ChipSpec field names so
    # roofline.chip_from_table can apply them directly
    from repro_torch.models import lm
    macs = sum(q.macs_per_token * q.n_mats for q in lm.enumerate_qlayers(cfg))
    decode_steps = max(int(stats.get("decode_steps", 0)), 1)
    measured_step_s = stats.get("t_decode_s", 0.0) / decode_steps
    prefill_tokens = max(int(stats.get("prefill_tokens", 0)), 1)
    measured_prefill_s = stats.get("t_prefill_s", 0.0)
    table = {
        "name": f"{chip.name}-measured",
        "hbm_bytes_s": (cost["hbm_bytes"] / measured_step_s
                        if measured_step_s > 0 else 0.0),
        "peak_flops": (2.0 * macs * prefill_tokens / measured_prefill_s
                       if measured_prefill_s > 0 else 0.0),
        "source": "repro_torch.obs.calibrate",
    }
    return {"chip": chip.name, "rows": rows, "device_table": table,
            "finite": all(math.isfinite(r["ratio"]) and r["ratio"] > 0
                          for r in rows)}


def render_table(rows: List[Dict[str, Any]]) -> str:
    """Fixed-width measured-vs-modeled table for logs."""
    lines = [f"  {'phase':<14} {'measured':>12} {'modeled':>12} "
             f"{'ratio':>10}  note"]
    for r in rows:
        lines.append(
            f"  {r['phase']:<14} {r['measured_s']:>10.3e} s "
            f"{r['modeled_s']:>10.3e} s {r['ratio']:>10.2f}  {r['note']}")
    return "\n".join(lines)
