"""Elastic precision serving: the paper's ILP moved inside the serving loop.

The headline result of arXiv:2203.08368 is that mixed-precision search
collapses to a one-shot MCKP the DP solver closes in ~0.06 s. That is
cheap enough to run *per admission round*, not just offline — so the
serving stack can trade model precision against live load:

* ``build_variant_bank`` searches N policy variants at different average
  weight-bit budgets over the SAME trained indicator banks (no extra
  training), stamps each with the bank family fingerprint
  (``runtime.session.bank_fingerprint``), and keeps the dense MCKP grids
  around for admission-time re-solves;
* ``runtime.session.ElasticSession`` packs every variant once at build;
* ``ElasticController.decide`` re-solves the size-budget ILP against live
  engine signals (arrived queue depth, slot occupancy, page-pool
  deferrals, measured KV-cache bytes) and picks the largest pre-packed
  variant that fits the live budget;
* ``launch.engine.DecodeEngine`` drains in-flight slots under the variant
  that admitted them, then repoints ``params`` at the chosen resident
  pre-packed tree (drain-then-swap — see ``_elastic_admission``).

Decisions are DETERMINISTIC given frozen signals: the DP solver has no
tie-breaking randomness and wall-clock only enters the solve-latency
telemetry, never the choice. That is what makes the bench's swap counts
regression-gateable.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ilp, search
from repro_torch.core.policy import MPQPolicy
from repro_torch.core.qspec import QLayer
from repro_torch.dist import roofline


def variant_id(budget_avg_bits: float) -> str:
    """Canonical variant name for an average weight-bit budget."""
    return f"w{budget_avg_bits:g}"


def demo_indicators(qlayers: Sequence[QLayer],
                    bits: Sequence[int]) -> search.Indicators:
    """Deterministic stand-in for trained importance indicators.

    The demo arch trains no indicator scalars, but the elastic path still
    needs a non-degenerate MCKP: error proxies decay in the bit-width
    (``4^-b`` for weights, ``2^-b`` for activations — so the budget always
    binds), scale with the layer's parameter / MAC share (so layers
    genuinely differ), and carry a small per-layer wobble (so the solver
    produces mixed assignments rather than uniform ties). Deterministic by
    construction — the bench gates swap counts on it.
    """
    bits = [int(b) for b in bits]
    total_w = float(sum(q.w_params for q in qlayers)) or 1.0
    total_m = float(sum(q.macs_per_token * q.n_mats for q in qlayers)) or 1.0
    out: search.Indicators = {}
    for li, q in enumerate(qlayers):
        wobble = 1.0 + 0.25 * math.sin(1.0 + 0.7 * li)
        w_share = q.w_params / total_w
        a_share = (q.macs_per_token * q.n_mats) / total_m
        out[q.name] = {
            "w": np.asarray([wobble * w_share * 4.0 ** -b for b in bits]),
            "a": np.asarray([wobble * a_share * 2.0 ** -b for b in bits]),
        }
    return out


@dataclasses.dataclass
class VariantBank:
    """N searched policy variants plus the MCKP grids they came from.

    ``policies`` maps variant id -> ``MPQPolicy`` in ascending-budget
    order; ``values`` / ``cost_size`` are the shared dense ``(L, n*n)``
    grids from ``search.build_mckp`` that ``ElasticController`` re-solves
    over at admission time; ``size_bits`` is each variant's ACHIEVED
    weight-storage bits (== its policy's ``size_bytes * 8``)."""

    policies: "OrderedDict[str, MPQPolicy]"
    values: np.ndarray
    cost_size: np.ndarray
    size_bits: Dict[str, float]
    layers: Tuple[str, ...]
    bits: Tuple[int, ...]
    family: Optional[str] = None

    @property
    def full(self) -> str:
        """Variant id with the largest achieved size (highest quality)."""
        return max(self.size_bits, key=lambda p: self.size_bits[p])

    @property
    def floor(self) -> str:
        """Variant id with the smallest achieved size (cheapest)."""
        return min(self.size_bits, key=lambda p: self.size_bits[p])


def build_variant_bank(qlayers: Sequence[QLayer], bits: Sequence[int],
                       budgets: Sequence[float], *,
                       indicators: Optional[search.Indicators] = None,
                       family: Optional[str] = None, alpha: float = 1.0,
                       method: str = "dp") -> VariantBank:
    """Search one policy variant per average weight-bit budget.

    All variants come from ONE ``build_mckp`` grid (same indicators, same
    searched bit set) — only the size budget differs, which is the whole
    point: no extra training, and the controller can re-solve the same
    grid live. Each variant is stamped with ``policy_id`` /
    ``avg_bits_budget`` / ``indicator_family`` meta. Budgets that collapse
    to identical assignments fail the build: a bank where two "variants"
    serve the same bits cannot degrade anything.
    """
    budgets = sorted(float(g) for g in budgets)
    if len(budgets) < 2 or len(set(budgets)) != len(budgets):
        raise ValueError(f"need >= 2 distinct avg-bit budgets, got {budgets}")
    lo, hi = min(int(b) for b in bits), max(int(b) for b in bits)
    bad = [g for g in budgets if not lo <= g <= hi]
    if bad:
        raise ValueError(f"budgets {bad} outside the searched bit range "
                         f"[{lo}, {hi}] — no assignment can average there")
    indicators = indicators if indicators is not None \
        else demo_indicators(qlayers, bits)
    values, _, cost_size = search.build_mckp(qlayers, indicators, bits,
                                             alpha, 1)
    total_w = float(sum(q.w_params for q in qlayers))
    policies: "OrderedDict[str, MPQPolicy]" = OrderedDict()
    size_bits: Dict[str, float] = {}
    assignments: Dict[tuple, str] = {}
    for g in budgets:
        pid = variant_id(g)
        res = search.search_policy(qlayers, indicators, bits, alpha=alpha,
                                   size_budget_bytes=g * total_w / 8.0,
                                   method=method)
        pol = res.policy
        pol.meta["policy_id"] = pid
        pol.meta["avg_bits_budget"] = g
        if family is not None:
            pol.meta["indicator_family"] = str(family)
        key = (tuple(sorted(pol.w_bits.items())),
               tuple(sorted(pol.a_bits.items())))
        if key in assignments:
            raise ValueError(
                f"budgets {assignments[key]} and {pid} solve to the same "
                "assignment — widen the bank's budget spread")
        assignments[key] = pid
        policies[pid] = pol
        size_bits[pid] = float(res.size_bytes) * 8.0
    return VariantBank(policies=policies, values=values, cost_size=cost_size,
                       size_bits=size_bits,
                       layers=tuple(q.name for q in qlayers),
                       bits=tuple(int(b) for b in bits), family=family)


@dataclasses.dataclass
class ElasticDecision:
    """One admission-time re-solve: which variant should serve, and why."""

    target: str          # variant id the engine should be serving
    active: str          # variant id it was serving when asked
    budget_bits: float   # live size budget the ILP solved against
    achieved_bits: float  # free-form optimum's size (lower bound audit)
    target_bits: float   # the chosen pre-packed variant's achieved size
    solver: str
    solve_ms: float
    signals: Dict[str, float]
    report: ilp.SolveReport  # the full audit trail (meta carries signals)

    def summary(self) -> Dict[str, Any]:
        """Compact JSON-able view for the ``policy_swap`` trace event."""
        return {"target": self.target, "active": self.active,
                "budget_bits": self.budget_bits,
                "achieved_bits": self.achieved_bits,
                "target_bits": self.target_bits,
                "objective": self.report.objective, "solver": self.solver,
                "optimal": self.report.optimal, "solve_ms": self.solve_ms,
                "signals": dict(self.signals)}


class ElasticController:
    """Admission-time ILP re-solve over a pre-packed variant bank.

    Every admission round with pending work, the engine hands this
    controller its live signals; ``decide`` turns them into a weight-size
    budget, re-solves the bank's MCKP grid against it (the ~tens-of-ms
    claim the obs histogram ``ilp.solve_ms`` now polices), and returns
    the largest pre-packed variant fitting the budget. The free-form
    solution itself is kept as the ``SolveReport`` audit trail — what the
    live-optimal assignment WOULD be if the bank held every policy — but
    only pre-packed variants can actually serve (no repacking on the hot
    path).

    Budget rule: the full variant's size, divided by the overload factor
    ``max(demand / slots, 1)`` where demand = arrived queue + occupied +
    fresh page-pool deferrals, then capped by HBM headroom when
    ``hbm_limit_bytes`` is set (live KV bytes eat into it). The result is
    clamped (with 1% slack for the DP's ceil-rounded cost grid) to the
    floor variant's size so a solve is always feasible. Upshifts are
    hysteretic: precision only recovers once nothing is waiting, so a
    sawtooth queue cannot thrash the bank.
    """

    def __init__(self, cfg: ModelConfig, bank: VariantBank, *, slots: int,
                 cache_len: int, kv_bits: float = 8.0,
                 kv_attend: str = "fused", method: str = "dp",
                 bins: int = 2048, hbm_limit_bytes: Optional[float] = None,
                 chip: Optional[roofline.ChipSpec] = None):
        self.bank = bank
        self.method = method
        # 2048 bins ≈ budget granularity well under one layer's smallest
        # bit step on the demo grids, at a quarter of the default solve
        # cost — this solve runs every admission round, not once
        self.bins = int(bins)
        self.hbm_limit_bytes = hbm_limit_bytes
        # largest -> smallest variant by achieved size
        self.order = sorted(bank.size_bits, key=lambda p: bank.size_bits[p],
                            reverse=True)
        self.full, self.floor = self.order[0], self.order[-1]
        # calibrated roofline step cost per variant: the audit signal
        # saying what each downshift buys per decode step (surfaced in
        # explain(); the decision itself stays a pure budget rule)
        self.step_s = {
            pid: roofline.decode_step_cost(
                cfg, slots, cache_tokens=cache_len, kv_bits=kv_bits,
                kv_attend=kv_attend, w_bits_total=bank.size_bits[pid],
                chip=chip or roofline.DEFAULT_CHIP)["step_s"]
            for pid in self.order}
        self.solves = 0
        self.max_solve_ms = 0.0
        self.last_report: Optional[ilp.SolveReport] = None

    def live_budget_bits(self, *, queue_depth: int, occupied: int,
                         slots: int, deferred: float = 0.0,
                         cache_bytes: float = 0.0) -> float:
        demand = float(queue_depth) + float(occupied) + float(deferred)
        overload = max(demand / max(int(slots), 1), 1.0)
        budget = self.bank.size_bits[self.full] / overload
        if self.hbm_limit_bytes:
            headroom_bits = (float(self.hbm_limit_bytes)
                             - float(cache_bytes)) * 8.0
            budget = min(budget, headroom_bits)
        # 1% slack: solve_dp ceil-rounds each layer cost onto the bin
        # grid, so a budget exactly at the floor assignment's true size
        # could round infeasible
        return max(budget, self.bank.size_bits[self.floor] * 1.01)

    def decide(self, *, active: str, queue_depth: int, occupied: int,
               slots: int, deferred: int = 0, cache_bytes: float = 0.0
               ) -> ElasticDecision:
        signals = {"queue_depth": float(queue_depth),
                   "occupied": float(occupied), "slots": float(slots),
                   "deferred": float(deferred),
                   "cache_bytes": float(cache_bytes)}
        budget = self.live_budget_bits(queue_depth=queue_depth,
                                       occupied=occupied, slots=slots,
                                       deferred=deferred,
                                       cache_bytes=cache_bytes)
        t0 = time.perf_counter()
        sol = ilp.solve_mckp(self.bank.values, self.bank.cost_size, budget,
                             method=self.method, bins=self.bins)
        solve_ms = (time.perf_counter() - t0) * 1e3
        self.solves += 1
        self.max_solve_ms = max(self.max_solve_ms, solve_ms)
        report = ilp.build_solve_report(
            list(self.bank.layers), list(self.bank.bits), sol,
            self.bank.values, {"size_bits": self.bank.cost_size},
            {"size_bits": budget}, elapsed_s=solve_ms / 1e3,
            meta=dict(signals, kind="elastic-resolve"))
        self.last_report = report
        sizes = self.bank.size_bits
        fitting = [p for p in self.order if sizes[p] <= budget * (1 + 1e-9)]
        target = fitting[0] if fitting else self.floor
        # hysteresis: upshift only once nothing is waiting
        if (active in sizes and sizes[target] > sizes[active]
                and queue_depth > 0):
            target = active
        return ElasticDecision(target=target, active=str(active),
                               budget_bits=float(budget),
                               achieved_bits=float(sol.cost),
                               target_bits=float(sizes[target]),
                               solver=sol.method, solve_ms=float(solve_ms),
                               signals=signals, report=report)

    def explain(self) -> str:
        """One line per variant: achieved size and modeled step cost."""
        rows = [f"{pid}: {self.bank.size_bits[pid] / 8e6:.2f} MB, "
                f"{self.step_s[pid] * 1e3:.3f} ms/step (roofline)"
                for pid in self.order]
        return "\n".join(rows)
