"""End-to-end MPQ search (paper §3.5): indicators -> ILP -> MPQPolicy.

The objective per layer l and choice (i, j) is  s_a[j] + alpha * s_w[i]
(Eq. 3). Costs are BitOps (Eq. 3b) and/or weight-storage bits (Table 3's
compression-rate constraint).

`reverse=True` implements the Table-6 ablation (sensitive layers get FEWER
bits) by rank-mirroring the indicator table across layers: the most
sensitive layer receives the least-sensitive layer's indicators and vice
versa, then the SAME ILP runs. (Negating the objective would instead
collapse to all-min-bits and under-use the budget — not the paper's
"reversed assignment" at the same BitOps level.)
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ilp, qspec
from repro_torch.core.policy import MPQPolicy
from repro_torch.core.qspec import QLayer

Indicators = Dict[str, Dict[str, np.ndarray]]  # name -> {"w": (n,), "a": (n,)}


@dataclass
class SearchResult:
    policy: MPQPolicy
    objective: float
    bitops: float
    size_bytes: float
    elapsed_s: float
    solver: str
    optimal: bool
    report: Optional[ilp.SolveReport] = None  # the ILP audit trail


def reverse_indicators(qlayers: Sequence[QLayer],
                       indicators: Indicators) -> Indicators:
    """Rank-mirror the indicator table across layers (Table-6 'Ours-R')."""
    names = [q.name for q in qlayers]
    score = {n: float(np.sum(indicators[n]["w"]) + np.sum(indicators[n]["a"]))
             for n in names}
    order = sorted(names, key=lambda n: score[n])
    mirror = {order[i]: order[len(order) - 1 - i] for i in range(len(order))}
    return {n: indicators[mirror[n]] for n in names}


def build_mckp(qlayers: Sequence[QLayer], indicators: Indicators,
               bits: Sequence[int], alpha: float, n_tokens: int,
               reverse: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense (L, n*n) value/bitops/sizebits arrays; choice c = i*n + j."""
    if reverse:
        indicators = reverse_indicators(qlayers, indicators)
    n = len(bits)
    L = len(qlayers)
    values = np.zeros((L, n * n), np.float64)
    cost_ops = np.zeros((L, n * n), np.float64)
    cost_size = np.zeros((L, n * n), np.float64)
    for l, q in enumerate(qlayers):
        s_w = np.asarray(indicators[q.name]["w"], np.float64)
        s_a = np.asarray(indicators[q.name]["a"], np.float64)
        for i, bw in enumerate(bits):
            for j, ba in enumerate(bits):
                c = i * n + j
                values[l, c] = s_a[j] + alpha * s_w[i]
                cost_ops[l, c] = qspec.bitops(q, int(bw), int(ba), n_tokens)
                cost_size[l, c] = qspec.model_bits(q, int(bw))
    return values, cost_ops, cost_size


def search_policy(
    qlayers: Sequence[QLayer],
    indicators: Indicators,
    bits: Sequence[int],
    *,
    alpha: float = 1.0,
    n_tokens: int = 1,
    bitops_budget: Optional[float] = None,
    size_budget_bytes: Optional[float] = None,
    method: str = "dp",
    reverse: bool = False,
) -> SearchResult:
    if bitops_budget is None and size_budget_bytes is None:
        raise ValueError("need at least one constraint (Eq. 3b)")
    values, cost_ops, cost_size = build_mckp(
        qlayers, indicators, bits, alpha, n_tokens, reverse=reverse)

    t0 = time.perf_counter()
    if bitops_budget is not None and size_budget_bytes is not None:
        sol = ilp.solve_mckp_dual(values, cost_ops, bitops_budget,
                                  cost_size, size_budget_bytes * 8.0)
    elif bitops_budget is not None:
        sol = ilp.solve_mckp(values, cost_ops, bitops_budget, method=method)
    else:
        sol = ilp.solve_mckp(values, cost_size, size_budget_bytes * 8.0,
                             method=method)
    elapsed = time.perf_counter() - t0

    report = ilp.build_solve_report(
        [q.name for q in qlayers], [int(b) for b in bits], sol, values,
        {"bitops": cost_ops, "size_bits": cost_size},
        {"bitops": bitops_budget,
         "size_bits": (size_budget_bytes * 8.0
                       if size_budget_bytes is not None else None)},
        elapsed_s=elapsed,
        meta={
            "kind": "ilp-reversed" if reverse else "ilp",
            "alpha": alpha,
            "n_tokens": n_tokens,
        },
    )
    policy = MPQPolicy.from_choice(
        qlayers, sol.choice, bits,
        meta={
            "kind": "ilp-reversed" if reverse else "ilp",
            "alpha": alpha,
            "bitops_budget": bitops_budget,
            "size_budget_bytes": size_budget_bytes,
            "solver": sol.method,
            "elapsed_s": elapsed,
            "solve_report": report.to_json(),
        },
    )
    return SearchResult(
        policy=policy,
        objective=float(abs(sol.value)),
        bitops=policy.bitops(qlayers, n_tokens),
        size_bytes=policy.size_bytes(qlayers),
        elapsed_s=elapsed,
        solver=sol.method,
        optimal=sol.optimal,
        report=report,
    )


def bitops_budget_for_uniform(qlayers: Sequence[QLayer], bits: int,
                              n_tokens: int = 1) -> float:
    """Budget equal to a uniform `bits`-bit network — the paper's
    '3-bit level' / '4-bit level' constraint definition."""
    u = MPQPolicy.uniform(qlayers, bits)
    return u.bitops(qlayers, n_tokens)


def size_budget_for_rate(qlayers: Sequence[QLayer], fp_bits: int,
                         rate: float) -> float:
    """Size budget from a compression rate (Table 3: 12.2x over fp32)."""
    fp_bytes = sum(q.w_params for q in qlayers) * fp_bits / 8.0
    return fp_bytes / rate
