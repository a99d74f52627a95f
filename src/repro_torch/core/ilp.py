"""Multiple-Choice Knapsack (the paper's Eq. 3 ILP) — in-repo solvers.

The paper solves Eq. 3 with PuLP; PuLP is not available offline, so we ship
three solvers with cross-checked semantics:

  * ``solve_bruteforce`` — exponential, tests only.
  * ``solve_dp``         — exact on a ceil-rounded integer cost grid
                           (admissible: rounding costs *up* keeps every
                           returned solution feasible for the true budget).
  * ``solve_lagrangian`` — bisection on the dual multiplier + greedy repair;
                           returns a certified duality gap.

All solvers MINIMIZE sum of per-layer choice values subject to
sum of per-layer choice costs <= budget, picking exactly one choice per layer
(Eq. 3a/3b/3c). Inputs are dense (L, C) float64 arrays.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class MCKPSolution:
    choice: np.ndarray          # (L,) int — chosen column per layer
    value: float                # achieved objective
    cost: float                 # achieved total cost
    budget: float
    method: str
    optimal: bool               # True when the method certifies optimality
    gap: float = 0.0            # duality gap for lagrangian (abs value units)

    @property
    def feasible(self) -> bool:
        return self.cost <= self.budget * (1 + 1e-12)


class InfeasibleError(ValueError):
    pass


def _validate(values: np.ndarray, costs: np.ndarray, budget: float):
    values = np.asarray(values, np.float64)
    costs = np.asarray(costs, np.float64)
    if values.shape != costs.shape or values.ndim != 2:
        raise ValueError(f"values/costs must be (L, C); got {values.shape} vs {costs.shape}")
    if np.any(costs < 0):
        raise ValueError("negative costs unsupported")
    min_cost = costs.min(axis=1).sum()
    if min_cost > budget:
        raise InfeasibleError(
            f"budget {budget:.3e} below minimum achievable cost {min_cost:.3e}")
    return values, costs


def solve_bruteforce(values, costs, budget: float) -> MCKPSolution:
    values, costs = _validate(values, costs, budget)
    L, C = values.shape
    if C ** L > 2_000_000:
        raise ValueError("bruteforce only for tiny instances")
    best_v, best_choice = np.inf, None
    idx = np.zeros(L, dtype=int)
    while True:
        c = costs[np.arange(L), idx].sum()
        if c <= budget:
            v = values[np.arange(L), idx].sum()
            if v < best_v:
                best_v, best_choice = v, idx.copy()
        # odometer increment
        pos = L - 1
        while pos >= 0:
            idx[pos] += 1
            if idx[pos] < C:
                break
            idx[pos] = 0
            pos -= 1
        if pos < 0:
            break
    if best_choice is None:
        raise InfeasibleError("no feasible assignment")
    cost = costs[np.arange(L), best_choice].sum()
    return MCKPSolution(best_choice, float(best_v), float(cost), budget,
                        "bruteforce", optimal=True)


def _greedy_improve(values: np.ndarray, costs: np.ndarray, budget: float,
                    choice: np.ndarray) -> np.ndarray:
    """Single-layer swaps that reduce value while staying within the TRUE
    budget. Recovers solutions the ceil-rounded DP grid excludes at tight
    budgets and polishes the Lagrangian primal."""
    L = values.shape[0]
    rows = np.arange(L)
    choice = choice.copy()
    improved = True
    while improved:
        improved = False
        cur_cost = costs[rows, choice].sum()
        for l in range(L):
            c0 = choice[l]
            slack = budget - (cur_cost - costs[l, c0])
            cand = np.where(costs[l] <= slack, values[l], np.inf)
            c1 = int(np.argmin(cand))
            if cand[c1] < values[l, c0] - 1e-15:
                choice[l] = c1
                cur_cost = cur_cost - costs[l, c0] + costs[l, c1]
                improved = True
    return choice


def solve_dp(values, costs, budget: float, bins: int = 8192) -> MCKPSolution:
    """Exact DP on a ceil-rounded cost grid + greedy true-budget polish.

    Cost unit = budget / bins. Each choice cost is rounded UP to grid units so
    any solution the DP accepts is feasible for the real budget; optimality is
    exact on the rounded instance (gap vanishes as bins grows — tests compare
    against bruteforce). The greedy pass then reclaims budget the ceil
    rounding left on the table (tight integral instances).
    """
    values, costs = _validate(values, costs, budget)
    L, C = values.shape
    unit = budget / bins if budget > 0 else 1.0
    icost = np.ceil(costs / unit - 1e-12).astype(np.int64)  # (L, C)
    icost = np.clip(icost, 0, bins + 1)

    NEG = np.inf
    dp = np.full(bins + 1, NEG)
    dp[0] = 0.0
    # dp[b] = min value over layer-prefixes whose rounded cost is EXACTLY b;
    # the final answer is argmin over all b <= bins (i.e. cost <= budget).
    back = np.zeros((L, bins + 1), dtype=np.int8 if C < 127 else np.int16)
    for l in range(L):
        new_dp = np.full(bins + 1, NEG)
        new_back = np.zeros(bins + 1, dtype=back.dtype)
        for c in range(C):
            ic, v = int(icost[l, c]), values[l, c]
            if ic > bins:
                continue
            cand = np.full(bins + 1, NEG)
            cand[ic:] = dp[: bins + 1 - ic] + v
            better = cand < new_dp
            new_dp = np.where(better, cand, new_dp)
            new_back = np.where(better, c, new_back)
        dp = new_dp
        back[l] = new_back
        if not np.isfinite(dp).any():
            raise InfeasibleError("DP infeasible at layer %d" % l)

    # best terminal state
    b = int(np.argmin(dp))
    if not np.isfinite(dp[b]):
        raise InfeasibleError("no feasible assignment")
    choice = np.zeros(L, dtype=int)
    for l in range(L - 1, -1, -1):
        c = int(back[l, b])
        choice[l] = c
        b -= int(icost[l, c])
    choice = _greedy_improve(values, costs, budget, choice)
    cost = costs[np.arange(L), choice].sum()
    value = values[np.arange(L), choice].sum()
    return MCKPSolution(choice, float(value), float(cost), budget, "dp",
                        optimal=True)


def solve_lagrangian(values, costs, budget: float, iters: int = 64) -> MCKPSolution:
    """Bisection on lambda for min_x sum(v + lam*c) with greedy repair.

    Fast (O(L*C*iters)) and near-optimal; returns the certified gap between
    the best primal found and the Lagrangian dual bound.
    """
    values, costs = _validate(values, costs, budget)
    L = values.shape[0]
    rows = np.arange(L)

    def primal(lam: float):
        choice = np.argmin(values + lam * costs, axis=1)
        return choice, costs[rows, choice].sum(), values[rows, choice].sum()

    lo, hi = 0.0, 1.0
    # grow hi until feasible
    choice_hi, cost_hi, _ = primal(hi)
    guard = 0
    while cost_hi > budget and guard < 128:
        hi *= 4.0
        choice_hi, cost_hi, _ = primal(hi)
        guard += 1
    if cost_hi > budget:
        raise InfeasibleError("lagrangian could not reach feasibility")

    best_choice, best_cost, best_val = choice_hi, cost_hi, values[rows, choice_hi].sum()
    dual_bound = -np.inf
    for _ in range(iters):
        lam = 0.5 * (lo + hi)
        choice, cost, val = primal(lam)
        dual_bound = max(dual_bound, val + lam * (cost - budget))
        if cost <= budget:
            hi = lam
            if val < best_val:
                best_choice, best_cost, best_val = choice, cost, val
        else:
            lo = lam

    best_choice = _greedy_improve(values, costs, budget, best_choice)
    best_cost = costs[rows, best_choice].sum()
    best_val = values[rows, best_choice].sum()
    gap = float(best_val - dual_bound)
    return MCKPSolution(best_choice, float(best_val), float(best_cost), budget,
                        "lagrangian", optimal=gap <= 1e-9, gap=max(gap, 0.0))


def solve_mckp(values, costs, budget: float, method: str = "auto",
               bins: int = 8192) -> MCKPSolution:
    if method == "auto":
        method = "dp"
    if method == "bruteforce":
        return solve_bruteforce(values, costs, budget)
    if method == "dp":
        return solve_dp(values, costs, budget, bins=bins)
    if method == "lagrangian":
        return solve_lagrangian(values, costs, budget)
    raise ValueError(f"unknown method {method!r}")


def solve_mckp_dual(values, costs_a, budget_a: float, costs_b,
                    budget_b: float, outer_iters: int = 40,
                    bins: int = 8192) -> MCKPSolution:
    """Two simultaneous budgets (paper Table 3: BitOps AND compression rate).

    Lagrangian-relax constraint B into the objective, bisect its multiplier,
    and solve the remaining single-constraint MCKP exactly with the DP.
    """
    values = np.asarray(values, np.float64)
    costs_a = np.asarray(costs_a, np.float64)
    costs_b = np.asarray(costs_b, np.float64)
    L = values.shape[0]
    rows = np.arange(L)

    def inner(mu: float) -> MCKPSolution:
        return solve_dp(values + mu * costs_b, costs_a, budget_a, bins=bins)

    sol = inner(0.0)
    if costs_b[rows, sol.choice].sum() <= budget_b:
        sol.method = "dual(mu=0)"
        return sol
    lo, mu = 0.0, 1.0
    sol_hi = inner(mu)
    guard = 0
    while costs_b[rows, sol_hi.choice].sum() > budget_b and guard < 60:
        mu *= 4.0
        sol_hi = inner(mu)
        guard += 1
    if costs_b[rows, sol_hi.choice].sum() > budget_b:
        raise InfeasibleError("dual-budget instance infeasible")
    hi = mu
    best = sol_hi
    for _ in range(outer_iters):
        mid = 0.5 * (lo + hi)
        s = inner(mid)
        if costs_b[rows, s.choice].sum() <= budget_b:
            hi = mid
            if values[rows, s.choice].sum() <= values[rows, best.choice].sum():
                best = s
        else:
            lo = mid
    choice = best.choice
    return MCKPSolution(
        choice,
        float(values[rows, choice].sum()),
        float(costs_a[rows, choice].sum()),
        budget_a,
        "dual",
        optimal=False,
    )

# ---------------------------------------------------------------------------
# SolveReport: the ILP audit trail
# ---------------------------------------------------------------------------
SOLVE_REPORT_SCHEMA = 1


@dataclass
class SolveReport:
    """Structured audit of one MCKP solve: *why* each layer got its bits.

    Everything the serving side needs to explain (and re-verify) a
    policy: the candidate grid, per-layer chosen bits, the objective
    decomposed per layer (``importance``), and every constraint with its
    used cost and slack. Round-trips to JSON (``to_json``/``from_json``)
    so ``checkpoint`` can embed it in the serving bundle and ``serve
    --explain-policy`` can render it back as a table.

    Replaying the audit is cheap and exact: ``chosen_w``/``chosen_a``
    rebuilt into an ``MPQPolicy`` must validate against the qlayers, and
    ``policy.size_bytes * 8`` must equal the ``size_bits`` constraint's
    ``used`` — the property the tests pin.
    """

    layers: List[str]                    # per-layer site names
    bits: List[int]                      # searched candidate widths
    chosen_w: List[int]                  # chosen weight bits per layer
    chosen_a: List[int]                  # chosen activation bits per layer
    importance: List[float]              # per-layer chosen objective term
    candidate_values: List[List[float]]  # (L, n*n) objective grid
    candidate_costs: Dict[str, List[List[float]]]  # name -> (L, n*n)
    constraints: List[Dict[str, Any]]    # name/budget/used/slack/binding
    objective: float
    solver: str
    optimal: bool
    elapsed_s: float
    meta: Dict[str, Any] = field(default_factory=dict)
    schema: int = SOLVE_REPORT_SCHEMA

    # -- accessors ---------------------------------------------------------
    @property
    def binding(self) -> str:
        """Name of the binding (smallest relative slack) constraint."""
        for c in self.constraints:
            if c.get("binding"):
                return str(c["name"])
        return "none"

    def constraint(self, name: str) -> Dict[str, Any]:
        for c in self.constraints:
            if c["name"] == name:
                return c
        raise KeyError(f"no constraint {name!r} in report")

    def policy_bits(self) -> Dict[str, Dict[str, int]]:
        """{"w_bits": {...}, "a_bits": {...}} keyed by layer name."""
        return {
            "w_bits": dict(zip(self.layers, self.chosen_w)),
            "a_bits": dict(zip(self.layers, self.chosen_a)),
        }

    # -- json round-trip ---------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "schema": self.schema,
            "layers": list(self.layers),
            "bits": [int(b) for b in self.bits],
            "chosen_w": [int(b) for b in self.chosen_w],
            "chosen_a": [int(b) for b in self.chosen_a],
            "importance": [float(v) for v in self.importance],
            "candidate_values": [[float(v) for v in row]
                                 for row in self.candidate_values],
            "candidate_costs": {k: [[float(v) for v in row] for row in m]
                                for k, m in self.candidate_costs.items()},
            "constraints": [dict(c) for c in self.constraints],
            "objective": float(self.objective),
            "solver": self.solver,
            "optimal": bool(self.optimal),
            "elapsed_s": float(self.elapsed_s),
            "meta": dict(self.meta),
        }

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "SolveReport":
        schema = int(obj.get("schema", 0))
        if schema > SOLVE_REPORT_SCHEMA:
            raise ValueError(
                f"SolveReport schema {schema} is newer than supported "
                f"{SOLVE_REPORT_SCHEMA}")
        return cls(
            layers=list(obj["layers"]),
            bits=[int(b) for b in obj["bits"]],
            chosen_w=[int(b) for b in obj["chosen_w"]],
            chosen_a=[int(b) for b in obj["chosen_a"]],
            importance=[float(v) for v in obj["importance"]],
            candidate_values=[list(map(float, r))
                              for r in obj["candidate_values"]],
            candidate_costs={k: [list(map(float, r)) for r in m]
                             for k, m in obj["candidate_costs"].items()},
            constraints=[dict(c) for c in obj["constraints"]],
            objective=float(obj["objective"]),
            solver=str(obj["solver"]),
            optimal=bool(obj["optimal"]),
            elapsed_s=float(obj["elapsed_s"]),
            meta=dict(obj.get("meta", {})),
            schema=schema,
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "SolveReport":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- human rendering ---------------------------------------------------
    def render_table(self) -> str:
        """The ``serve --explain-policy`` table: one row per layer plus
        the constraint footer naming the binding budget."""
        size = self.candidate_costs.get("size_bits")
        ops = self.candidate_costs.get("bitops")
        n = len(self.bits)
        header = (f"{'layer':<28} {'w':>2} {'a':>2} {'importance':>12} "
                  f"{'kbytes':>10} {'bitops':>12}")
        lines = [header, "-" * len(header)]
        for l, name in enumerate(self.layers):
            i = self.bits.index(self.chosen_w[l])
            j = self.bits.index(self.chosen_a[l])
            c = i * n + j
            kb = size[l][c] / 8.0 / 1024.0 if size else float("nan")
            bo = ops[l][c] if ops else float("nan")
            lines.append(f"{name:<28} {self.chosen_w[l]:>2} "
                         f"{self.chosen_a[l]:>2} {self.importance[l]:>12.5g} "
                         f"{kb:>10.2f} {bo:>12.4g}")
        lines.append("")
        lines.append(f"objective {self.objective:.6g}  solver {self.solver}"
                     f"{' (optimal)' if self.optimal else ''}  "
                     f"elapsed {self.elapsed_s * 1e3:.1f} ms")
        for c in self.constraints:
            mark = "  <- binding" if c.get("binding") else ""
            if c["budget"] is None:
                lines.append(f"constraint {c['name']:<10} budget -         "
                             f"used {c['used']:.4g}  (tracked, unconstrained)")
            else:
                lines.append(
                    f"constraint {c['name']:<10} budget {c['budget']:.4g}  "
                    f"used {c['used']:.4g}  slack {c['slack']:.4g} "
                    f"({100.0 * c['slack_frac']:.1f}%){mark}")
        return "\n".join(lines)


def _constraint_rows(used_by_name: Dict[str, float],
                     budget_by_name: Dict[str, Optional[float]]
                     ) -> List[Dict[str, Any]]:
    """Constraint dicts with slack; the smallest relative slack among
    constraints that HAVE a budget is marked binding."""
    rows: List[Dict[str, Any]] = []
    for name, used in used_by_name.items():
        budget = budget_by_name.get(name)
        if budget is None:
            rows.append({"name": name, "budget": None, "used": float(used),
                         "slack": None, "slack_frac": 0.0, "binding": False})
            continue
        slack = float(budget) - float(used)
        frac = slack / budget if budget else 0.0
        rows.append({"name": name, "budget": float(budget),
                     "used": float(used), "slack": slack,
                     "slack_frac": frac, "binding": False})
    budgeted = [r for r in rows if r["budget"] is not None]
    if budgeted:
        min(budgeted, key=lambda r: r["slack_frac"])["binding"] = True
    return rows


def build_solve_report(
    layers: Sequence[str],
    bits: Sequence[int],
    sol: MCKPSolution,
    values: np.ndarray,
    cost_matrices: Dict[str, np.ndarray],
    budgets: Dict[str, Optional[float]],
    *,
    elapsed_s: float = 0.0,
    meta: Optional[Dict[str, Any]] = None,
) -> SolveReport:
    """Compose the audit from a solved instance (search.py's call site).

    ``cost_matrices`` are the dense (L, C) cost grids keyed by constraint
    name; ``budgets`` maps the same names to their budget (None for a
    cost that was tracked but not constrained).
    """
    values = np.asarray(values, np.float64)
    L = len(layers)
    n = len(bits)
    rows = np.arange(L)
    choice = np.asarray(sol.choice, int)
    iw, ja = np.divmod(choice, n)
    used = {name: float(np.asarray(m, np.float64)[rows, choice].sum())
            for name, m in cost_matrices.items()}
    return SolveReport(
        layers=[str(s) for s in layers],
        bits=[int(b) for b in bits],
        chosen_w=[int(bits[i]) for i in iw],
        chosen_a=[int(bits[j]) for j in ja],
        importance=[float(v) for v in values[rows, choice]],
        candidate_values=values.tolist(),
        candidate_costs={k: np.asarray(m, np.float64).tolist()
                         for k, m in cost_matrices.items()},
        constraints=_constraint_rows(used, budgets),
        objective=float(values[rows, choice].sum()),
        solver=sol.method,
        optimal=bool(sol.optimal),
        elapsed_s=float(elapsed_s),
        meta=dict(meta or {}),
    )


def describe_policy_report(qlayers, policy, bits: Sequence[int],
                           n_tokens: int = 1,
                           meta: Optional[Dict[str, Any]] = None
                           ) -> SolveReport:
    """Post-hoc audit for a policy that was NOT produced by a solve here
    (the demo stand-in, a hand-written policy). Cost grids are the real
    qspec accounting; importance is unknown (zeros); budgets are set to
    the used costs, so slack is exactly 0 and the size constraint reads
    as binding. ``meta.kind == "describe"`` marks the provenance.
    """
    from repro_torch.core import qspec  # local import: keep ilp dependency-light

    bits = [int(b) for b in bits]
    n = len(bits)
    L = len(qlayers)
    values = np.zeros((L, n * n), np.float64)
    cost_ops = np.zeros((L, n * n), np.float64)
    cost_size = np.zeros((L, n * n), np.float64)
    choice = np.zeros(L, int)
    for l, q in enumerate(qlayers):
        for i, bw in enumerate(bits):
            for j, ba in enumerate(bits):
                cost_ops[l, i * n + j] = qspec.bitops(q, bw, ba, n_tokens)
                cost_size[l, i * n + j] = qspec.model_bits(q, bw)
        choice[l] = (bits.index(policy.w_bits[q.name]) * n
                     + bits.index(policy.a_bits[q.name]))
    rows = np.arange(L)
    sol = MCKPSolution(choice, 0.0, float(cost_size[rows, choice].sum()),
                       float(cost_size[rows, choice].sum()),
                       method="describe", optimal=False)
    budgets = {"bitops": None,
               "size_bits": float(cost_size[rows, choice].sum())}
    m = {"kind": "describe"}
    m.update(meta or {})
    return build_solve_report(
        [q.name for q in qlayers], bits, sol, values,
        {"bitops": cost_ops, "size_bits": cost_size}, budgets, meta=m)
