"""Request queue + admission policies for the continuous-batching engine.

The scheduler owns *which* request enters *which* slot *when*; the engine
(`repro_torch.launch.engine`) owns the device state. Three policies:

* ``continuous`` — FIFO continuous batching: a finished sequence frees its
  slot immediately and the next arrived request is admitted mid-flight,
  subject to a per-iteration prefill-token budget (see below).
* ``continuous-sjf`` — same, but arrived requests admit shortest-prompt
  first (reduces head-of-line blocking under the token budget).
* ``fixed`` — the legacy fixed-batch path expressed as a policy: requests
  are admitted only when every slot is free, and the engine holds all slots
  until the whole round finishes — i.e. everything is padded to the round's
  max generation length.

Prefill/decode interleave
-------------------------
Every engine iteration grants the scheduler ``prefill_chunk`` tokens of
prefill bandwidth (the chunk comes from
``repro_torch.dist.roofline.suggest_prefill_chunk`` unless the engine is
given one: the headroom between the decode step's memory/interconnect
ceiling and its compute term, i.e. how many compute-bound prefill tokens
ride along a memory-bound decode step for free). Credit accrues while
work is waiting, and a request is admitted
once its prompt cost is covered — a prompt longer than the chunk therefore
spreads its admission over ``ceil(prompt / chunk)`` iterations, which is
exactly the stall pattern of chunked prefill without needing a separate
multi-token cache-append kernel.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

POLICIES = ("continuous", "continuous-sjf", "fixed")


def bucket_length(n: int, min_bucket: int = 8) -> int:
    """Round a prompt length up to its power-of-two bucket (>= min_bucket).

    The engine pads bucketed prompts to this length so prefill sees at most
    ``log2(cache_len)`` distinct shapes. Padding sits at the END of the prompt: causal attention means no
    real token ever attends a pad, logits are read at the true last
    position, and pad KV rows are invalidated
    (``lm.apply_prefill(true_len=...)``).
    """
    b = max(int(min_bucket), 1)
    while b < n:
        b *= 2
    return b


def prefix_chain_keys(tokens: np.ndarray, page_size: int) -> List[bytes]:
    """Page-aligned prefix-chain keys for the paged KV cache's shared-prefix
    registry: key ``j`` (0-based) hashes the first ``(j + 1) * page_size``
    prompt tokens, for every *complete* page the prompt fills. Two prompts
    share key ``j`` iff they agree on that whole page-aligned prefix, so
    the longest key hit names exactly the physical pages that can be
    re-mapped instead of re-prefilled (``kv_cache.PagePool``)."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    keys: List[bytes] = []
    for j in range(1, len(toks) // int(page_size) + 1):
        keys.append(hashlib.sha1(toks[: j * page_size].tobytes()).digest())
    return keys


class Request(NamedTuple):
    """One serving request: a prompt and a generation budget."""

    rid: int
    tokens: np.ndarray  # (P,) int32 prompt token ids
    max_new: int  # generation budget (>= 1; the prefill emits token 1)
    arrival: int = 0  # engine iteration at which the request becomes visible
    extra_inputs: Optional[Dict[str, Any]] = None  # e.g. VLM image features

    @property
    def prompt_len(self) -> int:
        return int(len(self.tokens))


@dataclasses.dataclass
class Completion:
    """Engine output for one request."""

    rid: int
    prompt_len: int
    tokens: List[int]  # generated ids, length <= max_new
    admitted_at: int  # engine iteration of admission (prefill)
    finished_at: int  # engine iteration after which the sequence was done
    # self-speculative decoding bookkeeping (zero when speculate=0): how
    # many tokens the low-bit draft proposed while this request held its
    # slot, and how many of those the target policy confirmed — the
    # per-request acceptance rate the aggregate EngineStats.spec_* counters
    # cannot attribute
    spec_drafted: int = 0
    spec_accepted: int = 0
    # elastic serving: id of the packed policy variant that generated
    # every token of this request ("" when the engine serves one fixed
    # policy). Drain-then-swap means a single variant per request — the
    # attribution key for per-variant reference checks
    policy_id: str = ""


class Scheduler:
    """Admission policy over a request queue (see module docstring)."""

    def __init__(
        self,
        policy: str = "continuous",
        prefill_chunk: int = 128,
        metrics=None,
    ):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
        self.policy = policy
        self.prefill_chunk = int(prefill_chunk)
        self.pending: List[Request] = []
        self._credit = 0
        # optional repro_torch.obs.metrics.MetricsRegistry shared with the engine
        # (queue depth / banked prefill credit gauges, admission counter)
        self.metrics = metrics

    def _observe(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("scheduler.queue_depth").set(len(self.pending))
            self.metrics.gauge("scheduler.prefill_credit").set(self._credit)

    # -- queue --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if not self.pending:
            # a fresh wave after the queue drained must not inherit credit
            # banked by the previous wave (admit() is only called while work
            # is pending, so it cannot clear this itself)
            self._credit = 0
        self.pending.append(req)
        self._observe()

    def has_pending(self) -> bool:
        return bool(self.pending)

    def _arrived(self, now: int) -> List[Request]:
        arrived = [r for r in self.pending if r.arrival <= now]
        if self.policy == "continuous-sjf":
            arrived.sort(key=lambda r: (r.prompt_len, r.rid))
        return arrived

    # -- policy -------------------------------------------------------------
    @property
    def hold_round(self) -> bool:
        """Fixed-batch semantics: slots stay occupied until the whole round
        is done (the engine pads every sequence to the round max)."""
        return self.policy == "fixed"

    def admit(
        self,
        now: int,
        free_slots: List[int],
        occupied: int,
        page_budget: Optional[int] = None,
        page_need: int = 0,
        hold: bool = False,
    ) -> List[Tuple[Request, int]]:
        """Return [(request, slot)] to admit at iteration ``now``.

        ``page_budget``/``page_need`` are the paged-KV pressure check:
        the engine passes the pool's worst-case obtainable pages
        (``PagePool.available_count``, free + LRU-evictable) and one
        admission's worst-case page need. Continuous policies stop
        admitting once the next admission could exhaust the pool —
        deferring FIFO order rather than skipping ahead — and count each
        deferral round in ``scheduler.admissions_deferred_pool``. The
        fixed policy admits whole rounds into a pool sized for all
        slots, so it ignores the budget.

        ``hold=True`` is the elastic engine's drain-then-swap gate: a
        pending policy hot-swap admits nothing this round (in-flight
        slots must drain under the variant that admitted them). Prefill
        credit still accrues while work waits, and each held round is
        counted in ``scheduler.admissions_deferred_swap`` so the stats
        show what the swap cost in admission latency.
        """
        if hold:
            if self._arrived(now):
                self._credit += self.prefill_chunk
                if self.metrics is not None:
                    self.metrics.counter(
                        "scheduler.admissions_deferred_swap",
                        help="admission rounds held while a policy swap "
                        "drains",
                    ).inc()
            self._observe()
            return []
        if self.policy == "fixed":
            if occupied:
                return []
            picks = self._arrived(now)[: len(free_slots)]
            self._drop(picks)
            if self.metrics is not None and picks:
                self.metrics.counter("scheduler.admitted").inc(len(picks))
            self._observe()
            return list(zip(picks, free_slots))

        # continuous: accrue prefill credit only while work is waiting
        arrived = self._arrived(now)
        if arrived:
            self._credit += self.prefill_chunk
        else:
            self._credit = 0
        out: List[Tuple[Request, int]] = []
        free = list(free_slots)
        budget = page_budget
        for r in arrived:
            if not free or self._credit < r.prompt_len:
                break
            if budget is not None and page_need > budget:
                if self.metrics is not None:
                    self.metrics.counter(
                        "scheduler.admissions_deferred_pool",
                        help="admission rounds deferred on page-pool "
                        "pressure",
                    ).inc()
                break
            if budget is not None:
                budget -= page_need
            self._credit -= r.prompt_len
            out.append((r, free.pop(0)))
        self._drop([r for r, _ in out])
        if self.metrics is not None and out:
            self.metrics.counter("scheduler.admitted").inc(len(out))
        self._observe()
        return out

    def _drop(self, picks: List[Request]) -> None:
        # removal by identity: list.remove would compare Request tuples,
        # and equality on the np.ndarray tokens field raises/ambiguates
        taken = {id(r) for r in picks}
        self.pending = [p for p in self.pending if id(p) not in taken]
