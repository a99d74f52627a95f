"""Continuous-batching decode engine (ring or paged KV layout, greedy decode).

``slots`` concurrent sequences share one decode step over per-slot KV
caches, and a ``launch.scheduler.Scheduler`` decides admission. A finished
sequence frees its slot mid-flight, so a staggered workload completes in
fewer decode steps than padding everything to the longest request.

The model behind the engine is pluggable: a *model adapter* supplies
``prefill`` / ``decode`` / ``init_state`` / ``state_per_slot``. The default
``LMAdapter`` is the fake-quant ``models.lm`` graph (the reference);
``runtime.session.QuantizedSession`` is the packed-weights implementation
of the same interface.

Execution model (host loop, eager device calls):

* ``prefill`` -- one request at a time, the whole prompt at its true length,
  the cache sized ``cache_len``.
* ``insert``  -- writes the prefilled per-layer state into slot row ``i``.
* ``decode``  -- one token for all slots at once with a per-slot position
  vector. Free slots ride along at position -1: their row writes land with
  position -1 (never valid to attend), so an evicted slot can never leak
  KV entries into a later occupant.

The paged layout (``kv_layout="paged"``) pools int8 pages across slots
behind a page table, with a host-side ``PagePool`` (refcounts, prefix
registry). Admission looks up the longest registered page-aligned prefix of
the prompt and maps those pages (a page-table update, no compute); only the
rest of the prompt runs, through the adapter's chunked ``append`` in chunks
of ``prefill_chunk // page_size * page_size`` tokens (one chunk shape). The
prompt's full pages are then registered for the next request. Decode writes
into the slot's own pages; a finished slot releases its references and
freed pages get their ``pos`` rows cleared.

Self-speculative decoding (``speculate=k``, a ``runtime.session.SpecSession``
adapter): each round, the uniform low-bit draft pack proposes k tokens per
slot (k one-token decodes, the argmax fed back on the device), the searched
target pack verifies ``[cur, d1..dk]`` in one multi-token pass, greedy
acceptance keeps the longest matching prefix, and KV rows past each slot's
last fed token roll back by position. Every emitted token is the target's
own greedy token. The host uploads the round's inputs, and reads targets,
accept lengths, emit counts and margins back once, after the round: nothing
inside it synchronises.

Elastic precision serving (``elastic=`` an ``launch.elastic.ElasticController``
over a ``runtime.session.ElasticSession``): every admission round with
pending work re-solves the ILP against the engine's live signals (arrived
queue, occupied slots, fresh page-pool deferrals, KV-cache bytes). A
decision for another variant holds admission until the in-flight slots
drain under the variant that admitted them, then repoints ``params`` at the
chosen resident pre-packed tree (never a repack); the paged layout also
flushes its prefix registry, whose pages hold KV of the old weights. Each
request is stamped with the variant that served it (``Completion.policy_id``
and its trace tokens).

Phase timers stop after ``torch.cuda.synchronize()`` on a CUDA device (the
host reads the sampled tokens anyway), so a phase's time covers its device
work, not its launch latency.

The prefill budget (``prefill_chunk``: the tokens the scheduler admits per
iteration, and the paged layout's append chunk) is 0 by default, which
means auto: ``dist.roofline.suggest_prefill_chunk`` on this engine's own
decode step (its slots, cache, KV storage and attention route, the
session's packed weight bits, the speculative round shape) under
``EngineConfig.chip``. ``bucket_prompts`` pads ring prompts to power-of-two
lengths (``scheduler.bucket_length``), so prefill sees few shapes; it stays
off for the paged layout (one append chunk shape already), recurrent
schedules (pads would run through the state) and windowed caches.

Observability (``obs``): every engine owns a ``MetricsRegistry``
(``engine.metrics``, shared with its session; after each fenced prefill
and step the routes the session's dispatch took are published into it)
and, with ``trace`` on (the default), a ``TraceRecorder``
(``engine.trace``). ``stats`` renders the registry into an ``EngineStats``
snapshot. Each request traces its lifecycle (``admit``, ``prefix_hit``,
the ``prefill`` span, ``first_token``, one ``token`` instant per emitted
token, ``complete``, ``evict``) and each step a ``decode_step`` span whose
duration is the same fenced time ``t_decode_s`` adds up. A speculative
round stays one call with no host synchronisation: CUDA events recorded
between its draft and verify parts are read after the round's fence, and
give its ``spec_draft`` / ``spec_verify_phase`` spans measured device
times (host timestamps on the CPU, where calls run synchronously).
Pack-time health is published once per epoch; the KV write scales are
sampled every ``health_every`` steps after the fence, outside the timer;
threshold alerts (``obs.monitor``) land in the registry and the trace.

For every emitted token the engine also records the top-2 logit margin
(``margins[rid]``), which tells a comparison of two engines' greedy tokens
which steps are decisive.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import roofline
from repro_torch.launch.scheduler import (Completion, Request, Scheduler,
                                          bucket_length, prefix_chain_keys)
from repro_torch.models import lm
from repro_torch.obs import health as obs_health
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import monitor as obs_monitor
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import dispatch
from repro_torch.runtime import kv_cache as qkv


def check_kv_layout(cfg: ModelConfig, kv_layout: str) -> None:
    """Whether ``cfg``'s schedule can serve over ``kv_layout``: the paged
    layout serves attention-only schedules without a window (as the
    reference, which refuses windowed archs on pages)."""
    dispatch.ROUTES.validate("kv_layout", kv_layout)
    if kv_layout == "paged" and lm.attn_window(cfg):
        raise ValueError(
            "kv_layout='paged' does not support sliding-window "
            "archs: a window evicts mid-page, breaking page sharing")
    bad = {s.kind for s in lm.iter_sites(cfg)} - set(lm.ATTN_KINDS)
    if kv_layout == "paged" and bad:
        raise NotImplementedError(
            f"kv_layout='paged' on a schedule with {sorted(bad)} sites "
            "(recurrent state beside the pages, chunked append through the "
            "wkv state) comes with a later slice; serve it over the ring")


def check_speculate(cfg: ModelConfig, k: int) -> None:
    """Whether ``cfg`` can decode with ``speculate=k``: k >= 0, and for
    k > 0 every cache of the schedule rewinds by position past a rejected
    draft token (attention only, no sliding window)."""
    dispatch.ROUTES.validate("spec", "self" if k else "off")
    if k < 0:
        raise ValueError(f"speculate must be >= 0, got {k}")
    if not k:
        return
    bad = {s.kind for s in lm.iter_sites(cfg)} - set(lm.ATTN_KINDS)
    if bad:
        raise ValueError(
            f"speculate > 0 requires an attention-only schedule: "
            f"{sorted(bad)} state is sequential and cannot roll back "
            "past a rejected draft token")
    if lm.attn_window(cfg):
        raise ValueError(
            "speculate > 0 does not support sliding-window archs: "
            "the ring window overwrites rows a rollback would need")


@dataclasses.dataclass
class EngineConfig:
    """Engine knobs."""

    slots: int = 4  # concurrent sequences
    cache_len: int = 64  # per-slot KV capacity (prompt + generation)
    # prefill tokens granted per iteration; 0 = auto, the roofline headroom
    # of this engine's decode step (roofline.suggest_prefill_chunk)
    prefill_chunk: int = 0
    policy: str = "continuous"  # continuous | continuous-sjf | fixed
    state_dtype: Any = torch.float32
    max_iters: int = 100_000  # hard stop for the host loop
    chip: roofline.ChipSpec = roofline.DEFAULT_CHIP  # the auto budget's card
    kv_quant: str = "none"  # "none" | "int8" | "fake" (reference numerics)
    kv_layout: str = "ring"  # "ring" | "paged" (pooled pages + prefix reuse)
    page_size: int = 8  # tokens per KV page (paged layout only)
    n_pages: int = 0  # paged pool size; 0 = (slots + 1) * pages per slot
    bucket_prompts: bool = False  # pow-2 prompt padding (ring layout)
    bucket_min: int = 8  # smallest prompt bucket
    trace: bool = True  # record the per-request lifecycle event trace
    health_every: int = 4  # KV-scale drift sample stride (decode steps; 0 off)
    eos_id: Optional[int] = None  # optional early-stop token id
    speculate: int = 0  # self-speculative draft length k (0 = off)


@dataclasses.dataclass
class EngineStats:
    """A snapshot of the engine's metrics registry (the fields this path
    fills)."""

    iterations: int = 0  # scheduler ticks (admission and/or decode)
    decode_steps: int = 0  # decode launches
    slot_steps: int = 0  # sum over decode steps of slots emitting a token
    padded_slot_steps: int = 0  # sum of *occupied* slots
    prefill_calls: int = 0
    prefill_tokens: int = 0
    prefill_compiles: int = 0  # distinct prompt (ring) or chunk (paged) shapes
    prefill_flops_saved: float = 0.0  # 2 * MACs skipped by prefix page hits
    prefix_hit_tokens: int = 0  # prompt tokens served by page-table remaps
    kv_unique_pages: int = 0  # paged: distinct physical pages referenced
    admissions_deferred_pool: int = 0  # admit rounds held on page pressure
    act_quant_reused: int = 0  # activation quantizes elided
    decode_attn_route: str = "fp"  # fused | dequant-fp | fp
    admitted: int = 0
    completed: int = 0
    tokens_generated: int = 0
    alerts_fired: int = 0  # monitor threshold trips this epoch
    spec_rounds: int = 0  # draft + verify rounds (speculate > 0)
    spec_draft_tokens: int = 0  # tokens the low-bit draft proposed
    spec_accepted_tokens: int = 0  # proposals the target confirmed
    policy_swaps: int = 0  # elastic variant swaps applied this epoch
    policy_swaps_down: int = 0  # swaps that lowered the served avg bits
    ilp_solves: int = 0  # admission-time MCKP re-solves (elastic)
    admissions_deferred_swap: int = 0  # admit rounds held for a swap drain
    active_policy: str = ""  # serving variant id ("" = single policy)
    t_prefill_s: float = 0.0
    t_decode_s: float = 0.0
    latency: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.tokens_generated / max(self.t_decode_s, 1e-9)

    @property
    def total_tokens_per_s(self) -> float:
        total = self.tokens_generated + self.prefill_tokens
        return total / max(self.t_decode_s + self.t_prefill_s, 1e-9)

    @property
    def spec_accept_rate(self) -> float:
        """Fraction of drafted tokens the target verified (greedy match)."""
        return self.spec_accepted_tokens / max(self.spec_draft_tokens, 1)

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("latency"))
        d["decode_tokens_per_s"] = self.decode_tokens_per_s
        d["total_tokens_per_s"] = self.total_tokens_per_s
        d["spec_accept_rate"] = self.spec_accept_rate
        return d


class LMAdapter:
    """Default model adapter: the fake-quant ``models.lm`` graph. The 8-bit
    fake-quantized embedding table is computed once per params object."""

    def __init__(self, cfg: ModelConfig, bits, ctx):
        self.cfg = cfg
        self.bits = bits
        self.ctx = ctx
        self._table = (None, None)

    @property
    def kv_quant(self) -> str:
        return self.ctx.kv_quant

    def _table_for(self, params):
        w = params["embed"]["w"]
        if self._table[0] is not w:
            from repro_torch.models.quant_layers import pinned_table
            self._table = (w, pinned_table(params["embed"], self.ctx))
        return self._table[1]

    def prefill(self, params, tokens, *, prefill_cap, true_len=None):
        return lm.apply_prefill(params, self.cfg, tokens, self.bits, self.ctx,
                                prefill_cap=prefill_cap, true_len=true_len,
                                table=self._table_for(params))

    def decode(self, params, tok, pos, state):
        return lm.apply_decode(params, self.cfg, tok, pos, state, self.bits,
                               self.ctx, table=self._table_for(params))

    def init_state(self, batch, capacity, dtype, per_slot=True, device=None,
                   layout=None):
        # recurrent state in the compute dtype: a float64 evaluation keeps
        # its carried state float64
        return lm.init_decode_state(
            self.cfg, batch, capacity, dtype=dtype, per_slot=per_slot,
            kv_quant="int8" if self.ctx.kv_quant == "int8" else "none",
            layout=layout, device=device,
            rec_dtype=torch.promote_types(dtype, self.ctx.compute_dtype))

    def state_per_slot(self, row):
        return lm.decode_state_per_slot(row)


class PagedLMAdapter(LMAdapter):
    """The fake-quant graph over pooled int8 pages: ``LMAdapter`` with the
    chunked append of the paged layout, so a paged run has a reference
    that prefills as it does (a MoE chunk's pad rows attend the slot's
    pages and compete for an expert's capacity, so which tokens it drops
    depends on the pool's history: ``serve.moe_over_pages``)."""

    def append(self, params, tok, pos, slot: int, last_idx: int, states):
        return lm.apply_append(params, self.cfg, tok, pos, slot, last_idx,
                               states, self.bits, self.ctx,
                               table=self._table_for(params))


class _Slot:
    """Host-side bookkeeping for one engine slot."""

    __slots__ = ("req", "next_tok", "next_pos", "gen", "done", "admitted_at",
                 "ts_admit", "ts_last_token", "spec_drafted", "spec_accepted",
                 "policy_id")

    def __init__(self, req: Request, first_tok: int, now: int,
                 ts_admit: float = 0.0, ts_last_token: float = 0.0,
                 policy_id: str = ""):
        self.req = req
        self.next_tok = first_tok
        self.next_pos = req.prompt_len
        self.gen: List[int] = [first_tok]
        self.done = False
        self.admitted_at = now
        self.ts_admit = ts_admit  # trace-clock stamp of the admit event
        self.ts_last_token = ts_last_token  # last emitted token (ITL base)
        self.spec_drafted = 0  # draft proposals made for this slot
        self.spec_accepted = 0  # proposals the target confirmed
        # elastic: the variant that admitted the request serves all of it
        self.policy_id = policy_id


class _PhaseMarks:
    """Timestamps inside one device call that must not synchronise: CUDA
    events on a CUDA device (read after the call's fence), host clock
    readings on the CPU, whose calls run synchronously."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks: list = []

    def mark(self) -> None:
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def seconds(self, i: int, j: int) -> float:
        """Time from mark ``i`` to mark ``j`` (after the fence)."""
        a, b = self._marks[i], self._marks[j]
        return a.elapsed_time(b) / 1e3 if self._cuda else b - a


def _insert(full, row, slot: int) -> None:
    """Write a one-row per-slot state into row ``slot`` of the engine state
    (in place: the engine owns its state tensors). A site's state is a
    cache (a NamedTuple of tensors) or a recurrent site's plain tuple of
    tensors; both carry the slot axis first on every tensor."""
    for key, c in full["sites"].items():
        for t, r in zip(c, row["sites"][key]):
            t[slot] = r[0].to(t.dtype)


class DecodeEngine:
    """Slot-based continuous-batching decode engine over a quantized LM."""

    def __init__(self, params, cfg: ModelConfig, bits, ctx, *,
                 ecfg: Optional[EngineConfig] = None, adapter=None,
                 device=None, elastic=None):
        lm.check_decodes(cfg)
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        if self.ecfg.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0 (0 = auto), got "
                             f"{self.ecfg.prefill_chunk}")
        if adapter is None:
            if self.ecfg.kv_quant != "none" and ctx.kv_quant == "none":
                ctx = dataclasses.replace(ctx, kv_quant=self.ecfg.kv_quant)
            adapter = LMAdapter(cfg, bits, ctx)
        self.adapter = adapter
        self.device = torch.device(device) if device is not None else \
            params["embed"]["w"].device
        kv_mode = getattr(adapter, "kv_quant", self.ecfg.kv_quant)
        check_kv_layout(cfg, self.ecfg.kv_layout)
        self._paged = self.ecfg.kv_layout == "paged"
        self.layout: Optional[qkv.KVCacheLayout] = None
        self.pool: Optional[qkv.PagePool] = None
        if self._paged:
            # pooled int8 pages, a slot -> page-list table, chunked append
            # prefill: the packed int8 serving path
            if kv_mode != "int8":
                raise ValueError(
                    f"kv_layout='paged' requires int8 KV (got {kv_mode!r}): "
                    "pages hold codes + scales")
            if not hasattr(adapter, "append"):
                raise ValueError(
                    "kv_layout='paged' needs an append-capable adapter "
                    "(QuantizedSession); the fake-quant LMAdapter serves "
                    "through the ring layout")
            self.layout = qkv.KVCacheLayout(kind="paged", quant="int8",
                                            page_size=self.ecfg.page_size,
                                            n_pages=self.ecfg.n_pages)
            self._pages_per_slot = self.layout.pages_per_slot(
                self.ecfg.cache_len)
            # FLOPs one prompt token costs across every quantized matmul:
            # what a shared-prefix page hit avoids recomputing
            self._flops_per_token = 2.0 * sum(
                q.macs_per_token * q.n_mats for q in lm.enumerate_qlayers(cfg))
        self._spec_k = int(self.ecfg.speculate)
        self.draft_params = getattr(adapter, "draft_params", None)
        check_speculate(cfg, self._spec_k)
        if self._spec_k and (not hasattr(adapter, "verify")
                             or self.draft_params is None):
            raise ValueError(
                "speculate > 0 needs a dual-policy adapter "
                "(runtime.session.SpecSession): a draft_params tree to "
                "propose tokens and a verify() pass to confirm them")
        # elastic serving: the controller re-solves the ILP at admission
        # and the engine swaps the active pre-packed variant between batches
        self.elastic = elastic
        self._active_policy = str(getattr(adapter, "active_policy", "") or "")
        dispatch.ROUTES.validate("elastic", "off" if elastic is None
                                 else "bank")
        if elastic is not None:
            if not (hasattr(adapter, "set_active")
                    and hasattr(adapter, "params_for")):
                raise ValueError(
                    "elastic serving needs a variant-bank adapter "
                    "(runtime.session.ElasticSession): set_active()/"
                    "params_for() hand back pre-packed policy variants; a "
                    "single-policy adapter has nothing to swap")
            if self._spec_k:
                raise ValueError(
                    "elastic + speculate is unsupported: the draft pack is "
                    "derived from ONE target policy and would go stale at "
                    "the first swap")
        if kv_mode == "int8":
            self.decode_attn_route = dispatch.decode_attn_route(self.device)
        else:
            self.decode_attn_route = "fp"
        # the roofline budget's shape, kept for obs.calibrate to replay the
        # measured timings against the model the engine planned with
        self.kv_bits = 8.0 if kv_mode == "int8" else 8.0 * torch.empty(
            (), dtype=self.ecfg.state_dtype).element_size()
        self.kv_attend = ("fused" if self.decode_attn_route.startswith("fused")
                          else "dequant")
        self.prefill_chunk = int(
            self.ecfg.prefill_chunk or roofline.suggest_prefill_chunk(
                cfg, self.ecfg.slots, cache_tokens=self.ecfg.cache_len,
                kv_bits=self.kv_bits, kv_attend=self.kv_attend,
                w_bits_total=getattr(adapter, "w_bits_total", None),
                # a speculating engine's iteration is a whole round
                spec_k=self._spec_k,
                draft_w_bits=float(getattr(adapter, "draft_w_bits", 2.0)),
                chip=self.ecfg.chip))
        # padded prompt tokens would run through recurrent state and evict
        # rows of a windowed cache; the paged layout's append prefill has
        # one chunk shape already
        kinds = {s.kind for s in lm.iter_sites(cfg)}
        self._bucket = (bool(self.ecfg.bucket_prompts) and not self._paged
                        and not kinds & {"rwkv", "rec"}
                        and not lm.attn_window(cfg))
        self.on_step = None  # per-iteration callback (serve --metrics-stream)
        self.reset()

    # -- observability -------------------------------------------------------
    def _init_obs(self) -> None:
        """A fresh metrics registry, trace and monitor for one serving
        epoch: a ``stats`` snapshot (and the old registry) taken before
        ``reset()`` stays as it was."""
        self.metrics = m = obs_metrics.MetricsRegistry()
        self.trace = obs_trace.TraceRecorder() if self.ecfg.trace else None
        m.gauge("engine.slots",
                help="configured concurrent-sequence capacity").set(
                    self.ecfg.slots)
        m.gauge("engine.prefill_chunk").set(self.prefill_chunk)
        if self._spec_k:
            m.gauge("engine.speculate",
                    help="self-speculative draft length k").set(self._spec_k)
        m.counter(f"engine.decode_attn_route.{self.decode_attn_route}").inc()
        if hasattr(self.adapter, "metrics"):
            self.adapter.metrics = m
        # the session's route tallies at the epoch's start: each fenced
        # prefill and step publishes what they gained since
        counts = getattr(self.adapter, "route_counts", None)
        self._routes_seen = ({op: dict(r) for op, r in counts.routes.items()}
                             if counts is not None else None)
        if hasattr(self.adapter, "packed_bytes"):
            m.gauge("engine.packed_bytes",
                    help="resident packed weight codes").set(
                        self.adapter.packed_bytes())
        if hasattr(self.adapter, "scale_bytes"):
            m.gauge("engine.scale_bytes").set(self.adapter.scale_bytes())
        pack_health = getattr(self.adapter, "pack_health", None)
        if pack_health:
            obs_health.publish_pack_health(m, pack_health)
        self._kv_drift = obs_health.KVScaleDrift()
        # the pool watcher reads obtainable pages (free + LRU-evictable), the
        # number admission defers on
        self.monitor = obs_monitor.default_monitor(
            pool_min_free=(self._pages_per_slot - 1) if self._paged else None)
        # elastic epoch state: a pending (unapplied) swap decision and the
        # page-pool deferral count the controller diffs against
        self._swap_decision = None
        self._deferred_seen = 0
        if self.elastic is not None:
            m.gauge("engine.policy_variants",
                    help="pre-packed policy variants resident in the bank"
                    ).set(len(self.adapter.variants))
            self._observe_active_policy()
            if self.trace is not None:
                # reconcile checks each stamped token against the swap epoch
                # active at its time, so epoch zero needs a marker
                self.trace.instant("policy_swap", to=self._active_policy,
                                   initial=True, iteration=-1)

    def _now(self) -> float:
        """The trace clock (the host clock without a trace)."""
        return self.trace.now() if self.trace is not None \
            else time.perf_counter()

    def _set_cache_gauges(self) -> None:
        """Resident KV-cache inventory gauges (zeros for fp caches)."""
        inv = qkv.tree_inventory(self.state)
        m = self.metrics
        m.gauge("engine.kv_cache_bytes",
                help="codes + scales + pos, all quantized caches").set(
                    sum(inv.values()))
        for part, nbytes in inv.items():
            m.gauge(f"engine.kv_{part}_bytes").set(nbytes)
        if self._paged:
            self._set_pool_gauges()

    def reset(self) -> None:
        """Clear queue, slots and decode state and start a new metrics and
        trace epoch: a ``stats`` snapshot taken before stays as it was."""
        self._init_obs()
        self.scheduler = Scheduler(self.ecfg.policy, self.prefill_chunk,
                                   metrics=self.metrics)
        self.slots: List[Optional[_Slot]] = [None] * self.ecfg.slots
        self.completions: Dict[int, Completion] = {}
        self.margins: Dict[int, List[float]] = {}
        self._act_reuse_base = getattr(self.adapter, "act_quant_reused", 0)
        self._prefill_shapes: set = set()
        # the paged layout's host pool and device state are one unit: an
        # empty table and every page free
        self._slot_pages: List[Optional[List[int]]] = [None] * self.ecfg.slots
        kw = {}
        if self._paged:
            self.pool = qkv.PagePool(
                self.layout.pool_pages(self.ecfg.slots, self.ecfg.cache_len),
                self.ecfg.page_size)
            kw["layout"] = self.layout
        self.state = self.adapter.init_state(
            self.ecfg.slots, self.ecfg.cache_len, self.ecfg.state_dtype,
            per_slot=True, device=self.device, **kw)
        self._set_cache_gauges()

    @property
    def stats(self) -> EngineStats:
        m = self.metrics

        def c(name: str) -> int:
            return int(m.value(f"engine.{name}"))

        lat: Dict[str, float] = {}
        for key in ("ttft", "itl", "decode_step", "prefill"):
            h = m.get(f"engine.{key}_ms")
            if isinstance(h, obs_metrics.Histogram) and h.count:
                lat[f"{key}_p50_ms"] = h.percentile(0.50)
                lat[f"{key}_p95_ms"] = h.percentile(0.95)
        solve = m.get("ilp.solve_ms")
        if isinstance(solve, obs_metrics.Histogram) and solve.count:
            lat["ilp_solve_p50_ms"] = solve.percentile(0.50)
            # percentile() clamps to the observed extremes: 1.0 is the max
            lat["ilp_solve_max_ms"] = solve.percentile(1.0)
        return EngineStats(
            iterations=c("iterations"), decode_steps=c("decode_steps"),
            slot_steps=c("slot_steps"),
            padded_slot_steps=c("padded_slot_steps"),
            prefill_calls=c("prefill_calls"),
            prefill_tokens=c("prefill_tokens"),
            prefill_compiles=c("prefill_compiles"),
            prefill_flops_saved=m.value("engine.prefill_flops_saved"),
            prefix_hit_tokens=c("prefix_hit_tokens"),
            kv_unique_pages=c("kv_unique_pages"),
            admissions_deferred_pool=int(
                m.value("scheduler.admissions_deferred_pool")),
            act_quant_reused=c("act_quant_reused"),
            decode_attn_route=self.decode_attn_route,
            admitted=c("admitted"), completed=c("completed"),
            tokens_generated=c("tokens_generated"),
            alerts_fired=int(m.value(obs_monitor.ALERTS_FIRED)),
            spec_rounds=int(m.value("spec.rounds")),
            spec_draft_tokens=int(m.value("spec.draft_tokens")),
            spec_accepted_tokens=int(m.value("spec.accepted_tokens")),
            policy_swaps=c("policy_swaps"),
            policy_swaps_down=c("policy_swaps_down"),
            ilp_solves=c("ilp_solves"),
            admissions_deferred_swap=int(
                m.value("scheduler.admissions_deferred_swap")),
            active_policy=self._active_policy,
            t_prefill_s=m.value("engine.t_prefill_s"),
            t_decode_s=m.value("engine.t_decode_s"), latency=lat)

    # -- queue --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Validate and enqueue a request."""
        if req.prompt_len < 1 or req.max_new < 1:
            raise ValueError(f"request {req.rid}: empty prompt or max_new < 1")
        taken = {s.req.rid for s in self.slots if s is not None}
        taken |= set(self.completions)
        taken.update(r.rid for r in self.scheduler.pending)
        if req.rid in taken:
            raise ValueError(
                f"request id {req.rid} already queued, running, or completed")
        windowed = bool(lm.attn_window(self.cfg))
        if not windowed and \
                req.prompt_len + req.max_new > self.ecfg.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + max_new "
                f"{req.max_new} exceeds cache_len {self.ecfg.cache_len} "
                "(full-attention arch cannot ring-wrap without changing "
                "results)")
        self.scheduler.submit(req)

    def submit_all(self, reqs) -> None:
        for r in reqs:
            self.submit(r)

    # -- internals ----------------------------------------------------------
    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _occupied(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _each_cache(self, fn) -> None:
        """``fn`` on every KV cache of the engine state (recurrent site
        state has no rows to evict or pages to free)."""
        self.state = lm.map_caches(self.state, fn)

    def _clear_freed(self, freed: List[int]) -> None:
        """Clear the device ``pos`` rows of pages whose refcount hit zero.
        Load-bearing: a recycled page keeping its previous occupant's
        ``pos`` rows would be attendable the moment it is mapped again."""
        if freed:
            ids = torch.as_tensor(freed, dtype=torch.long, device=self.device)
            self._each_cache(lambda c: c.free_pages(ids))

    def _set_pool_gauges(self) -> None:
        m = self.metrics
        m.gauge("engine.kv_unique_pages",
                help="distinct physical pages currently referenced").set(
                    self.pool.unique_pages_in_use)
        m.gauge("engine.kv_pool_free_pages",
                help="PagePool free-list length").set(self.pool.free_count)
        m.gauge("engine.kv_pool_available_pages",
                help="free + LRU-evictable pages (admission headroom)").set(
                    self.pool.available_count)

    def _set_reuse_gauge(self) -> None:
        self.metrics.gauge("engine.act_quant_reused").set(
            getattr(self.adapter, "act_quant_reused", 0)
            - self._act_reuse_base)

    def _publish_routes(self) -> None:
        """The session's dispatch routes since the last publish, into the
        registry (``dispatch.publish_routes``), once per prefill or step."""
        if self._routes_seen is not None:
            dispatch.publish_routes(self.metrics, self.adapter.route_counts,
                                    self._routes_seen)

    def _sample_health(self) -> None:
        """KV-scale drift every ``health_every`` decode steps, read after
        the step's fence and outside its timer."""
        he, m = self.ecfg.health_every, self.metrics
        if he and int(m.value("engine.decode_steps")) % he == 0:
            self._kv_drift.publish(m, self._kv_drift.update(self.state))

    def _free(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _pick(self, logits: torch.Tensor):
        """Greedy tokens (first index of the max, as ``argmax``) and top-2
        margins of (B, V) logits, on the host."""
        top2 = torch.topk(logits, 2, dim=-1).values
        tok = torch.argmax(logits, dim=-1).cpu().numpy()
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        return tok, margin

    def _finish(self, idx: int, now: int) -> None:
        slot = self.slots[idx]
        rid = slot.req.rid
        toks = slot.gen[: slot.req.max_new]
        self.completions[rid] = Completion(
            rid=rid, prompt_len=slot.req.prompt_len, tokens=toks,
            admitted_at=slot.admitted_at, finished_at=now,
            spec_drafted=slot.spec_drafted, spec_accepted=slot.spec_accepted,
            policy_id=slot.policy_id)
        self.margins[rid] = self.margins[rid][: len(toks)]
        m = self.metrics
        m.counter("engine.completed").inc()
        m.counter("engine.tokens_generated").inc(len(toks))
        self.slots[idx] = None
        m.gauge("engine.slot_occupancy").set(len(self._occupied()))
        self._each_cache(lambda c: c.evict(idx))
        if self._paged:
            pages = self._slot_pages[idx]
            self._slot_pages[idx] = None
            if pages:
                # drop this slot's references; registry pins keep shared
                # prefix pages alive for later requests
                self._clear_freed(self.pool.release(pages))
            self._set_pool_gauges()
        if self.trace is not None:
            ts, track = self.trace.now(), obs_trace.req_track(rid)
            self.trace.instant("complete", track=track, ts=ts, rid=rid,
                               tokens=len(slot.gen), iteration=now)
            self.trace.span("request", slot.ts_admit, ts, track=track,
                            rid=rid, prompt_len=slot.req.prompt_len,
                            tokens=len(slot.gen), slot=idx)
            self.trace.instant("evict", track=track, rid=rid, slot=idx)

    def _mark_done(self, idx: int, now: int) -> None:
        """Sequence finished: free immediately (continuous) or hold the slot
        until the whole round drains (fixed-batch semantics)."""
        self.slots[idx].done = True
        if not self.scheduler.hold_round:
            self._finish(idx, now)

    def _admit(self, req: Request, idx: int, now: int) -> None:
        if self._paged:
            return self._admit_paged(req, idx, now)
        toks = np.asarray(req.tokens, np.int32)
        plen = req.prompt_len
        if self._bucket:
            blen = min(bucket_length(plen, self.ecfg.bucket_min),
                       self.ecfg.cache_len)
            if blen > plen:
                toks = np.pad(toks, (0, blen - plen))
        tokens = torch.as_tensor(toks, device=self.device)[None, :]
        ts_admit = self._now()
        t0 = time.perf_counter()
        logits, row = self.adapter.prefill(
            self.params, tokens, prefill_cap=self.ecfg.cache_len,
            true_len=plen if self._bucket else None)
        _insert(self.state, self.adapter.state_per_slot(row), idx)
        tok, margin = self._pick(logits)
        self._fence()
        dt = time.perf_counter() - t0
        self._prefill_shapes.add(len(toks))
        self._admitted(req, idx, now, ts_admit, dt, plen, len(toks),
                       int(tok[0]), float(margin[0]))

    def _admit_paged(self, req: Request, idx: int, now: int) -> None:
        """Paged admission: the longest registered page-aligned prefix
        becomes a page-table remap (attended through shared, refcounted
        pages); only the rest of the prompt runs through chunked append
        prefill, in one chunk shape."""
        toks = np.asarray(req.tokens, np.int32)
        plen, ps, pool = req.prompt_len, self.ecfg.page_size, self.pool
        chain = prefix_chain_keys(toks, ps)
        # cap the hit one page short of the whole prompt: at least one token
        # must run to give the first token's logits
        shared = list(pool.lookup_prefix(chain[: (plen - 1) // ps]))
        hit_tokens = len(shared) * ps
        # take this slot's reference on the shared pages BEFORE allocating:
        # allocation may drop the LRU registry entry that pins them, and
        # they would be free (and recyclable) by the time they are mapped
        pool.ref(shared)
        try:
            fresh, freed = pool.alloc_with_freed(
                self._pages_per_slot - len(shared))
        except RuntimeError:
            self._clear_freed(pool.release(shared))
            raise
        self._clear_freed(freed)
        table_row = shared + fresh
        ts_admit = self._now()
        t0 = time.perf_counter()
        row = torch.as_tensor(table_row, dtype=torch.int32, device=self.device)
        self._each_cache(lambda c: c.map_slot(idx, row))
        chunk_len = max(ps, self.prefill_chunk // ps * ps)
        logits = None
        for start in range(hit_tokens, plen, chunk_len):
            n = min(chunk_len, plen - start)
            chunk = np.zeros((1, chunk_len), np.int32)
            chunk[0, :n] = toks[start:start + n]
            qpos = np.full((chunk_len,), -1, np.int32)
            qpos[:n] = np.arange(start, start + n, dtype=np.int32)
            logits, self.state = self.adapter.append(
                self.params, torch.as_tensor(chunk, device=self.device),
                torch.as_tensor(qpos, device=self.device), idx, n - 1,
                self.state)
        tok, margin = self._pick(logits)
        self._fence()
        dt = time.perf_counter() - t0
        self._prefill_shapes.add(chunk_len)
        # register the prompt's own full-page chains: the next prompt that
        # shares them prefills only its suffix
        k_full = plen // ps
        pool.register_prefix(chain[:k_full], table_row[:k_full])
        self._slot_pages[idx] = table_row
        m = self.metrics
        if hit_tokens:
            m.counter("engine.prefix_hit_tokens").inc(hit_tokens)
            m.counter("engine.prefill_flops_saved").inc(
                hit_tokens * self._flops_per_token)
        self._set_pool_gauges()
        self._admitted(req, idx, now, ts_admit, dt, plen - hit_tokens,
                       plen - hit_tokens, int(tok[0]), float(margin[0]),
                       hit=(len(shared), hit_tokens))

    def _admitted(self, req: Request, idx: int, now: int, ts_admit: float,
                  dt: float, prefilled: int, shape: int, first: int,
                  margin: float, hit=(0, 0)) -> None:
        """Bookkeeping of an admission whose prefill started at trace time
        ``ts_admit``, took ``dt`` seconds and ran ``prefilled`` prompt
        tokens (``shape`` tokens with padding); ``hit`` is the (pages,
        tokens) of a paged prefix hit."""
        self.margins[req.rid] = [margin]
        m = self.metrics
        m.counter("engine.t_prefill_s").inc(dt)
        m.counter("engine.prefill_calls").inc()
        m.counter("engine.prefill_tokens").inc(prefilled)
        m.counter("engine.admitted").inc()
        m.gauge("engine.prefill_compiles").set(len(self._prefill_shapes))
        self._set_reuse_gauge()
        m.histogram("engine.prefill_ms").observe(dt * 1e3)
        # the first token comes from the prefill logits: TTFT for an admitted
        # request is the fenced prefill time (queue wait is the scheduler's)
        m.histogram("engine.ttft_ms").observe(dt * 1e3)
        self._publish_routes()
        obs_health.attribute_latency(
            m, "matmul", dispatch.dominant_route(m), dt)
        self.slots[idx] = _Slot(req, first, now, ts_admit, ts_admit + dt,
                                self._active_policy)
        m.gauge("engine.slot_occupancy").set(len(self._occupied()))
        if self.trace is not None:
            track = obs_trace.req_track(req.rid)
            pages, hit_tokens = hit
            self.trace.instant(
                "admit", track=track, ts=ts_admit, rid=req.rid, slot=idx,
                prompt_len=req.prompt_len, iteration=now,
                **({"prefix_hit_tokens": hit_tokens} if self._paged else {}))
            if hit_tokens:
                # a remap is not a prefill: the event carries what the page
                # hit skipped, so reconcile can tell the two apart
                self.trace.instant(
                    "prefix_hit", track=track, ts=ts_admit, rid=req.rid,
                    pages_reused=pages, tokens=hit_tokens,
                    flops_saved=hit_tokens * self._flops_per_token)
            self.trace.span("prefill", ts_admit, ts_admit + dt, track=track,
                            rid=req.rid, tokens=shape)
            self.trace.instant("first_token", track=track, ts=ts_admit + dt,
                               rid=req.rid, token=first,
                               **self._policy_stamp(self.slots[idx]))
        if req.max_new == 1 or first == self.ecfg.eos_id:
            self._mark_done(idx, now)

    def _stepped(self, now: int, dt: float, live: List[int]) -> float:
        """Bookkeeping shared by a decode step and a speculative round of
        ``dt`` fenced seconds over the ``live`` slots; returns the trace
        time at its end."""
        m = self.metrics
        m.counter("engine.t_decode_s").inc(dt)
        m.counter("engine.decode_steps").inc()
        m.counter("engine.slot_steps").inc(len(live))
        m.counter("engine.padded_slot_steps").inc(len(self._occupied()))
        self._set_reuse_gauge()
        m.histogram("engine.decode_step_ms").observe(dt * 1e3)
        self._publish_routes()
        obs_health.attribute_latency(m, "decode_attn",
                                     self.decode_attn_route, dt)
        self._sample_health()
        ts1 = self._now()
        if self.trace is not None:
            self.trace.span("decode_step", ts1 - dt, ts1, slots=len(live),
                            iteration=now)
        return ts1

    def _emit(self, i: int, toks, margins, ts1: float, now: int) -> None:
        """Slot ``i`` emits ``toks`` (with their top-2 margins) at trace
        time ``ts1``."""
        s = self.slots[i]
        s.gen.extend(toks)
        self.margins[s.req.rid].extend(margins)
        s.next_tok = toks[-1]
        s.next_pos += len(toks)
        self.metrics.histogram("engine.itl_ms").observe(
            (ts1 - s.ts_last_token) * 1e3)
        s.ts_last_token = ts1
        if self.trace is not None:
            track = obs_trace.req_track(s.req.rid)
            for t in toks:
                self.trace.instant("token", track=track, ts=ts1,
                                   rid=s.req.rid, token=t, iteration=now,
                                   **self._policy_stamp(s))
        if len(s.gen) >= s.req.max_new or s.next_tok == self.ecfg.eos_id:
            self._mark_done(i, now)

    @staticmethod
    def _policy_stamp(slot: _Slot) -> Dict[str, str]:
        """Trace args naming the variant that serves ``slot`` (none for a
        single policy)."""
        return {"policy": slot.policy_id} if slot.policy_id else {}

    # -- elastic precision serving ------------------------------------------
    def _observe_active_policy(self) -> None:
        """Gauges of the serving variant: its average weight bits and its
        packed bytes (``ElasticSession`` accounting follows the swap)."""
        m = self.metrics
        m.gauge("engine.active_policy_avg_bits",
                help="mean weight bits of the serving variant").set(
                    self.adapter.policy.avg_bits()[0])
        m.counter(f"engine.policy_active.{self._active_policy}").inc()
        m.gauge("engine.packed_bytes").set(self.adapter.packed_bytes())

    def _elastic_admission(self, now: int) -> None:
        """Consult the controller before admitting (drain-then-swap).

        Re-solves every admission round with pending work, so the decision
        corrects itself while slots drain. A decision for another variant
        swaps at once if the slots are empty; otherwise it parks in
        ``_swap_decision``, which holds admission (``Scheduler.admit(
        hold=True)``) until the in-flight requests finish under the variant
        that admitted them. Decode never pauses, so the drain ends."""
        m = self.metrics
        deferred_now = int(m.value("scheduler.admissions_deferred_pool"))
        arrived = sum(1 for r in self.scheduler.pending if r.arrival <= now)
        decision = self.elastic.decide(
            active=self._active_policy, queue_depth=arrived,
            occupied=len(self._occupied()), slots=self.ecfg.slots,
            deferred=max(deferred_now - self._deferred_seen, 0),
            cache_bytes=float(sum(qkv.tree_inventory(self.state).values())))
        self._deferred_seen = deferred_now
        m.histogram("ilp.solve_ms",
                    help="admission-time MCKP re-solve wall time").observe(
                        decision.solve_ms)
        m.counter("engine.ilp_solves").inc()
        if decision.target == self._active_policy:
            self._swap_decision = None
            return
        self._swap_decision = decision
        if not self._occupied():
            self._apply_swap(decision, now)

    def _apply_swap(self, decision, now: int) -> None:
        """Swap the serving variant: repoint ``params`` at the adapter's
        resident pre-packed tree (never a repack), on drained slots only, so
        every request's tokens come from one variant. ``engine.swap_ms`` is
        fenced."""
        if self._occupied():
            raise RuntimeError("policy swap with occupied slots")
        self._fence()
        t0 = time.perf_counter()
        self.params = self.adapter.set_active(decision.target)
        self._fence()
        dt = time.perf_counter() - t0
        prev, self._active_policy = self._active_policy, decision.target
        self._swap_decision = None
        # the new variant tallies its own routes: publish from its count on
        counts = self.adapter.route_counts
        self._routes_seen = {op: dict(r) for op, r in counts.routes.items()}
        m = self.metrics
        if self._paged:
            # registered prefix pages hold KV of the previous variant's
            # weights: a hit after the swap would splice them into a request
            # that must equal its own variant's single-policy engine
            self._clear_freed(self.pool.flush_prefixes())
            self._set_pool_gauges()
        pols = self.adapter.variant_policies
        down = pols[decision.target].avg_bits()[0] < pols[prev].avg_bits()[0]
        m.counter("engine.policy_swaps").inc()
        m.counter("engine.policy_swaps_down" if down
                  else "engine.policy_swaps_up").inc()
        m.histogram("engine.swap_ms").observe(dt * 1e3)
        self._observe_active_policy()
        # the new variant's pack-time health: per-site gauges overwritten,
        # the histograms gain its sites
        if self.adapter.pack_health:
            obs_health.publish_pack_health(m, self.adapter.pack_health)
        if self.trace is not None:
            self.trace.instant(
                "policy_swap", ts=self.trace.now(), to=decision.target,
                from_policy=prev, budget_bits=decision.budget_bits,
                solver=decision.solver, solve_ms=decision.solve_ms,
                report=decision.summary(), iteration=now)

    def _decode_step(self, now: int) -> None:
        n = self.ecfg.slots
        toks = np.zeros((n, 1), np.int32)
        pos = np.full((n,), -1, np.int32)
        live: List[int] = []
        for i, s in enumerate(self.slots):
            if s is not None and not s.done:
                toks[i, 0] = s.next_tok
                pos[i] = s.next_pos
                live.append(i)
        t0 = time.perf_counter()
        logits, self.state = self.adapter.decode(
            self.params, torch.as_tensor(toks, device=self.device),
            torch.as_tensor(pos, device=self.device), self.state)
        nxt, margin = self._pick(logits)
        self._fence()
        ts1 = self._stepped(now, time.perf_counter() - t0, live)
        for i in live:
            self._emit(i, [int(nxt[i])], [float(margin[i])], ts1, now)

    # -- self-speculative decode --------------------------------------------
    def _spec_draft_body(self, steps: int, tok, pos, state):
        """``steps`` one-token decodes of the draft pack, writing draft KV
        rows at p..p+steps-1; the argmax stays on the device and feeds the
        next step. Returns (drafts (n, steps) int32, state)."""
        drafts = []
        for _ in range(steps):
            logits, state = self.adapter.decode(self.draft_params, tok, pos,
                                                state)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            pos = torch.where(pos < 0, pos, pos + 1)
            drafts.append(tok)
        return torch.cat(drafts, dim=1), state

    def _spec_verify_fn(self, tok, drafts, pos, remaining, state):
        """The target pass over ``[cur, d1..dk]`` at positions p..p+k (it
        overwrites every draft KV row with the target's and writes row
        p+k), then on the device: greedy acceptance, emission truncation
        (``max_new`` first, then the first EOS: the order a token-at-a-time
        engine stops in), and the rollback past each slot's last fed row.
        Free slots (pos -1) ride along at -1 with a cut nothing reaches.
        Returns (targets (n, k+1), top-2 margins (n, k+1), accepted (n,),
        emitted (n,), state)."""
        k = drafts.shape[1]
        off = torch.arange(k + 1, dtype=torch.int32, device=pos.device)
        vpos = torch.where(pos[:, None] < 0, -1, pos[:, None] + off[None])
        logits, state = self.adapter.verify(
            self.params, torch.cat([tok, drafts], dim=1), vpos, state)
        targets = torch.argmax(logits, dim=-1).to(torch.int32)
        top2 = torch.topk(logits, 2, dim=-1).values
        accept = torch.cumprod((drafts == targets[:, :k]).to(torch.int32),
                               dim=1)
        a = accept.sum(dim=1)
        emit = torch.minimum(a + 1, remaining)
        if self.ecfg.eos_id is not None:
            hits = (targets == self.ecfg.eos_id) & (off[None] < emit[:, None])
            first = torch.argmax(hits.to(torch.int32), dim=1)
            emit = torch.where(hits.any(dim=1), first + 1, emit)
        cut = torch.where(pos < 0, 2 ** 30, pos + emit)
        state = lm.rollback_decode_state(state, cut)
        return targets, top2[..., 0] - top2[..., 1], a, emit, state

    def _spec_fused(self, steps: int, tok, pos, remaining, state,
                    marks: Optional[_PhaseMarks] = None):
        """One whole round on the device, with no host synchronisation:
        the draft steps, the verify pass, acceptance and rollback; ``marks``
        (if given) is marked before the draft, between the parts and after
        the verify. Returns ((n, 2 * (steps + 1) + 2) float64: targets,
        margins, accepted and emitted per slot, for one read), state)."""
        if marks is not None:
            marks.mark()
        drafts, state = self._spec_draft_body(steps, tok, pos, state)
        if marks is not None:
            marks.mark()
        targets, margins, a, emit, state = self._spec_verify_fn(
            tok, drafts, pos, remaining, state)
        if marks is not None:
            marks.mark()
        f = torch.float64      # holds the token ids and counts exactly
        return torch.cat([targets.to(f), margins.to(f), a[:, None].to(f),
                          emit[:, None].to(f)], dim=1), state

    def _spec_round(self, now: int) -> None:
        """One speculative round over the live slots (module docstring):
        emits 1..k+1 tokens per slot, each the target's greedy token."""
        live = [i for i, s in enumerate(self.slots)
                if s is not None and not s.done]
        # a live slot has at least one token to go, so k >= 1
        k = min(self._spec_k, min(self.slots[i].req.max_new
                                  - len(self.slots[i].gen) for i in live))
        n = self.ecfg.slots
        toks = np.zeros((n, 1), np.int32)
        pos = np.full((n,), -1, np.int32)
        remaining = np.zeros((n,), np.int32)
        for i in live:
            s = self.slots[i]
            toks[i, 0] = s.next_tok
            pos[i] = s.next_pos
            remaining[i] = s.req.max_new - len(s.gen)
        marks = _PhaseMarks(self.device) if self.trace is not None else None
        t0 = time.perf_counter()
        out, self.state = self._spec_fused(
            k, *(torch.as_tensor(a, device=self.device)
                 for a in (toks, pos, remaining)), self.state, marks)
        host = out.cpu().numpy()            # the round's one read
        self._fence()
        dt = time.perf_counter() - t0
        tgt, marg = host[:, :k + 1].astype(np.int64), host[:, k + 1:2 * k + 2]
        acc, emit = host[:, -2].astype(np.int64), host[:, -1].astype(np.int64)
        m = self.metrics
        m.counter("spec.rounds").inc()
        m.counter("spec.draft_tokens").inc(k * len(live))
        m.counter("spec.accepted_tokens").inc(int(acc[live].sum()))
        accept_len = m.histogram("spec.accept_len")
        for i in live:
            accept_len.observe(float(acc[i]))
        ts1 = self._stepped(now, dt, live)
        if self.trace is not None:
            # the draft part's device time, read after the fence, inside
            # the round's fenced time
            t_draft = min(marks.seconds(0, 1), dt)
            self.trace.span("spec_draft", ts1 - dt, ts1 - dt + t_draft,
                            slots=len(live), k=k, iteration=now)
            self.trace.span("spec_verify_phase", ts1 - dt + t_draft, ts1,
                            slots=len(live), iteration=now,
                            device_s=marks.seconds(1, 2))
            self.trace.instant("spec_verify", ts=ts1, drafted=k * len(live),
                               accepted=int(acc[live].sum()),
                               emitted=int(emit[live].sum()), iteration=now)
        for i in live:
            s = self.slots[i]
            s.spec_drafted += k
            s.spec_accepted += int(acc[i])
            e = int(emit[i])
            self._emit(i, [int(t) for t in tgt[i, :e]],
                       [float(x) for x in marg[i, :e]], ts1, now)

    # -- main loop ----------------------------------------------------------
    def step(self, now: int) -> bool:
        """One engine iteration: release a drained round (fixed policy),
        admit per policy, then decode. Returns False when nothing is left."""
        if self.scheduler.hold_round:
            occ = self._occupied()
            if occ and all(self.slots[i].done for i in occ):
                for i in occ:
                    self._finish(i, now)
        if self.scheduler.has_pending():
            if self.elastic is not None:
                self._elastic_admission(now)
            # paged: the pool's worst-case obtainable pages, so admission
            # defers (FIFO) rather than exhausting the pool mid-prefill; a
            # pending swap holds admission while the slots drain
            for req, idx in self.scheduler.admit(
                    now, self._free(), len(self._occupied()),
                    page_budget=self.pool.available_count if self._paged
                    else None,
                    page_need=self._pages_per_slot if self._paged else 0,
                    hold=self._swap_decision is not None):
                self._admit(req, idx, now)
        if any(s is not None and not s.done for s in self.slots):
            if self._spec_k:
                self._spec_round(now)
            else:
                self._decode_step(now)
        elif not self._occupied() and not self.scheduler.has_pending():
            return False
        self.metrics.counter("engine.iterations").inc()
        self.monitor.check(self.metrics, self.trace)
        if self.on_step is not None:
            self.on_step(self.metrics)
        return True

    def run(self) -> Dict[int, Completion]:
        """Drain the queue; returns {rid: Completion}."""
        now = 0
        while self.step(now):
            now += 1
            if now >= self.ecfg.max_iters:
                raise RuntimeError(
                    f"engine exceeded max_iters={self.ecfg.max_iters} "
                    f"(pending={len(self.scheduler.pending)}, "
                    f"occupied={len(self._occupied())})")
        if self._occupied():
            raise RuntimeError("slot leak: occupied slots after drain")
        return self.completions


def decisive_prefix(tokens: List[int], ref_tokens: List[int],
                    ref_margins: List[float], min_margin: float = 1e-2,
                    ctrl_tokens: Optional[List[int]] = None,
                    ctrl_margins: Optional[List[float]] = None):
    """Compare one request's greedy tokens against a reference's, token by
    token, up to (not including) the first step that is not decisive: the
    reference's top-2 margin is <= ``min_margin`` -- or, given a control
    (the same reference evaluated at another precision), the control picks
    another token or is itself within ``min_margin``. After such a step the
    two runs may rightly part. Returns (steps compared, first mismatching
    step or None)."""
    n = 0
    for t, (a, b) in enumerate(zip(tokens, ref_tokens)):
        if ref_margins[t] <= min_margin:
            break
        if ctrl_tokens is not None and (ctrl_tokens[t] != b
                                        or ctrl_margins[t] <= min_margin):
            break
        if a != b:
            return n, t
        n += 1
    return n, None
