"""Per-request lifecycle traces for the serving engine.

Copied from the reference package's ``obs/trace.py`` with its imports
renamed; the port's engine fences with ``torch.cuda.synchronize()``.

The engine records one event stream per serving epoch: every request
emits ``admit`` → ``prefill`` (span) → ``first_token`` → one ``token``
instant per decode tick → ``complete`` → ``evict``, and the engine adds
``decode_step`` spans for each decode step (or speculative round).
Timestamps are ``time.perf_counter`` seconds relative to the recorder's
epoch, stamped only after the step's device work is fenced
(``torch.cuda.synchronize()``) — so a span's duration is wall time the
device actually spent, not launch latency.

Two interchangeable export formats (``serve --trace-out``):

* JSONL — one event per line (``to_jsonl``/``from_jsonl``), the
  greppable artifact format;
* Chrome trace / Perfetto — a ``{"traceEvents": [...]}`` JSON
  (``chrome``/``write_chrome``/``from_chrome``) loadable in
  ``chrome://tracing`` or https://ui.perfetto.dev. Requests render as
  named tracks (``req:<rid>``) alongside the engine track; the original
  event fields ride in ``args`` so the two formats round-trip
  losslessly.

``reconcile`` cross-checks a trace against an ``EngineStats.as_dict()``
snapshot — the serve smoke's proof that the trace and the counters
describe the same run (decode-span time within tolerance of
``t_decode_s``, token events == ``tokens_generated``, every admitted
request closed out in order).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Union

TRACE_SCHEMA_VERSION = 1

ENGINE_TRACK = "engine"

# per-request lifecycle vocabulary, in lifecycle order. ``prefix_hit`` is
# optional (paged layout only): it marks an admission that re-mapped shared
# prefix pages instead of prefilling them, carrying pages_reused / tokens /
# flops_saved — without it a shared-prefix admission is indistinguishable
# from a suspiciously fast prefill in the trace.
REQUEST_EVENTS = ("admit", "prefix_hit", "first_token", "token",
                  "complete", "evict")
# events that each carry exactly one emitted token
TOKEN_EVENTS = ("first_token", "token")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One trace event. ``phase`` follows the Chrome trace vocabulary we
    use: ``"X"`` = complete span (``ts``..``ts+dur``), ``"i"`` = instant.
    ``ts``/``dur`` are seconds relative to the recorder epoch."""

    name: str
    phase: str
    ts: float
    dur: float = 0.0
    track: str = ENGINE_TRACK
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def end(self) -> float:
        return self.ts + self.dur


def req_track(rid: int) -> str:
    return f"req:{rid}"


class TraceRecorder:
    """Append-only event recorder with a ``perf_counter`` epoch."""

    def __init__(self):
        self.events: List[TraceEvent] = []
        self._epoch = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._epoch

    def instant(self, name: str, track: str = ENGINE_TRACK,
                ts: Optional[float] = None, **args) -> TraceEvent:
        ev = TraceEvent(name, "i", self.now() if ts is None else ts,
                        0.0, track, args)
        self.events.append(ev)
        return ev

    def span(self, name: str, t0: float, t1: float,
             track: str = ENGINE_TRACK, **args) -> TraceEvent:
        if t1 < t0:
            raise ValueError(f"span {name!r}: end {t1} before start {t0}")
        ev = TraceEvent(name, "X", t0, t1 - t0, track, args)
        self.events.append(ev)
        return ev

    # -- JSONL ---------------------------------------------------------------
    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps({"schema": TRACE_SCHEMA_VERSION}) + "\n")
            for ev in self.events:
                f.write(json.dumps(dataclasses.asdict(ev), sort_keys=True)
                        + "\n")

    @classmethod
    def from_jsonl(cls, path: str) -> "TraceRecorder":
        rec = cls()
        with open(path) as f:
            header = json.loads(f.readline())
            if header.get("schema") != TRACE_SCHEMA_VERSION:
                raise ValueError(f"unknown trace schema {header!r}")
            for line in f:
                rec.events.append(TraceEvent(**json.loads(line)))
        return rec

    # -- Chrome trace / Perfetto --------------------------------------------
    def chrome(self) -> Dict[str, Any]:
        """Chrome-trace JSON object. ``ts``/``dur`` in microseconds per the
        format; one tid per track plus thread-name metadata so Perfetto
        labels the request lanes."""
        tids: Dict[str, int] = {ENGINE_TRACK: 0}
        events: List[Dict[str, Any]] = []
        for ev in self.events:
            tid = tids.setdefault(ev.track, len(tids))
            ce: Dict[str, Any] = {
                "name": ev.name, "ph": ev.phase, "pid": 0, "tid": tid,
                "ts": ev.ts * 1e6,
                "args": dict(ev.args, track=ev.track),
            }
            if ev.phase == "X":
                ce["dur"] = ev.dur * 1e6
            if ev.phase == "i":
                ce["s"] = "t"  # instant scope: thread
            events.append(ce)
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": track}} for track, tid in tids.items()]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "metadata": {"schema": TRACE_SCHEMA_VERSION,
                             "source": "repro_torch.obs.trace"}}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome(), f, indent=1, sort_keys=True)

    @classmethod
    def from_chrome(cls, obj: Union[str, Dict[str, Any]]) -> "TraceRecorder":
        """Rebuild a recorder from ``chrome()`` output (path or dict) —
        the schema round-trip the tests gate."""
        if isinstance(obj, str):
            with open(obj) as f:
                obj = json.load(f)
        if not isinstance(obj, dict) or "traceEvents" not in obj:
            raise ValueError("not a Chrome trace: no traceEvents")
        rec = cls()
        for ce in obj["traceEvents"]:
            if ce.get("ph") == "M":
                continue
            args = dict(ce.get("args", {}))
            track = args.pop("track", ENGINE_TRACK)
            rec.events.append(TraceEvent(
                name=ce["name"], phase=ce["ph"], ts=ce["ts"] / 1e6,
                dur=ce.get("dur", 0.0) / 1e6, track=track, args=args))
        return rec

    def write(self, path: str) -> None:
        """Format by extension: ``.jsonl`` -> JSONL, else Chrome trace."""
        if path.endswith(".jsonl"):
            self.to_jsonl(path)
        else:
            self.write_chrome(path)


# ---------------------------------------------------------------------------
# analysis over a recorded event stream
# ---------------------------------------------------------------------------
def request_summaries(events: List[TraceEvent]) -> Dict[int, Dict[str, Any]]:
    """Per-request lifecycle view: timestamps of each stage, token count,
    TTFT and the inter-token gaps (milliseconds)."""
    out: Dict[int, Dict[str, Any]] = {}
    for ev in events:
        if not ev.track.startswith("req:"):
            continue
        rid = int(ev.track.split(":", 1)[1])
        r = out.setdefault(rid, {"events": [], "token_ts": []})
        r["events"].append(ev)
        if ev.name in TOKEN_EVENTS:
            r["token_ts"].append(ev.end())
        if ev.name in ("admit", "first_token", "complete", "evict"):
            r[ev.name] = ev.ts
    for rid, r in out.items():
        ts = sorted(r["token_ts"])
        r["tokens"] = len(ts)
        r["ttft_ms"] = ((r["first_token"] - r["admit"]) * 1e3
                        if "first_token" in r and "admit" in r else None)
        r["itl_ms"] = [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]
    return out


def reconcile(rec: TraceRecorder, stats: Dict[str, Any],
              tol: float = 0.05) -> List[str]:
    """Cross-check a trace against an ``EngineStats.as_dict()`` snapshot.

    Returns a list of problems (empty = the trace and the counters agree):

    * sum of ``decode_step`` span durations within ``tol`` of
      ``t_decode_s`` (and prefill spans vs ``t_prefill_s``);
    * token events (``first_token`` + ``token``) == ``tokens_generated``;
    * every admitted request has a complete
      admit → first_token → tokens → complete chain with non-decreasing
      timestamps, and the request count matches ``completed``;
    * one ``spec_verify`` instant per speculative round, whose
      ``drafted``/``accepted`` args sum exactly to the engine's
      ``spec_draft_tokens``/``spec_accepted_tokens`` counters;
    * elastic traces: ``policy_swap`` events define swap epochs — every
      policy-stamped token must fall in its variant's epoch, every
      request stays within one variant, and the swap count and final
      epoch match ``policy_swaps`` / ``active_policy``.
    """
    problems: List[str] = []

    def close(measured: float, counted: float, label: str) -> None:
        ref = max(abs(counted), 1e-9)
        if abs(measured - counted) / ref > tol:
            problems.append(f"{label}: trace {measured:.6f} vs stats "
                            f"{counted:.6f} (tol {tol:.0%})")

    decode_spans = [e for e in rec.events if e.name == "decode_step"]
    close(sum(e.dur for e in decode_spans), stats.get("t_decode_s", 0.0),
          "sum(decode_step dur) != t_decode_s")
    if len(decode_spans) != stats.get("decode_steps", 0):
        problems.append(f"decode_step spans {len(decode_spans)} != "
                        f"decode_steps {stats.get('decode_steps')}")
    prefill_spans = [e for e in rec.events if e.name == "prefill"]
    close(sum(e.dur for e in prefill_spans), stats.get("t_prefill_s", 0.0),
          "sum(prefill dur) != t_prefill_s")

    # prefix-hit admissions are page-table remaps, NOT prefills: the
    # explicit prefix_hit events must account for exactly the tokens and
    # FLOPs the counters say were saved, and every admit that reports
    # reused prefix tokens must have one — otherwise the trace would
    # under-count what the paged path skipped.
    hits = [e for e in rec.events if e.name == "prefix_hit"]
    hit_tokens = sum(int(e.args.get("tokens", 0)) for e in hits)
    if hit_tokens != stats.get("prefix_hit_tokens", 0):
        problems.append(f"prefix_hit tokens {hit_tokens} != "
                        f"prefix_hit_tokens {stats.get('prefix_hit_tokens')}")
    close(sum(float(e.args.get("flops_saved", 0.0)) for e in hits),
          stats.get("prefill_flops_saved", 0.0),
          "sum(prefix_hit flops_saved) != prefill_flops_saved")
    hit_tracks = {e.track for e in hits}
    for e in rec.events:
        if (e.name == "admit" and e.args.get("prefix_hit_tokens", 0)
                and e.track not in hit_tracks):
            problems.append(f"{e.track}: admit reused "
                            f"{e.args['prefix_hit_tokens']} prefix tokens "
                            f"but has no prefix_hit event")

    # speculative rounds: every round emits one spec_verify instant; its
    # drafted/accepted args must sum exactly to the spec counters, so a
    # round that lost or double-counted acceptance bookkeeping cannot
    # reconcile (token identity alone would not catch the stats drifting)
    verifies = [e for e in rec.events if e.name == "spec_verify"]
    if len(verifies) != stats.get("spec_rounds", 0):
        problems.append(f"spec_verify instants {len(verifies)} != "
                        f"spec_rounds {stats.get('spec_rounds')}")
    drafted = sum(int(e.args.get("drafted", 0)) for e in verifies)
    if drafted != stats.get("spec_draft_tokens", 0):
        problems.append(f"sum(spec_verify drafted) {drafted} != "
                        f"spec_draft_tokens {stats.get('spec_draft_tokens')}")
    accepted = sum(int(e.args.get("accepted", 0)) for e in verifies)
    if accepted != stats.get("spec_accepted_tokens", 0):
        problems.append(
            f"sum(spec_verify accepted) {accepted} != "
            f"spec_accepted_tokens {stats.get('spec_accepted_tokens')}")

    # elastic swap epochs: policy_swap events partition the trace into
    # epochs, each serving ONE variant. Every policy-stamped token must
    # match the epoch active at its timestamp, every request must stay
    # inside a single variant (drain-then-swap admits nothing mid-swap),
    # the non-initial swap count must equal the policy_swaps counter, and
    # the last epoch must be the variant the stats say is active. Gated
    # on the events being present, so single-policy traces skip it —
    # reconcile no longer ASSUMES one policy per trace, it verifies it
    # per epoch.
    swaps = sorted((e for e in rec.events if e.name == "policy_swap"),
                   key=lambda e: e.ts)
    if swaps:
        real = [e for e in swaps if not e.args.get("initial")]
        if len(real) != stats.get("policy_swaps", 0):
            problems.append(f"policy_swap events {len(real)} != "
                            f"policy_swaps {stats.get('policy_swaps')}")
        if not swaps[0].args.get("initial"):
            problems.append("trace has policy_swap events but no initial "
                            "epoch marker (initial=true)")
        marks = [(e.ts, str(e.args.get("to", ""))) for e in swaps]
        active_stat = str(stats.get("active_policy", ""))
        if active_stat and marks[-1][1] != active_stat:
            problems.append(f"last swap epoch {marks[-1][1]!r} != stats "
                            f"active_policy {active_stat!r}")

        def epoch_at(ts: float) -> str:
            cur = marks[0][1]
            for t, pid in marks:
                if t <= ts:
                    cur = pid
                else:
                    break
            return cur

        variants_by_track: Dict[str, set] = {}
        for ev in rec.events:
            if ev.name in TOKEN_EVENTS and "policy" in ev.args:
                pid = str(ev.args["policy"])
                variants_by_track.setdefault(ev.track, set()).add(pid)
                expected = epoch_at(ev.ts)
                if pid != expected:
                    problems.append(
                        f"{ev.track}: {ev.name} stamped {pid!r} inside the "
                        f"{expected!r} swap epoch (ts {ev.ts:.6f})")
        for track, pids in sorted(variants_by_track.items()):
            if len(pids) > 1:
                problems.append(
                    f"{track}: tokens span policy variants {sorted(pids)} "
                    "— a request must drain under the variant that "
                    "admitted it")

    reqs = request_summaries(rec.events)
    tokens = sum(r["tokens"] for r in reqs.values())
    if tokens != stats.get("tokens_generated", 0):
        problems.append(f"token events {tokens} != tokens_generated "
                        f"{stats.get('tokens_generated')}")
    admits = [rid for rid, r in reqs.items() if "admit" in r]
    if len(admits) != stats.get("admitted", 0):
        problems.append(f"admit events {len(admits)} != admitted "
                        f"{stats.get('admitted')}")
    completes = [rid for rid, r in reqs.items() if "complete" in r]
    if len(completes) != stats.get("completed", 0):
        problems.append(f"complete events {len(completes)} != completed "
                        f"{stats.get('completed')}")
    for rid, r in reqs.items():
        for stage in ("first_token", "complete"):
            if stage not in r:
                problems.append(f"rid {rid}: no {stage} event")
        chain = [r[k] for k in ("admit", "first_token", "complete")
                 if k in r]
        if any(b < a for a, b in zip(chain, chain[1:])):
            problems.append(f"rid {rid}: lifecycle timestamps decrease")
        toks = r["token_ts"]
        if toks != sorted(toks):
            problems.append(f"rid {rid}: token timestamps decrease")
    return problems


def validate_chrome(obj: Dict[str, Any]) -> List[str]:
    """Minimal structural validity of a Chrome-trace dict."""
    problems: List[str] = []
    evs = obj.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["no traceEvents list"]
    for i, ce in enumerate(evs):
        if not isinstance(ce, dict) or "ph" not in ce or "name" not in ce:
            problems.append(f"event {i}: missing ph/name")
            continue
        if ce["ph"] in ("X", "i") and ce.get("ts", -1.0) < 0:
            problems.append(f"event {i} ({ce['name']}): negative/missing ts")
        if ce["ph"] == "X" and ce.get("dur", -1.0) < 0:
            problems.append(f"event {i} ({ce['name']}): negative/missing dur")
    return problems
