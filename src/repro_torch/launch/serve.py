"""Serving driver: a searched mixed-precision policy, packed into a
``runtime.session.QuantizedSession``, served through the continuous-batching
engine (``launch.engine``) with greedy decode, over an int8 (or fp) ring KV
cache or, with ``--kv-layout paged``, pooled int8 pages with shared-prefix
reuse and chunked append prefill. ``--speculate K`` decodes
self-speculatively: a uniform ``--draft-bits`` repack of the same weights
proposes K tokens per round and the searched policy verifies them in one
multi-token pass (greedy only, int8 KV, either layout). ``--elastic``
serves a bank of policy variants (``--policy-variants``: their average
weight-bit budgets, searched over the indicator banks of the weights the
``--policy`` was searched for) and re-solves the ILP at every admission
round against the live load, swapping the serving variant once the slots
drain (``launch.elastic``, ``serve_elastic``).

The weights are the port's seeded random initialisation (``--seed``; no
checkpoint of a published model ships with the repository); the policy is a
searched ``MPQPolicy`` json, e.g. one ``--write-demo-policy`` wrote, or
``demo_mixed_policy`` when none is given. ``--uniform-bits B`` serves the
fake-quant training graph at uniform B bits instead (fp KV), the reference
package's path without ``--policy``.

The engine budgets prefill from the roofline model of its own decode step
(``dist.roofline.suggest_prefill_chunk``) on the H100 envelope, or on a
measured device table (``--chip-table``, as ``obs.calibrate`` writes it).
``--compare`` serves the same requests again under the fixed schedule and
checks the tokens (identical for token-at-a-time decode; on every decisive
step for speculation, whose rounds take other shapes under the other
schedule) and counts the decode steps continuous batching saved; it also
gates the request-lifecycle trace against the engine's counters
(``check_trace``) and replays the measured timings against the roofline
(``calibration_report``). ``--smoke`` serves the arch's reduced config and
implies ``--compare --stagger``. ``--check`` also gates the greedy tokens
against the fake-quant reference engine on decisive steps. The trace, the
metrics snapshot and a periodic metrics stream with a Prometheus dump are
written with ``--trace-out``, ``--metrics-out`` and ``--metrics-stream``.

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device and without ``--device cpu`` it raises rather than run on the CPU.

Examples:
  python -m repro_torch.launch.serve --requests 8 --slots 4 \
      --prompt-len 256 --gen 32 --cache-len 320 --compare --stagger
  python -m repro_torch.launch.serve --smoke --device cpu \
      --trace-out out/trace.json --metrics-stream out/metrics.jsonl
  python -m repro_torch.launch.serve --smoke --device cpu --kv-layout paged \
      --check --stagger
  python -m repro_torch.launch.serve --write-demo-policy searched.json
  python -m repro_torch.launch.serve --policy searched.json --explain-policy
  python -m repro_torch.launch.serve --smoke --device cpu --speculate 4 \
      --draft-bits 2
  python -m repro_torch.launch.serve --smoke --write-demo-policy P
  python -m repro_torch.launch.serve --smoke --device cpu --policy P \
      --elastic --stagger
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.policy import MPQPolicy
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.engine import DecodeEngine, EngineConfig, \
    PagedLMAdapter, check_kv_layout, check_speculate, decisive_prefix
from repro_torch.launch.scheduler import POLICIES, Request
from repro_torch.models import lm
from repro_torch.models.quant_layers import QuantContext
from repro_torch.runtime import dispatch


def resolve_device(name: Optional[str]) -> torch.device:
    """``cuda`` unless the caller asks for ``cpu``; no quiet CPU fallback."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain versions on the CPU")
    return dev


def check_kv(kv: str, kv_layout: str) -> None:
    """The KV flags' contract: int8 or fp rows, and pages hold int8 only."""
    if kv not in ("int8", "fp"):
        raise ValueError(f"kv must be 'int8' or 'fp', got {kv!r}")
    dispatch.ROUTES.validate("kv_layout", kv_layout)
    if kv_layout == "paged" and kv != "int8":
        raise ValueError("--kv-layout paged requires --kv int8: pages hold "
                         "int8 codes + scales")


def check_spec(cfg, speculate: int, draft_bits: int, *, kv: str = "int8",
               policy_given: bool = True) -> None:
    """The ``--speculate`` contract, each incompatibility with its reason:
    int8 KV, a policy to draft for, a draft width in [2, 8] (it must also
    be a searched width: ``SpecSession`` checks that against the config),
    and a schedule the engine can roll back (``check_speculate``).
    Speculation is greedy because the engine decodes greedily."""
    check_speculate(cfg, speculate)
    if not speculate:
        return
    if not policy_given:
        raise ValueError(
            "--speculate needs --policy <searched.json> (or --smoke, which "
            "serves the demo policy): the draft is a low-bit repack of the "
            "target's packed weights")
    if kv != "int8":
        raise ValueError(
            "--speculate requires --kv int8: draft and verify share one int8 "
            "KV cache, rolled back past the first rejection")
    if not 2 <= draft_bits <= 8:
        raise ValueError(f"--draft-bits must be in [2, 8], got {draft_bits}")


@dataclasses.dataclass
class ServeConfig:
    """The serving flags as one typed, validated object: ``main()`` builds
    it from argparse (``from_args``), tests build it directly, and every
    engine of a run takes its ``EngineConfig`` from ``engine_config()``.
    Route-shaped fields validate against ``runtime.dispatch.ROUTES`` at
    construction."""

    arch: str = "qwen3-0.6b"
    requests: int = 8
    slots: int = 4
    prompt_len: int = 32
    gen: int = 16
    cache_len: int = 0          # 0 = prompt + gen
    prefill_chunk: int = 0      # prefill tokens per iteration; 0 = roofline
    schedule: str = "continuous"
    stagger: bool = False
    arrive_every: int = 0
    policy_path: Optional[str] = None   # None: demo_mixed_policy
    kv: str = "int8"            # int8 | fp: the packed session's KV rows
    kv_layout: str = "ring"     # ring | paged (dispatch.ROUTES registry)
    page_size: int = 8          # tokens per KV page (paged only)
    decode_attn: str = "auto"   # auto | a dispatch decode_attn route
    bucket: bool = True         # prompt-length bucketing (ring only)
    chip_table: Optional[str] = None  # measured device table json (roofline)
    speculate: int = 0          # self-speculative draft length k (0 = off)
    draft_bits: int = 2         # draft policy weight bits (--speculate)
    elastic: bool = False       # admission-time ILP re-solve + variant swap
    policy_variants: str = "3,4,6"  # avg weight-bit budgets of the bank
    sampling: str = "greedy"    # token selection; only greedy exists
    seed: int = 0               # lm.init_params seed
    trace: bool = True          # record the request-lifecycle trace

    def __post_init__(self):
        if self.schedule not in POLICIES:
            raise ValueError(
                f"unknown schedule {self.schedule!r}; known: {POLICIES}")
        check_kv(self.kv, self.kv_layout)
        if self.decode_attn != "auto":
            dispatch.ROUTES.validate("decode_attn", self.decode_attn)
        if self.speculate < 0:
            raise ValueError(f"--speculate must be >= 0, got {self.speculate}")
        if self.sampling != "greedy":
            raise ValueError(
                f"unknown sampling mode {self.sampling!r}; the engine "
                "decodes greedily (argmax)")
        dispatch.ROUTES.validate("elastic", "bank" if self.elastic else "off")
        if self.elastic:
            if not self.policy_path:
                raise ValueError(
                    "--elastic needs --policy <searched.json>: the variant "
                    "bank searches its budgets over the SAME indicator "
                    "banks the base policy was searched from, and the base "
                    "policy anchors that family")
            if self.speculate:
                raise ValueError(
                    "--elastic is incompatible with --speculate: the draft "
                    "pack pairs with ONE target policy and would go stale "
                    "at the first hot-swap")
            if self.schedule == "fixed":
                raise ValueError(
                    "--elastic needs a continuous schedule: the controller "
                    "re-solves against the live admission stream, which "
                    "the fixed policy drains in whole rounds")
            if self.kv == "fp":
                raise ValueError(
                    "--elastic requires --kv int8: the variant bank is a "
                    "packed-session feature (pre-packed trees to swap)")
            self.variant_budgets  # malformed --policy-variants fails HERE

    @property
    def variant_budgets(self) -> Tuple[float, ...]:
        """``--policy-variants`` parsed to sorted avg weight-bit budgets."""
        try:
            vals = tuple(float(x) for x in self.policy_variants.split(","))
        except ValueError:
            raise ValueError(
                "--policy-variants must be comma-separated average "
                f"weight-bit budgets, got {self.policy_variants!r}")
        if len(vals) < 2 or len(set(vals)) != len(vals):
            raise ValueError(
                "--policy-variants needs >= 2 distinct budgets "
                f"(a one-variant bank cannot degrade), got "
                f"{self.policy_variants!r}")
        return tuple(sorted(vals))

    @property
    def resolved_cache_len(self) -> int:
        return self.cache_len or (self.prompt_len + self.gen)

    @property
    def session_kv(self) -> str:
        """KV storage mode for the packed session (``--kv`` normalized)."""
        return "none" if self.kv == "fp" else "int8"

    @classmethod
    def from_args(cls, args) -> "ServeConfig":
        return cls(
            arch=args.arch, requests=args.requests, slots=args.slots,
            prompt_len=args.prompt_len, gen=args.gen,
            cache_len=args.cache_len, schedule=args.schedule,
            stagger=args.stagger, arrive_every=args.arrive_every,
            policy_path=args.policy, kv=args.kv, kv_layout=args.kv_layout,
            page_size=args.page_size, decode_attn=args.decode_attn,
            bucket=not args.no_bucket, chip_table=args.chip_table,
            speculate=args.speculate, draft_bits=args.draft_bits,
            elastic=args.elastic, policy_variants=args.policy_variants,
            seed=args.seed, trace=not args.no_trace)

    @property
    def chip(self):
        """``--chip-table`` resolved to a calibrated ``ChipSpec`` (cached);
        None without a table."""
        if self.chip_table is None:
            return None
        if not hasattr(self, "_chip"):
            self._chip = load_chip_table(self.chip_table)
        return self._chip

    def engine_config(self, *, kv_quant: Optional[str] = None,
                      schedule: Optional[str] = None,
                      layout: Optional[str] = None,
                      calibrated: bool = True,
                      speculate: int = 0) -> EngineConfig:
        """An ``EngineConfig`` for one engine of this serving run.

        ``kv_quant`` defaults to the packed session's storage mode; a
        non-int8 engine (the fp path, the fake-quant graph) serves through
        the ring layout: pages hold int8 codes. ``calibrated=False`` keeps
        the default ``ChipSpec`` even when a ``--chip-table`` is loaded.
        ``speculate`` is opt-in per engine: only the measured speculative
        engine drafts."""
        kv = self.session_kv if kv_quant is None else kv_quant
        lay = self.kv_layout if layout is None else layout
        if kv != "int8":
            lay = "ring"
        ecfg = EngineConfig(
            slots=self.slots, cache_len=self.resolved_cache_len,
            prefill_chunk=self.prefill_chunk,
            policy=schedule or self.schedule, kv_quant=kv, kv_layout=lay,
            page_size=self.page_size, bucket_prompts=self.bucket,
            trace=self.trace, speculate=speculate)
        if calibrated and self.chip is not None:
            ecfg = dataclasses.replace(ecfg, chip=self.chip)
        return ecfg


def build_requests(data, n, prompt_len, gen, *, stagger=False,
                   arrive_every=0, share_prefix=0) -> List[Request]:
    """A deterministic request set from the synthetic corpus. ``stagger``
    varies prompt/generation lengths across requests (the traffic
    continuous batching wins on); ``arrive_every`` spaces arrivals out by
    that many engine iterations; ``share_prefix`` overwrites the first that
    many tokens of every prompt with request 0's (the shared-system-prompt
    traffic the paged layout's prefix reuse serves)."""
    reqs = []
    base = None
    for i in range(n):
        p, g = prompt_len, gen
        if stagger:
            p = max(4, prompt_len - 3 * (i % 4))
            g = max(2, gen - 2 * (i % 3))
        toks = data.batch(i, 1, p)["tokens"][0]
        if share_prefix:
            toks = np.asarray(toks).copy()
            if base is None:
                base = toks[:share_prefix].copy()
            k = min(share_prefix, len(toks))
            toks[:k] = base[:k]
        reqs.append(Request(rid=i, tokens=toks, max_new=g,
                            arrival=i * arrive_every))
    return reqs


def load_chip_table(path: str):
    """``--chip-table`` loader: a measured device-table json (a bare
    stanza, or an object with a ``device_table`` key, as
    ``calibration_report`` results are written) -> calibrated
    ``ChipSpec``."""
    from repro_torch.dist import roofline

    with open(path) as f:
        table = json.load(f)
    if "device_table" in table:
        table = table["device_table"]
    try:
        return roofline.chip_from_table(table)
    except ValueError as e:
        raise SystemExit(f"--chip-table {path}: {e}")


def demo_mixed_policy(cfg, meta=None) -> MPQPolicy:
    """A mixed MPQPolicy cycling the searched widths over the arch's QLayer
    table -- a deterministic stand-in for an ILP search result (the same
    assignment as the reference's ``demo_mixed_policy``), with a
    descriptive ``SolveReport`` (zero importance, real costs) embedded under
    ``meta["solve_report"]``, so ``--explain-policy`` renders it."""
    from repro_torch.core import ilp

    ql = lm.enumerate_qlayers(cfg)
    bits = sorted(int(b) for b in cfg.bits)
    n = len(bits)
    policy = MPQPolicy(
        {q.name: bits[i % n] for i, q in enumerate(ql)},
        {q.name: bits[(i + 1) % n] for i, q in enumerate(ql)},
        meta=dict(meta or {}, kind="demo-mixed", arch=cfg.name))
    report = ilp.describe_policy_report(ql, policy, bits,
                                        meta={"kind": "demo-mixed",
                                              "arch": cfg.name})
    policy.meta["solve_report"] = report.to_json()
    return policy


def write_demo_policy(path, arch="qwen3-0.6b", smoke=True) -> MPQPolicy:
    """Write a ``demo_mixed_policy`` json (``--write-demo-policy``), so the
    ``--policy`` path can be served without running the search."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    policy = demo_mixed_policy(cfg, meta={"smoke": smoke})
    policy.save(path)
    print(f"wrote demo policy for {cfg.name} ({len(policy.w_bits)} layers) "
          f"-> {path}")
    return policy


def explain_policy(args, cfg):
    """``--explain-policy``: render the ILP audit trail of ``--policy`` as
    a per-layer table (importance, chosen bits, bytes, binding constraint)
    and exit. The report is the policy's embedded ``SolveReport``; a policy
    without one gets a descriptive report rebuilt from its bit assignment
    (zero importance, measured costs). A PATH argument also writes the
    report json there."""
    from repro_torch.core import ilp

    policy = MPQPolicy.load(args.policy)
    raw = (policy.meta or {}).get("solve_report")
    if raw is not None:
        report = ilp.SolveReport.from_json(raw)
    else:
        ql = lm.enumerate_qlayers(cfg)
        try:
            policy.validate(ql)
        except ValueError as e:
            raise SystemExit(
                f"--explain-policy: {args.policy} has no embedded "
                f"solve_report and does not match arch {cfg.name!r} "
                f"(did you mix --smoke and full variants?): {e}")
        report = ilp.describe_policy_report(
            ql, policy, sorted(int(b) for b in cfg.bits),
            meta={"arch": cfg.name, "policy_path": args.policy})
    print(report.render_table())
    if args.explain_policy != "-":
        _ensure_dir(args.explain_policy)
        report.save(args.explain_policy)
        print(f"solve report -> {args.explain_policy}")
    return report


def make_context(cfg) -> QuantContext:
    return QuantContext.make(cfg.bits, cfg.quant_act_signed,
                             compute_dtype=torch.float32)


def build_session(cfg, params, policy: MPQPolicy, *, kv: str = "int8",
                  speculate: int = 0, draft_bits: int = 2, site_source=None):
    """Pack ``policy`` into a ``QuantizedSession`` (a ``SpecSession`` with
    its ``draft_bits`` draft pack when ``speculate`` > 0). ``site_source``
    makes each site's params when it is packed (under both policies of a
    speculative session)."""
    from repro_torch.runtime.session import QuantizedSession, SpecSession
    kv_quant = "int8" if kv == "int8" else "none"
    if speculate:
        return SpecSession(cfg, params, policy, make_context(cfg),
                           kv_quant=kv_quant, draft_w_bits=draft_bits,
                           site_source=site_source)
    return QuantizedSession(cfg, params, policy, make_context(cfg),
                            kv_quant=kv_quant, site_source=site_source)


def serve_quantized(cfg, params, policy: MPQPolicy, reqs, *, slots: int,
                    cache_len: int, prefill_chunk: int = 0, device=None,
                    kv: str = "int8", kv_layout: str = "ring",
                    page_size: int = 8, speculate: int = 0,
                    draft_bits: int = 2, site_source=None):
    """Pack ``policy`` (``build_session``) and serve ``reqs`` through the
    engine over a ``kv`` ring KV cache or the paged int8 layout
    (``prefill_chunk`` 0: the roofline budget). Returns (session, engine,
    completions)."""
    check_spec(cfg, speculate, draft_bits, kv=kv)
    scfg = ServeConfig(arch=cfg.name, slots=slots, cache_len=cache_len,
                       prefill_chunk=prefill_chunk, kv=kv,
                       kv_layout=kv_layout, page_size=page_size,
                       bucket=False, speculate=speculate,
                       draft_bits=draft_bits)
    sess = build_session(cfg, params, policy, kv=kv, speculate=speculate,
                         draft_bits=draft_bits, site_source=site_source)
    eng, out = run_engine(None, cfg, None, sess.ctx, reqs, scfg=scfg,
                          device=device, adapter=sess, speculate=speculate)
    return sess, eng, out


def run_engine(params, cfg, bits, ctx, reqs, *, scfg: ServeConfig, device,
               schedule: Optional[str] = None, adapter=None,
               calibrated: bool = True, speculate: int = 0, on_step=None):
    """Build one engine of this serving run and drain ``reqs`` through it:
    the packed session ``adapter`` (its KV mode and layout), or without
    one the fake-quant graph at ``bits`` with fp KV rows. Returns (engine,
    completions)."""
    ecfg = scfg.engine_config(kv_quant=None if adapter is not None
                              else "none", schedule=schedule,
                              calibrated=calibrated, speculate=speculate)
    eng = DecodeEngine(params if adapter is None else adapter.params, cfg,
                       bits, ctx, adapter=adapter, device=device, ecfg=ecfg)
    eng.on_step = on_step
    eng.submit_all(reqs)
    return eng, eng.run()


def token_at_a_time(sess, cfg, reqs, eng):
    """The speculative engine's session, layout and slots through a
    token-at-a-time engine (``speculate=0``). Returns (engine,
    completions)."""
    ecfg = dataclasses.replace(eng.ecfg, speculate=0)
    base = DecodeEngine(sess.params, cfg, None, sess.ctx, adapter=sess,
                        device=eng.device, ecfg=ecfg)
    base.submit_all(reqs)
    return base, base.run()


def compare_spec(out, base, base_out, min_margin: float = 1e-2):
    """Speculative completions ``out`` against the token-at-a-time engine
    ``base``'s ``base_out``: (tokens identical in all, tokens compared, steps
    decisive and compared, [rids that differ on a decisive step]). A step is
    decisive when ``base``'s top-2 margin exceeds ``min_margin``: the verify
    pass computes its logits from S rows at once, and a tie closer than the
    float32 rounding of the head may fall either way."""
    same = total = compared = 0
    bad = []
    for rid, c in out.items():
        ref = base_out[rid].tokens
        same += sum(a == b for a, b in zip(c.tokens, ref))
        total += len(ref)
        n, miss = decisive_prefix(c.tokens, ref, base.margins[rid],
                                  min_margin)
        compared += n
        if miss is not None or len(c.tokens) != len(ref):
            bad.append(rid)
    return same, total, compared, bad


def reference_engine(cfg, params, policy: MPQPolicy, reqs, *, slots: int,
                     cache_len: int, prefill_chunk: int = 0, device=None,
                     compute_dtype=torch.float32, kv: str = "int8",
                     bucket_prompts: bool = False, kv_layout: str = "ring",
                     page_size: int = 8):
    """The fake-quant graph (``LMAdapter``) through the same engine, with
    int8 KV slots referenced as quantize-dequantize in fp (``kv="fp"``:
    plain fp rows); ``compute_dtype`` float64 evaluates the same graph at
    higher precision (the control). ``kv_layout="paged"`` serves it over
    pooled int8 pages (``PagedLMAdapter``), attended on the dequant-fp
    route, so it prefills as the served run does. On the card it
    runs the kernels' plain versions (``ops.plain_on_cuda``): a reference
    computes in plain PyTorch, and the float64 control reaches ``wkv``,
    whose kernel takes float32 only."""
    ctx = dataclasses.replace(make_context(cfg), compute_dtype=compute_dtype)
    bits = lm.bits_from_policy(cfg, policy)
    paged = kv_layout == "paged"
    ecfg = EngineConfig(slots=slots, cache_len=cache_len,
                        prefill_chunk=prefill_chunk,
                        kv_quant="fake" if kv == "int8" else "none",
                        bucket_prompts=bucket_prompts)
    adapter = None
    if paged:
        ctx = dataclasses.replace(ctx, kv_quant="int8")
        adapter = PagedLMAdapter(cfg, bits, ctx)
        ecfg = dataclasses.replace(ecfg, kv_quant="int8", kv_layout="paged",
                                   page_size=page_size)
    eng = DecodeEngine(params, cfg, bits, ctx, adapter=adapter,
                       device=device, ecfg=ecfg)
    eng.submit_all(reqs)
    with ops.plain_on_cuda(*ops.PLAIN_KERNELS), \
            dispatch.force_route("decode_attn",
                                 "dequant-fp" if paged else None):
        return eng, eng.run()


def compare_greedy(out, ref, ref_out, ctrl=None, ctrl_out=None,
                   min_margin: float = 1e-2):
    """(decisive steps compared, [rids that diverged on a decisive step]) of
    completions ``out`` against reference engine ``ref``'s ``ref_out`` (and
    its control ``ctrl``/``ctrl_out``, see ``engine.decisive_prefix``)."""
    compared, bad = 0, []
    for rid, c in out.items():
        kw = {} if ctrl is None else dict(ctrl_tokens=ctrl_out[rid].tokens,
                                          ctrl_margins=ctrl.margins[rid])
        n, miss = decisive_prefix(c.tokens, ref_out[rid].tokens,
                                  ref.margins[rid], min_margin, **kw)
        compared += n
        if miss is not None:
            bad.append(rid)
    return compared, bad


def check_greedy(cfg, params, policy, reqs, out, **kw):
    """Gate the served tokens against the fake-quant reference engine.

    The quantizers (2-6-bit activations, int8 KV rows) turn a last-bit
    difference anywhere into whole code steps downstream, so two correct
    float evaluations of one graph part after a few layers: on Qwen3-0.6B
    the float32 reference and its own float64 evaluation differ by ~1 logit
    on identical prompts. A step is therefore decisive when the float32
    reference's top-2 margin exceeds 1e-2 AND its float64 evaluation picks
    the same token with a margin above 1e-2; the served tokens must equal
    the reference's on every decisive step up to a request's first
    non-decisive one. Returns (decisive steps compared, [diverged rids],
    rids where the two reference precisions disagreed on a confident step).
    """
    ref, ref_out = reference_engine(cfg, params, policy, reqs, **kw)
    ctrl, ctrl_out = reference_engine(cfg, params, policy, reqs,
                                      compute_dtype=torch.float64, **kw)
    compared, bad = compare_greedy(out, ref, ref_out, ctrl, ctrl_out)
    _, unstable = compare_greedy(ctrl_out, ref, ref_out)
    return compared, bad, unstable


def print_stats(label: str, eng) -> None:
    """One line of the epoch's ``EngineStats`` and its prefill budget, then
    the monitor's alerts."""
    d = eng.stats.as_dict()
    keys = ("decode_steps", "prefill_calls", "prefill_tokens",
            "tokens_generated",
            "prefill_p50_ms", "decode_step_p50_ms", "decode_tokens_per_s",
            "decode_attn_route", "act_quant_reused", "alerts_fired")
    print(f"[{label}] " + " ".join(
        f"{k}={d[k]:.4g}" if isinstance(d.get(k), float) else f"{k}={d.get(k)}"
        for k in keys if k in d) + f" prefill_chunk={eng.prefill_chunk}")
    for a in eng.monitor.alerts:
        print(f"  ALERT[{a.severity}] {a.name}: {a.metric} {a.op} "
              f"{a.threshold:g} (value {a.value:g})")


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def export_obs(args, eng) -> None:
    """``--trace-out`` / ``--metrics-out`` artifacts of one engine's
    epoch."""
    if getattr(args, "trace_out", None):
        if eng.trace is None:
            raise SystemExit("--trace-out: engine tracing is disabled")
        _ensure_dir(args.trace_out)
        eng.trace.write(args.trace_out)
        print(f"trace: {len(eng.trace.events)} events -> {args.trace_out}")
    if getattr(args, "metrics_out", None):
        _ensure_dir(args.metrics_out)
        with open(args.metrics_out, "w") as f:
            json.dump(eng.metrics.snapshot(), f, indent=1, sort_keys=True)
        print(f"metrics: {len(eng.metrics)} series -> {args.metrics_out}")


def make_streamer(args):
    """``--metrics-stream``: the JSONL snapshot streamer (or None). Hook it
    onto an engine with ``eng.on_step = streamer.tick``: the engine calls
    it once per scheduler iteration."""
    path = getattr(args, "metrics_stream", None)
    if not path:
        return None
    from repro_torch.obs.export import MetricsStreamer

    _ensure_dir(path)
    return MetricsStreamer(path, interval_s=float(args.metrics_interval))


def finish_stream(args, eng, streamer) -> None:
    """Close the JSONL stream (force-emitting a final snapshot, so every
    run yields >= 2 snapshots) and write a Prometheus text dump of the same
    registry next to it (``<path>.prom``)."""
    if streamer is None:
        return
    from repro_torch.obs.export import write_prometheus

    streamer.close(eng.metrics)
    prom = args.metrics_stream + ".prom"
    text = write_prometheus(eng.metrics, prom)
    print(f"metrics stream: {streamer.seq} snapshots -> "
          f"{args.metrics_stream} | {len(text.splitlines())} prometheus "
          f"lines -> {prom}")


def check_trace(eng, label) -> None:
    """Gate: the recorded lifecycle trace and the stats counters describe
    the same run (``obs.trace.reconcile``)."""
    from repro_torch.obs import trace as obs_trace
    if eng.trace is None:
        return
    problems = obs_trace.reconcile(eng.trace, eng.stats.as_dict())
    if problems:
        raise SystemExit(f"{label}: trace/stats reconcile failed: "
                         + "; ".join(problems))
    print(f"{label}: trace reconciles with engine stats "
          f"({len(eng.trace.events)} events)")


def calibration_report(eng, cfg, *, gate=False):
    """Replay the epoch's measured phase timings against the roofline
    step-cost model the engine budgeted with (``obs.calibrate``), publish
    the worst modeled-vs-measured factor for the drift watcher, and (with
    ``gate``) fail on a non-finite or non-positive ratio."""
    from repro_torch.obs import calibrate
    from repro_torch.obs import health as obs_health
    report = calibrate.calibrate(
        cfg, eng.stats.as_dict(), slots=eng.ecfg.slots,
        cache_tokens=eng.ecfg.cache_len, kv_bits=eng.kv_bits,
        kv_attend=eng.kv_attend,
        w_bits_total=getattr(eng.adapter, "w_bits_total", None),
        chip=eng.ecfg.chip)
    print("roofline calibration (measured vs modeled):")
    print(calibrate.render_table(report["rows"]))
    t = report["device_table"]
    print(f"  measured device table: hbm_bytes_s={t['hbm_bytes_s']:.3e} "
          f"peak_flops={t['peak_flops']:.3e} ({t['name']})")
    eng.metrics.gauge(
        "roofline.drift_max",
        help="worst modeled-vs-measured phase cost factor").set(
            obs_health.roofline_drift(report["rows"]))
    eng.monitor.check(eng.metrics, eng.trace)
    if gate and not report["finite"]:
        raise SystemExit("roofline calibration produced a non-finite or "
                         f"non-positive ratio: {report['rows']}")
    return report


def measured_epoch(args, cfg, eng, label: str, streamer):
    """What follows a measured run: its stats, the trace and metrics
    artifacts, under ``--smoke`` / ``--compare`` the trace and calibration
    gates, then the metrics stream's close (after the calibration gauge
    lands, so the last snapshot and the dump carry it). Returns the
    calibration report (None without the gates)."""
    print_stats(label, eng)
    export_obs(args, eng)
    report = None
    if args.smoke or args.compare:
        check_trace(eng, label)
        report = calibration_report(eng, cfg, gate=True)
    finish_stream(args, eng, streamer)
    return report


def moe_over_pages(cfg, kv_layout: str) -> bool:
    """Whether a serving run's tokens depend on its schedule: a MoE
    schedule over pages routes each append chunk's pad rows beside its
    prompt tokens, through a capacity set by the chunk, and a pad row
    (position -1, no key admitted) attends the slot's whole gathered view,
    rows that earlier requests left in its pages included."""
    return kv_layout == "paged" and any(s.kind == "moe"
                                        for s in lm.iter_sites(cfg))


def compare_schedules(args, scfg: ServeConfig, eng, out, fixed, fixed_out):
    """``--compare``: the continuous run ``eng``/``out`` against the same
    requests under the fixed schedule. Token-at-a-time decode must give the
    same tokens (every step runs all slots, so each row sees the same
    shapes); speculative rounds take other shapes under the other schedule,
    so there the tokens must agree on every decisive step
    (``decisive_prefix``). A MoE schedule over pages (``moe_over_pages``)
    prints the rids that differ and why instead of exiting. Returns the
    decode steps saved."""
    cont = eng.stats
    saved = fixed.stats.decode_steps - cont.decode_steps
    routed = moe_over_pages(eng.cfg, eng.ecfg.kv_layout)
    if eng.ecfg.speculate:
        same, total, n, bad = compare_spec(out, fixed, fixed_out)
        what = (f"tokens equal the fixed batch's on {n} decisive steps "
                f"({same} of {total} identical)")
        if bad and not routed:
            raise SystemExit(f"token mismatch vs fixed batch on a decisive "
                             f"step: rids {bad}")
    else:
        bad = [rid for rid, c in out.items()
               if fixed_out[rid].tokens != c.tokens]
        what = "token-identical with fixed batch"
        if bad and not routed:
            raise SystemExit(f"token mismatch vs fixed batch: rids {bad}")
    if bad:
        what = (f"tokens differ from the fixed batch's in rids {bad}: a MoE "
                "schedule over pages routes each append chunk's pad rows "
                "beside its tokens, and a pad row attends the rows earlier "
                "requests left in the slot's pages, so the tokens an "
                "expert's capacity drops depend on the pool's history (as "
                "in the reference's paged engine)")
    print(f"{what}; {saved} decode steps saved ({cont.decode_steps} vs "
          f"{fixed.stats.decode_steps})")
    if scfg.chip is not None:
        print(f"chip-table {scfg.chip_table}: calibrated prefill chunk "
              f"{eng.prefill_chunk} vs default {fixed.prefill_chunk} -- "
              "tokens identical, only the budget differs")
    if args.smoke and args.stagger and not eng.ecfg.speculate and saved <= 0:
        raise SystemExit("continuous batching saved no decode steps on a "
                         "staggered schedule")
    return saved


def serve_packed(args, scfg: ServeConfig, cfg, params, reqs, dev):
    """The packed path: ``--policy`` (or the demo policy) packed once and
    served; the gates of ``--smoke``, ``--compare`` and ``--check``."""
    from repro_torch.runtime.session import summarize

    policy = (MPQPolicy.load(scfg.policy_path) if scfg.policy_path
              else demo_mixed_policy(cfg))
    try:
        sess = build_session(cfg, params, policy, kv=scfg.kv,
                             speculate=scfg.speculate,
                             draft_bits=scfg.draft_bits)
    except ValueError as e:
        raise SystemExit(f"--policy / --draft-bits: {e}")
    streamer = make_streamer(args)
    eng, out = run_engine(None, cfg, None, sess.ctx, reqs, scfg=scfg,
                          device=dev, adapter=sess, speculate=scfg.speculate,
                          on_step=streamer.tick if streamer else None)
    res: Dict[str, Any] = dict(scfg=scfg, sess=sess, eng=eng, completions=out)
    res["calibration"] = measured_epoch(args, cfg, eng,
                                        f"quantized/{scfg.schedule}",
                                        streamer)
    st = eng.stats
    if eng.ecfg.kv_layout == "paged":
        print(f"paged KV: {eng.pool.n_pages} pages x {scfg.page_size} tokens "
              f"| {st.prefix_hit_tokens} prompt tokens from shared pages, "
              f"{st.prefill_flops_saved:.0f} prefill FLOPs saved | "
              f"{st.kv_unique_pages} pages in use | {st.prefill_compiles} "
              "prefill chunk shape(s)")
    s = summarize(sess)
    print(f"packed weights: {s['packed_bytes']} B (+{s['scale_bytes']} B "
          f"scales) vs policy accounting {s['policy_bytes']:.0f} B "
          f"(x{s['packed_vs_policy']:.3f}) on {dev} | kv={s['kv_quant']} "
          f"layout={eng.ecfg.kv_layout} decode-attn={eng.decode_attn_route}")
    if scfg.speculate:
        print(f"speculate k={scfg.speculate} draft_bits={scfg.draft_bits}: "
              f"{st.spec_rounds} rounds | drafted {st.spec_draft_tokens} "
              f"accepted {st.spec_accepted_tokens} (accept rate "
              f"{st.spec_accept_rate:.2f}) | draft pack {sess.draft_bytes()} B "
              f"on top of {s['packed_bytes']} B")
        if args.smoke:
            # the speculative gate: the same packed session through a
            # token-at-a-time engine; speculation may change the step count
            # and nothing else
            base, base_out = token_at_a_time(sess, cfg, reqs, eng)
            same, total, n, bad = compare_spec(out, base, base_out)
            if bad:
                raise SystemExit(
                    "speculative decode diverged from token-at-a-time "
                    f"packed decode on a decisive step: rids {bad}")
            print(f"speculative tokens equal token-at-a-time packed decode "
                  f"on {n} decisive steps ({same} of {total} tokens "
                  f"identical; {st.decode_steps} spec rounds vs "
                  f"{base.stats.decode_steps} decode steps)")
    print("generated[rid=0]:", out[0].tokens)
    if args.compare and scfg.schedule != "fixed":
        fixed, fixed_out = run_engine(None, cfg, None, sess.ctx, reqs,
                                      scfg=scfg, device=dev, adapter=sess,
                                      schedule="fixed", calibrated=False,
                                      speculate=scfg.speculate)
        print_stats("quantized/fixed", fixed)
        res.update(fixed=fixed, fixed_completions=fixed_out,
                   saved=compare_schedules(args, scfg, eng, out, fixed,
                                           fixed_out))
    elif args.compare:
        print("note: --compare has no effect with --schedule fixed "
              "(nothing to compare the fixed path against)")
    if args.check:
        # a MoE run over pages is held to the reference served over pages
        # under the same schedule: the pool's history decides which tokens
        # an expert drops (moe_over_pages)
        layout = ("paged" if moe_over_pages(cfg, scfg.kv_layout)
                  else "ring")
        n, bad, _ = check_greedy(cfg, params, policy, reqs, out, kv=scfg.kv,
                                 slots=scfg.slots,
                                 cache_len=scfg.resolved_cache_len,
                                 prefill_chunk=eng.prefill_chunk, device=dev,
                                 kv_layout=layout,
                                 page_size=scfg.page_size)
        if bad:
            raise SystemExit(f"packed runtime diverged from the fake-quant "
                             f"reference on decisive steps: rids {bad}")
        print(f"greedy tokens equal the fake-quant reference on {n} "
              "decisive steps")
    return res


def serve_elastic(args, scfg: ServeConfig, cfg, params, reqs, dev):
    """The ``--elastic`` path: a variant bank and the admission-time ILP
    re-solve.

    Builds an ``ElasticSession`` holding one pre-packed tree per
    ``--policy-variants`` budget (all searched over the same indicator
    banks, stamped with this weight set's ``bank_fingerprint``), hands the
    engine an ``ElasticController`` and serves the requests. With
    ``--smoke`` or ``--check`` the trace must reconcile and every completion
    must equal its variant's single-policy packed engine and its fake-quant
    reference (``check_elastic``). ``--smoke`` adds the reference's own
    gates: at least one downshift, every re-solve under 50 ms. A swap may
    change who serves the next request, never what an admitted request
    decodes. Returns what it served."""
    from repro_torch.launch import elastic as elastic_mod
    from repro_torch.runtime.session import ElasticSession, bank_fingerprint

    base = MPQPolicy.load(scfg.policy_path)
    ql = lm.enumerate_qlayers(cfg)
    try:
        base.validate(ql, bits=cfg.bits)
        bank = elastic_mod.build_variant_bank(
            ql, cfg.bits, scfg.variant_budgets,
            family=bank_fingerprint(params))
        sess = ElasticSession(cfg, params, bank.policies, make_context(cfg),
                              kv_quant=scfg.session_kv, active=bank.full)
    except ValueError as e:
        raise SystemExit(f"--elastic: {e}")
    ctrl = elastic_mod.ElasticController(
        cfg, bank, slots=scfg.slots, cache_len=scfg.resolved_cache_len,
        chip=scfg.chip)
    streamer = make_streamer(args)
    eng = DecodeEngine(sess.params, cfg, None, sess.ctx, adapter=sess,
                       device=dev, ecfg=scfg.engine_config(), elastic=ctrl)
    eng.on_step = streamer.tick if streamer else None
    eng.submit_all(reqs)
    out = eng.run()
    print_stats(f"elastic/{scfg.schedule}", eng)
    export_obs(args, eng)
    st = eng.stats
    per_variant: Dict[str, List[int]] = {}
    for c in out.values():
        per_variant.setdefault(c.policy_id, []).append(c.rid)
    budgets = ",".join(f"{b:g}" for b in scfg.variant_budgets)
    print(f"elastic bank [{budgets}] avg-bit budgets | {st.policy_swaps} "
          f"swap(s), {st.policy_swaps_down} down | {st.ilp_solves} "
          f"admission re-solves, max {ctrl.max_solve_ms:.1f} ms | held "
          f"{st.admissions_deferred_swap} round(s) for drains | final "
          f"variant {st.active_policy}")
    for pid in sorted(per_variant):
        print(f"  {pid}: {len(per_variant[pid])} request(s) "
              f"{sorted(per_variant[pid])}")
    res: Dict[str, Any] = dict(scfg=scfg, sess=sess, eng=eng, completions=out,
                               bank=bank, controller=ctrl,
                               per_variant=per_variant, params=params,
                               reqs=reqs)
    if args.smoke or args.check:
        check_trace(eng, "elastic")
    if args.smoke:
        if st.policy_swaps_down < 1:
            raise SystemExit(
                "elastic smoke: the traffic ramp triggered no downshift "
                "swap — the controller never traded precision for load")
        if ctrl.max_solve_ms >= 50.0:
            raise SystemExit(
                f"elastic smoke: admission-time ILP re-solve took "
                f"{ctrl.max_solve_ms:.1f} ms (>= 50 ms budget; the paper's "
                "~0.06 s one-shot search claim is load-bearing here)")
    if args.smoke or args.check:
        res["checks"] = check_elastic(res, dev)
    finish_stream(args, eng, streamer)
    return res


def replay_on_dequant_routes(res, dev):
    """The elastic run again, from its largest variant, over the same
    session and requests with the matmul and decode-attention routes
    forced to ``dequant-fp``: the fake-quant graph's own op chain, so its
    completions can be held to the fake-quant reference bit for bit (on
    the CPU that route is the one served). Swap decisions read the load,
    never the numerics: the replay must stamp every request with the same
    variant. Returns (engine, completions)."""
    from repro_torch.launch import elastic as elastic_mod

    eng, sess, bank, scfg = res["eng"], res["sess"], res["bank"], res["scfg"]
    sess.set_active(bank.full)
    ctrl = elastic_mod.ElasticController(
        eng.cfg, bank, slots=scfg.slots, cache_len=scfg.resolved_cache_len,
        chip=scfg.chip)
    replay = DecodeEngine(sess.params, eng.cfg, None, sess.ctx, adapter=sess,
                          device=dev, elastic=ctrl,
                          ecfg=dataclasses.replace(
                              eng.ecfg, prefill_chunk=eng.prefill_chunk))
    replay.submit_all(res["reqs"])
    with dispatch.force_route("matmul", "dequant-fp"), \
            dispatch.force_route("decode_attn", "dequant-fp"):
        out = replay.run()
    served = {rid: c.policy_id for rid, c in res["completions"].items()}
    if {rid: c.policy_id for rid, c in out.items()} != served:
        raise SystemExit("the elastic replay on the dequant-fp routes took "
                         "other swap decisions than the served run")
    return replay, out


def check_elastic(res, dev, reference: bool = True):
    """Hold an elastic run (``serve_elastic``'s result) to each variant, over
    the requests that variant served (gates, raising SystemExit):

    * its single-policy packed engine (the same layout, slots, cache and
      prefill chunk): every completion bit for bit;
    * its fake-quant reference engine: the run replayed on the dequant-fp
      routes (``replay_on_dequant_routes``) bit for bit, the reference
      package's own gate -- over the ring, and over pages on the CPU. On
      the card a paged prefill runs in append chunks, whose float GEMM
      shapes differ from the ring reference's whole-prompt prefill, so
      there even the dequant-fp op chain is not the reference's bits.

    Also compares the served tokens with the fake-quant reference on
    decisive steps (``check_greedy``'s float64 control), recorded and not
    gated: on the card the kernels' exact integer sums are a third float
    evaluation, which parts from the float32 and float64 references on
    near-ties (top-2 margins of a few hundredths). ``reference=False``
    skips the reference engines where they feed only that record (over
    pages on the card). Returns {variant: its rids, decisive steps
    compared, rids that parted on one (None without the reference)}."""
    from repro_torch.runtime.session import QuantizedSession

    cfg, params, eng, out = (res["eng"].cfg, res["params"], res["eng"],
                             res["completions"])
    scfg, bank = res["scfg"], res["bank"]
    exact = (eng.ecfg.kv_layout == "ring"
             or torch.device(dev).type == "cpu")
    dq_out = replay_on_dequant_routes(res, dev)[1] if exact else None
    ecfg = dataclasses.replace(eng.ecfg, prefill_chunk=eng.prefill_chunk)
    # the reference pads ring prompts as the served engine did (pages never)
    kw = dict(kv=scfg.kv, slots=scfg.slots, cache_len=scfg.resolved_cache_len,
              prefill_chunk=eng.prefill_chunk, device=dev,
              bucket_prompts=eng.ecfg.bucket_prompts
              and eng.ecfg.kv_layout != "paged")
    checks: Dict[str, Any] = {}
    for pid, rids in sorted(res["per_variant"].items()):
        sub = [r for r in res["reqs"] if r.rid in set(rids)]
        single = QuantizedSession(cfg, params, bank.policies[pid],
                                  make_context(cfg), kv_quant=scfg.session_kv)
        one = DecodeEngine(single.params, cfg, None, single.ctx,
                           adapter=single, device=dev, ecfg=ecfg)
        one.submit_all(sub)
        one_out = one.run()
        bad = [rid for rid in rids if one_out[rid].tokens != out[rid].tokens]
        if bad:
            raise SystemExit(
                f"elastic variant {pid} diverged from its single-policy "
                f"packed engine on rids {bad}")
        if not (reference or exact):
            checks[pid] = dict(rids=sorted(rids), decisive=None, parted=None)
            continue
        ref, ref_out = reference_engine(cfg, params, bank.policies[pid], sub,
                                        **kw)
        bad = [rid for rid in rids
               if dq_out and ref_out[rid].tokens != dq_out[rid].tokens]
        if bad:
            raise SystemExit(
                f"elastic variant {pid} on the dequant-fp routes differs "
                f"from its fake-quant reference on rids {bad}")
        ctrl, ctrl_out = reference_engine(cfg, params, bank.policies[pid],
                                          sub, compute_dtype=torch.float64,
                                          **kw)
        n, parted = compare_greedy({rid: out[rid] for rid in rids}, ref,
                                   ref_out, ctrl, ctrl_out)
        checks[pid] = dict(rids=sorted(rids), decisive=n, parted=parted)
    also = (" and on the dequant-fp routes with its fake-quant reference"
            if exact else "")
    print(f"per-variant tokens identical with each generating variant's "
          f"single-policy packed engine{also} ({len(out)} requests across "
          f"{len(checks)} variant(s)); served vs the reference on decisive "
          f"steps: " + "; ".join(
              f"{pid} {c['decisive']} compared, parted on rids {c['parted']}"
              for pid, c in checks.items()))
    return checks


def serve_fake_quant(args, scfg: ServeConfig, cfg, params, reqs, dev):
    """``--uniform-bits``: the fake-quant graph at uniform bits (fp KV), as
    the reference package serves without ``--policy``; with ``--compare``
    against the fixed schedule, then one int8 ``quant_matmul`` against its
    fake-quant value on the first layer's ``wq``."""
    from repro_torch.core.quantizer import bit_range

    ql = lm.enumerate_qlayers(cfg)
    policy = MPQPolicy.uniform(ql, args.uniform_bits)
    bits = lm.bits_from_policy(cfg, policy)
    ctx = make_context(cfg)
    streamer = make_streamer(args)
    eng, out = run_engine(params, cfg, bits, ctx, reqs, scfg=scfg, device=dev,
                          on_step=streamer.tick if streamer else None)
    res: Dict[str, Any] = dict(scfg=scfg, eng=eng, completions=out)
    res["calibration"] = measured_epoch(args, cfg, eng, scfg.schedule,
                                        streamer)
    r0 = out[0]
    print(f"generated[rid=0] ({r0.prompt_len}-token prompt):", r0.tokens)
    if args.compare and scfg.schedule != "fixed":
        fixed, fixed_out = run_engine(params, cfg, bits, ctx, reqs,
                                      scfg=scfg, device=dev,
                                      schedule="fixed", calibrated=False)
        print_stats("fixed", fixed)
        res.update(fixed=fixed, fixed_completions=fixed_out,
                   saved=compare_schedules(args, scfg, eng, out, fixed,
                                           fixed_out))
    elif args.compare:
        print("note: --compare has no effect with --schedule fixed "
              "(nothing to compare the fixed path against)")
    p0 = params.get("body", {}).get("0", {}).get("wq")
    if p0 is not None:
        w = p0["w"][0] if p0["w"].dim() == 3 else p0["w"]
        s_w = (p0["s_w"][0] if p0["s_w"].dim() == 2 else p0["s_w"])[2:3]
        qmin, qmax = bit_range(4, True)
        wq = torch.clamp(torch.round(w / s_w), qmin, qmax).to(torch.int8)
        gen = torch.Generator(device=dev).manual_seed(scfg.seed)
        x = torch.randn((8, w.shape[0]), generator=gen, device=dev)
        s_x = torch.full((1,), 0.05, device=dev)
        xq = torch.clamp(torch.round(x / s_x), qmin, qmax).to(torch.int8)
        kern = ops.quant_matmul(xq, wq, s_x, s_w)
        ref = (xq.float() * s_x) @ (wq.float() * s_w)
        res["int8_max_err"] = float((kern - ref).abs().max())
        print(f"int8 quant_matmul vs fake-quant ref: "
              f"max_err={res['int8_max_err']:.2e}")
    return res


def main(argv=None):
    """The serve CLI. Returns what it served (the ``ServeConfig``, the
    measured engine and its completions, the fixed-schedule engine under
    ``--compare``, the calibration report), or None after
    ``--write-demo-policy`` / ``--explain-policy``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config; implies "
                         "--compare and --stagger and caps the request set")
    ap.add_argument("--policy", default=None,
                    help="MPQPolicy json (default: demo_mixed_policy)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", "--batch", type=int, default=4, dest="slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=0, help="0 = prompt+gen")
    ap.add_argument("--schedule", default="continuous", choices=POLICIES)
    ap.add_argument("--stagger", action="store_true")
    ap.add_argument("--arrive-every", type=int, default=0,
                    help="space request arrivals this many iterations apart")
    ap.add_argument("--compare", action="store_true",
                    help="also serve under the fixed schedule and check the "
                         "tokens and the decode steps saved; gate the trace "
                         "and the roofline calibration")
    ap.add_argument("--kv", default="int8", choices=("int8", "fp"),
                    help="KV-cache storage")
    ap.add_argument("--kv-layout", default="ring",
                    choices=dispatch.ROUTES.routes("kv_layout"),
                    help="ring = per-slot ring buffers; paged = pooled "
                         "fixed-size int8 pages with shared-prefix remapping "
                         "and chunked append prefill (prompts then share "
                         "their first prompt-len // 2 tokens)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page (--kv-layout paged)")
    ap.add_argument("--decode-attn", default="auto",
                    choices=("auto",) + dispatch.ROUTES.routes("decode_attn"),
                    help="decode-attention route over the int8 KV cache: "
                         "auto = fused (the CUDA kernel) on the card, "
                         "dequant-fp on the CPU")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="self-speculative decoding: a uniform --draft-bits "
                         "repack of the same packed weights proposes K "
                         "tokens per round and the searched policy verifies "
                         "them in one multi-token pass (needs --policy or "
                         "--smoke, --kv int8)")
    ap.add_argument("--draft-bits", type=int, default=2,
                    help="weight bits of the draft pack (--speculate); one "
                         "of the arch's searched widths")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic precision serving: pack a bank of policy "
                         "variants (--policy-variants) and re-solve the ILP "
                         "at every admission round against the live load, "
                         "swapping the serving variant once the slots drain "
                         "(needs --policy, --kv int8, a continuous schedule)")
    ap.add_argument("--policy-variants", default="3,4,6", metavar="B,B,...",
                    help="average weight-bit budgets of the --elastic bank "
                         "(>= 2 distinct)")
    ap.add_argument("--no-bucket", action="store_true",
                    help="disable prompt-length bucketing (ring layout)")
    ap.add_argument("--chip-table", default=None, metavar="JSON",
                    help="measured device table (obs.calibrate's "
                         "device_table, bare or under a device_table key): "
                         "budget the engine with that ChipSpec instead of "
                         "the H100 envelope")
    ap.add_argument("--explain-policy", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="render the --policy's ILP audit trail "
                         "(SolveReport: per-layer importance, chosen bits, "
                         "bytes, binding constraint) as a table and exit; "
                         "a PATH argument also writes the report json")
    ap.add_argument("--metrics-stream", default=None, metavar="PATH",
                    help="append periodic JSONL metric snapshots while "
                         "serving (one {ts, seq, metrics} object per line); "
                         "a Prometheus text dump of the final registry "
                         "lands at PATH.prom")
    ap.add_argument("--metrics-interval", type=float, default=0.5,
                    help="seconds between --metrics-stream snapshots")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the request-lifecycle trace of the measured "
                         "run: .jsonl = one event per line, anything else = "
                         "Chrome trace JSON (chrome://tracing / Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the engine metrics-registry snapshot (json)")
    ap.add_argument("--no-trace", action="store_true",
                    help="record no request-lifecycle trace (the trace's "
                         "own cost is the difference)")
    ap.add_argument("--write-demo-policy", default=None, metavar="PATH",
                    help="write a mixed demo MPQPolicy json and exit")
    ap.add_argument("--uniform-bits", type=int, default=None, metavar="B",
                    help="serve the fake-quant graph at uniform B bits (fp "
                         "KV) instead of a packed policy")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (lm.init_params)")
    ap.add_argument("--check", action="store_true",
                    help="also run the fake-quant reference engine (float32 "
                         "and float64) and compare greedy tokens on decisive "
                         "steps (check_greedy)")
    args = ap.parse_args(argv)

    if args.write_demo_policy:
        # layer names depend on the config size: the policy is written for
        # the variant (--smoke or full) it will serve
        write_demo_policy(args.write_demo_policy, args.arch,
                          smoke=args.smoke)
        return None
    if args.explain_policy is not None:
        if not args.policy:
            raise SystemExit("--explain-policy needs --policy <json> (the "
                             "report explains a concrete bit assignment)")
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
        explain_policy(args, cfg)
        return None
    if args.smoke:
        if args.schedule == "fixed":
            raise SystemExit("--smoke needs a continuous schedule: its gate "
                             "compares the engine against the fixed path")
        args.compare = True
        args.stagger = True
        # the elastic smoke needs a queue deep enough to overload the
        # slots (that is what triggers a downshift)
        args.requests = min(args.requests, 12 if args.elastic else 6)
        args.prompt_len = min(args.prompt_len, 16)
        args.gen = min(args.gen, 8)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    try:
        lm.check_decodes(cfg)
        scfg = ServeConfig.from_args(args)
        check_kv_layout(cfg, scfg.kv_layout)
        check_spec(cfg, scfg.speculate, scfg.draft_bits, kv=scfg.kv,
                   policy_given=bool(args.policy) or args.smoke)
        if args.uniform_bits is not None and (args.policy or scfg.speculate
                                              or scfg.elastic):
            raise ValueError("--uniform-bits serves the fake-quant graph: "
                             "it takes neither --policy, --speculate nor "
                             "--elastic")
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))

    dev = resolve_device(args.device)
    params = lm.init_params(cfg, seed=scfg.seed, device=dev)
    # paged serving shares half the prompt across requests, so the run
    # exercises prefix remapping and not only the page pool
    share = scfg.prompt_len // 2 if scfg.kv_layout == "paged" else 0
    reqs = build_requests(SyntheticLM(cfg), scfg.requests, scfg.prompt_len,
                          scfg.gen, stagger=scfg.stagger,
                          arrive_every=scfg.arrive_every, share_prefix=share)
    forced = None if scfg.decode_attn == "auto" else scfg.decode_attn
    with dispatch.force_route("decode_attn", forced):
        if args.uniform_bits is not None:
            return serve_fake_quant(args, scfg, cfg, params, reqs, dev)
        if scfg.elastic:
            return serve_elastic(args, scfg, cfg, params, reqs, dev)
        return serve_packed(args, scfg, cfg, params, reqs, dev)


if __name__ == "__main__":
    main()
