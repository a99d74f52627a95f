"""Serving driver: a searched mixed-precision policy, packed into a
``runtime.session.QuantizedSession``, served through the continuous-batching
engine (``launch.engine``) with greedy decode, over an int8 (or fp) ring KV
cache or, with ``--kv-layout paged``, pooled int8 pages with shared-prefix
reuse and chunked append prefill. ``--speculate K`` decodes
self-speculatively: a uniform ``--draft-bits`` repack of the same weights
proposes K tokens per round and the searched policy verifies them in one
multi-token pass (greedy only, int8 KV, either layout).

The weights are the port's seeded random initialisation (no checkpoint of a
published model ships with the repository); the policy is a searched
``MPQPolicy`` json, e.g. one the reference package wrote with ``serve
--write-demo-policy``, or ``demo_mixed_policy`` when none is given.

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device and without ``--device cpu`` it raises rather than run on the CPU.

Examples:
  python -m repro_torch.launch.serve --requests 8 --slots 4 \
      --prompt-len 256 --gen 32 --cache-len 320
  python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu
  python -m repro_torch.launch.serve --smoke --device cpu --kv-layout paged \
      --check --stagger
  python -m repro_torch.launch.serve --policy searched.json --check
  python -m repro_torch.launch.serve --smoke --device cpu --speculate 4 \
      --draft-bits 2
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.policy import MPQPolicy
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.engine import DecodeEngine, EngineConfig, \
    check_kv_layout, check_speculate, decisive_prefix
from repro_torch.launch.scheduler import Request
from repro_torch.models import lm
from repro_torch.models.quant_layers import QuantContext
from repro_torch.runtime import dispatch


# prefill tokens the scheduler grants per iteration (the reference derives
# it from its TPU roofline model, which the port does not have yet)
PREFILL_CHUNK = 128


def resolve_device(name: Optional[str]) -> torch.device:
    """``cuda`` unless the caller asks for ``cpu``; no quiet CPU fallback."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain versions on the CPU")
    return dev


def build_requests(data, n, prompt_len, gen, *, stagger=False,
                   share_prefix=0) -> List[Request]:
    """A deterministic request set from the synthetic corpus; ``stagger``
    varies prompt/generation lengths across requests; ``share_prefix``
    overwrites the first that many tokens of every prompt with request 0's
    (the shared-system-prompt traffic the paged layout's prefix reuse
    serves)."""
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
        reqs.append(Request(rid=i, tokens=toks, max_new=g))
    return reqs


def demo_mixed_policy(cfg, meta=None) -> MPQPolicy:
    """A mixed MPQPolicy cycling the searched widths over the arch's QLayer
    table -- a deterministic stand-in for an ILP search result (the same
    assignment as the reference's ``demo_mixed_policy``)."""
    ql = lm.enumerate_qlayers(cfg)
    bits = sorted(int(b) for b in cfg.bits)
    n = len(bits)
    return MPQPolicy(
        {q.name: bits[i % n] for i, q in enumerate(ql)},
        {q.name: bits[(i + 1) % n] for i, q in enumerate(ql)},
        meta=dict(meta or {}, kind="demo-mixed", arch=cfg.name))


def make_context(cfg) -> QuantContext:
    return QuantContext.make(cfg.bits, cfg.quant_act_signed,
                             compute_dtype=torch.float32)


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


def serve_quantized(cfg, params, policy: MPQPolicy, reqs, *, slots: int,
                    cache_len: int, prefill_chunk: int, device=None,
                    kv: str = "int8", kv_layout: str = "ring",
                    page_size: int = 8, speculate: int = 0,
                    draft_bits: int = 2):
    """Pack ``policy`` into a ``QuantizedSession`` (a ``SpecSession`` with
    its ``draft_bits`` draft pack when ``speculate`` > 0) and serve
    ``reqs`` through the engine over a ``kv`` ring KV cache or the paged
    int8 layout. Returns (session, engine, completions)."""
    from repro_torch.runtime.session import QuantizedSession, SpecSession
    check_kv(kv, kv_layout)
    check_spec(cfg, speculate, draft_bits, kv=kv)
    kv_quant = "int8" if kv == "int8" else "none"
    if speculate:
        sess = SpecSession(cfg, params, policy, make_context(cfg),
                           kv_quant=kv_quant, draft_w_bits=draft_bits)
    else:
        sess = QuantizedSession(cfg, params, policy, make_context(cfg),
                                kv_quant=kv_quant)
    eng = DecodeEngine(sess.params, cfg, None, sess.ctx, adapter=sess,
                       device=device,
                       ecfg=EngineConfig(slots=slots, cache_len=cache_len,
                                         prefill_chunk=prefill_chunk,
                                         kv_quant=kv_quant,
                                         kv_layout=kv_layout,
                                         page_size=page_size,
                                         speculate=speculate))
    eng.submit_all(reqs)
    return sess, eng, eng.run()


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
                     cache_len: int, prefill_chunk: int, device=None,
                     compute_dtype=torch.float32, kv: str = "int8"):
    """The fake-quant graph (``LMAdapter``) through the same engine (ring
    layout), with int8 KV slots referenced as quantize-dequantize in fp
    (``kv="fp"``: plain fp rows); ``compute_dtype`` float64 evaluates the
    same graph at higher precision (the control). On the card it runs the
    kernels' plain versions (``ops.plain_on_cuda``): a reference computes
    in plain PyTorch, and the float64 control reaches ``wkv``, whose kernel
    takes float32 only."""
    ctx = dataclasses.replace(make_context(cfg), compute_dtype=compute_dtype)
    eng = DecodeEngine(params, cfg, lm.bits_from_policy(cfg, policy), ctx,
                       device=device,
                       ecfg=EngineConfig(slots=slots, cache_len=cache_len,
                                         prefill_chunk=prefill_chunk,
                                         kv_quant="fake" if kv == "int8"
                                         else "none"))
    eng.submit_all(reqs)
    with ops.plain_on_cuda(*ops.PLAIN_KERNELS):
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
    d = eng.stats.as_dict()
    keys = ("decode_steps", "prefill_calls", "prefill_tokens",
            "tokens_generated",
            "prefill_p50_ms", "decode_step_p50_ms", "decode_tokens_per_s",
            "decode_attn_route", "act_quant_reused")
    print(f"[{label}] " + " ".join(
        f"{k}={d[k]:.4g}" if isinstance(d.get(k), float) else f"{k}={d.get(k)}"
        for k in keys if k in d))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--policy", default=None,
                    help="MPQPolicy json (default: demo_mixed_policy)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=0, help="0 = prompt+gen")
    ap.add_argument("--stagger", action="store_true")
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
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="self-speculative decoding: a uniform --draft-bits "
                         "repack of the same packed weights proposes K "
                         "tokens per round and the searched policy verifies "
                         "them in one multi-token pass (needs --policy or "
                         "--smoke, --kv int8)")
    ap.add_argument("--draft-bits", type=int, default=2,
                    help="weight bits of the draft pack (--speculate); one "
                         "of the arch's searched widths")
    ap.add_argument("--check", action="store_true",
                    help="also run the fake-quant reference engine (float32 "
                         "and float64) and compare greedy tokens on decisive "
                         "steps (check_greedy)")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    try:
        check_kv(args.kv, args.kv_layout)
        check_kv_layout(cfg, args.kv_layout)
        check_spec(cfg, args.speculate, args.draft_bits, kv=args.kv,
                   policy_given=bool(args.policy) or args.smoke)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))

    dev = resolve_device(args.device)
    policy = (MPQPolicy.load(args.policy) if args.policy
              else demo_mixed_policy(cfg))
    params = lm.init_params(cfg, seed=0, device=dev)
    # paged serving shares half the prompt across requests, so the run
    # exercises prefix remapping and not only the page pool
    share = args.prompt_len // 2 if args.kv_layout == "paged" else 0
    reqs = build_requests(SyntheticLM(cfg), args.requests, args.prompt_len,
                          args.gen, stagger=args.stagger, share_prefix=share)
    cache_len = args.cache_len or (args.prompt_len + args.gen)
    kw = dict(slots=args.slots, cache_len=cache_len,
              prefill_chunk=PREFILL_CHUNK, device=dev)
    sess, eng, out = serve_quantized(cfg, params, policy, reqs, kv=args.kv,
                                     kv_layout=args.kv_layout,
                                     page_size=args.page_size,
                                     speculate=args.speculate,
                                     draft_bits=args.draft_bits, **kw)
    print_stats("quantized", eng)
    if args.kv_layout == "paged":
        st = eng.stats
        print(f"paged KV: {eng.pool.n_pages} pages x {args.page_size} tokens "
              f"| {st.prefix_hit_tokens} prompt tokens from shared pages, "
              f"{st.prefill_flops_saved:.0f} prefill FLOPs saved | "
              f"{st.kv_unique_pages} pages in use | {st.prefill_compiles} "
              "prefill chunk shape(s)")
    from repro_torch.runtime.session import summarize
    s = summarize(sess)
    print(f"packed weights: {s['packed_bytes']} B (+{s['scale_bytes']} B "
          f"scales) vs policy accounting {s['policy_bytes']:.0f} B "
          f"(x{s['packed_vs_policy']:.3f}) on {dev}")
    if args.speculate:
        st = eng.stats
        print(f"speculate k={args.speculate} draft_bits={args.draft_bits}: "
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
    if args.check:
        n, bad, _ = check_greedy(cfg, params, policy, reqs, out, kv=args.kv,
                                 **kw)
        if bad:
            raise SystemExit(f"packed runtime diverged from the fake-quant "
                             f"reference on decisive steps: rids {bad}")
        print(f"greedy tokens equal the fake-quant reference on {n} "
              "decisive steps")


if __name__ == "__main__":
    main()
