#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

In order:

1. print the card (``nvidia-smi`` name and power limit) and build every
   CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   at once);
2. kernel phases: hold each kernel against its plain PyTorch version on the
   card at the serving path's Qwen3-0.6B shapes -- both int8 matmuls bit
   for bit (atol 0), int8 decode attention to rtol 2e-5 / atol 2e-6 -- and
   time kernel, plain version and, where one PyTorch call computes the same
   function, that call (CUDA-event medians, L2 flushed before each launch);
3. serve phase: Qwen3-0.6B at full width (28 layers, seeded random
   weights) under ``demo_mixed_policy`` (w-bits cycle 2..6, so both matmul
   kernels serve), 8 requests with staggered 128-256-token prompts and 32
   new tokens over 4 slots, int8 ring KV cache of 320 rows, continuous
   batching, greedy. Gates: (a) every kernel launched during serving and no
   kernel-eligible projection fell through to dequant-fp; (b) greedy tokens
   equal the fake-quant reference engine's on every decisive step -- the
   reference's top-2 margin > 1e-2 and its float64 evaluation agreeing
   (``serve.check_greedy``); a request's comparison stops at its first
   non-decisive step; (c) packed weight bytes within 5% of
   ``MPQPolicy.size_bytes``.

Any failure exits non-zero. The line before the last is a JSON object with
one entry per kernel; the last is ``{"ok": true, "device": {...}}``. The
per-case numbers also go to ``chiprun_out/chip_smoke.json``.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and int8 / f32 rates
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12

# (K, N) of the Qwen3-0.6B projections: wq, wk/wv, wo, mlp_wi/wg, mlp_wo
QWEN3_KN = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
            (3072, 1024)]
MAIN_KN = (1024, 3072)      # the summary row of each matmul: a decode GEMV
MAIN_SC = 320               # the summary row of decode attention: the serve ring
PROMPTS = [256, 128, 224, 160, 192, 144, 240, 176]
GEN, SLOTS, CACHE_LEN, PREFILL_CHUNK = 32, 4, 320, 256

SOURCES = {
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:117"),
    "quant_matmul_w4": ("src/repro_torch/csrc/quant_matmul.cu",
                        "src/repro/kernels/quant_matmul.py:72"),
    "decode_attn_quant": ("src/repro_torch/csrc/decode_attn_quant.cu",
                          "src/repro/kernels/quant_attention.py:97"),
}


class GateError(RuntimeError):
    pass


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise GateError(what)


def cuda_ms(torch, fn, flush, reps: int = 40, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after an L2
    flush (the serving path reads every weight cold)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def matmul_phase(torch, ops, ref, flush, dev):
    rows = []
    for w4 in (False, True):
        name = "quant_matmul_w4" if w4 else "quant_matmul"
        for M in (4, 128):
            for K, N in QWEN3_KN:
                g = torch.Generator(device=dev).manual_seed(K * 31 + N + M)
                x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                                  dtype=torch.int8)
                if w4:
                    w = torch.randint(0, 256, (K // 2, N), generator=g,
                                      device=dev, dtype=torch.uint8)
                else:
                    w = torch.randint(-128, 128, (K, N), generator=g,
                                      device=dev, dtype=torch.int8)
                s_x = torch.tensor(0.0173, device=dev)
                s_w = torch.tensor([0.0391], device=dev)
                kern = ops.quant_matmul_w4 if w4 else ops.quant_matmul
                plain = ref.quant_matmul_w4_ref if w4 else ref.quant_matmul_ref
                out = kern(x, w, s_x, s_w)
                want = plain(x, w, s_x, s_w)
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                gate(torch.equal(out, want),
                     f"{name} M={M} K={K} N={N} differs from its plain "
                     f"version (max |err| {err})")
                lib_ms = None
                if not w4:
                    # torch._int_mm takes M > 16 only: the decode shape is
                    # timed with x zero-padded to 32 rows
                    xm = x if M > 16 else torch.cat(
                        [x, x.new_zeros((32 - M, K))])
                    lib_ms = cuda_ms(torch, lambda: torch._int_mm(xm, w), flush)
                n_bytes = M * K + w.numel() + 8 + M * N * 4
                b_ms, b_by = bound_ms(n_bytes, 2.0 * M * K * N, INT8_OPS_PER_S)
                rows.append(dict(
                    name=name, shape=f"M={M} K={K} N={N}", max_abs_err=err,
                    ms=cuda_ms(torch, lambda: kern(x, w, s_x, s_w), flush),
                    plain_ms=cuda_ms(torch, lambda: plain(x, w, s_x, s_w),
                                     flush),
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    main=(M == 4 and (K, N) == MAIN_KN)))
                print(f"[kernel] {name:16s} M={M:<3d} K={K:<4d} N={N:<4d} "
                      f"err={err:.1e} ms={rows[-1]['ms']:.4f} "
                      f"plain={rows[-1]['plain_ms']:.4f} "
                      f"lib={lib_ms if lib_ms is None else round(lib_ms, 4)} "
                      f"bound={b_ms:.4f}({b_by})", flush=True)
    return rows


def attn_phase(torch, ops, ref, flush, dev):
    import torch.nn.functional as F
    rows = []
    B, KV, G, hd = 4, 8, 2, 128
    H = KV * G
    for Sc in (320, 4096):
        r = np.random.default_rng(Sc)
        q_pos = np.array([Sc + 37, Sc - 1, Sc // 2, 3 * Sc], np.int32)
        pos = np.full((B, Sc), -1, np.int32)
        for b in range(B):                     # wrapped ring: slot t % Sc
            for t in range(max(0, q_pos[b] + 1 - Sc), q_pos[b] + 1):
                pos[b, t % Sc] = t
        pos[1, r.integers(0, Sc, Sc // 5)] = -1          # evicted slots
        g = torch.Generator(device=dev).manual_seed(Sc)
        kc = torch.randint(-127, 128, (B, Sc, KV, hd), generator=g,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-127, 128, (B, Sc, KV, hd), generator=g,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((B, Sc, KV), generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand((B, Sc, KV), generator=g, device=dev) * 0.02 + 1e-3
        q = torch.randn((B, 1, H, hd), generator=g, device=dev)
        pos_t = torch.from_numpy(pos).to(dev)
        qp = torch.from_numpy(q_pos).to(dev)
        args = (q, kc, ks, vc, vs, pos_t, qp)
        out = ops.decode_attn_quant(*args)

        def plain():
            qf = q.reshape(B, KV, G, hd) * (hd ** -0.5)
            return ref.decode_attn_quant_ref(qf, kc, ks, vc, vs, pos_t, qp)

        want = plain().reshape(out.shape)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        gate(bool(torch.allclose(out, want, rtol=2e-5, atol=2e-6)),
             f"decode_attn_quant Sc={Sc} differs from its plain version "
             f"(max |err| {err})")
        # yardstick: SDPA on the dequantized cache under the same mask
        kd = (kc.float() * ks[..., None]).permute(0, 2, 1, 3).contiguous()
        vd = (vc.float() * vs[..., None]).permute(0, 2, 1, 3).contiguous()
        mask = ((pos_t >= 0) & (pos_t <= qp[:, None]))[:, None, None, :]
        qh = q.permute(0, 2, 1, 3).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask,
                                                  enable_gqa=True)

        lib = sdpa().permute(0, 2, 1, 3)
        gate(bool(torch.allclose(lib, out, rtol=1e-3, atol=1e-4)),
             "SDPA yardstick disagrees with the kernel")
        n_bytes = (2 * B * Sc * KV * hd + 2 * B * Sc * KV * 4 + B * Sc * 4
                   + B * H * hd * 4 + B * 4 + B * H * hd * 4)
        b_ms, b_by = bound_ms(n_bytes, 4.0 * B * H * Sc * hd, F32_OPS_PER_S)
        rows.append(dict(
            name="decode_attn_quant", shape=f"B={B} Sc={Sc} KV={KV} G={G} "
            f"hd={hd}", max_abs_err=err,
            ms=cuda_ms(torch, lambda: ops.decode_attn_quant(*args), flush),
            plain_ms=cuda_ms(torch, plain, flush),
            library_ms=cuda_ms(torch, sdpa, flush), bound_ms=b_ms,
            bound_by=b_by, main=Sc == MAIN_SC))
        print(f"[kernel] decode_attn_quant Sc={Sc:<5d} err={err:.1e} "
              f"ms={rows[-1]['ms']:.4f} plain={rows[-1]['plain_ms']:.4f} "
              f"sdpa={rows[-1]['library_ms']:.4f} bound={b_ms:.4f}({b_by})",
              flush=True)
    return rows


def prefill_noise(torch, cfg, params, policy, sess, reqs, dev):
    """Max |logit difference| over the vocabulary at prefill, per prompt:
    served path vs the float32 fake-quant reference, and that reference vs
    its float64 evaluation."""
    import dataclasses
    from repro_torch.launch import serve
    from repro_torch.launch.engine import LMAdapter
    from repro_torch.models import lm
    bits = lm.bits_from_policy(cfg, policy)
    ctx = dataclasses.replace(serve.make_context(cfg), kv_quant="fake")
    r32 = LMAdapter(cfg, bits, ctx)
    r64 = LMAdapter(cfg, bits, dataclasses.replace(
        ctx, compute_dtype=torch.float64))
    rows = []
    for r in reqs:
        t = torch.as_tensor(r.tokens, device=dev)[None]
        lk, _ = sess.prefill(sess.params, t, prefill_cap=CACHE_LEN)
        l32, _ = r32.prefill(params, t, prefill_cap=CACHE_LEN)
        l64, _ = r64.prefill(params, t, prefill_cap=CACHE_LEN)
        rows.append(dict(
            rid=r.rid, served_vs_ref32=float((lk - l32).abs().max()),
            ref32_vs_ref64=float((l32 - l64.float()).abs().max()),
            logit_std=float(l32.std())))
    print("[serve] prefill max|logit diff| served-vs-ref32 / ref32-vs-ref64: "
          + " ".join(f"{x['served_vs_ref32']:.3f}/{x['ref32_vs_ref64']:.3f}"
                     for x in rows)
          + f" (logit std {rows[0]['logit_std']:.3f})", flush=True)
    return rows


def profile_decode_step(torch, sess, dev):
    """One decode step of the served model (4 slots) under torch.profiler:
    kernel launches, host time and device time."""
    from torch.profiler import ProfilerActivity, profile
    st = sess.init_state(SLOTS, CACHE_LEN, torch.float32, device=dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(SLOTS, dtype=torch.int32, device=dev) + 200
    for _ in range(2):
        sess.decode(sess.params, tok, pos, st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.decode(sess.params, tok, pos, st)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) for e in ev)
    res = dict(wall_ms=wall, kernel_launches=launches,
               device_ms=dev_us / 1e3 if dev_us else None)
    print(f"[serve] one decode step under the profiler: {wall:.1f} ms wall, "
          f"{launches} kernel launches, device busy "
          + (f"{res['device_ms']:.1f} ms ({res['device_ms'] / wall:.0%})"
             if dev_us else "not measured"), flush=True)
    return res


def serve_phase(torch, ops, dev):
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.launch.scheduler import Request
    from repro_torch.models import lm
    from repro_torch.runtime.session import summarize

    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    policy = serve.demo_mixed_policy(cfg)
    data = SyntheticLM(cfg)
    reqs = [Request(rid=i, tokens=data.batch(i, 1, p)["tokens"][0],
                    max_new=GEN) for i, p in enumerate(PROMPTS)]
    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, prefill_chunk=PREFILL_CHUNK,
              device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"vocab={cfg.vocab}, init {time.perf_counter() - t0:.1f}s",
          flush=True)
    # warm-up (library loads, allocator, cuBLAS handles): one short request
    serve.serve_quantized(cfg, params, policy, reqs[:1], **dict(
        kw, slots=1))

    ops.reset_launches()                         # counts: the main path only
    t0 = time.perf_counter()
    sess, eng, out = serve.serve_quantized(cfg, params, policy, reqs, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = eng.stats
    d = st.as_dict()
    print(f"[serve] {len(out)} requests in {wall:.2f}s wall (packing "
          f"included): prefill p50 {d['prefill_p50_ms']:.2f} ms, decode step "
          f"p50 {d['decode_step_p50_ms']:.2f} ms, decode "
          f"{st.decode_tokens_per_s:.1f} tok/s ({st.decode_steps} steps, "
          f"{st.tokens_generated} tokens)", flush=True)
    print(f"[serve] launches {launches}; routes {sess.route_counts.routes}",
          flush=True)

    # (a) the path went through every kernel, none fell back to dequant-fp
    gate(all(n > 0 for n in launches.values()),
         f"a kernel was never launched while serving: {launches}")
    gate(sess.route_counts.eligible_fp == 0,
         f"{sess.route_counts.eligible_fp} kernel-eligible matmuls ran "
         "dequant-fp")
    gate(set(sess.route_counts.routes["decode_attn"]) == {"fused"},
         f"decode attention routes {sess.route_counts.routes['decode_attn']}")
    # output shape/range sanity
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == GEN and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    # (b) greedy tokens vs the fake-quant reference engine on decisive steps
    # (serve.check_greedy: the float32 reference confident and agreeing with
    # its own float64 evaluation)
    compared, bad, unstable = serve.check_greedy(cfg, params, policy, reqs,
                                                 out, **kw)
    n_tok = sum(len(c.tokens) for c in out.values())
    print(f"[serve] greedy tokens vs fake-quant reference: {compared} of "
          f"{n_tok} steps decisive and compared, diverged rids {bad}; the "
          f"reference's float32 and float64 evaluations part on a confident "
          f"step in rids {unstable}", flush=True)
    gate(not bad, f"greedy tokens diverged on decisive steps: rids {bad}")
    gate(compared > 0, "no decisive step to compare")
    # how far two correct float evaluations of one graph part: max |logit
    # difference| at prefill on identical prompts (no gate; see check_greedy)
    noise = prefill_noise(torch, cfg, params, policy, sess, reqs, dev)
    # (c) packed bytes vs the policy's accounting
    s = summarize(sess)
    print(f"[serve] packed weights {s['packed_bytes']} B vs policy "
          f"{s['policy_bytes']:.0f} B (x{s['packed_vs_policy']:.4f})",
          flush=True)
    gate(abs(s["packed_vs_policy"] - 1.0) <= 0.05,
         f"packed bytes off the policy accounting by x{s['packed_vs_policy']}")
    step = profile_decode_step(torch, sess, dev)
    return launches, dict(
        prefill_noise=noise, decode_step_profile=step, wall_s=wall,
        prefill_p50_ms=d["prefill_p50_ms"],
        decode_step_p50_ms=d["decode_step_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps, tokens=st.tokens_generated,
        decisive_compared=compared, reference_unstable_rids=unstable,
        packed_bytes=s["packed_bytes"],
        policy_bytes=s["policy_bytes"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.SYMBOLS)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = matmul_phase(torch, ops, ref, flush, dev)
    rows += attn_phase(torch, ops, ref, flush, dev)
    del flush
    launches, serve_res = serve_phase(torch, ops, dev)

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name]
        main_row = next(r for r in mine if r["main"])
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"]))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "cases": rows, "serve": serve_res,
         "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except GateError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
