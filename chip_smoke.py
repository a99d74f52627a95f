#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

In order:

1. print the card (``nvidia-smi`` name and power limit) and build every
   CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   at once);
2. kernel phases: hold each kernel against its plain PyTorch version on the
   card at the main paths' Qwen3-0.6B shapes -- both int8 matmuls,
   fake-quant forward and its dv bit for bit (atol 0), the fake-quant ds
   to rtol 1e-4 of |ds| plus 1e-6 of sum |g * dsd| (float32 sums in
   another order, over up to 155M terms), int8 decode attention to rtol
   2e-5 / atol 2e-6, flash forward to 2e-5 (out) / 1e-5 (lse) -- and time
   kernel, plain version and, where one PyTorch call computes the same
   function, that call (CUDA-event medians, L2 flushed before each launch);
3. train phase: the paper pipeline on Qwen3-0.6B at full width and depth
   (28 layers, seeded random weights), B=1, S=2048, float32: 2 joint
   importance steps (5 uniform + 1 random pass, SGD on the banks only),
   indicator extraction, the ILP search under the uniform-3-bit BitOps
   budget, 3 QAT steps under the searched policy (AdamW 3e-3, clip 1.0), an
   evaluation batch. Gates: (a) fake-quant forward / backward and flash
   launches exactly as the schedule implies (per pass 394 / 394 / 28);
   (b) every loss and gradient norm finite; (c) the backbone bit for bit
   unchanged by the importance steps, every bank moved; (d) the searched
   policy valid and within its budget;
4. serve phase: Qwen3-0.6B at full width (28 layers, seeded random
   weights) under ``demo_mixed_policy`` (w-bits cycle 2..6, so both matmul
   kernels serve), 8 requests with staggered 128-256-token prompts and 32
   new tokens over 4 slots, int8 ring KV cache of 320 rows, continuous
   batching, greedy. Gates: (a) every serving kernel launched and no
   kernel-eligible projection fell through to dequant-fp; (b) greedy tokens
   equal the fake-quant reference engine's on every decisive step -- the
   reference's top-2 margin > 1e-2 and its float64 evaluation agreeing
   (``serve.check_greedy``); a request's comparison stops at its first
   non-decisive step; (c) packed weight bytes within 5% of
   ``MPQPolicy.size_bytes``. The reference engine runs the plain versions
   (``ops.plain_on_cuda()``), so its fake-quant is plain PyTorch;
5. train gate (e): one ``loss_fn`` + backward at full width, 2 layers, S =
   2048, through the kernels and through their plain versions
   (``ops.plain_on_cuda``), loss and every gradient within ``TRAIN_TOL``:
   once with activations unquantized, every kernel against its plain
   version; once with them quantized, the fake-quant kernels against their
   plain versions and the flash kernel on both sides, so that every
   quantizer code is the same on both sides; the full-depth differences
   with every kernel against its plain version are printed, not gated.

Any failure exits non-zero. The line before the last is a JSON object with
one entry per kernel; the last is ``{"ok": true, "device": {...}}``. The
per-case numbers also go to ``chiprun_out/chip_smoke.json``.
"""
import json
import math
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
    "fake_quant_fwd": ("src/repro_torch/csrc/fake_quant.cu",
                       "src/repro/kernels/fake_quant.py:51"),
    "fake_quant_bwd": ("src/repro_torch/csrc/fake_quant.cu",
                       "src/repro/kernels/fake_quant.py:73"),
    "flash_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:76"),
}
SERVE_KERNELS = ("quant_matmul", "quant_matmul_w4", "decode_attn_quant")
TRAIN_KERNELS = ("fake_quant_fwd", "fake_quant_bwd", "flash_fwd")

# fake-quant: Qwen3-0.6B's (1024, 3072)/(3072, 1024) weights, the (2048,
# 3072) MLP activation at B*S = 2048, the tied (151936, 1024) table, and a
# ragged shape; summary row: the activation at 4 bits
FQ_SHAPES = [(1024, 3072), (3072, 1024), (2048, 3072), (151936, 1024),
             (37, 1000)]
FQ_BITS = (2, 4, 6, 8)
FQ_MAIN = ((2048, 3072), 4)
# flash: (S, causal, window); summary row S=2048 causal
FLASH_CASES = [(2048, True, None), (4096, True, None), (2048, True, 512),
               (2048, False, None)]
FLASH_MAIN = (2048, True, None)
TRAIN_S, IMP_STEPS, QAT_STEPS = 2048, 2, 3
SPIN_CYCLES = 2_000_000         # ~1 ms of torch.cuda._sleep at H100 clocks
# gate (e), kernels vs plain versions through one loss_fn + backward at 2
# layers: loss rtol, and per-gradient-leaf relative L2, the reference's ds
# rtol 1e-3 (tests/test_kernels.py:55). It holds only while every quantizer
# code is the same on both sides: a last-bit difference in the flash output
# that lands an activation on the other side of a half-integer of a 2-6-bit
# grid moves the gradients by a few percent. So the flash kernel runs on
# both sides of the pass with activations quantized
TRAIN_TOL = dict(loss_rtol=1e-5, grad_rel=1e-3)


class GateError(RuntimeError):
    pass


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise GateError(what)


def cuda_ms(torch, fn, flush, reps: int = 40, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after an L2
    flush (the serving path reads every weight cold). A spin kernel of
    ~1 ms ahead of each launch lets the host queue the flush, the events and
    ``fn``'s kernels before the device reaches them, so the events time the
    device's work and not the host's launch latency."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sync_ms(torch, t0: float) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


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


def _ds_terms_abs(torch, v, s, g, qmin, qmax):
    """sum |g * dsd| of the LSQ ds sum: the scale of its float32 rounding."""
    vs = v / torch.clamp(s, min=1e-9)
    inside = (vs > qmin) & (vs < qmax)
    c = torch.clamp(vs, qmin, qmax)
    return float((g * torch.where(inside, torch.round(c) - vs, c)).abs()
                 .double().sum())


def fake_quant_phase(torch, ops, ref, flush, dev):
    rows = []
    for shape in FQ_SHAPES:
        g_ = torch.Generator(device=dev).manual_seed(shape[0] * 7 + shape[1])
        v = torch.randn(shape, generator=g_, device=dev) * 0.05
        g = torch.randn(shape, generator=g_, device=dev)
        for bits in FQ_BITS:
            qmin, qmax = float(-2 ** (bits - 1)), float(2 ** (bits - 1) - 1)
            s = (2 * v.abs().mean() / qmax ** 0.5).reshape(1)  # LSQ init
            out = ops.fake_quant_fwd(v, s, qmin, qmax)
            want = ref.fake_quant_ref(v, s.reshape(()), qmin, qmax)
            dv, ds = ops.fake_quant_bwd(v, s, g, qmin, qmax)
            dv_p, ds_p = ref.fake_quant_grads_ref(v, s.reshape(()), g, qmin,
                                                  qmax)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            gate(torch.equal(out, want), f"fake_quant_fwd {shape} {bits}b "
                 f"differs from its plain version (max |err| {err})")
            gate(torch.equal(dv, dv_p), f"fake_quant_bwd {shape} {bits}b: dv "
                 f"differs (max |err| {float((dv - dv_p).abs().max())})")
            ds_err = abs(float(ds) - float(ds_p))
            ds_tol = (1e-4 * abs(float(ds_p))
                      + 1e-6 * _ds_terms_abs(torch, v, s, g, qmin, qmax))
            gate(ds_err <= ds_tol, f"fake_quant_bwd {shape} {bits}b: ds "
                 f"{float(ds)} vs plain {float(ds_p)} (tol {ds_tol})")
            main = (shape, bits) == FQ_MAIN
            if bits != 4:
                rows.append(dict(name="fake_quant_fwd", shape=f"{shape} {bits}b",
                                 max_abs_err=err, main=False))
                rows.append(dict(name="fake_quant_bwd", shape=f"{shape} {bits}b",
                                 max_abs_err=ds_err, main=False))
                continue
            n = v.numel()
            # library yardstick: PyTorch's learnable per-tensor fake-quant
            # (same integer grid; it multiplies by a reciprocal, so times
            # only)
            lib_f = lib_b = None
            if hasattr(torch, "_fake_quantize_learnable_per_tensor_affine"):
                zp = torch.zeros(1, device=dev)
                vl = v.clone().requires_grad_(True)
                sl = s.clone().requires_grad_(True)

                def lib_fwd():
                    return torch._fake_quantize_learnable_per_tensor_affine(
                        v, s, zp, int(qmin), int(qmax), 1.0)

                def lib_fwd_bwd():
                    o = torch._fake_quantize_learnable_per_tensor_affine(
                        vl, sl, zp, int(qmin), int(qmax), 1.0)
                    return torch.autograd.grad(o, (vl, sl), g)

                lib_f, lib_b = (cuda_ms(torch, lib_fwd, flush),
                                cuda_ms(torch, lib_fwd_bwd, flush))
            b_f = bound_ms(8.0 * n + 4, 5.0 * n, F32_OPS_PER_S)
            b_b = bound_ms(12.0 * n + 8, 10.0 * n, F32_OPS_PER_S)
            for name, kern, plain, lib, (b_ms, b_by), e in (
                    ("fake_quant_fwd",
                     lambda: ops.fake_quant_fwd(v, s, qmin, qmax),
                     lambda: ref.fake_quant_ref(v, s.reshape(()), qmin, qmax),
                     lib_f, b_f, err),
                    ("fake_quant_bwd",
                     lambda: ops.fake_quant_bwd(v, s, g, qmin, qmax),
                     lambda: ref.fake_quant_grads_ref(v, s.reshape(()), g,
                                                      qmin, qmax),
                     lib_b, b_b, ds_err)):
                rows.append(dict(
                    name=name, shape=f"{shape} {bits}b", max_abs_err=e,
                    ms=cuda_ms(torch, kern, flush),
                    plain_ms=cuda_ms(torch, plain, flush), library_ms=lib,
                    bound_ms=b_ms, bound_by=b_by, main=main))
                print(f"[kernel] {name:15s} {str(shape):14s} {bits}b "
                      f"err={e:.1e} ms={rows[-1]['ms']:.4f} "
                      f"plain={rows[-1]['plain_ms']:.4f} "
                      f"lib={lib if lib is None else round(lib, 4)} "
                      f"bound={b_ms:.4f}({b_by})", flush=True)
    print(f"[kernel] fake_quant: {len(FQ_SHAPES) * len(FQ_BITS)} cases, "
          "forward and dv bit for bit, ds within tolerance", flush=True)
    return rows


def _attended_pairs(S: int, causal: bool, window) -> int:
    """(q, k) pairs a row group attends under the mask (this run's work)."""
    if not causal:
        return S * S if window is None else sum(
            S - max(0, q - window + 1) for q in range(S))
    return sum(q + 1 if window is None else min(q + 1, window)
               for q in range(S))


def flash_phase(torch, ops, ref, flush, dev):
    import torch.nn.functional as F
    rows = []
    B, KV, G, hd = 1, 8, 2, 128
    H = KV * G
    for S, causal, window in FLASH_CASES:
        g_ = torch.Generator(device=dev).manual_seed(S + (window or 0)
                                                     + causal)
        q = torch.randn((B, S, KV, G, hd), generator=g_,
                        device=dev) * hd ** -0.5
        k = torch.randn((B, S, KV, hd), generator=g_, device=dev)
        v = torch.randn((B, S, KV, hd), generator=g_, device=dev)
        kw = dict(causal=causal, window=window)
        out, lse = ops.flash_fwd(q, k, v, **kw)
        out_p, lse_p = ref.flash_fwd_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out - out_p).abs().max())
        err_lse = float((lse - lse_p).abs().max())
        tag = f"S={S} causal={causal} window={window}"
        gate(bool(torch.allclose(out, out_p, rtol=2e-5, atol=2e-5)),
             f"flash_fwd {tag}: out differs (max |err| {err})")
        gate(bool(torch.allclose(lse, lse_p, rtol=1e-5, atol=1e-5)),
             f"flash_fwd {tag}: lse differs (max |err| {err_lse})")
        # yardstick: SDPA in float32 on (B, H, S, hd), the same mask
        qh = q.reshape(B, S, H, hd).permute(0, 2, 1, 3).contiguous()
        kh = k.permute(0, 2, 1, 3).contiguous()
        vh = v.permute(0, 2, 1, 3).contiguous()
        mask = None
        if window is not None:
            pos = torch.arange(S, device=dev)
            d = pos[:, None] - pos[None, :]
            mask = (d < window) & ((d >= 0) if causal else True)

        def sdpa():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask,
                is_causal=causal and mask is None, scale=1.0,
                enable_gqa=True)

        lib_out = sdpa().permute(0, 2, 1, 3).reshape(out.shape)
        gate(bool(torch.allclose(lib_out, out, rtol=1e-3, atol=1e-4)),
             f"SDPA yardstick disagrees with flash_fwd {tag}")
        n_bytes = 4.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd + B * H * S)
        n_ops = 4.0 * hd * _attended_pairs(S, causal, window) * B * H
        b_ms, b_by = bound_ms(n_bytes, n_ops, F32_OPS_PER_S)
        rows.append(dict(
            name="flash_fwd", shape=f"B={B} {tag} KV={KV} G={G} hd={hd}",
            max_abs_err=max(err, err_lse),
            ms=cuda_ms(torch, lambda: ops.flash_fwd(q, k, v, **kw), flush,
                       reps=20),
            plain_ms=cuda_ms(torch, lambda: ref.flash_fwd_ref(q, k, v, **kw),
                             flush, reps=10),
            library_ms=cuda_ms(torch, sdpa, flush, reps=20), bound_ms=b_ms,
            bound_by=b_by, main=(S, causal, window) == FLASH_MAIN))
        print(f"[kernel] flash_fwd {tag:32s} err={err:.1e}/{err_lse:.1e} "
              f"ms={rows[-1]['ms']:.4f} plain={rows[-1]['plain_ms']:.4f} "
              f"sdpa={rows[-1]['library_ms']:.4f} bound={b_ms:.4f}({b_by})",
              flush=True)
    return rows


def _tree_leaves(tree, pre=""):
    """[(path, tensor)] of a nested param/grad dict in sorted key order."""
    out = []
    for k in sorted(tree):
        key = f"{pre}/{k}" if pre else k
        v = tree[k]
        out += _tree_leaves(v, key) if isinstance(v, dict) else [(key, v)]
    return out


def _is_bank(path: str) -> bool:
    return path.endswith(("s_w", "s_a"))


def train_phase(torch, ops, dev):
    """The paper pipeline on Qwen3-0.6B at full width and depth. Returns
    (launch counts of the run, results)."""
    from repro_torch import optim, training
    from repro_torch.configs import get_config
    from repro_torch.core import importance as imp
    from repro_torch.core import search
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.models.quant_layers import QuantContext

    cfg = get_config("qwen3-0.6b")
    ql = lm.enumerate_qlayers(cfg)
    n_proj = len(ql)
    per_pass = dict(fake_quant_fwd=2 * n_proj + 2,
                    fake_quant_bwd=2 * n_proj + 2, flash_fwd=cfg.n_layers)
    n_pass = cfg.n_bits + 1
    ctx = QuantContext.make(cfg.bits, cfg.quant_act_signed,
                            compute_dtype=torch.float32)
    data = SyntheticLM(cfg)

    def batch(step):
        return {"tokens": torch.as_tensor(
            data.batch(step, 1, TRAIN_S)["tokens"], device=dev)}

    params = lm.init_params(cfg, seed=0, device=dev)
    p0 = {k: t.clone() for k, t in _tree_leaves(params)}
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, "
          f"{lm.param_count(params) / 1e6:.1f}M params, {n_proj} searchable "
          f"projections, B=1 S={TRAIN_S} float32", flush=True)
    res = dict(per_pass=per_pass)
    total = {k: 0 for k in TRAIN_KERNELS}

    def run(label, expect, fn):
        ops.reset_launches()                     # counts: this run only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        ms = sync_ms(torch, t0)
        got = {k: ops.launches[k] for k in TRAIN_KERNELS}
        for k in TRAIN_KERNELS:
            total[k] += got[k]
        # (a) launches exactly as the schedule implies
        gate(got == expect, f"[{label}] launches {got}, expected {expect}")
        gate(all(ops.launches[k] == 0 for k in SERVE_KERNELS),
             f"[{label}] a serving kernel launched while training")
        return out, ms

    # 1. joint importance training
    opt = imp.importance_optimizer(0.01, momentum=0.9, freeze_backbone=True)
    step = imp.make_importance_step(cfg, ctx, opt, remat=False)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(1234)
    imp_ms, imp_loss = [], []
    for i in range(IMP_STEPS):
        b = batch(i)
        (params, state, m), ms = run(
            f"importance step {i}", {k: n_pass * v for k, v in per_pass.items()},
            lambda: step(params, state, b, gen))
        losses = m["loss_uniform"].tolist() + [float(m["loss_random"])]
        gnorm = float(m["grad_norm"])
        gate(all(math.isfinite(x) for x in losses + [gnorm]),   # (b)
             f"importance step {i}: loss {losses} grad norm {gnorm}")
        imp_ms.append(ms)
        imp_loss.append(losses)
        print(f"[train] importance step {i}: {ms:.0f} ms ({n_pass} passes, "
              f"{n_pass * TRAIN_S / ms * 1e3:.0f} tok/s over all passes), "
              f"losses uniform {[round(x, 4) for x in losses[:-1]]} random "
              f"{losses[-1]:.4f}, grad norm {gnorm:.4g}", flush=True)
    del state
    # (c) backbone bit for bit, every bank moved
    now = dict(_tree_leaves(params))
    frozen = [k for k in p0 if not _is_bank(k)]
    gate(all(torch.equal(now[k], p0[k]) for k in frozen),
         "importance steps moved a backbone weight")
    banks = [k for k in p0 if _is_bank(k)]
    still = [k for k in banks if torch.equal(now[k], p0[k])]
    gate(not still, f"banks not moved by the importance steps: {still[:4]}")
    print(f"[train] backbone ({len(frozen)} tensors) bit for bit unchanged; "
          f"all {len(banks)} banks moved", flush=True)
    del p0, now

    # 2-3. indicators and the one-time ILP search
    ind = imp.extract_indicators(params, cfg, ql)
    budget = search.bitops_budget_for_uniform(ql, 3)
    sr = search.search_policy(ql, ind, cfg.bits, alpha=1.0,
                              bitops_budget=budget)
    sr.policy.validate(ql, bits=cfg.bits)                       # (d)
    gate(sr.bitops <= budget * (1 + 1e-6),
         f"searched policy BitOps {sr.bitops} over budget {budget}")
    w_avg, a_avg = sr.policy.avg_bits()
    print(f"[train] ILP search {sr.elapsed_s * 1e3:.1f} ms, solver "
          f"{sr.solver}, avg bits w={w_avg:.3f} a={a_avg:.3f}, BitOps "
          f"{sr.bitops:.4g} <= budget {budget:.4g}", flush=True)

    # 4. QAT finetune under the searched policy
    bits = lm.bits_from_policy(cfg, sr.policy, ql)
    opt = optim.adamw(3e-3, clip_norm=1.0)
    qstep = training.make_train_step(cfg, ctx, opt, bits, remat=False)
    state = opt.init(params)
    qat_ms, qat_loss = [], []
    for i in range(QAT_STEPS):
        b = batch(IMP_STEPS + i)
        (params, state, m), ms = run(f"qat step {i}", per_pass,
                                     lambda: qstep(params, state, b))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        gate(math.isfinite(loss) and math.isfinite(gnorm),       # (b)
             f"qat step {i}: loss {loss} grad norm {gnorm}")
        qat_ms.append(ms)
        qat_loss.append(loss)
        print(f"[train] qat step {i}: {ms:.0f} ms "
              f"({TRAIN_S / ms * 1e3:.0f} tok/s), loss {loss:.4f}, grad norm "
              f"{gnorm:.4g}", flush=True)
    del state

    # 5. evaluation on a held-out batch
    b = batch(1000)
    ev, ev_ms = run("eval", dict(per_pass, fake_quant_bwd=0),
                    lambda: training.evaluate(params, cfg, ctx, bits, [b]))
    gate(all(math.isfinite(v) for v in ev.values()), f"eval {ev}")   # (b)
    print(f"[train] eval: ce {ev['ce']:.4f} in {ev_ms:.0f} ms", flush=True)
    print(f"[train] launches over the run {total} (per pass {per_pass})",
          flush=True)
    # where the time goes: one more QAT step under the profiler (outside
    # the counted run; its result is dropped)
    state = opt.init(params)
    res["qat_step_profile"] = profile_device(
        torch, lambda: qstep(params, state, b))
    print_profile("train", "one QAT step", res["qat_step_profile"])
    del state
    res.update(importance_ms=imp_ms, importance_losses=imp_loss,
               qat_ms=qat_ms, qat_losses=qat_loss, eval=ev, eval_ms=ev_ms,
               qat_tokens_per_s=TRAIN_S / statistics.median(qat_ms) * 1e3,
               importance_tokens_per_s=n_pass * TRAIN_S
               / statistics.median(imp_ms) * 1e3,
               ilp_ms=sr.elapsed_s * 1e3, ilp_solver=sr.solver,
               avg_bits=[w_avg, a_avg], bitops=sr.bitops,
               bitops_budget=budget, peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    del params
    return total, res


def profile_device(torch, fn, top: int = 8):
    """``fn`` under torch.profiler: wall ms, kernel launches, device busy ms
    (the sum over device-side kernel events only: a host op's device time
    repeats its kernels') and the ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = sync_ms(torch, t0)
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = sorted((e for e in ev if e.device_type == DeviceType.CUDA
                      and dev_us(e) > 0), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / 1e3
    return dict(wall_ms=wall, device_ms=busy or None,
                kernel_launches=sum(e.count for e in ev
                                    if e.key == "cudaLaunchKernel"),
                top=[(e.key[:64], dev_us(e) / 1e3, e.count)
                     for e in kernels[:top]])


def print_profile(label: str, what: str, res: dict) -> None:
    wall, busy = res["wall_ms"], res["device_ms"]
    print(f"[{label}] {what} under the profiler: {wall:.1f} ms wall, "
          f"{res['kernel_launches']} kernel launches, device busy "
          + (f"{busy:.1f} ms ({busy / wall:.0%})" if busy else "not measured"),
          flush=True)
    for name, ms, n in res["top"]:
        print(f"[{label}]   {ms:9.2f} ms {n:6d}x  {name}", flush=True)


def kernel_vs_plain(torch, ops, dev, n_layers=None, quantize_acts=True,
                    plain=TRAIN_KERNELS):
    """One loss_fn + backward at full width, S=2048, 4-bit uniform, through
    the kernels and through the plain versions of the kernels ``plain`` (the
    others launch on both sides). Returns the differences: loss rtol and
    per-leaf relative L2 of the gradients (max over banks, max over the
    rest)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.models.quant_layers import QuantContext
    from repro_torch.training import value_and_grad

    cfg = get_config("qwen3-0.6b")
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    params = lm.init_params(cfg, seed=0, device=dev)
    ctx = dataclasses.replace(
        QuantContext.make(cfg.bits, cfg.quant_act_signed,
                          compute_dtype=torch.float32),
        quantize_acts=quantize_acts)
    batch = {"tokens": torch.as_tensor(
        SyntheticLM(cfg).batch(7, 1, TRAIN_S)["tokens"], device=dev)}
    bits = lm.bits_uniform(cfg, 2)

    def once():
        ops.reset_launches()
        loss, _, g = value_and_grad(
            lambda p: lm.loss_fn(p, cfg, batch, bits, ctx), params)
        torch.cuda.synchronize()
        return float(loss), dict(_tree_leaves(g)), dict(ops.launches)

    lk, gk, nk = once()
    with ops.plain_on_cuda(*plain):
        lp, gp, np_ = once()
    gate(all(nk[k] > 0 for k in TRAIN_KERNELS)
         and all(np_[k] == (0 if k in plain else nk[k])
                 for k in TRAIN_KERNELS),
         f"kernel pass launched {nk}, plain pass {np_} (plain: {plain})")
    rel = {k: float((gk[k] - gp[k]).norm() / gp[k].norm().clamp_min(1e-30))
           for k in gp}
    d = dict(layers=cfg.n_layers, quantize_acts=quantize_acts,
             plain=list(plain), launches={k: nk[k] for k in TRAIN_KERNELS},
             loss_kernel=lk, loss_plain=lp,
             loss_rtol=abs(lk - lp) / abs(lp),
             bank_rel_max=max(v for k, v in rel.items() if _is_bank(k)),
             weight_rel_max=max(v for k, v in rel.items() if not _is_bank(k)),
             worst=sorted(rel.items(), key=lambda kv: -kv[1])[:4])
    print(f"[train] kernels vs plain {list(plain)}, {cfg.n_layers} layers, "
          f"activations {'quantized' if quantize_acts else 'unquantized'}: loss "
          f"{lk:.6f} vs {lp:.6f} (rtol {d['loss_rtol']:.2e}), gradient "
          f"relative L2 max {d['bank_rel_max']:.2e} (banks) / "
          f"{d['weight_rel_max']:.2e} (weights, norms); worst "
          f"{[(k, f'{v:.2e}') for k, v in d['worst']]}", flush=True)
    return d


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
    st = sess.init_state(SLOTS, CACHE_LEN, torch.float32, device=dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(SLOTS, dtype=torch.int32, device=dev) + 200
    for _ in range(2):
        sess.decode(sess.params, tok, pos, st)
    res = profile_device(torch, lambda: sess.decode(sess.params, tok, pos,
                                                    st), top=4)
    print_profile("serve", "one decode step", res)
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
    launches = {k: ops.launches[k] for k in SERVE_KERNELS}
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
    gate(all(launches[k] > 0 for k in SERVE_KERNELS),
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
    with ops.plain_on_cuda():           # the reference stays plain PyTorch
        compared, bad, unstable = serve.check_greedy(cfg, params, policy,
                                                     reqs, out, **kw)
    n_tok = sum(len(c.tokens) for c in out.values())
    print(f"[serve] greedy tokens vs fake-quant reference: {compared} of "
          f"{n_tok} steps decisive and compared, diverged rids {bad}; the "
          f"reference's float32 and float64 evaluations part on a confident "
          f"step in rids {unstable}", flush=True)
    gate(not bad, f"greedy tokens diverged on decisive steps: rids {bad}")
    gate(compared > 0, "no decisive step to compare")
    # how far two correct float evaluations of one graph part: max |logit
    # difference| at prefill on identical prompts (no gate; see check_greedy)
    with ops.plain_on_cuda():
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
    rows += fake_quant_phase(torch, ops, ref, flush, dev)
    rows += flash_phase(torch, ops, ref, flush, dev)
    del flush
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_launches, train_res = train_phase(torch, ops, dev)
    torch.cuda.empty_cache()
    serve_launches, serve_res = serve_phase(torch, ops, dev)
    torch.cuda.empty_cache()
    # (e) kernels vs plain versions through one train pass: gated at 2
    # layers (activations unquantized, every kernel against its plain
    # version; then quantized, the flash kernel on both sides), printed at
    # full depth
    vs_plain = {}
    for key, kw, tol in (
            ("acts_unquantized", dict(n_layers=2, quantize_acts=False),
             TRAIN_TOL),
            ("acts_quantized", dict(n_layers=2, plain=("fake_quant_fwd",
                                                       "fake_quant_bwd")),
             TRAIN_TOL),
            ("full_depth", {}, None)):
        d = vs_plain[key] = kernel_vs_plain(torch, ops, dev, **kw)
        if tol is not None:
            gate(d["loss_rtol"] <= tol["loss_rtol"]
                 and d["bank_rel_max"] <= tol["grad_rel"]
                 and d["weight_rel_max"] <= tol["grad_rel"],
                 f"train pass through the kernels differs from the plain "
                 f"versions beyond {tol}: {d}")
    train_res["vs_plain"] = vs_plain
    launches = dict(serve_launches, **train_launches)

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
        {"card": card, "cases": rows, "train": train_res,
         "serve": serve_res, "kernels": kernels}, indent=1, default=str))
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
