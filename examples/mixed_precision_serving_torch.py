"""Serving with a mixed-precision policy on the PyTorch/CUDA port: the same
steps at the same config as ``examples/mixed_precision_serving.py``.

  1. a short joint indicator training and a size-constrained ILP search
     (Table-3 style: 10x compression over float32 weights)
  2. batched prefill + greedy decode under the searched policy
  3. the int8 deployment path: one projection through the int8 matmul
     (``ops.quant_matmul``) against the fake-quant graph

Run on the GPU:  python examples/mixed_precision_serving_torch.py
Run on the CPU:  PYTHONPATH=src python examples/mixed_precision_serving_torch.py --device cpu
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import importance as imp  # noqa: E402
from repro_torch.core import search  # noqa: E402
from repro_torch.core.quantizer import bit_range  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.quant_layers import QuantContext  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg = get_config("limpq-demo")
    params = lm.init_params(cfg, seed=0, device=dev)
    ctx = QuantContext.make(cfg.bits, cfg.quant_act_signed,
                            compute_dtype=torch.float32)
    data = SyntheticLM(cfg)
    ql = lm.enumerate_qlayers(cfg)

    def batch(step, b, s):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(step, b, s).items()}

    # indicators (short) + size-constrained search: Table-3 style 10x rate
    params, _ = imp.train_importance(params, cfg, ctx,
                                     [batch(s, 4, 64) for s in range(4)],
                                     lr=0.01)
    ind = imp.extract_indicators(params, cfg, ql)
    size_budget = search.size_budget_for_rate(ql, 32, rate=10.0)
    res = search.search_policy(ql, ind, cfg.bits, alpha=1.0,
                               size_budget_bytes=size_budget)
    fp_bytes = sum(q.w_params for q in ql) * 4
    print(f"policy: {fp_bytes / res.size_bytes:.1f}x weight compression, "
          f"avg bits {res.policy.avg_bits()}, search "
          f"{res.elapsed_s * 1e3:.0f} ms")
    bits = lm.bits_from_policy(cfg, res.policy, ql)

    # batched serving: prefill + greedy decode
    B, P, G = 4, 32, 16
    prompts = batch(0, B, P)["tokens"]
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, state = lm.apply_prefill(params, cfg, prompts, bits, ctx,
                                         prefill_cap=P + G)
        sync()
        print(f"prefill B={B} S={P}: "
              f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
        toks = [torch.argmax(logits, -1)]
        t0 = time.perf_counter()
        for i in range(G - 1):
            pos = torch.tensor(P + i, dtype=torch.int32, device=dev)
            lg, state = lm.apply_decode(
                params, cfg, toks[-1][:, None].to(torch.int32), pos, state,
                bits, ctx)
            toks.append(torch.argmax(lg, -1))
        sync()
        dt = time.perf_counter() - t0
    print(f"decode {G - 1} steps: {dt * 1e3:.0f} ms "
          f"({B * (G - 1) / dt:.1f} tok/s on {dev.type})")
    print("sample:", torch.stack(toks, 1)[0].tolist())

    # int8 deployment path equivalence on a real projection
    node = params["body"]["0"]["mlp_wi"]
    w = node["w"][0]
    bidx = list(cfg.bits).index(res.policy.w_bits["L000.mlp_wi"]) \
        if "L000.mlp_wi" in res.policy.w_bits else 2
    s_w = node["s_w"][0][bidx].detach().reshape(1)
    b = cfg.bits[bidx]
    qmin, qmax = bit_range(int(b), True)
    wq = torch.clamp(torch.round(w.detach() / s_w), qmin, qmax).to(torch.int8)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((16, w.shape[0]), generator=gen).to(dev)
    s_x = torch.tensor([0.04], dtype=torch.float32, device=dev)
    xq = torch.clamp(torch.round(x / s_x), qmin, qmax).to(torch.int8)
    fused = ops.quant_matmul(xq, wq, s_x, s_w)
    ref = (xq.to(torch.float32) * s_x) @ (wq.to(torch.float32) * s_w)
    print(f"int8 kernel vs fake-quant graph at {b} bits: "
          f"max_err={float((fused - ref).abs().max()):.2e}")


if __name__ == "__main__":
    main()
