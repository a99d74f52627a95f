"""Training entry point: the paper's pipeline modes (section 4.1).

  importance  -- joint n+1-pass indicator training (paper section 3.4)
  qat         -- finetune with a searched policy active (or uniform bits)
  fp          -- full-precision baseline

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device and without ``--device cpu`` it raises rather than run on the CPU.
The weights are the port's seeded random initialisation. Checkpointing and
resume come with a later slice.

Examples:
  python -m repro_torch.launch.train --arch qwen3-0.6b --mode importance \
      --seq 2048 --batch 1 --steps 2 --save-indicators ind.json
  python -m repro_torch.launch.train --arch qwen3-0.6b --mode qat \
      --policy searched.json --seq 2048 --batch 1 --steps 3
  python -m repro_torch.launch.train --smoke --device cpu --mode importance \
      --steps 2
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import optim, training
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import importance as imp
from repro_torch.core.policy import MPQPolicy
from repro_torch.data import SyntheticLM
from repro_torch.launch.serve import resolve_device
from repro_torch.models import lm
from repro_torch.models.quant_layers import QuantContext, fp_context


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="limpq-demo")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config of --arch")
    ap.add_argument("--mode", default="qat",
                    choices=["importance", "qat", "fp"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--policy", default=None,
                    help="MPQPolicy json for qat mode (default: uniform bits)")
    ap.add_argument("--uniform-bits", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-freeze-backbone", action="store_true")
    ap.add_argument("--save-indicators", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = lm.init_params(cfg, seed=args.seed, device=dev)
    data = SyntheticLM(cfg)
    ctx = (fp_context(torch.float32) if args.mode == "fp"
           else QuantContext.make(cfg.bits, cfg.quant_act_signed,
                                  compute_dtype=torch.float32))

    bits = None
    if args.mode == "qat":
        ql = lm.enumerate_qlayers(cfg)
        policy = (MPQPolicy.load(args.policy) if args.policy
                  else MPQPolicy.uniform(ql, args.uniform_bits))
        bits = lm.bits_from_policy(cfg, policy, ql)

    if args.mode == "importance":
        lr = args.lr if args.lr is not None else 0.01
        opt = imp.importance_optimizer(
            lr, freeze_backbone=not args.no_freeze_backbone)
        step_fn = imp.make_importance_step(cfg, ctx, opt, remat=False)
    else:
        lr = args.lr if args.lr is not None else 3e-3
        opt = optim.adamw(optim.cosine_warmup(lr, args.steps // 20 + 1,
                                              args.steps),
                          weight_decay=2.5e-5, clip_norm=1.0)
        step_fn = training.make_train_step(cfg, ctx, opt, bits, remat=False)
    opt_state = opt.init(params)

    gen = torch.Generator().manual_seed(args.seed + 1)
    t_start = time.time()
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step, args.batch, args.seq).items()}
        _sync(dev)
        t0 = time.perf_counter()
        if args.mode == "importance":
            params, opt_state, m = step_fn(params, opt_state, batch, gen)
            loss = float(m["loss_uniform"].mean())
        else:
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])
        _sync(dev)
        dt = time.perf_counter() - t0
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  {dt * 1e3:7.1f} ms  "
                  f"{args.batch * args.seq / dt:.0f} tok/s on {dev}")

    if args.mode == "importance" and args.save_indicators:
        ind = imp.extract_indicators(params, cfg)
        with open(args.save_indicators, "w") as f:
            json.dump({k: {"w": v["w"].tolist(), "a": v["a"].tolist()}
                       for k, v in ind.items()}, f, indent=1)
        print(f"indicators -> {args.save_indicators}")
    print(f"total {time.time() - t_start:.1f}s")
    return params


if __name__ == "__main__":
    main()
