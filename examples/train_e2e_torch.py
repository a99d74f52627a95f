"""End-to-end training driver on the PyTorch/CUDA port: importance -> search
-> QAT finetune with checkpointing and restart, on a scaled-down
qwen3-family model (the counterpart of ``examples/train_e2e.py``).

The QAT phase saves the params every ``--ckpt-every`` steps and at the end
(``checkpoint.CheckpointManager``, the reference's npz + json format) and
the searched policy beside them. Run it again with more ``--steps`` and it
resumes from the latest checkpoint: the searched policy is read back
(the search is deterministic, so it is the one phases 1-2 would give), the
params are restored, and the deterministic data pipeline skips to the step
after the saved one. As in the reference, the optimizer state restarts.

Run on the GPU:  python examples/train_e2e_torch.py [--steps 200]
Run on the CPU:  PYTHONPATH=src python examples/train_e2e_torch.py --device cpu
"""
import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch import optim, training  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, StepWatchdog  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import importance as imp  # noqa: E402
from repro_torch.core import search  # noqa: E402
from repro_torch.core.policy import MPQPolicy  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.quant_layers import QuantContext  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "train_e2e_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=25)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config("qwen3-0.6b").scaled(name="qwen3-e2e")
    print(f"model: {cfg.name} ({cfg.n_layers}L d{cfg.d_model}) on {dev} -- "
          f"same family/code path as the full qwen3-0.6b config")
    params = lm.init_params(cfg, seed=0, device=dev)
    print(f"params: {lm.param_count(params) / 1e6:.2f} M")
    ctx = QuantContext.make(cfg.bits, cfg.quant_act_signed,
                            compute_dtype=torch.float32)
    data = SyntheticLM(cfg)
    ql = lm.enumerate_qlayers(cfg)
    mgr = CheckpointManager(args.ckpt, keep_n=2)
    policy_path = os.path.join(args.ckpt, "policy.json")
    latest = mgr.latest_step()

    def batch(step, n):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(step, n, args.seq).items()}

    if latest is not None and os.path.exists(policy_path):
        policy = MPQPolicy.load(policy_path)
        print(f"phases 1-2: the searched policy from {policy_path}, avg bits "
              f"{policy.avg_bits()}")
    else:
        # --- phase 1: indicators (short) ------------------------------------
        print("phase 1: joint importance training")
        params, _ = imp.train_importance(params, cfg, ctx,
                                         [batch(s, 4) for s in range(6)],
                                         lr=0.01)
        ind = imp.extract_indicators(params, cfg, ql)
        # --- phase 2: search ------------------------------------------------
        budget = search.bitops_budget_for_uniform(ql, 4)
        res = search.search_policy(ql, ind, cfg.bits, alpha=2.0,
                                   bitops_budget=budget)
        policy = res.policy
        print(f"phase 2: ILP {res.elapsed_s * 1e3:.1f} ms, "
              f"avg bits {policy.avg_bits()}")
        policy.save(policy_path)

    # --- phase 3: QAT finetune with fault tolerance -------------------------
    print(f"phase 3: QAT finetune {args.steps} steps (ckpt every "
          f"{args.ckpt_every} to {args.ckpt})")
    bits = lm.bits_from_policy(cfg, policy, ql)
    opt = optim.adamw(optim.cosine_warmup(3e-3, 10, args.steps),
                      weight_decay=2.5e-5, clip_norm=1.0)
    step = training.make_train_step(cfg, ctx, opt, bits, remat=False)
    wd = StepWatchdog()
    start = 0
    if latest is not None:
        params = mgr.restore(latest, params)
        start = latest + 1
        print(f"  resumed from step {latest} "
              f"(deterministic data pipeline skips to step {start})")
    opt_state = opt.init(params)
    for s in range(start, args.steps):
        t0 = time.time()
        params, opt_state, m = step(params, opt_state, batch(s, args.batch))
        loss = float(m["loss"])
        if wd.observe(time.time() - t0):
            print(f"  [watchdog] straggler at step {s}")
        if s % args.log_every == 0 or s == args.steps - 1:
            print(f"  step {s:4d} loss {loss:.4f}")
        if (s + 1) % args.ckpt_every == 0:
            mgr.save(s, params, meta={"arch": cfg.name})
    mgr.save(args.steps - 1, params, meta={"arch": cfg.name}, blocking=True)
    print(f"done; checkpoints: {mgr.all_steps()}, policy: {policy_path}")


if __name__ == "__main__":
    main()
