"""Quickstart on the PyTorch/CUDA port: the paper's full pipeline in one
script, the same five steps at the same tiny config as
``examples/quickstart.py``.

  1. joint importance-indicator training (paper section 3.4, n+1 passes
     per step)
  2. extract the learned per-bit indicators (the scale factors)
  3. one-time ILP search under a 3-bit-level BitOps budget (Eq. 3)
  4. QAT finetune with the searched policy
  5. compare against the uniform-3-bit baseline

Run on the GPU:  python examples/quickstart_torch.py
Run on the CPU:  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch import optim, training  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import importance as imp  # noqa: E402
from repro_torch.core import search  # noqa: E402
from repro_torch.core.policy import MPQPolicy  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.quant_layers import QuantContext  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("limpq-demo").scaled(n_layers=3, d_model=128,
                                          n_heads=4, n_kv_heads=2,
                                          d_ff=512, vocab=512)
    params = lm.init_params(cfg, seed=0, device=dev)
    ctx = QuantContext.make(cfg.bits, cfg.quant_act_signed,
                            compute_dtype=torch.float32)
    data = SyntheticLM(cfg)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(s, 4, 64).items()} for s in range(26)]

    # 1. joint indicator training -------------------------------------------
    print("1) joint importance training (n+1 passes per step)...")
    params, hist = imp.train_importance(params, cfg, ctx, batches[:8],
                                        lr=0.02, freeze_backbone=True)
    print(f"   uniform-pass losses step0={hist[0]['loss_uniform']}")
    print(f"                 last  ={hist[-1]['loss_uniform']}")

    # 2. extract indicators ----------------------------------------------------
    ql = lm.enumerate_qlayers(cfg)
    ind = imp.extract_indicators(params, cfg, ql)
    print("2) indicators (first 4 layers):")
    print(imp.indicators_summary({k: ind[k] for k in list(ind)[:4]},
                                 cfg.bits))

    # 3. one-time ILP search ---------------------------------------------------
    budget = search.bitops_budget_for_uniform(ql, 3)
    res = search.search_policy(ql, ind, cfg.bits, alpha=1.0,
                               bitops_budget=budget)
    print(f"3) ILP search: {res.elapsed_s*1e3:.1f} ms, solver={res.solver}, "
          f"avg bits w={res.policy.avg_bits()[0]:.2f} "
          f"a={res.policy.avg_bits()[1]:.2f} "
          f"(budget respected: {res.bitops <= budget * 1.000001})")

    # 4/5. finetune: searched policy vs uniform baseline -----------------------
    def finetune(policy, label):
        bits = lm.bits_from_policy(cfg, policy, ql)
        opt = optim.adamw(3e-3, clip_norm=1.0)
        step = training.make_train_step(cfg, ctx, opt, bits, remat=False)
        p, s = params, opt.init(params)
        for b in batches[8:20]:
            p, s, _ = step(p, s, b)
        ce = training.evaluate(p, cfg, ctx, bits, batches[20:])["ce"]
        print(f"   {label:16s} eval CE = {ce:.4f}")
        return ce

    print("4) QAT finetune under the searched policy vs uniform 3-bit:")
    ce_ours = finetune(res.policy, "ours (ILP)")
    ce_uni = finetune(MPQPolicy.uniform(ql, 3), "uniform 3-bit")
    print(f"5) delta (uniform - ours) = {ce_uni - ce_ours:+.4f} "
          f"(positive = searched policy wins)")


if __name__ == "__main__":
    main()
