"""Joint one-shot importance-indicator training (paper section 3.4).

At every step the atomic update runs ``n`` forward/backward passes -- the
whole network uniformly at bit option k -- plus ONE pass at a random
per-layer bit assignment (the "communication" pass, one-shot-NAS style).
The n+1 gradients are aggregated and applied in a single optimizer update,
so all ``M = 2 * L * n`` indicators are learned in one QAT run.

Paper finding (section 3.4, last paragraph): freezing the backbone weights
and training *only* the indicators yields near-identical indicators; both
modes are exposed (``freeze_backbone``).

``extract_indicators`` then reads the learned banks out of the param tree
in QLayer order, producing exactly what ``core.search.search_policy``
(Eq. 3) consumes.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs.base import ModelConfig
from repro_torch.core.qspec import QLayer
from repro_torch.models import lm
from repro_torch.models.quant_layers import QuantContext
from repro_torch.training import value_and_grad

Indicators = Dict[str, Dict[str, np.ndarray]]


def importance_optimizer(lr: float = 0.01, momentum: float = 0.9,
                         freeze_backbone: bool = True) -> optim.Optimizer:
    """Paper section 4.1: SGD, lr=0.01, global-norm clip 1.0. With
    freeze_backbone only the scale banks (the indicators) receive updates."""
    base = optim.sgd(lr, momentum=momentum, clip_norm=1.0)
    if freeze_backbone:
        return optim.masked(base, optim.indicator_only_mask)
    return base


def make_importance_step(cfg: ModelConfig, ctx: QuantContext,
                         optimizer: optim.Optimizer, *,
                         remat: bool = True) -> Callable:
    """Returns step(params, opt_state, batch, gen) -> (params, opt_state,
    metrics); ``gen`` is the CPU ``torch.Generator`` the random pass draws
    its bits from. One call = the paper's atomic operation."""
    n = cfg.n_bits

    def grads_at(params, batch, bits):
        loss, _, g = value_and_grad(
            lambda p: lm.loss_fn(p, cfg, batch, bits, ctx, remat), params)
        return loss, g

    def step(params, opt_state, batch, gen):
        grads_sum = None
        losses = []
        passes = [lm.bits_uniform(cfg, k) for k in range(n)]
        passes.append(lm.bits_random(cfg, gen))    # communication pass
        for bits in passes:
            loss, g = grads_at(params, batch, bits)
            losses.append(loss)
            if grads_sum is None:
                grads_sum = g
            else:      # in place: one gradient tree less in device memory
                optim.tree_map(lambda a, b: a.add_(b), grads_sum, g)
        # aggregate the n+1 gradients into one atomic update (section 3.4):
        # backbone weights receive signal from every pass -> average over
        # all of them. A bank ENTRY is selected by its own uniform pass plus
        # at most the random pass, so the banks are normalized by that
        # upper bound (2) instead -- the reference's deliberately
        # conservative fixed constant
        grads = optim.tree_map_with_path(      # in place, as the sum
            lambda path, g: g.div_(2 if optim.indicator_only_mask(path, g)
                                   else n + 1),
            grads_sum)
        del grads_sum
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        metrics = {"loss_uniform": torch.stack(losses[:n]),
                   "loss_random": losses[n],
                   "grad_norm": optim.global_norm(grads)}
        return params, opt_state, metrics

    return step


def train_importance(params, cfg: ModelConfig, ctx: QuantContext, batches, *,
                     lr: float = 0.01, freeze_backbone: bool = True,
                     remat: bool = False, seed: int = 1234):
    """Convenience loop: run the joint scheme over ``batches`` (an
    iterable); the random passes draw from a CPU generator seeded with
    ``seed``. Returns (params, history of numpy metrics)."""
    opt = importance_optimizer(lr, freeze_backbone=freeze_backbone)
    step = make_importance_step(cfg, ctx, opt, remat=remat)
    opt_state = opt.init(params)
    gen = torch.Generator().manual_seed(seed)
    history = []
    for batch in batches:
        params, opt_state, m = step(params, opt_state, batch, gen)
        history.append({k: v.cpu().numpy() for k, v in m.items()})
    return params, history


# ---------------------------------------------------------------------------
# indicator extraction
# ---------------------------------------------------------------------------
def _qparam_node(params, segment: str, path):
    seg, idx = segment.split(".")
    node = params[seg][idx]
    for k in path:
        node = node[k]
    return node


def extract_indicators(params, cfg: ModelConfig,
                       qlayers: Optional[Sequence[QLayer]] = None
                       ) -> Indicators:
    """Read the learned (n_bits,) banks per QLayer as float64 numpy
    magnitudes. Body banks are stacked (repeats, ..., n); MoE expert stacks
    are averaged over the expert dim — one QLayer spans the whole stacked
    tensor."""
    qlayers = qlayers if qlayers is not None else lm.enumerate_qlayers(cfg)
    out: Indicators = {}
    for q in qlayers:
        node = _qparam_node(params, q.segment, q.path)
        s_w = node["s_w"].detach().cpu().numpy().astype(np.float64)
        s_a = node["s_a"].detach().cpu().numpy().astype(np.float64)
        if q.segment.startswith("body."):
            s_w, s_a = s_w[q.unit], s_a[q.unit]
        while s_w.ndim > 1:            # MoE expert dim
            s_w = s_w.mean(axis=0)
        while s_a.ndim > 1:
            s_a = s_a.mean(axis=0)
        out[q.name] = {"w": np.abs(s_w), "a": np.abs(s_a)}
    return out


def indicators_summary(ind: Indicators, bits) -> str:
    lines = ["layer".ljust(28) + "  " + "  ".join(f"w@{b}b" for b in bits)
             + "  |  " + "  ".join(f"a@{b}b" for b in bits)]
    for name, d in ind.items():
        lines.append(name.ljust(28) + "  "
                     + "  ".join(f"{v:.4f}" for v in d["w"])
                     + "  |  " + "  ".join(f"{v:.4f}" for v in d["a"]))
    return "\n".join(lines)
