"""QAT finetune / pretrain step factory (eager PyTorch).

After the ILP search, the model is finetuned with the searched policy's
static bit assignment active (paper section 4.1). The same factory also
produces the full-precision and uniform-bit baseline steps -- one code
path for every experiment row.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import optim
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.quant_layers import QuantContext


def value_and_grad(loss_of: Callable, params):
    """(loss, aux, grads) of ``loss_of(params) -> (loss, aux)`` with grads a
    tree like ``params`` (``jax.value_and_grad(..., has_aux=True)``). The
    params are taken as autograd leaves without a copy."""
    live = optim.tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = optim.tree_leaves(live)
    loss, aux = loss_of(live)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(t):
        # a leaf the loss does not read (the tied head's activation scale)
        # gets a zero gradient, as under jax.grad
        g = next(grads)
        return torch.zeros_like(t) if g is None else g

    return loss.detach(), aux, optim.tree_map(grad_of, live)


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, ctx: QuantContext,
                    optimizer: optim.Optimizer, bits, *,
                    remat: bool = True) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``bits`` is a static bit-assignment tree (or None for full precision)
    captured by the step, as the searched policy is baked into the
    reference's compiled step."""

    def step(params, opt_state, batch):
        _, metrics, grads = value_and_grad(
            lambda p: lm.loss_fn(p, cfg, batch, bits, ctx, remat), params)
        metrics = _detached(metrics)
        metrics["grad_norm"] = optim.global_norm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads           # one gradient tree less beside the new params
        params = optim.apply_updates(params, updates)
        return params, opt_state, metrics

    return step


def make_eval_step(cfg: ModelConfig, ctx: QuantContext, bits) -> Callable:
    def step(params, batch):
        with torch.no_grad():
            _, metrics = lm.loss_fn(params, cfg, batch, bits, ctx,
                                    remat=False)
        return metrics
    return step


def evaluate(params, cfg: ModelConfig, ctx: QuantContext, bits,
             batches) -> dict:
    """Mean of each metric over ``batches``, as python floats."""
    step = make_eval_step(cfg, ctx, bits)
    total, n = None, 0
    for b in batches:
        m = step(params, b)
        total = m if total is None else {k: total[k] + m[k] for k in m}
        n += 1
    return {k: float(v) / n for k, v in total.items()}
