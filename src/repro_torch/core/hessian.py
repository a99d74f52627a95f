"""HAWQ-style Hessian-trace sensitivity baseline (Dong et al., HAWQ-v2), the
criterion the paper compares its learned indicators against
(``repro.core.hessian``; run by ``benchmarks/hessian_baseline.py``):

  sensitivity_l(b) = (Tr(H_l) / numel_l) * ||Q_b(W_l) - W_l||^2

with Tr(H_l) estimated by Hutchinson, E_v[v^T H v] over Rademacher probes v
restricted to the QLayer weight leaves, on the FULL-PRECISION loss (the
bias the paper names: the trace is blind to the quantizer). The table plugs
into the same MCKP solver as the learned indicators.

The Hessian-vector product is reverse over reverse: the gradient of the
loss with ``create_graph=True``, then the gradient of ``<g, v>``. Its
attention runs the plain ``"xla_scan"`` flash baseline
(``models.attention.flash_attention``) wherever the model would take the
flash path (S >= 2048): that is part of this function's definition, not a
fallback. The ``"custom_vjp"`` path saves the kernel forward's logsumexp as
a constant, so a second derivative through it would miss lse's dependence
on q and k and give a wrong product without an error; the plain scan is
differentiated by autograd through its ops, as JAX differentiates the
reference's ``custom_vjp`` residuals.

The reference's estimator has two quirks, reproduced here and not fixed:
a body QLayer's probe is drawn over the WHOLE stacked body leaf (all units;
the reference draws one per QLayer of the leaf and the last one drawn
wins, so this draws one per leaf), and its trace is that whole leaf's
``<v, Hv>`` divided by the number of units, so every unit of a body slot
gets the same trace.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qspec import QLayer
from repro_torch.core.quantizer import bit_range, fake_quant, init_scale_from_stats
from repro_torch.models import attention, lm
from repro_torch.models.quant_layers import fp_context


def _leaf_key(q: QLayer):
    return (q.segment,) + tuple(q.path)


def _weight_leaf(params, q: QLayer) -> torch.Tensor:
    seg, idx = q.segment.split(".")
    node = params[seg][idx]
    for k in q.path:
        node = node[k]
    return node["w"]


def with_weights(params, qlayers: Sequence[QLayer], weights: dict):
    """``params`` (a tree of dicts, rebuilt here) whose QLayer weight
    leaves are ``weights``, keyed by (segment, *path) of the QLayer; every
    other leaf is shared."""
    def copy(node):
        return {k: copy(v) for k, v in node.items()} \
            if isinstance(node, dict) else node

    out = copy(params)
    for q in qlayers:
        seg, idx = q.segment.split(".")
        node = out[seg][idx]
        for k in q.path:
            node = node[k]
        node["w"] = weights[_leaf_key(q)]
    return out


def rademacher(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Independent +-1 entries in float32 on ``device``, drawn from ``gen``
    on its own device."""
    r = torch.randint(0, 2, tuple(shape), generator=gen, device=gen.device)
    return (2.0 * r - 1.0).to(device=device, dtype=torch.float32)


def hessian_vector_products(loss: torch.Tensor,
                            leaves: Sequence[torch.Tensor],
                            probes: Iterable[Sequence[torch.Tensor]]
                            ) -> Iterator[Tuple[Sequence[torch.Tensor],
                                                Tuple[torch.Tensor, ...]]]:
    """(v, H v) for each probe list ``v`` (one tensor per leaf) of the
    scalar ``loss`` of ``leaves``, reverse over reverse: the gradient once,
    with its graph, then the gradient of ``<g, v>`` per probe. The graph is
    freed after the last probe."""
    grads = torch.autograd.grad(loss, list(leaves), create_graph=True)
    it = iter(probes)
    v = next(it, None)
    while v is not None:
        nxt = next(it, None)
        dot = sum((g * p).sum() for g, p in zip(grads, v))
        yield v, torch.autograd.grad(dot, list(leaves),
                                     retain_graph=nxt is not None)
        v = nxt


def full_precision_loss(params, cfg: ModelConfig, batch,
                        qlayers: Sequence[QLayer],
                        dtype: torch.dtype = torch.float32):
    """The loss the traces differentiate: ``fp_context`` in ``dtype``, no
    remat, attention through ``"xla_scan"``. Returns (loss, {leaf key:
    weight leaf}) with the QLayer weight leaves (one per stacked leaf, in
    ``qlayers`` order) fresh autograd leaves in ``dtype``; every other leaf
    is read as it is (cast to ``dtype`` when it is floating)."""
    weights: Dict[tuple, torch.Tensor] = {}
    for q in qlayers:
        if _leaf_key(q) not in weights:
            weights[_leaf_key(q)] = _weight_leaf(params, q).detach() \
                .to(dtype).requires_grad_(True)

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return node.to(dtype) if node.is_floating_point() else node

    live = with_weights(cast(params), qlayers, weights)
    with attention.flash_impl("xla_scan"):
        loss = lm.loss_fn(live, cfg, batch, None, fp_context(dtype),
                          remat=False)[0]
    return loss, weights


def hutchinson_traces(params, cfg: ModelConfig, batch,
                      qlayers: Sequence[QLayer], rng: torch.Generator, *,
                      n_samples: int = 4,
                      probes: Optional[Sequence[Dict[str, torch.Tensor]]]
                      = None) -> Dict[str, float]:
    """Per-QLayer Hessian-trace estimates of the FULL-PRECISION loss
    (``fp_context``, float32, no remat, attention through ``"xla_scan"``).

    ``rng`` draws the Rademacher probes (on its own device). ``probes``,
    when given, replaces them: one dict per sample, QLayer name -> probe
    over that QLayer's whole weight leaf, applied in ``qlayers`` order so
    that the last QLayer of a leaf wins, as the reference's keys do; its
    length is the sample count."""
    loss, weights = full_precision_loss(params, cfg, batch, qlayers)
    order: List[tuple] = list(weights)

    def draw(s):
        if probes is None:
            return [rademacher(weights[k].shape, rng, weights[k].device)
                    for k in order]
        v = {}
        for q in qlayers:                   # the last QLayer of a leaf wins
            p = probes[s][q.name]
            if isinstance(p, np.ndarray):
                p = np.array(p)             # a writable copy
            v[_leaf_key(q)] = torch.as_tensor(
                p, dtype=torch.float32, device=weights[_leaf_key(q)].device)
        return [v[k] for k in order]

    samples = n_samples if probes is None else len(probes)
    traces = {q.name: 0.0 for q in qlayers}
    for v, hv in hessian_vector_products(
            loss, [weights[k] for k in order],
            (draw(s) for s in range(samples))):
        contrib = {k: float((p * h).sum()) for k, p, h in zip(order, v, hv)}
        for q in qlayers:
            c = contrib[_leaf_key(q)]
            if q.segment.startswith("body."):
                # probes hit all units at once; attribute uniformly
                c /= max(1, weights[_leaf_key(q)].shape[0])
            traces[q.name] += c / samples
    return traces


def quantization_perturbations(params, cfg: ModelConfig,
                               qlayers: Sequence[QLayer]
                               ) -> Dict[str, np.ndarray]:
    """||Q_b(W) - W||^2 per QLayer per bit option (statistics-init scales):
    the QLayer's own unit of a stacked body leaf."""
    out = {}
    with torch.no_grad():
        for q in qlayers:
            w = _weight_leaf(params, q).to(torch.float32)
            if q.segment.startswith("body."):
                w = w[q.unit].contiguous()
            errs = []
            for b in cfg.bits:
                qmin, qmax = bit_range(int(b), True)
                s = init_scale_from_stats(w, qmax)
                qw = fake_quant(w, s, qmin, qmax)
                errs.append(float(torch.sum(torch.square(qw - w))))
            out[q.name] = np.asarray(errs, np.float64)
    return out


def hawq_sensitivities(params, cfg: ModelConfig, batch, rng: torch.Generator,
                       *, qlayers: Optional[Sequence[QLayer]] = None,
                       n_samples: int = 4,
                       probes: Optional[Sequence[Dict[str, torch.Tensor]]]
                       = None):
    """HAWQ-v2 style values table: name -> {"w": (n_bits,) sensitivity,
    "a": zeros} (HAWQ does not rank activations). Plug into
    ``core.search.search_policy`` as its ``indicators``."""
    qlayers = qlayers if qlayers is not None else lm.enumerate_qlayers(cfg)
    traces = hutchinson_traces(params, cfg, batch, qlayers, rng,
                               n_samples=n_samples, probes=probes)
    perturb = quantization_perturbations(params, cfg, qlayers)
    return sensitivity_table(qlayers, traces, perturb)


def sensitivity_table(qlayers: Sequence[QLayer], traces: Dict[str, float],
                      perturb: Dict[str, np.ndarray]):
    """(max(Tr(H), 0) / numel) * ||Q_b(W) - W||^2 per QLayer and bit, the
    activation half zero (HAWQ does not rank activations)."""
    table = {}
    for q in qlayers:
        numel = max(1, q.w_params)
        sens = max(traces[q.name], 0.0) / numel * perturb[q.name]
        table[q.name] = {"w": sens, "a": np.zeros_like(sens)}
    return table
