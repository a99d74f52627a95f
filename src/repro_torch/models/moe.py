"""Mixture-of-Experts FFN with capacity-bounded gather dispatch.

Token-choice top-k routing with per-expert top-C token selection for
capacity: each expert gathers its C highest-gate tokens into an (E, C, D)
buffer, runs the stacked expert matmuls, and its rows are added back to
their tokens. Tokens an expert has no room for are dropped, as in
capacity-factor dispatch. This is the reference's single-device dispatch
(one routing group); its group-local dispatch waits for the distributed
layer.

Routing (router logits, softmax, top-k, renormalised gates, the
Switch-style load-balance aux) stays in float32 and is not quantized.
Expert matmuls are QLayers: one (E, ...) stacked tensor per projection with
a per-expert indicator bank (the selected scale broadcasts as (E, 1, 1)).

The combine is deterministic: each token adds its experts' rows in
ascending expert order, starting from zero -- the order in which the
reference's scatter-add sums them on the CPU (index order, expert-major),
and the same from run to run on the card, where a scatter-add with
repeated indices sums in no fixed order.

The router's and the expert stacks' float32 products run over rows padded
with zeros to a multiple of ``common.ROW_ALIGN`` (the capacity's
alignment; ``common.pad_rows``, ``quant_layers.einsum_rows``), as the
norms' reductions do: the card's GEMM picks its kernel, and with it the
order of a row's sum, by shape, so padded, a decode step (one row a slot)
and a speculative verify pass (k + 1 rows a slot) of up to 128 rows give
a token the same router logits and expert rows, as the integer matmul
kernels' exact sums do. The padding is added after the activation
fake-quant (its LSQ grad-scale factor counts the real rows, as the
reference's) and dropped after the product: the values are the
reference's.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import activation, dense_init, pad_rows
from repro_torch.models.quant_layers import QuantContext, qdense_init, qeinsum


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(n_tokens: int, moe: MoEConfig, factor: float = 1.25,
             align: int = 128) -> int:
    """Tokens each expert takes from a call of ``n_tokens`` tokens (so a
    chunked prefill routes as its chunks do)."""
    c = int(n_tokens * moe.top_k / moe.n_experts * factor)
    c = min(round_up(c, align), n_tokens)          # top-k needs C <= n_tokens
    return max(min(align, n_tokens), c)


def moe_init(gen: torch.Generator, d_model: int, moe: MoEConfig, bits,
             gated: bool, *, stacked=(), device=None):
    E, Fe = moe.n_experts, moe.d_ff
    ex = tuple(stacked) + (E,)

    def qd(i, o, st):
        return qdense_init(gen, i, o, bits, stacked=st, device=device)

    p = {"router": {"w": dense_init(gen, d_model, E, stacked=stacked,
                                    device=device)},
         "wi": qd(d_model, Fe, ex), "wo": qd(Fe, d_model, ex)}
    if gated:
        p["wg"] = qd(d_model, Fe, ex)
    if moe.n_shared:
        Fs = moe.n_shared * Fe
        p["shared_wi"] = qd(d_model, Fs, stacked)
        p["shared_wo"] = qd(Fs, d_model, stacked)
        if gated:
            p["shared_wg"] = qd(d_model, Fs, stacked)
    return p


def combine(y: torch.Tensor, gi: torch.Tensor, keep: torch.Tensor,
            top_i: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """Rows ``y`` (E, C, D) back onto their ``n_tokens`` tokens: ``gi`` (E,
    C) the token of each row, ``keep`` (E, C) whether it counts, ``top_i``
    (T, K) each token's experts. Each token sums its kept rows in ascending
    expert order from zero (a dropped pick adds a zero row, which changes
    no partial sum), by K gathers and adds: no atomics, so two equal calls
    are equal bit for bit."""
    E, C, D = y.shape
    EC = E * C
    rows = torch.arange(EC, device=y.device).reshape(E, C)
    rows = torch.where(keep > 0, rows, torch.full_like(rows, EC))
    # row of (expert e, token t), or the zero row; an expert's C tokens
    # are distinct, so the scatter writes each element once
    slot = torch.full((E, n_tokens), EC, dtype=torch.long, device=y.device)
    slot.scatter_(1, gi, rows)
    experts = torch.sort(top_i, dim=-1).values                  # (T, K)
    tok = torch.arange(n_tokens, device=y.device)[:, None]
    picks = slot[experts, tok]                                  # (T, K)
    yz = torch.cat([y.reshape(EC, D), y.new_zeros((1, D))])
    out = y.new_zeros((n_tokens, D))
    for k in range(picks.shape[1]):
        out = out + yz[picks[:, k]]
    return out


class Routing(NamedTuple):
    top_i: torch.Tensor     # (T, K) each token's experts, by probability
    gv: torch.Tensor        # (E, C) each expert's gates, descending
    gi: torch.Tensor        # (E, C) the tokens they belong to
    keep: torch.Tensor      # (E, C) 1.0 where the gate is positive
    aux: torch.Tensor       # the load-balance loss, a float32 scalar


def route(xf: torch.Tensor, router_w: torch.Tensor, moe: MoEConfig,
          capacity_factor: float = 1.25) -> Routing:
    """Routing of ``xf`` (T, D), in float32 and unquantized: softmax, top-k,
    the gates renormalised over the k, the Switch-style aux, and each
    expert's top-C tokens by gate (C from T: ``capacity``)."""
    E, K = moe.n_experts, moe.top_k
    T = xf.shape[0]
    logits = torch.einsum("td,de->te", pad_rows(xf.to(torch.float32), 0),
                          router_w.to(torch.float32))[:T]
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    top_w, top_i = torch.topk(probs, K, dim=-1)                 # (T, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    gates = torch.zeros_like(probs).scatter(-1, top_i, top_w)   # (T, E)
    frac_tokens = (gates > 0).to(torch.float32).mean(0)
    frac_probs = probs.mean(0)
    aux = E * (frac_tokens * frac_probs).sum()
    C = capacity(xf.shape[0], moe, capacity_factor)
    gv, gi = torch.topk(gates.t(), C, dim=-1)                   # (E, C)
    return Routing(top_i, gv, gi, (gv > 0.0).to(torch.float32), aux)


def moe_ffn(x: torch.Tensor, p, moe: MoEConfig, bits: Optional[Dict],
            ctx: QuantContext, act: str, gated: bool,
            capacity_factor: float = 1.25):
    """x: (B, S, D) -> (out (B, S, D), aux loss, a float32 scalar)."""
    B, S, D = x.shape
    T = B * S
    E = moe.n_experts
    act_fn = activation(act)
    xf = x.reshape(T, D)
    r = route(xf, p["router"]["w"], moe, capacity_factor)
    gv, gi, keep = r.gv, r.gi, r.keep
    xg = xf.index_select(0, gi.reshape(-1)).reshape(E, gi.shape[1], D)

    # ---- expert matmuls (quantized) ---------------------------------------
    def b(name):
        return None if bits is None else bits[name]

    h = qeinsum("ecd,edf->ecf", xg, p["wi"], b("wi"), ctx)
    if gated:
        g = qeinsum("ecd,edf->ecf", xg, p["wg"], b("wg"), ctx)
        h = act_fn(g) * h
    else:
        h = act_fn(h)
    y = qeinsum("ecf,efd->ecd", h, p["wo"], b("wo"), ctx)
    y = y * (gv * keep)[..., None].to(y.dtype)
    out = combine(y, gi, keep, r.top_i, T)

    # ---- shared experts (always on) ---------------------------------------
    if moe.n_shared:
        hs = qeinsum("td,df->tf", xf, p["shared_wi"], b("shared_wi"), ctx)
        if gated:
            gs = qeinsum("td,df->tf", xf, p["shared_wg"], b("shared_wg"),
                         ctx)
            hs = act_fn(gs) * hs
        else:
            hs = act_fn(hs)
        out = out + qeinsum("tf,fd->td", hs, p["shared_wo"],
                            b("shared_wo"), ctx)
    return out.reshape(B, S, D), r.aux


def moe_qlayer_defs(d_model: int, moe: MoEConfig, gated: bool):
    """(path, in, out, n_mats, macs_per_token, params, kind) tuples."""
    E, K, Fe = moe.n_experts, moe.top_k, moe.d_ff
    defs = [
        (("wi",), d_model, Fe, E, K * d_model * Fe, E * d_model * Fe, "moe"),
        (("wo",), Fe, d_model, E, K * Fe * d_model, E * Fe * d_model, "moe"),
    ]
    if gated:
        defs.append((("wg",), d_model, Fe, E, K * d_model * Fe,
                     E * d_model * Fe, "moe"))
    if moe.n_shared:
        Fs = moe.n_shared * Fe
        defs += [
            (("shared_wi",), d_model, Fs, 1, d_model * Fs, d_model * Fs,
             "moe"),
            (("shared_wo",), Fs, d_model, 1, Fs * d_model, Fs * d_model,
             "moe"),
        ]
        if gated:
            defs.append((("shared_wg",), d_model, Fs, 1, d_model * Fs,
                         d_model * Fs, "moe"))
    return defs
