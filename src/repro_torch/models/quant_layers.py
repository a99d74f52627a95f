"""Quantized einsum layers carrying the paper's per-bit indicator banks.

Every searchable projection is a param dict ``{"w", "s_w", "s_a"}`` where
``s_w``/``s_a`` are the (n_bits,) learnable scale banks -- the layer's
importance indicators (paper §3.3/3.4). Bit selection is an index into the
bank. Pinned 8-bit layers (embedding / lm head, paper §4.1) carry a single
scale and never enter the search.

Serving-time projections are ``runtime.packing.PackedLinear`` leaves
instead of dicts; ``qeinsum`` hands those to ``runtime.dispatch``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.quantizer import (
    bit_range,
    fake_quant,
    init_scale_from_stats,
    init_scale_same,
    lsq_grad_scale_factor,
)
from repro_torch.models.common import dense_init


@dataclass(frozen=True)
class BitTables:
    """Per-bank-index (qmin, qmax) of a bit-width menu."""
    bits: Tuple[int, ...]
    qmin: Tuple[float, ...]
    qmax: Tuple[float, ...]

    @staticmethod
    def make(bits: Sequence[int], signed: bool) -> "BitTables":
        ranges = [bit_range(int(b), signed) for b in bits]
        return BitTables(tuple(int(b) for b in bits),
                         tuple(float(lo) for lo, _ in ranges),
                         tuple(float(hi) for _, hi in ranges))


@dataclass(frozen=True)
class QuantContext:
    """Static quantization-mode switches threaded through the model.

    ``kv_quant`` selects the decode-time KV-cache storage: "none" (fp),
    "int8" (codes + per-head write-time scales, ``runtime.kv_cache``), or
    "fake" (quantize-dequantize in an fp cache -- the reference graph whose
    tokens the int8 path must reproduce).
    """
    tables_w: BitTables
    tables_a: BitTables
    enabled: bool = True
    quantize_acts: bool = True
    compute_dtype: torch.dtype = torch.bfloat16
    kv_quant: str = "none"

    @staticmethod
    def make(bits, act_signed: bool, enabled: bool = True,
             compute_dtype=torch.bfloat16, kv_quant: str = "none"
             ) -> "QuantContext":
        return QuantContext(
            tables_w=BitTables.make(bits, signed=True),
            tables_a=BitTables.make(bits, signed=act_signed),
            enabled=enabled, compute_dtype=compute_dtype, kv_quant=kv_quant)


def fp_context(compute_dtype: torch.dtype) -> QuantContext:
    """Quantization disabled (the full-precision baseline)."""
    return QuantContext(tables_w=BitTables.make((8,), True),
                        tables_a=BitTables.make((8,), True), enabled=False,
                        compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# param construction
# ---------------------------------------------------------------------------
def qdense_init(gen: torch.Generator, in_dim: int, out_dim: int, bits, *,
                stacked=(), device=None):
    """Searchable projection: weight + per-bit indicator banks.

    Weight scales use the statistics init (2E|w|/sqrt(qmax_b)) over the
    whole (stacked) tensor, activation scales the same-value init 0.1/b;
    stacked layers get banks of shape (*stacked, n_bits)."""
    w = dense_init(gen, in_dim, out_dim, stacked=stacked, device=device)
    ones = torch.ones(tuple(stacked), dtype=torch.float32, device=device)
    s_w = torch.stack([init_scale_from_stats(w, bit_range(int(b), True)[1])
                       * ones for b in bits], dim=-1)
    s_a = torch.stack([init_scale_same(int(b)).to(device) * ones
                       for b in bits], dim=-1)
    return {"w": w, "s_w": s_w, "s_a": s_a}


def pinned_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
                pinned_bits: int = 8, stacked=(), device=None):
    """8-bit pinned projection (the audio frontend, the untied lm head):
    one weight scale from the weight's statistics and one activation scale
    0.1 / pinned_bits, outside the search."""
    w = dense_init(gen, in_dim, out_dim, stacked=stacked, device=device)
    s = init_scale_from_stats(w, bit_range(pinned_bits, True)[1])
    ones = torch.ones(tuple(stacked), dtype=torch.float32, device=device)
    return {"w": w, "s_w8": s * ones,
            "s_a8": torch.full(tuple(stacked), 0.1 / pinned_bits,
                               dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------
def fake_quant_indexed(v: torch.Tensor, scale_bank: torch.Tensor, bit_idx: int,
                       tables: BitTables, numel: int) -> torch.Tensor:
    """Fake-quant ``v`` at bank entry ``bit_idx`` (a python int)."""
    s = scale_bank[..., bit_idx]
    if s.dim():                        # (E,) -> (E, 1, ..., 1) to broadcast
        s = s.reshape(tuple(s.shape) + (1,) * (v.dim() - s.dim()))
    g = lsq_grad_scale_factor(numel, tables.qmax[bit_idx], device=v.device)
    return fake_quant(v, s, tables.qmin[bit_idx], tables.qmax[bit_idx],
                      grad_scale_factor=g)


def _maybe_quant_w(p, w_idx: Optional[int], ctx: QuantContext) -> torch.Tensor:
    w = p["w"]
    if ctx.enabled and w_idx is not None:
        w = fake_quant_indexed(w.to(torch.float32), p["s_w"], w_idx,
                               ctx.tables_w, numel=w.numel())
    return w.to(ctx.compute_dtype)


def _maybe_quant_a(x: torch.Tensor, p, a_idx: Optional[int],
                   ctx: QuantContext) -> torch.Tensor:
    if ctx.enabled and ctx.quantize_acts and a_idx is not None:
        x = fake_quant_indexed(x, p["s_a"], a_idx, ctx.tables_a,
                               numel=x.numel())
    return x.to(ctx.compute_dtype)


def qeinsum(eqn: str, x: torch.Tensor, p, bits, ctx: QuantContext
            ) -> torch.Tensor:
    """Quantized einsum. ``bits`` is None (fp) or {"w": idx, "a": idx} of
    python-int bank indices. A ``PackedLinear`` ``p`` routes through the
    runtime kernel dispatch (its bit-widths are baked in; ``bits`` is
    ignored)."""
    if not isinstance(p, dict):
        from repro_torch.runtime.dispatch import packed_qeinsum
        return packed_qeinsum(eqn, x, p, ctx)
    w_idx = None if bits is None else bits["w"]
    a_idx = None if bits is None else bits["a"]
    return torch.einsum(eqn, _maybe_quant_a(x, p, a_idx, ctx),
                        _maybe_quant_w(p, w_idx, ctx))


def qeinsum_pinned(eqn: str, x: torch.Tensor, p, ctx: QuantContext,
                   pinned_bits: int = 8, quant_act: bool = True
                   ) -> torch.Tensor:
    """8-bit pinned einsum for first/last layers (outside the search)."""
    w = p["w"]
    if ctx.enabled:
        qmin, qmax = bit_range(pinned_bits, True)
        g = lsq_grad_scale_factor(w.numel(), qmax, device=w.device)
        w = fake_quant(w.to(torch.float32), p["s_w8"], qmin, qmax,
                       grad_scale_factor=g)
        if quant_act:
            ga = lsq_grad_scale_factor(x.numel(), qmax, device=x.device)
            x = fake_quant(x, p["s_a8"].to(x.dtype), qmin, qmax,
                           grad_scale_factor=ga)
    return torch.einsum(eqn, x.to(ctx.compute_dtype), w.to(ctx.compute_dtype))


def pinned_table(p, ctx: QuantContext, pinned_bits: int = 8) -> torch.Tensor:
    """The pinned embedding table as the model reads it: fake-quantized at
    8 bits over the whole table when quantization is on. A pure function of
    the weights, so callers may compute it once and reuse it."""
    w = p["w"]
    if ctx.enabled:
        qmin, qmax = bit_range(pinned_bits, True)
        g = lsq_grad_scale_factor(w.numel(), qmax, device=w.device)
        w = fake_quant(w.to(torch.float32), p["s_w8"], qmin, qmax,
                       grad_scale_factor=g)
    return w.to(ctx.compute_dtype)


def embed_lookup_pinned(tokens: torch.Tensor, p, ctx: QuantContext,
                        table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding lookup in the 8-bit fake-quantized table (``table`` is a
    precomputed :func:`pinned_table`). ``F.embedding``, whose backward sums
    a row's repeated tokens in a fixed order: the backward of an indexing
    lookup accumulates them with atomics on the CPU, so two equal passes
    could part in the last bit of the table's gradient."""
    if table is None:
        table = pinned_table(p, ctx)
    return torch.nn.functional.embedding(tokens.long(), table)
