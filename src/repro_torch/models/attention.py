"""Attention: GQA with RoPE'd inputs for training and prefill
(``self_attention``), text queries over image K/V (``cross_attention``,
unmasked), the one-token decode path over fp / int8 ring KV
caches and the paged int8 layout, the S-token speculative verify pass
(``verify_attention``), and the chunked append prefill of one paged slot
(``append_attention``).

``self_attention`` switches as the reference does: from 2048 tokens on
(S a multiple of the 512-row q block) it takes the flash path named by
``FLASH_IMPL`` -- ``"custom_vjp"``, ``flash_attention_cv``: the
``flash_fwd`` CUDA kernel forward (its plain blockwise version on the CPU)
and a recompute backward in PyTorch that saves only (out, lse); or
``"xla_scan"``, ``flash_attention``: the reference's plain blockwise
online softmax differentiated by autograd, a baseline that nothing on the
main path selects (``core.hessian`` takes it for its second derivative) --
and below that ``direct_attention``, which materializes the (B, KV, G, Sq,
Sk) logits. Decode over an int8 cache routes through
``runtime.dispatch.resolve_decode_attn``: the ``decode_attn_quant`` CUDA
kernel reads the codes directly (``decode_attn_quant_paged`` gathers the
pages by index in the kernel), and the dequant-fp route rebuilds exact fp
rows first (CPU tensors, and the numerics the kernel is held against); on
the paged layout it attends over ``gather()``'s dense view, bit for bit the
ring's arrays.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels.ref import kv_slice_len as _kv_slice_len
from repro_torch.runtime import kv_cache as qkv
from repro_torch.runtime.kv_cache import (FpKVCache, PagedKVCache,
                                         QuantKVCache)

NEG_INF = -1e30
FLASH_IMPLS = ("custom_vjp", "xla_scan")
FLASH_IMPL = "custom_vjp"        # "custom_vjp" | "xla_scan" (baseline)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) additive bias. k_pos < 0 marks empty cache slots."""
    valid = k_pos[None, :] >= 0
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def _gqa_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,KV,G,hd) x k (B,Sk,KV,hd) -> (B,KV,G,Sq,Sk), in f32 or wider
    (a float64 evaluation stays float64)."""
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                             torch.float32)
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(dt), k.to(dt))


def direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                     causal: bool, window: Optional[int]) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, hd) * (hd ** -0.5)
    logits = _gqa_logits(qr, k) + _mask_bias(q_pos, k_pos, causal, window)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, hd)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Text queries (B, S, H, hd) over the image tokens' K/V (B, N, KV,
    hd), no mask: ``direct_attention`` at every position, as the
    reference computes it (outside any kernel)."""
    q_pos = torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    return direct_attention(q, k, v, q_pos, k_pos, causal=False, window=None)


# ---------------------------------------------------------------------------
# custom-backward flash attention (FlashAttention-2 style: the backward
# recomputes p from the saved logsumexp)
# ---------------------------------------------------------------------------
def _flash_bwd(qr, k, v, out, lse, dout, *, causal, window, q_block,
               kv_block):
    """Recompute backward (the reference's ``_flash_cv_bwd``): per q block,
    rebuild p over its kv slice from lse, then dv += p^T dout, dp = dout
    v^T, ds = p (dp - D) with D = rowsum(dout * out), dq = ds k, dk += ds^T
    q."""
    B, S, KV, G, hd = qr.shape
    Lkv, _ = _kv_slice_len(S, window, q_block, kv_block)
    dout = dout.to(torch.float32)
    Drow = (dout * out.to(torch.float32)).sum(dim=-1)          # (B,S,KV,G)
    dk = torch.zeros((B, S, KV, hd), dtype=torch.float32, device=qr.device)
    dv = torch.zeros_like(dk)
    dq = torch.empty((B, S, KV, G, hd), dtype=torch.float32, device=qr.device)
    for qs in range(0, S, q_block):
        q_blk = qr[:, qs:qs + q_block].to(torch.float32)
        do_blk = dout[:, qs:qs + q_block]
        D_blk = Drow[:, qs:qs + q_block]
        lse_blk = lse[..., qs:qs + q_block]
        qpos = torch.arange(qs, qs + q_block, device=qr.device)
        start = 0 if Lkv == S else min(max(qs + q_block - Lkv, 0), S - Lkv)
        k_src = k[:, start:start + Lkv].to(torch.float32)
        v_src = v[:, start:start + Lkv].to(torch.float32)
        kpos = torch.arange(start, start + Lkv, device=qr.device)
        logits = _gqa_logits(q_blk, k_src) + _mask_bias(qpos, kpos, causal,
                                                        window)
        p = torch.exp(logits - lse_blk[..., None])            # (B,KV,G,qb,L)
        dv[:, start:start + Lkv] += torch.einsum("bkgqs,bqkgd->bskd", p,
                                                 do_blk)
        dp = torch.einsum("bqkgd,bskd->bkgqs", do_blk, v_src)
        ds = p * (dp - D_blk.permute(0, 2, 3, 1)[..., None])
        dq[:, qs:qs + q_block] = torch.einsum("bkgqs,bskd->bqkgd", ds, k_src)
        dk[:, start:start + Lkv] += torch.einsum("bkgqs,bqkgd->bskd", ds,
                                                 q_blk)
    return dq.to(qr.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashCV(torch.autograd.Function):
    """Flash attention that saves only (q, k, v, out, lse) and recomputes
    the probabilities blockwise in the backward. The forward with per-row
    logsumexp is the ``flash_fwd`` CUDA kernel on CUDA tensors, its plain
    blockwise version on the CPU."""

    @staticmethod
    def forward(ctx, qr, k, v, causal, window, q_block, kv_block):
        from repro_torch.kernels import ops
        qr, k, v = qr.contiguous(), k.contiguous(), v.contiguous()
        out, lse = ops.flash_fwd(qr, k, v, causal=causal, window=window,
                                 q_block=q_block, kv_block=kv_block)
        ctx.save_for_backward(qr, k, v, out, lse)
        ctx.cfg = dict(causal=causal, window=window, q_block=q_block,
                       kv_block=kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        qr, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(qr, k, v, out, lse, dout, **ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int], q_block: int = 512,
                    kv_block: int = 512) -> torch.Tensor:
    """The reference's ``xla_scan`` baseline: per q block, an online
    softmax over the kv blocks of its kv slice (a window shorter than S
    bounds the slice), in plain PyTorch ops that autograd differentiates
    -- to any order, since nothing is saved as a constant, at the memory
    cost of every block's probabilities. q (B, S, H, hd), k/v (B, S, KV,
    hd); S a multiple of ``q_block``."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if S % q_block:
        raise ValueError(f"flash_attention: S={S} is not a multiple of "
                         f"q_block={q_block}")
    qr = q.reshape(B, S, KV, G, hd) * (hd ** -0.5)
    Lkv, kvb = _kv_slice_len(S, window, q_block, kv_block)
    dt = torch.promote_types(q.dtype, torch.float32)
    outs = []
    for qs in range(0, S, q_block):
        q_blk = qr[:, qs:qs + q_block]
        qpos = torch.arange(qs, qs + q_block, device=q.device)
        start = min(max(qs + q_block - Lkv, 0), S - Lkv)
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=dt, device=q.device)
        l = torch.zeros((B, KV, G, q_block), dtype=dt, device=q.device)
        acc = torch.zeros((B, KV, G, q_block, hd), dtype=dt, device=q.device)
        for s0 in range(start, start + Lkv, kvb):
            k_blk, v_blk = k[:, s0:s0 + kvb], v[:, s0:s0 + kvb]
            kpos = torch.arange(s0, s0 + kvb, device=q.device)
            logits = _gqa_logits(q_blk, k_blk) + _mask_bias(qpos, kpos,
                                                            causal, window)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype), v_blk).to(dt)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)      # (B,S,KV,G,hd)
    return out.reshape(B, S, H, hd).to(q.dtype)


@contextlib.contextmanager
def flash_impl(impl: str):
    """``FLASH_IMPL`` set to ``impl`` for the scope (the reference sets its
    module global)."""
    global FLASH_IMPL
    if impl not in FLASH_IMPLS:
        raise ValueError(f"flash_impl: {impl!r} is not one of {FLASH_IMPLS}")
    prev, FLASH_IMPL = FLASH_IMPL, impl
    try:
        yield
    finally:
        FLASH_IMPL = prev


def flash_attention_cv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool, window: Optional[int], q_block: int = 512,
                       kv_block: int = 512) -> torch.Tensor:
    """Self-attention over equal-length q/k through the flash forward and
    the recompute backward. q (B, S, H, hd), k/v (B, S, KV, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qr = q.reshape(B, S, KV, H // KV, hd) * (hd ** -0.5)
    out = _FlashCV.apply(qr, k, v, causal, window, q_block, kv_block)
    return out.reshape(B, S, H, hd).to(q.dtype)


def self_attention(q, k, v, *, causal: bool, window: Optional[int],
                   flash_threshold: int = 2048, q_block: int = 512,
                   kv_block: int = 512):
    """Training and prefill attention: the flash path that ``FLASH_IMPL``
    names (set through :func:`flash_impl`) from ``flash_threshold`` tokens
    on (when S is a multiple of ``q_block``), as the reference switches,
    else the direct masked softmax."""
    S = q.shape[1]
    if S >= flash_threshold and S % q_block == 0:
        fn = flash_attention_cv if FLASH_IMPL == "custom_vjp" \
            else flash_attention
        return fn(q, k, v, causal=causal, window=window, q_block=q_block,
                  kv_block=kv_block)
    pos = torch.arange(S, device=q.device)
    return direct_attention(q, k, v, pos, pos, causal=causal, window=window)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------
def _prefill_rows(S: int, cap: int, device):
    """(row slice, pos) of a fresh cache of ``cap`` rows over S prompt rows:
    the last ``cap`` rows when the prompt overflows (sliding window), else
    the prompt plus ``-1``-position headroom."""
    if cap <= S:
        return slice(S - cap, S), torch.arange(S - cap, S, dtype=torch.int32,
                                               device=device)
    pos = torch.cat([torch.arange(S, dtype=torch.int32, device=device),
                     torch.full((cap - S,), -1, dtype=torch.int32,
                                device=device)])
    return slice(0, S), pos


def _fit(t: torch.Tensor, rows: slice, cap: int) -> torch.Tensor:
    """Rows ``rows`` of axis 1 of ``t``, zero-padded to ``cap`` rows."""
    t = t[:, rows]
    pad = cap - t.shape[1]
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))],
                      dim=1)
    return t


def build_prefill_cache(k: torch.Tensor, v: torch.Tensor, S: int, cap: int
                        ) -> FpKVCache:
    """Store prefill k/v rows into a fresh fp decode cache of ``cap`` rows
    (with "fake" KV quantization the rows are already quantize-dequantized:
    the reference view of an int8 slot)."""
    rows, pos = _prefill_rows(S, cap, k.device)
    return FpKVCache(k=_fit(k, rows, cap), v=_fit(v, rows, cap), pos=pos)


def build_prefill_cache_from_codes(kq, ksc, vq, vsc, S: int, cap: int
                                   ) -> QuantKVCache:
    """An int8 decode cache of ``cap`` rows from the codes and scales the
    prefill already computed (re-quantizing the dequantized values could
    move a scale by an ulp)."""
    rows, pos = _prefill_rows(S, cap, kq.device)
    return QuantKVCache(k=_fit(kq, rows, cap), v=_fit(vq, rows, cap),
                        k_scale=_fit(ksc, rows, cap),
                        v_scale=_fit(vsc, rows, cap), pos=pos)


def cache_per_slot(cache):
    """Widen a shared-position cache (pos (Sc,)) to the per-slot layout
    (pos (B, Sc)); other leaves, per-slot caches and the paged layout (its
    page table is per-slot already) pass through."""
    if not isinstance(cache, qkv.CACHE_TYPES) or \
            isinstance(cache, PagedKVCache) or cache.pos.dim() != 1:
        return cache
    B = cache.k.shape[0]
    return cache._replace(pos=cache.pos[None].expand(B, -1).contiguous())


def _attend_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos_arr: torch.Tensor, pos: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """Per-slot masked softmax over a full (written) cache: row b attends
    under its own causal/window/validity mask. Rows whose cache is empty
    (all pos -1) softmax over a fully-masked row -- finite output, discarded
    by the engine for inactive slots."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qr = q.reshape(B, 1, KV, G, hd) * (hd ** -0.5)
    logits = _gqa_logits(qr, k)                          # (B,KV,G,1,cap)
    valid = (pos_arr >= 0) & (pos_arr <= pos[:, None])
    if window is not None:
        valid = valid & (pos[:, None] - pos_arr < window)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    logits = logits + bias[:, None, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(B, 1, H, hd)


def _attend_quant_fused(q: torch.Tensor, cache: QuantKVCache,
                        pos: torch.Tensor, window: Optional[int]
                        ) -> torch.Tensor:
    """Fused decode attention on the int8 codes (the ``decode_attn_quant``
    kernel). The shared-position layout broadcasts its mask inputs to the
    per-slot shape the kernel takes; codes and scales pass through."""
    from repro_torch.kernels import ops
    pos_arr, q_pos = cache.pos, pos
    B = q.shape[0]
    if pos_arr.dim() == 1:
        pos_arr = pos_arr[None].expand(B, -1)
        q_pos = q_pos.reshape(()).expand(B)
    return ops.decode_attn_quant(
        q, cache.k, cache.k_scale, cache.v, cache.v_scale,
        pos_arr.contiguous(), q_pos.to(torch.int32).contiguous(),
        window=window)


def decode_attention(q: torch.Tensor, cache, k_new: torch.Tensor,
                     v_new: torch.Tensor, pos, *, window: Optional[int]):
    """One-token decode: ``cache.append`` the new row, then attend. With a
    per-slot cache (pos (B, Sc)) or the paged layout ``pos`` is a (B,)
    vector and each row masks independently. Returns (out (B, 1, H, hd),
    new cache)."""
    from repro_torch.runtime import dispatch
    out_dtype = v_new.dtype
    new = cache.append(k_new, v_new, pos)
    pos32 = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if isinstance(new, PagedKVCache):
        if dispatch.resolve_decode_attn(q.device) != "dequant-fp":
            from repro_torch.kernels import ops
            out = ops.decode_attn_quant_paged(
                q, new.k, new.k_scale, new.v, new.v_scale, new.pos,
                new.page_table, pos32.contiguous(), window=window)
            return out.to(out_dtype), new
        dense = new.gather()
        k = qkv.dequantize(dense.k, dense.k_scale, k_new.dtype)
        v = qkv.dequantize(dense.v, dense.v_scale, out_dtype)
        return _attend_rows(q, k, v, dense.pos, pos32, window), new
    if isinstance(new, QuantKVCache):
        if dispatch.resolve_decode_attn(q.device) != "dequant-fp":
            out = _attend_quant_fused(q, new, pos32, window)
            return out.to(out_dtype), new
        k = qkv.dequantize(new.k, new.k_scale, k_new.dtype)
        v = qkv.dequantize(new.v, new.v_scale, out_dtype)
    else:
        k, v = new.k, new.v
    if new.pos.dim() == 2:
        out = _attend_rows(q, k, v, new.pos, pos32, window)
    else:
        out = direct_attention(q, k, v, pos32.reshape(1), new.pos,
                               causal=True, window=window)
    return out, new


def verify_attention(q: torch.Tensor, cache, k_new: torch.Tensor,
                     v_new: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int]):
    """Multi-token verify for self-speculative decoding: append all S rows
    per slot (``cache.append_batch``), then attend each query at its own
    position. ``q (B, S, H, hd)``, ``pos (B, S)`` per-slot absolute
    positions (-1 rows for inactive slots). On the int8 layouts' fused
    route one ``verify_attn_quant[_paged]`` launch attends all S queries;
    on the dequant-fp route and for fp caches each query j attends through
    the one-token per-slot softmax. Either way rows at positions past a
    query's own mask out, so query j's output is the one-token
    ``decode_attention``'s at ``pos[:, j]``. Returns (out (B, S, H, hd),
    new cache)."""
    from repro_torch.runtime import dispatch
    out_dtype = v_new.dtype
    pos32 = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    new = cache.append_batch(k_new, v_new, pos32)
    paged = isinstance(new, PagedKVCache)
    if isinstance(new, qkv.QUANT_CACHE_TYPES) and \
            dispatch.resolve_decode_attn(q.device) != "dequant-fp":
        from repro_torch.kernels import ops
        pos32 = pos32.contiguous()
        if paged:
            out = ops.verify_attn_quant_paged(
                q, new.k, new.k_scale, new.v, new.v_scale, new.pos,
                new.page_table, pos32, window=window)
        else:
            out = ops.verify_attn_quant(q, new.k, new.k_scale, new.v,
                                        new.v_scale, new.pos, pos32,
                                        window=window)
        return out.to(out_dtype), new
    dense = new.gather() if paged else new
    if dense.pos.dim() != 2:
        raise ValueError("verify_attention needs a per-slot cache (pos (B, "
                         "Sc))")
    if isinstance(dense, QuantKVCache):
        k = qkv.dequantize(dense.k, dense.k_scale, k_new.dtype)
        v = qkv.dequantize(dense.v, dense.v_scale, out_dtype)
    else:
        k, v = dense.k, dense.v
    return torch.cat([_attend_rows(q[:, j:j + 1], k, v, dense.pos,
                                   pos32[:, j], window)
                      for j in range(q.shape[1])], dim=1), new


def append_attention(q: torch.Tensor, cache: PagedKVCache,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     q_pos: torch.Tensor, slot: int, *,
                     window: Optional[int]):
    """Chunked prefill for one paged slot: quantize-and-write the chunk's
    rows into the slot's pages at absolute positions ``q_pos`` (-1 pads
    are dropped), then attend the chunk's queries causally over the slot's
    dense gathered view. Row values and mask sets match the dense prefill
    graph (unmapped columns carry ``pos = -1`` and contribute exact zeros),
    so a prompt prefilled in chunks decodes as one prefilled at once.
    Returns (out (1, C, H, hd), new cache)."""
    if not isinstance(cache, PagedKVCache):
        raise TypeError(f"append_attention needs a PagedKVCache, got "
                        f"{type(cache).__name__}")
    out_dtype = v_new.dtype
    new = cache.append_rows(k_new, v_new, q_pos, slot)
    dense = new.gather_slot(slot)
    k = qkv.dequantize(dense.k, dense.k_scale, k_new.dtype)
    v = qkv.dequantize(dense.v, dense.v_scale, out_dtype)
    out = direct_attention(q, k, v, torch.as_tensor(q_pos, dtype=torch.int32,
                                                    device=q.device),
                           dense.pos[0], causal=True, window=window)
    return out, new
