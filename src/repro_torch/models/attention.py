"""Attention: GQA with RoPE'd inputs for training and prefill
(``self_attention``) and the one-token decode path over fp / int8 ring KV
caches.

``self_attention`` switches as the reference does: from 2048 tokens on
(S a multiple of the 512-row q block) it takes ``flash_attention_cv`` --
the ``flash_fwd`` CUDA kernel forward (its plain blockwise version on the
CPU) and a recompute backward in PyTorch that saves only (out, lse) --
and below that ``direct_attention``, which materializes the (B, KV, G, Sq,
Sk) logits. Decode over an int8 cache routes through
``runtime.dispatch.resolve_decode_attn``: the ``decode_attn_quant`` CUDA
kernel reads the codes directly, and the dequant-fp route rebuilds exact fp
rows first (CPU tensors, and the numerics the kernel is held against).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ref import kv_slice_len as _kv_slice_len
from repro_torch.runtime import kv_cache as qkv
from repro_torch.runtime.kv_cache import FpKVCache, QuantKVCache

NEG_INF = -1e30


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
    """Training and prefill attention: the flash path from
    ``flash_threshold`` tokens on (when S is a multiple of ``q_block``), as
    the reference switches, else the direct masked softmax."""
    S = q.shape[1]
    if S >= flash_threshold and S % q_block == 0:
        return flash_attention_cv(q, k, v, causal=causal, window=window,
                                  q_block=q_block, kv_block=kv_block)
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
    (pos (B, Sc)); other leaves and per-slot caches pass through."""
    if not isinstance(cache, qkv.CACHE_TYPES) or cache.pos.dim() != 1:
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
    per-slot cache (pos (B, Sc)) ``pos`` is a (B,) vector and each row masks
    independently. Returns (out (B, 1, H, hd), new cache)."""
    from repro_torch.runtime import dispatch
    out_dtype = v_new.dtype
    new = cache.append(k_new, v_new, pos)
    pos32 = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
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
