"""Plain PyTorch versions of the hand-written CUDA kernels.

They compute the same functions as ``csrc/*.cu`` from the same inputs, in
plain tensor code: the CPU tests run them (the wrappers in ``ops`` take them
for CPU tensors, or for CUDA tensors inside ``ops.plain_on_cuda()``), and ``chip_smoke.py`` holds each kernel against them on the
card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.runtime.packing import unpack_nib4

NEG_INF = -1e30


def quant_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
                     s_w: torch.Tensor) -> torch.Tensor:
    """``float32(x_q @ w_q) * (s_x * s_w)`` with the exact integer sum.

    The sum runs in float64, which holds every partial sum exactly here
    (``K * 128**2 < 2**53``) on both the CPU and the card, where PyTorch
    has no integer matmul; a float32 sum would not be exact
    (``3072 * 127**2 > 2**24``)."""
    acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
    scale = s_x.to(torch.float32).reshape(()) * s_w.to(torch.float32).reshape(())
    return acc.to(torch.float32) * scale


def quant_matmul_w4_ref(x_q: torch.Tensor, w_p: torch.Tensor,
                        s_x: torch.Tensor, s_w: torch.Tensor) -> torch.Tensor:
    """:func:`quant_matmul_ref` with nib4-packed int4 weights (two K-rows
    per byte, low nibble = even k, offset-binary ``q + 8``)."""
    return quant_matmul_ref(x_q, unpack_nib4(w_p, x_q.shape[1]), s_x, s_w)


def fake_quant_ref(v: torch.Tensor, s: torch.Tensor, qmin: float,
                   qmax: float) -> torch.Tensor:
    """Eq. 1 forward: ``round(clip(v / max(s, 1e-9), qmin, qmax)) * s``."""
    s = torch.clamp(s.to(v.dtype), min=1e-9)
    return torch.round(torch.clamp(v / s, qmin, qmax)) * s


def fake_quant_grads_ref(v: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                         qmin: float, qmax: float):
    """LSQ backward (Esser et al.): ``(dv, ds)``. dv passes g strictly
    inside the clip range; ds sums ``g * (round(v/s) - v/s)`` inside and
    ``g * clip(v/s)`` outside (before the grad-scale factor)."""
    s = torch.clamp(s.to(torch.float32), min=1e-9)
    vs = v.to(torch.float32) / s
    inside = (vs > qmin) & (vs < qmax)
    dv = torch.where(inside, g, torch.zeros_like(g))
    c = torch.clamp(vs, qmin, qmax)
    dsd = torch.where(inside, torch.round(c) - vs, c)
    ds = (g.to(torch.float32) * dsd).sum()
    return dv.to(v.dtype), ds


def kv_slice_len(S: int, window: Optional[int], q_block: int, kv_block: int):
    """(kv rows one q block attends, kv block) of the blockwise flash
    schedule: a window shorter than S bounds the kv slice of a q block."""
    if window is not None and S > window + q_block:
        Lkv = min(((window + q_block + kv_block - 1) // kv_block) * kv_block, S)
    else:
        Lkv = S
    return Lkv, min(kv_block, Lkv)


def flash_fwd_ref(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: Optional[int], q_block: int = 512,
                  kv_block: int = 512):
    """Blockwise online-softmax forward with per-row logsumexp (the
    reference's ``_flash_fwd_lse``). qr (B, S, KV, G, hd) pre-scaled, k/v
    (B, S, KV, hd). Returns (out (B, S, KV, G, hd) f32, lse (B, KV, G, S)
    f32)."""
    B, S, KV, G, hd = qr.shape
    dev = qr.device
    Lkv, kvb = kv_slice_len(S, window, q_block, kv_block)
    outs, lses = [], []
    for qs in range(0, S, q_block):
        q_blk = qr[:, qs:qs + q_block].to(torch.float32)
        qpos = torch.arange(qs, qs + q_block, device=dev)
        start = 0 if Lkv == S else min(max(qs + q_block - Lkv, 0), S - Lkv)
        m = torch.full((B, KV, G, q_block), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, q_block), device=dev)
        acc = torch.zeros((B, KV, G, q_block, hd), device=dev)
        for s0 in range(start, start + Lkv, kvb):
            k_blk = k[:, s0:s0 + kvb].to(torch.float32)
            v_blk = v[:, s0:s0 + kvb].to(torch.float32)
            kpos = torch.arange(s0, s0 + kvb, device=dev)
            valid = torch.ones((q_block, kvb), dtype=torch.bool, device=dev)
            if causal:
                valid &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                valid &= qpos[:, None] - kpos[None, :] < window
            logits = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk) + \
                torch.where(valid, 0.0, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, v_blk)
            m = m_new
        lf = torch.clamp(l, min=1e-30)
        outs.append(acc / lf[..., None])
        lses.append(m + torch.log(lf))
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)       # (B,S,KV,G,hd)
    return out.contiguous(), torch.cat(lses, dim=3)


def decode_attn_quant_ref(qf: torch.Tensor, k_codes: torch.Tensor,
                          k_scale: torch.Tensor, v_codes: torch.Tensor,
                          v_scale: torch.Tensor, pos: torch.Tensor,
                          q_pos: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """One-token GQA attention on int8 codes, whole-row softmax.

    qf: (B, KV, G, hd) f32, already scaled by hd**-0.5; codes (B, Sc, KV, hd)
    int8; scales (B, Sc, KV) f32; pos (B, Sc) int32; q_pos (B,) int32.
    Returns (B, KV, G, hd) f32: the K-scale multiplies the logit after the
    dot on the codes, the V-scale multiplies the probability before PV, and
    the row sum is floored at 1e-30."""
    kc = k_codes.to(torch.float32).permute(0, 2, 1, 3)        # (B,KV,Sc,hd)
    vc = v_codes.to(torch.float32).permute(0, 2, 1, 3)
    logits = torch.matmul(qf, kc.transpose(-1, -2))          # (B,KV,G,Sc)
    logits = logits * k_scale.permute(0, 2, 1)[:, :, None, :]
    p_ = pos[:, None, None, :]
    qp = q_pos.reshape(-1, 1, 1, 1)
    valid = (p_ >= 0) & (p_ <= qp)
    if window is not None:
        valid &= qp - p_ < window
    logits = logits + torch.where(valid, 0.0, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p * v_scale.permute(0, 2, 1)[:, :, None, :], vc)
    return pv / torch.clamp(l, min=1e-30)
