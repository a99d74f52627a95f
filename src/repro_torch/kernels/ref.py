"""Plain PyTorch versions of the hand-written CUDA kernels.

They compute the same functions as ``csrc/*.cu`` from the same inputs, in
plain tensor code: the CPU tests run them (the wrappers in ``ops`` take them
for CPU tensors), and ``chip_smoke.py`` holds each kernel against them on
the card.
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
