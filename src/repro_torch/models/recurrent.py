"""RWKV6 'Finch' time-mix and channel-mix (the reference's
``models/recurrent.py``, its RWKV6 half).

The projections (the FLOP carriers) are QLayers with per-bit indicator
banks; the recurrence's control parameters (the ddlerp and decay loras,
the bonus ``u``, the head group-norm) stay full precision.

The wkv recurrence of a prefill whose length is a multiple of the chunk
goes through ``kernels.ops.wkv`` (the hand-written CUDA kernel on the card,
the chunked plain version on the CPU); any other length, and every decode
step, runs the step-by-step ``wkv_scan_ref``, plain PyTorch as in the
reference. Where the reference casts to float32, this module computes in
float32 or wider, so a float64 evaluation stays float64.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import wkv_scan_ref
from repro_torch.models.common import dense_init
from repro_torch.models.quant_layers import (QuantContext, qdense_init,
                                             qeinsum)

RWKV_LORA_R = 32       # ddlerp low-rank
RWKV_DECAY_R = 64      # decay low-rank
MIN_LOG_W = -8.0       # clamp: per-step decay w >= e^-8 (numerical floor)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """float32, or ``dtype`` where it is wider."""
    return torch.promote_types(dtype, torch.float32)


def token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """RWKV token shift: the value of the *previous* timestep (zeros, or
    the carried ``x_prev`` (B, 1, D))."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def rwkv_init(gen: torch.Generator, d_model: int, n_heads: int,
              head_dim: int, d_ff: int, bits, *, stacked=(), device=None):
    """Seeded RWKV6 layer params, the reference's tree and init values
    (``gen`` an explicit generator on ``device``)."""
    D, H, hd = d_model, n_heads, head_dim
    if H * hd != D:
        raise ValueError(f"n_heads * head_dim = {H} * {hd} != d_model {D}")
    st = tuple(stacked)

    def z(*s):
        return torch.zeros(st + s, dtype=torch.float32, device=device)

    def qd(i, o):
        return qdense_init(gen, i, o, bits, stacked=st, device=device)

    return {
        # ddlerp mixing (fp)
        "mu_x": z(D),
        "mu": z(5, D),                                  # w, k, v, r, g
        "lora_A": dense_init(gen, D, 5 * RWKV_LORA_R, stacked=st,
                             device=device) * 0.1,
        "lora_B": z(5, RWKV_LORA_R, D),
        # data-dependent decay (fp)
        "w0": z(D) - 4.0,                               # init: slowish decay
        "wd1": dense_init(gen, D, RWKV_DECAY_R, stacked=st,
                          device=device) * 0.1,
        "wd2": z(RWKV_DECAY_R, D),
        "u": z(H, hd) + 0.5,                            # bonus
        # head group-norm (fp)
        "ln_x_scale": z(D) + 1.0,
        "ln_x_bias": z(D),
        # projections (QLayers)
        "wr": qd(D, D), "wk": qd(D, D), "wv": qd(D, D), "wg": qd(D, D),
        "wo": qd(D, D),
        # channel-mix
        "mu_ck": z(D),
        "mu_cr": z(D),
        "cm_wk": qd(D, d_ff),
        "cm_wv": qd(d_ff, D),
        "cm_wr": qd(D, D),
    }


RWKV_QLAYER_PATHS = ("wr", "wk", "wv", "wg", "wo", "cm_wk", "cm_wv", "cm_wr")


def _ddlerp(x: torch.Tensor, xs: torch.Tensor, p) -> Tuple[torch.Tensor, ...]:
    """RWKV6 data-dependent lerp -> the 5 mixed inputs (w, k, v, r, g)."""
    sx = xs - x
    xxx = x + sx * p["mu_x"].to(x.dtype)
    B, S, _ = x.shape
    lo = torch.tanh(torch.einsum("bsd,dr->bsr", xxx, p["lora_A"].to(x.dtype)))
    lo = lo.reshape(B, S, 5, RWKV_LORA_R)
    lo = torch.einsum("bsfr,frd->bsfd", lo, p["lora_B"].to(x.dtype))
    return tuple(x + sx * (p["mu"][i].to(x.dtype) + lo[:, :, i])
                 for i in range(5))


def _decay_log(x_w: torch.Tensor, p) -> torch.Tensor:
    """log w_t in [MIN_LOG_W, -1e-6]: w = exp(-exp(w0 + tanh(x_w wd1) wd2))."""
    dt = _wide(x_w.dtype)
    d = p["w0"].to(dt) + torch.einsum(
        "bsr,rd->bsd",
        torch.tanh(torch.einsum("bsd,dr->bsr", x_w.to(dt), p["wd1"].to(dt))),
        p["wd2"].to(dt))
    return torch.clamp(-torch.exp(d), MIN_LOG_W, -1e-6)


def _head_groupnorm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 64e-5) -> torch.Tensor:
    """RWKV ln_x: GroupNorm with one group per head (population variance),
    affine over D."""
    B, S, H, hd = y.shape
    dt = _wide(y.dtype)
    y32 = y.to(dt)
    mu = y32.mean(dim=-1, keepdim=True)
    var = y32.var(dim=-1, keepdim=True, unbiased=False)
    yn = ((y32 - mu) * torch.rsqrt(var + eps)).reshape(B, S, H * hd)
    return (yn * scale.to(dt) + bias.to(dt)).to(y.dtype)


def _b(bits: Optional[Dict], name: str):
    return None if bits is None else bits[name]


def rwkv_time_mix(x: torch.Tensor, p, bits: Optional[Dict],
                  ctx: QuantContext, n_heads: int, head_dim: int,
                  state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  chunk: int = 32):
    """x: (B, S, D); state = (x_prev (B, 1, D), wkv (B, H, hd, hd)) or None
    (zero state). Returns (out, (x[:, -1:], new wkv state))."""
    B, S, _ = x.shape
    H, hd = n_heads, head_dim
    x_prev = None if state is None else state[0]

    xs = token_shift(x, x_prev)
    x_w, x_k, x_v, x_r, x_g = _ddlerp(x, xs, p)
    log_w = _decay_log(x_w, p).reshape(B, S, H, hd)
    r = qeinsum("bsd,de->bse", x_r, p["wr"], _b(bits, "wr"), ctx)
    k = qeinsum("bsd,de->bse", x_k, p["wk"], _b(bits, "wk"), ctx)
    v = qeinsum("bsd,de->bse", x_v, p["wv"], _b(bits, "wv"), ctx)
    g = F.silu(qeinsum("bsd,de->bse", x_g, p["wg"], _b(bits, "wg"), ctx))

    wt = _wide(r.dtype)
    r, k, v = (a.reshape(B, S, H, hd).to(wt).contiguous() for a in (r, k, v))
    log_w = log_w.to(wt).contiguous()
    u = p["u"].to(wt)
    if S % chunk == 0 and S > 1:
        wkv0 = None if state is None else state[1].to(wt)
        y, wkv1 = ops.wkv(r, k, v, log_w, u, wkv0, chunk=chunk)
    else:
        wkv0 = torch.zeros((B, H, hd, hd), dtype=wt, device=x.device) \
            if state is None else state[1].to(wt)
        y, wkv1 = wkv_scan_ref(r, k, v, log_w, u, wkv0)
    y = y.to(x.dtype)

    y = _head_groupnorm(y, p["ln_x_scale"], p["ln_x_bias"]) * g
    out = qeinsum("bsd,de->bse", y, p["wo"], _b(bits, "wo"), ctx)
    return out, (x[:, -1:], wkv1)


def rwkv_channel_mix(x: torch.Tensor, p, bits: Optional[Dict],
                     ctx: QuantContext,
                     state: Optional[torch.Tensor] = None):
    """x: (B, S, D); state = x_prev (B, 1, D) or None. Returns (out,
    x[:, -1:])."""
    xs = token_shift(x, state)
    xk = x + (xs - x) * p["mu_ck"].to(x.dtype)
    xr = x + (xs - x) * p["mu_cr"].to(x.dtype)
    k = qeinsum("bsd,df->bsf", xk, p["cm_wk"], _b(bits, "cm_wk"), ctx)
    k = torch.square(F.relu(k))
    kv = qeinsum("bsf,fd->bsd", k, p["cm_wv"], _b(bits, "cm_wv"), ctx)
    rgate = torch.sigmoid(qeinsum("bsd,de->bse", xr, p["cm_wr"],
                                  _b(bits, "cm_wr"), ctx))
    return rgate * kv, x[:, -1:]
