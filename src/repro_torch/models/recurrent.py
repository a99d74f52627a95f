"""Attention-free mixers (the reference's ``models/recurrent.py``): RWKV6
'Finch' time-mix and channel-mix, and the Griffin RG-LRU recurrent block
(recurrentgemma).

The projections (the FLOP carriers) are QLayers with per-bit indicator
banks; the recurrence's control parameters (the ddlerp and decay loras,
the bonus ``u``, the head group-norm; the RG-LRU gates, ``lam`` and the
temporal conv1d) stay full precision.

The wkv recurrence of a prefill whose length is a multiple of the chunk
goes through ``kernels.ops.wkv`` (the hand-written CUDA kernel on the card,
the chunked plain version on the CPU); any other length, and every decode
step, runs the step-by-step ``wkv_scan_ref``, plain PyTorch as in the
reference. Where the reference casts to float32, this module computes in
float32 or wider, so a float64 evaluation stays float64.

The RG-LRU recurrence ``h_t = a_t h_{t-1} + b_t`` has no TPU kernel: the
reference runs ``jax.lax.associative_scan``, and ``rglru_scan`` runs the
same odd/even combine tree in plain PyTorch (log2 S levels of whole-tensor
ops, each product and sum the reference's), so on the same inputs it is
the reference run op by op, bit for bit.
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
RGLRU_C = 8.0          # Griffin's fixed temperature on the recurrent gate
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


# ===========================================================================
# RG-LRU recurrent block (Griffin / recurrentgemma)
# ===========================================================================
def rglru_init(gen: torch.Generator, d_model: int, lru_width: int,
               n_heads: int, conv_width: int, bits, *, stacked=(),
               device=None):
    """Seeded RG-LRU block params, the reference's tree and init values:
    the ``wx``/``wgate``/``wo`` QLayers, a depthwise conv1d whose taps are
    one draw each, shared across the width, block-diagonal gates of
    ``n_heads`` blocks, and ``lam`` spread so a = sigmoid(lam)^c covers
    (0.9, 0.999) (Griffin A.2)."""
    W = lru_width or d_model
    bw = W // n_heads     # block-diagonal gate width
    st = tuple(stacked)

    def z(*s):
        return torch.zeros(st + s, dtype=torch.float32, device=device)

    def qd(i, o):
        return qdense_init(gen, i, o, bits, stacked=st, device=device)

    p = {"wx": qd(d_model, W), "wgate": qd(d_model, W), "wo": qd(W, d_model)}
    taps = dense_init(gen, conv_width, 1, stacked=st, device=device)
    p["conv_w"] = taps[..., 0][..., None] * torch.ones(
        st + (conv_width, W), device=device)
    p["conv_b"] = z(W)
    p["gate_a_w"] = dense_init(gen, bw, bw, stacked=st + (n_heads,),
                               device=device)
    p["gate_a_b"] = z(n_heads, bw)
    p["gate_x_w"] = dense_init(gen, bw, bw, stacked=st + (n_heads,),
                               device=device)
    p["gate_x_b"] = z(n_heads, bw)
    lam = torch.linspace(2.2, 6.0, W, dtype=torch.float32, device=device)
    p["lam"] = lam.expand(st + (W,)).contiguous()
    return p


RGLRU_QLAYER_PATHS = ("wx", "wgate", "wo")


def _causal_conv1d(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. u (B, S, W); w (cw, W); state (B, cw-1, W) or
    None (zeros): the last cw - 1 inputs of the previous call. Returns
    (out (B, S, W), the last cw - 1 rows of [state; u])."""
    cw = w.shape[0]
    if state is None:
        state = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    ext = torch.cat([state.to(u.dtype), u], dim=1)      # (B, S+cw-1, W)
    S = u.shape[1]
    out = torch.zeros_like(u)
    for j in range(cw):            # cw = 4: four shifted multiply-adds
        out = out + ext[:, j:j + S] * w[cw - 1 - j].to(u.dtype)
    out = out + b.to(u.dtype)
    return out, (ext[:, -(cw - 1):] if cw > 1 else state)


def _block_diag_gate(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     n_heads: int) -> torch.Tensor:
    """sigmoid(block-diagonal linear), in float32 or wider. u (B, S, W);
    w (H, bw, bw); b (H, bw)."""
    B, S, W = u.shape
    dt = _wide(u.dtype)
    uh = u.reshape(B, S, n_heads, W // n_heads).to(dt)
    y = torch.einsum("bshi,hij->bshj", uh, w.to(dt)) + b.to(dt)
    return torch.sigmoid(y).reshape(B, S, W)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 under (a1, b1) . (a2, b2) = (a1 a2,
    a2 b1 + b2), ``jax.lax.associative_scan``'s tree: combine adjacent
    pairs, scan the pairs (the odd outputs), then combine each odd output
    with the next even input (the even outputs), and interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_lo, b_lo = a[:, 0:-1:2], b[:, 0:-1:2]
    a_hi, b_hi = a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _assoc_scan(a_lo * a_hi, a_hi * b_lo + b_hi)
    a_ev, b_ev = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        odd_a_, odd_b_ = odd_a[:, :-1], odd_b[:, :-1]
    else:
        odd_a_, odd_b_ = odd_a, odd_b
    even_a = torch.cat([a[:, :1], odd_a_ * a_ev], dim=1)
    even_b = torch.cat([b[:, :1], a_ev * odd_b_ + b_ev], dim=1)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = even_a, odd_a
    out_b[:, 0::2], out_b[:, 1::2] = even_b, odd_b
    return out_a, out_b


def rglru_scan(a: torch.Tensor, bx: torch.Tensor,
               h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t through the associative scan. a/bx (B, S,
    W); h0 (B, W) or None (zero). Returns h (B, S, W)."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None].to(bx.dtype),
                        bx[:, 1:]], dim=1)
    return _assoc_scan(a, bx)[1]


def rglru_block(x: torch.Tensor, p, bits: Optional[Dict], ctx: QuantContext,
                n_heads: int,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Griffin recurrent block. x (B, S, D); state = (conv_buf (B, cw-1, W),
    h (B, W)) or None (zeros). Returns (out (B, S, D), (conv_buf, h at the
    last position in float32 or wider)); a one-token call takes the
    recurrence's single step instead of the scan."""
    u = qeinsum("bsd,dw->bsw", x, p["wx"], _b(bits, "wx"), ctx)
    gate = F.gelu(qeinsum("bsd,dw->bsw", x, p["wgate"], _b(bits, "wgate"),
                          ctx), approximate="tanh")   # jax.nn.gelu's default
    u, conv_state = _causal_conv1d(u, p["conv_w"], p["conv_b"],
                                   None if state is None else state[0])

    dt = _wide(u.dtype)
    r = _block_diag_gate(u, p["gate_a_w"], p["gate_a_b"], n_heads)
    i = _block_diag_gate(u, p["gate_x_w"], p["gate_x_b"], n_heads)
    lam = p["lam"].to(dt)
    # softplus as jax.nn.softplus computes it, logaddexp(lam, 0)
    log_a = (-RGLRU_C * torch.logaddexp(lam, torch.zeros_like(lam))) * r
    a = torch.exp(log_a)                                 # (B, S, W) in (0, 1)
    gated = i * u.to(dt)
    bx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated

    h0 = None if state is None else state[1].to(dt)
    if x.shape[1] == 1:                                  # decode: one step
        hprev = torch.zeros_like(bx[:, 0]) if h0 is None else h0
        h = (a[:, 0] * hprev + bx[:, 0])[:, None]
    else:
        h = rglru_scan(a, bx, h0)
    y = h.to(x.dtype) * gate
    out = qeinsum("bsw,wd->bsd", y, p["wo"], _b(bits, "wo"), ctx)
    return out, (conv_state, h[:, -1])
