"""Plain PyTorch versions of the hand-written CUDA kernels.

They compute the same functions as ``csrc/*.cu`` from the same inputs, in
plain tensor code: the CPU tests run them (the wrappers in ``ops`` take them
for CPU tensors, or for CUDA tensors inside ``ops.plain_on_cuda()``), and ``chip_smoke.py`` holds each kernel against them on the
card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.runtime.kv_cache import PagedKVCache
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


def decode_attn_quant_paged_ref(qf: torch.Tensor, k_pages: torch.Tensor,
                                k_scale: torch.Tensor, v_pages: torch.Tensor,
                                v_scale: torch.Tensor, page_pos: torch.Tensor,
                                page_table: torch.Tensor, q_pos: torch.Tensor,
                                window: Optional[int] = None) -> torch.Tensor:
    """:func:`decode_attn_quant_ref` over the paged layout: the slots' pages
    gathered into the dense (B, P * ps, ...) view first
    (``PagedKVCache.gather``; unmapped blocks hold page 0's rows at pos
    -1). Pages (n_pages, ps, KV, hd) int8, scales (n_pages, ps, KV) f32,
    page_pos (n_pages, ps) int32, page_table (B, P) int32 (-1 unmapped)."""
    dense = PagedKVCache(k_pages, v_pages, k_scale, v_scale, page_pos,
                         page_table).gather()
    return decode_attn_quant_ref(qf, dense.k, dense.k_scale, dense.v,
                                 dense.v_scale, dense.pos, q_pos, window)


def verify_attn_quant_ref(qf: torch.Tensor, k_codes: torch.Tensor,
                          k_scale: torch.Tensor, v_codes: torch.Tensor,
                          v_scale: torch.Tensor, pos: torch.Tensor,
                          q_pos: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """S-query verify attention: :func:`decode_attn_quant_ref` once per
    query index j at ``q_pos[:, j]``. qf (B, S, KV, G, hd) f32 pre-scaled,
    q_pos (B, S) int32; returns (B, S, KV, G, hd) f32."""
    return torch.stack([
        decode_attn_quant_ref(qf[:, j], k_codes, k_scale, v_codes, v_scale,
                              pos, q_pos[:, j], window)
        for j in range(qf.shape[1])], dim=1)


def verify_attn_quant_paged_ref(qf: torch.Tensor, k_pages: torch.Tensor,
                                k_scale: torch.Tensor, v_pages: torch.Tensor,
                                v_scale: torch.Tensor, page_pos: torch.Tensor,
                                page_table: torch.Tensor, q_pos: torch.Tensor,
                                window: Optional[int] = None) -> torch.Tensor:
    """:func:`verify_attn_quant_ref` over the paged layout, on the dense
    view ``PagedKVCache.gather`` builds."""
    dense = PagedKVCache(k_pages, v_pages, k_scale, v_scale, page_pos,
                         page_table).gather()
    return verify_attn_quant_ref(qf, dense.k, dense.k_scale, dense.v,
                                 dense.v_scale, dense.pos, q_pos, window)


def _wide(*ts: torch.Tensor) -> torch.dtype:
    """float32, or the widest floating type of ``ts`` if that is wider (the
    reference computes in float32; a float64 evaluation stays float64)."""
    dt = torch.float32
    for t in ts:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def wkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step RWKV6 wkv recurrence. r/k/v/log_w (B, S, H, hd), u (H,
    hd), state (B, H, hd, hd); i runs over key channels, j over value
    channels:

        y_t = r_t . (S_t + (u * k_t) v_t^T);  S_{t+1} = diag(w_t) S_t + k_t v_t^T

    Returns (y (B, S, H, hd), final state), in the inputs' own types."""
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t = r[:, t], k[:, t], v[:, t]
        w_t = torch.exp(log_w[:, t])
        y = torch.einsum("bhi,bhij->bhj", r_t, state) \
            + torch.einsum("bhi,bhi,bhj->bhj", r_t, u * k_t, v_t)
        state = w_t[..., None] * state + torch.einsum("bhi,bhj->bhij", k_t,
                                                      v_t)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`wkv_scan_ref` from zero state in float32 or wider: the
    step-by-step oracle of the chunked form. Returns y (B, S, H, hd)."""
    dt = _wide(r, k, v, log_w, u)
    B, _, H, hd = r.shape
    state = torch.zeros((B, H, hd, hd), dtype=dt, device=r.device)
    y, _ = wkv_scan_ref(*(a.to(dt) for a in (r, k, v, log_w, u)), state)
    return y


def wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_w: torch.Tensor, u: torch.Tensor,
                    state0: Optional[torch.Tensor] = None, chunk: int = 32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked RWKV6 wkv (the reference's ``wkv_chunked``), from ``state0``
    (zero when None). Shapes as :func:`wkv_scan_ref`; ``S % chunk == 0``.

    Per chunk, with L the inclusive cumulative log-decay and Lx = L - lw:
    ``y = (r e^Lx) S0 + A v + (sum_i r u k) v`` with ``A[t, s] = sum_i
    r[t, i] k[s, i] e^{min(Lx[t, i] - L[s, i], 0)}`` for t > s, and ``S <-
    diag(e^{L_T}) S0 + (k e^{L_T - L})^T v``: every exponent <= 0. Computes
    in float32 or wider; returns (y in r's type, final state)."""
    B, S, H, hd = r.shape
    if S % chunk:
        raise ValueError(f"wkv: S={S} is not a multiple of chunk={chunk}")
    dt = _wide(r, k, v, log_w, u)
    n, T = S // chunk, chunk

    def split(a):                                    # (n, B, H, T, hd)
        return a.to(dt).reshape(B, n, T, H, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(split, (r, k, v, log_w))
    uu = u.to(dt)[None, :, None, :]                   # (1, H, 1, hd)
    tri = torch.tril(torch.ones((T, T), dtype=dt, device=r.device), -1)
    S0 = torch.zeros((B, H, hd, hd), dtype=dt, device=r.device) \
        if state0 is None else state0.to(dt)
    ys = []
    for c in range(n):
        rt, kt, vt, lwt = rc[c], kc[c], vc[c], lwc[c]
        L = torch.cumsum(lwt, dim=2)                  # sum_{tau <= t} lw
        Lx = L - lwt                                  # sum_{tau < t} lw
        y = torch.einsum("bhti,bhij->bhtj", rt * torch.exp(Lx), S0)
        expo = Lx[:, :, :, None, :] - L[:, :, None, :, :]   # (B,H,t,tau,hd)
        dec = torch.exp(torch.clamp(expo, max=0.0)) * tri[None, None, :, :,
                                                          None]
        A = torch.einsum("bhti,bhtsi,bhsi->bhts", rt, dec, kt)
        y = y + torch.einsum("bhts,bhsj->bhtj", A, vt)
        y = y + torch.einsum("bhti,bhti,bhtj->bhtj", rt, uu * kt, vt)
        LT = L[:, :, -1:, :]                          # (B, H, 1, hd)
        k_dec = kt * torch.exp(LT - L)
        S0 = torch.exp(LT[:, :, 0, :, None]) * S0 \
            + torch.einsum("bhti,bhtj->bhij", k_dec, vt)
        ys.append(y)
    y = torch.stack(ys, dim=0).permute(1, 0, 3, 2, 4).reshape(B, S, H, hd)
    return y.to(r.dtype), S0


def wkv_chunkpar_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, u: torch.Tensor,
                     state0: Optional[torch.Tensor] = None, chunk: int = 32,
                     sub: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`wkv_chunked_ref` by ``csrc/wkv.cu``'s decomposition, for the
    CPU tests only (the kernel's plain version on the card stays
    :func:`wkv_chunked_ref`). In log2 units, Λ = cumsum(lw log2 e) per
    chunk and Λx_t = Λ_{t-1} (0 at t = 0):

    (a) every chunk on its own. Pair weights ``A[t, s]`` for t > s: within
        a sub-chunk of ``sub`` rows ``sum_i r k 2^{min(Λx_t - Λ_s, 0)}``;
        across sub-chunks the exponent factors about the row b before t's
        sub-chunk, ``sum_i (r_t 2^{min(Λx_t - Λ_b, 0)}) (k_s 2^{min(Λ_b -
        Λ_s, 0)})``; ``sum_i r u k`` at t = s. Then ``y_local = A v``,
        ``dS = (k 2^{Λ_T - Λ})^T v``, ``e = 2^{Λ_T}``, ``q = r 2^{Λx}``;
    (b) the carry in chunk order from ``state0`` (zero when None), which
        enters chunk 0 only: ``S_c = diag(e_c) S_{c-1} + dS_c`` and ``y_c =
        y_local + q_c S_{c-1}``.

    Shapes and types as :func:`wkv_chunked_ref`."""
    B, S, H, hd = r.shape
    if S % chunk or chunk % sub:
        raise ValueError(f"wkv: S={S} is not a multiple of chunk={chunk}, "
                         f"or chunk of sub={sub}")
    dt = _wide(r, k, v, log_w, u)
    n, T = S // chunk, chunk

    def split(a):                                    # (B, H, n, T, hd)
        return a.to(dt).reshape(B, n, T, H, hd).permute(0, 3, 1, 2, 4)

    rc, kc, vc, lwc = map(split, (r, k, v, log_w))
    lam = torch.cumsum(lwc * math.log2(math.e), dim=3)
    lamx = torch.cat([torch.zeros_like(lam[..., :1, :]), lam[..., :-1, :]],
                     dim=3)
    # (a) chunk-local, every chunk at once: pairs within a sub-chunk
    t_idx = torch.arange(T, device=r.device)
    same = (t_idx[:, None] // sub == t_idx[None, :] // sub) \
        & (t_idx[:, None] > t_idx[None, :])
    dec = torch.exp2(torch.clamp(lamx[..., :, None, :] - lam[..., None, :, :],
                                 max=0.0)) * same.to(dt)[..., None]
    A = torch.einsum("bhcti,bhctsi,bhcsi->bhcts", rc, dec, kc)
    # ... across sub-chunks, factored about b = sub * tau - 1
    for tau in range(1, T // sub):
        rows, b = slice(sub * tau, sub * (tau + 1)), sub * tau - 1
        r_hat = rc[..., rows, :] * torch.exp2(torch.clamp(
            lamx[..., rows, :] - lam[..., b:b + 1, :], max=0.0))
        k_hat = kc[..., :sub * tau, :] * torch.exp2(torch.clamp(
            lam[..., b:b + 1, :] - lam[..., :sub * tau, :], max=0.0))
        A[..., rows, :sub * tau] = r_hat @ k_hat.transpose(-1, -2)
    bonus = torch.einsum("bhcti,hi,bhcti->bhct", rc, u.to(dt), kc)
    A = A + torch.diag_embed(bonus)
    y_local = A @ vc
    lam_T = lam[..., -1:, :]
    dS = torch.einsum("bhcti,bhctj->bhcij", kc * torch.exp2(lam_T - lam), vc)
    e = torch.exp2(lam_T[..., 0, :])                 # (B, H, n, hd)
    q = rc * torch.exp2(lamx)
    # (b) the carry
    St = torch.zeros((B, H, hd, hd), dtype=dt, device=r.device) \
        if state0 is None else state0.to(dt)
    ys = []
    for c in range(n):
        ys.append(y_local[:, :, c] if c == 0 and state0 is None
                  else y_local[:, :, c] + q[:, :, c] @ St)
        St = e[:, :, c, :, None] * St + dS[:, :, c]
    y = torch.stack(ys, dim=2).permute(0, 2, 3, 1, 4).reshape(B, S, H, hd)
    return y.to(r.dtype), St
