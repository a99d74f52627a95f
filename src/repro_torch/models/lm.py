"""Config-driven LM, dense/attention layer kinds (serving and training).

A config expands into a *schedule*: ``prefix`` layers, a repeating
``pattern`` whose params are stacked ``repeats`` times on a leading axis
(the reference package scans over it), and ``suffix`` layers. The param
tree and its key paths are the reference's (``prefix``/``body``/``suffix``
/``embed``/``final_norm``/``head``), so weights cross over by key
(``repro_torch.interop``). Eager PyTorch has nothing to gain from a scan:
every forward here runs site by site (``iter_sites``), a body site on its
unit of the stack (``reference_sites``).

Every searchable projection is a QLayer (``core.qspec``) whose per-bit
indicator banks live next to the weight. Bit selection arrives as a
``bits`` tree mirroring the param tree (``bits_uniform``, ``bits_random``,
``bits_from_policy``): python ints for unrolled layers, per-unit index
arrays for the stacked body; a gradient reaches exactly the selected bank
entry of each unit.

Modes: ``train`` (full-sequence logits, no state: ``apply_train`` /
``loss_fn``), ``prefill`` (logits at the last position + decode state) and
``decode`` (one token per batch row with state). Decode state is
``{"sites": {"<gidx>": cache}}``, one KV cache per attention site.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import MPQPolicy
from repro_torch.core.qspec import QLayer
from repro_torch.core.quantizer import bit_range, init_scale_from_stats
from repro_torch.models import attention as attn
from repro_torch.models.common import (activation, apply_norm, apply_rope,
                                       dense_init, embed_init, norm_init)
from repro_torch.models.quant_layers import (QuantContext,
                                             embed_lookup_pinned,
                                             pinned_table, qdense_init,
                                             qeinsum, qeinsum_pinned)
from repro_torch.runtime import kv_cache as qkv

ATTN_KINDS = ("attn", "dense")
MOE_AUX_COEF = 0.01


# ===========================================================================
# schedule
# ===========================================================================
class Schedule(NamedTuple):
    prefix: Tuple[str, ...]
    pattern: Tuple[str, ...]
    repeats: int
    suffix: Tuple[str, ...]


class LayerSite(NamedTuple):
    kind: str          # attn | dense
    segment: str       # "prefix.0" | "body.2" | "suffix.1"
    unit: int          # repeat index within body, else 0
    gidx: int          # global execution index


def build_schedule(cfg: ModelConfig) -> Schedule:
    if cfg.family in ("moe", "vlm", "hybrid", "ssm") or cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense decoder families only "
            f"(family {cfg.family!r} comes with a later slice)")
    return Schedule((), ("attn",), cfg.n_layers, ())


def iter_sites(cfg: ModelConfig) -> List[LayerSite]:
    s = build_schedule(cfg)
    sites, g = [], 0
    for i, kind in enumerate(s.prefix):
        sites.append(LayerSite(kind, f"prefix.{i}", 0, g))
        g += 1
    for u in range(s.repeats):
        for p, kind in enumerate(s.pattern):
            sites.append(LayerSite(kind, f"body.{p}", u, g))
            g += 1
    for i, kind in enumerate(s.suffix):
        sites.append(LayerSite(kind, f"suffix.{i}", 0, g))
        g += 1
    return sites


def site_key(gidx: int) -> str:
    return f"{gidx:03d}"


def _select(tree, unit: Optional[int]):
    """Unit ``unit`` of every stacked tensor of a nested dict (None: as
    is)."""
    if isinstance(tree, dict):
        return {k: _select(v, unit) for k, v in tree.items()}
    return tree if unit is None else tree[unit]


def site_params(params, site: LayerSite):
    """One site's param subtree (a body site's unit sliced off the stack)."""
    seg, idx = site.segment.split(".")
    return _select(params[seg][idx], site.unit if seg == "body" else None)


# ===========================================================================
# init
# ===========================================================================
def _layer_init(gen, cfg: ModelConfig, kind: str, *, stacked=(), device=None):
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r}")
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff

    def nrm():
        return {k: v.expand(tuple(stacked) + tuple(v.shape)).contiguous()
                for k, v in norm_init(d, cfg.norm_type, device).items()}

    def qd_(i, o):
        return qdense_init(gen, i, o, cfg.bits, stacked=stacked, device=device)

    p = {"norm1": nrm(), "norm2": nrm(),
         "wq": qd_(d, qd), "wk": qd_(d, kvd), "wv": qd_(d, kvd),
         "wo": qd_(qd, d)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(tuple(stacked) + (cfg.hd,), device=device)
        p["k_norm"] = torch.ones(tuple(stacked) + (cfg.hd,), device=device)
    p["mlp_wi"] = qd_(d, ff)
    p["mlp_wo"] = qd_(ff, d)
    if cfg.mlp_gated:
        p["mlp_wg"] = qd_(d, ff)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device=None
                ) -> Dict[str, Any]:
    """Seeded random params with the reference's tree layout (one explicit
    ``torch.Generator`` on ``device``; the values differ from JAX's, whose
    PRNG differs -- carry JAX params across with ``interop`` instead)."""
    sched = build_schedule(cfg)
    gen = torch.Generator(device=device or "cpu").manual_seed(int(seed))
    w = embed_init(gen, cfg.vocab, cfg.d_model, device=device)
    params: Dict[str, Any] = {"embed": {
        "w": w, "s_w8": init_scale_from_stats(w, bit_range(8, True)[1])}}
    params["prefix"] = {str(i): _layer_init(gen, cfg, k, device=device)
                        for i, k in enumerate(sched.prefix)}
    params["body"] = {str(p): _layer_init(gen, cfg, k, stacked=(sched.repeats,),
                                          device=device)
                      for p, k in enumerate(sched.pattern)} \
        if sched.repeats else {}
    params["suffix"] = {str(i): _layer_init(gen, cfg, k, device=device)
                        for i, k in enumerate(sched.suffix)}
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm_type, device)
    if cfg.tie_embeddings:
        params["head"] = {"s_a8": torch.tensor(0.1 / 8, dtype=torch.float32,
                                               device=device)}
    else:
        hw = dense_init(gen, cfg.d_model, cfg.vocab, device=device)
        params["head"] = {
            "w": hw, "s_w8": init_scale_from_stats(hw, bit_range(8, True)[1]),
            "s_a8": torch.tensor(0.1 / 8, dtype=torch.float32, device=device)}
    return params


def param_count(params) -> int:
    """Number of scalars in a param tree."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(params.numel())


# ===========================================================================
# QLayer enumeration (must mirror init_params exactly)
# ===========================================================================
def _kind_qdefs(cfg: ModelConfig, kind: str):
    """[(path, in, out, n_mats, macs_per_token, w_params, qkind)]"""
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r}")
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    defs = [
        (("wq",), d, qd, 1, d * qd, d * qd, "attn"),
        (("wk",), d, kvd, 1, d * kvd, d * kvd, "attn"),
        (("wv",), d, kvd, 1, d * kvd, d * kvd, "attn"),
        (("wo",), qd, d, 1, qd * d, qd * d, "attn"),
        (("mlp_wi",), d, ff, 1, d * ff, d * ff, "mlp"),
        (("mlp_wo",), ff, d, 1, ff * d, ff * d, "mlp"),
    ]
    if cfg.mlp_gated:
        defs.append((("mlp_wg",), d, ff, 1, d * ff, d * ff, "mlp"))
    return defs


def enumerate_qlayers(cfg: ModelConfig) -> List[QLayer]:
    out = []
    for site in iter_sites(cfg):
        for path, i, o, n, macs, w, qk in _kind_qdefs(cfg, site.kind):
            out.append(QLayer(
                name=f"L{site.gidx:03d}.{'.'.join(path)}",
                segment=site.segment, unit=site.unit, path=path,
                in_dim=i, out_dim=o, n_mats=n,
                macs_per_token=float(macs), w_params=int(w), kind=qk))
    return out


def _nest(dst: dict, path: Tuple[str, ...], leaf):
    for k in path[:-1]:
        dst = dst.setdefault(k, {})
    dst[path[-1]] = leaf


def _bits_tree(cfg: ModelConfig, draw) -> Dict[str, Any]:
    """A ``bits`` tree whose every (QLayer, w/a) leaf is ``draw(n)``: n None
    for an unrolled layer (a python int), the repeat count for the stacked
    body (an int32 array of per-unit indices)."""
    sched = build_schedule(cfg)
    bits: Dict[str, Any] = {"prefix": {}, "body": {}, "suffix": {}}
    for seg, kinds, n in (
            ("prefix", sched.prefix, None),
            ("body", sched.pattern if sched.repeats else (), sched.repeats),
            ("suffix", sched.suffix, None)):
        for i, kind in enumerate(kinds):
            d: dict = {}
            for path, *_ in _kind_qdefs(cfg, kind):
                _nest(d, path, {"w": draw(n), "a": draw(n)})
            bits[seg][str(i)] = d
    return bits


def bits_uniform(cfg: ModelConfig, k: int) -> Dict[str, Any]:
    """Same bank index ``k`` for every QLayer (a uniform-bit pass)."""
    k = int(k)
    return _bits_tree(cfg, lambda n: k if n is None
                      else np.full((n,), k, np.int32))


def bits_random(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Independent random bank index per (QLayer, w/a) -- the paper's
    communication pass (section 3.4) -- drawn from the CPU generator
    ``gen`` as python ints (int32 arrays for the stacked body)."""
    def draw(n):
        t = torch.randint(0, cfg.n_bits, (n or 1,), generator=gen)
        return int(t[0]) if n is None else t.numpy().astype(np.int32)
    return _bits_tree(cfg, draw)


def bits_from_policy(cfg: ModelConfig, policy: MPQPolicy,
                     qlayers: Optional[Sequence[QLayer]] = None
                     ) -> Dict[str, Any]:
    """Static per-layer bank indices from an MPQPolicy: ints for unrolled
    segments, per-unit int32 arrays for the stacked body."""
    qlayers = qlayers if qlayers is not None else enumerate_qlayers(cfg)
    policy.validate(qlayers, bits=cfg.bits)    # stale files fail loudly
    lut = {int(b): i for i, b in enumerate(cfg.bits)}
    per_seg: Dict[str, Dict[Tuple[str, ...], list]] = {}
    for q in qlayers:
        per_seg.setdefault(q.segment, {}).setdefault(q.path, []).append(
            (q.unit, lut[policy.w_bits[q.name]], lut[policy.a_bits[q.name]]))
    bits: Dict[str, Any] = {"prefix": {}, "body": {}, "suffix": {}}
    for segment, paths in per_seg.items():
        seg, idx = segment.split(".")
        d = bits[seg].setdefault(idx, {})
        for path, triples in paths.items():
            triples.sort()
            w = np.asarray([t[1] for t in triples], np.int32)
            a = np.asarray([t[2] for t in triples], np.int32)
            if seg == "body":
                _nest(d, path, {"w": w, "a": a})
            else:
                _nest(d, path, {"w": int(w[0]), "a": int(a[0])})
    return bits


# ===========================================================================
# forward
# ===========================================================================
def embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                 ctx: QuantContext, table: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings (B, S, D) from the 8-bit pinned table."""
    return embed_lookup_pinned(tokens, params["embed"], ctx, table)


def _rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor):
    hd = cfg.hd
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv = 1.0 / (cfg.rope_theta ** exps)
    freqs = positions.to(torch.float32)[:, None] * inv[None, :]
    return torch.cos(freqs), torch.sin(freqs)


def _qk_rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS norm that multiplies the scale IN F32, before the cast
    (unlike ``common.rms_norm``)."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def _bget(bits, key):
    return None if bits is None else bits[key]


def _attn_sublayer(x, p, bits, cfg: ModelConfig, ctx: QuantContext,
                   mode: str, state, pos, prefill_cap=None):
    """Self-attention residual sub-block. Returns (x, new_state)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = apply_norm(x, p["norm1"], cfg.norm_type, cfg.norm_eps)
    q = qeinsum("bsd,de->bse", h, p["wq"], _bget(bits, "wq"), ctx)
    k = qeinsum("bsd,de->bse", h, p["wk"], _bget(bits, "wk"), ctx)
    v = qeinsum("bsd,de->bse", h, p["wv"], _bget(bits, "wv"), ctx)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd).to(ctx.compute_dtype)
    if cfg.qk_norm:
        q = _qk_rms(q, p["q_norm"], cfg.norm_eps)
        k = _qk_rms(k, p["k_norm"], cfg.norm_eps)
    per_slot = mode == "decode" and torch.as_tensor(pos).dim() == 1
    if mode == "decode":
        p_ = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        positions = torch.clamp(p_, min=0) if per_slot else p_.reshape(1)
    else:
        positions = torch.arange(S, device=x.device)
    cos, sin = _rope_cos_sin(cfg, positions)
    if per_slot:              # (B, hd/2) -> (B, 1, 1, hd/2): one angle per slot
        cos, sin = cos[:, None, None], sin[:, None, None]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin).to(ctx.compute_dtype)
    window = cfg.sliding_window
    if mode == "train":
        out = attn.self_attention(q.to(ctx.compute_dtype), k, v,
                                  causal=cfg.causal, window=window)
        new_state = None
    elif mode == "decode":
        if ctx.kv_quant == "fake":
            # reference view of an int8 slot: the new row is stored (and
            # attended) quantize-dequantized, in an fp cache
            k = qkv.fake_quant_kv(k)
            v = qkv.fake_quant_kv(v)
        out, new_state = attn.decode_attention(q, state, k, v, pos,
                                               window=window)
    else:
        kq = ksc = vq = vsc = None
        if ctx.kv_quant != "none":
            # quantize ONCE and attend over the dequantized view; the codes
            # and scales computed here are the ones the cache stores
            kq, ksc = qkv.quantize_rows(k)
            vq, vsc = qkv.quantize_rows(v)
            k = qkv.dequantize(kq, ksc, k.dtype)
            v = qkv.dequantize(vq, vsc, v.dtype)
        out = attn.self_attention(q.to(ctx.compute_dtype), k, v,
                                  causal=cfg.causal, window=window)
        cap_total = prefill_cap or S
        cap = min(cap_total, window) if window else cap_total
        if ctx.kv_quant == "int8":
            new_state = attn.build_prefill_cache_from_codes(kq, ksc, vq, vsc,
                                                            S, cap)
        else:   # "fake": k/v already hold the quantize-dequantized values
            new_state = attn.build_prefill_cache(k, v, S, cap)
    out = out.reshape(B, S, H * hd)
    out = qeinsum("bse,ed->bsd", out, p["wo"], _bget(bits, "wo"), ctx)
    return x + out, new_state


def _mlp_sublayer(x, p, bits, cfg: ModelConfig, ctx: QuantContext):
    h = apply_norm(x, p["norm2"], cfg.norm_type, cfg.norm_eps)
    hi = qeinsum("bsd,df->bsf", h, p["mlp_wi"], _bget(bits, "mlp_wi"), ctx)
    if cfg.mlp_gated:
        hg = qeinsum("bsd,df->bsf", h, p["mlp_wg"], _bget(bits, "mlp_wg"), ctx)
        hi = activation(cfg.act)(hg) * hi
    else:
        hi = activation(cfg.act)(hi)
    return x + qeinsum("bsf,fd->bsd", hi, p["mlp_wo"], _bget(bits, "mlp_wo"),
                       ctx)


def apply_layer(kind: str, x, p, bits, cfg: ModelConfig, ctx: QuantContext, *,
                mode: str, state=None, pos=None, prefill_cap=None):
    """One residual layer. Returns (x, new_state)."""
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r}")
    x, st = _attn_sublayer(x, p, bits, cfg, ctx, mode, state, pos, prefill_cap)
    return _mlp_sublayer(x, p, bits, cfg, ctx), st


def run_sites(x, sites, cfg: ModelConfig, ctx: QuantContext, *, mode: str,
              states=None, pos=None, prefill_cap=None):
    """Run ``sites`` -- ``[(LayerSite, params, bits)]`` in execution order --
    and collect their new decode state under ``{"sites": {key: ...}}``."""
    new_states = {"sites": {}}
    for site, p, b in sites:
        key = site_key(site.gidx)
        st = None if states is None else states["sites"][key]
        x, st = apply_layer(site.kind, x, p, b, cfg, ctx, mode=mode, state=st,
                            pos=pos, prefill_cap=prefill_cap)
        new_states["sites"][key] = st
    return x, new_states


def lm_head(x, params, cfg: ModelConfig, ctx: QuantContext,
            table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final norm + output projection -> f32 logits. The tied head reads
    the 8-bit fake-quantized embedding table (``table`` if precomputed)."""
    x = apply_norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    if cfg.tie_embeddings:
        if table is None:
            table = pinned_table(params["embed"], ctx)
        logits = torch.einsum("bsd,vd->bsv", x.to(ctx.compute_dtype),
                              table.to(ctx.compute_dtype))
    else:
        logits = qeinsum_pinned("bsd,dv->bsv", x, params["head"], ctx)
    return logits.to(torch.float32)


def trim_decode_state(states, true_len: int):
    """Invalidate KV rows at positions >= ``true_len`` (a prompt padded at
    the end leaves pad-token rows whose positions would look valid)."""
    return {"sites": {
        k: c._replace(pos=torch.where(c.pos < true_len, c.pos,
                                      torch.full_like(c.pos, -1)))
        for k, c in states["sites"].items()}}


def finish_prefill(x, states, params, cfg: ModelConfig, ctx: QuantContext,
                   true_len: Optional[int] = None,
                   table: Optional[torch.Tensor] = None):
    """Prefill epilogue: logits at the true last position and, for a padded
    prompt, pad rows invalidated. Returns (logits (B, V), states)."""
    if true_len is None:
        x_last = x[:, -1:]
    else:
        x_last = x[:, true_len - 1:true_len]
        states = trim_decode_state(states, true_len)
    return lm_head(x_last, params, cfg, ctx, table)[:, 0], states


def _unstack(tree, n: int) -> list:
    """The ``n`` per-unit trees of a stacked body tree: each tensor unbinds
    along its leading axis once (so autograd stacks the units' gradients
    in one op, not one full-size scatter per unit), index arrays become
    python ints."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per_key[k][u] for k in per_key} for u in range(n)]
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    return [int(b) for b in np.asarray(tree)]


def reference_sites(params, bits, cfg: ModelConfig):
    """``run_sites`` input for the fake-quant graph over stacked params:
    ``[(LayerSite, params, bits)]`` in execution order."""
    n = build_schedule(cfg).repeats
    body_p = {i: _unstack(t, n) for i, t in params["body"].items()}
    body_b = {} if bits is None else {i: _unstack(t, n)
                                      for i, t in bits["body"].items()}
    out = []
    for s in iter_sites(cfg):
        seg, idx = s.segment.split(".")
        if seg == "body":
            p, b = body_p[idx][s.unit], body_b.get(idx, [None] * n)[s.unit]
        else:
            p, b = params[seg][idx], None if bits is None else bits[seg][idx]
        out.append((s, p, b))
    return out


def apply_train(params, cfg: ModelConfig, inputs, bits, ctx: QuantContext,
                remat: bool = True):
    """Full-sequence logits. Returns (logits (B, S, V) f32, aux loss).
    ``remat`` is accepted for the reference's signature and unused: the
    port keeps every activation for the backward (no activation
    checkpointing yet)."""
    tokens = torch.as_tensor(inputs["tokens"],
                             device=params["embed"]["w"].device)
    x = embed_inputs(params, cfg, tokens, ctx)
    x, _ = run_sites(x, reference_sites(params, bits, cfg), cfg, ctx,
                     mode="train")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_head(x, params, cfg, ctx), aux


def loss_fn(params, cfg: ModelConfig, inputs, bits, ctx: QuantContext,
            remat: bool = True):
    """Next-token cross entropy (+ MoE aux). Returns (loss, metrics)."""
    logits, aux = apply_train(params, cfg, inputs, bits, ctx, remat)
    tokens = torch.as_tensor(inputs["tokens"], device=logits.device).long()
    lg, tg = logits[:, :-1], tokens[:, 1:]
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tg[..., None])[..., 0]
    ce = (lse - picked).mean()
    loss = ce + MOE_AUX_COEF * aux
    return loss, {"ce": ce, "moe_aux": aux, "loss": loss}


def apply_prefill(params, cfg: ModelConfig, tokens, bits, ctx: QuantContext,
                  prefill_cap=None, true_len=None, table=None):
    """Prompt pass of the fake-quant graph. Returns (last-position logits
    (B, V), decode state with shared positions)."""
    x = embed_inputs(params, cfg, tokens, ctx, table)
    x, states = run_sites(x, reference_sites(params, bits, cfg), cfg, ctx,
                          mode="prefill", prefill_cap=prefill_cap)
    return finish_prefill(x, states, params, cfg, ctx, true_len, table)


def apply_decode(params, cfg: ModelConfig, token, pos, states, bits,
                 ctx: QuantContext, table=None):
    """One decode step of the fake-quant graph. token (B, 1); ``pos`` a
    scalar (shared positions) or a (B,) vector (per-slot). Returns (logits
    (B, V), new states)."""
    x = embed_inputs(params, cfg, token, ctx, table)
    x, new_states = run_sites(x, reference_sites(params, bits, cfg), cfg, ctx,
                              mode="decode", states=states, pos=pos)
    return lm_head(x, params, cfg, ctx, table)[:, 0], new_states


# ===========================================================================
# decode state
# ===========================================================================
def init_site_state(cfg: ModelConfig, kind: str, batch: int, capacity: int, *,
                    dtype=torch.float32, per_slot: bool = False,
                    kv_quant: str = "none", device=None):
    """Fresh decode state (a ring KV cache) for ONE attention site;
    ``kv_quant="int8"`` selects codes + scales."""
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r}")
    window = cfg.sliding_window
    cap = min(capacity, window) if window else capacity
    return qkv.init_kv_cache(batch, cap, cfg.n_kv_heads, cfg.hd, dtype=dtype,
                             quant=kv_quant == "int8", per_slot=per_slot,
                             device=device)


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int, *,
                      dtype=torch.float32, per_slot: bool = False,
                      kv_quant: str = "none", device=None):
    return {"sites": {site_key(s.gidx): init_site_state(
        cfg, s.kind, batch, capacity, dtype=dtype, per_slot=per_slot,
        kv_quant=kv_quant, device=device) for s in iter_sites(cfg)}}


def decode_state_per_slot(states):
    """Widen a prefill-produced decode state to the per-slot layout."""
    return {"sites": {k: attn.cache_per_slot(c)
                      for k, c in states["sites"].items()}}
