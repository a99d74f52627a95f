"""Config-driven LM: dense attention layers (serving and training), RWKV6
layers (serving), the hybrid family's RG-LRU layers beside local
attention (recurrentgemma; serving) and the audio family's encoder
(hubert: bidirectional attention over frame embeddings from the stub
frontend, a sinusoid position table, no rope; training only) and the MoE
family's layers (deepseek-moe, mixtral: attention, then the routed experts
of ``models.moe`` beside always-on shared experts; leading dense layers).

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
``loss_fn``), ``prefill`` (logits at the last position + decode state),
``decode`` (one token per batch row with state), ``verify`` (S tokens per
slot at per-slot positions, the speculative verify pass: ``apply_verify``)
and ``append`` (a prefill chunk of one paged slot); an RWKV6 or RG-LRU
layer runs ``prefill`` and ``decode`` (``train`` without state). Decode
state is ``{"sites": {"<gidx>": state}}``: a KV cache per attention site,
the tuple ``(x_prev time-mix, wkv, x_prev channel-mix)`` per rwkv site,
``(conv_buf, h)`` per rec site; ``rollback_decode_state`` rewinds the
caches past a rejected draft. A hybrid config's attention is local: its
window is ``local_window`` (``attn_window``).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import MPQPolicy
from repro_torch.core.qspec import QLayer
from repro_torch.core.quantizer import bit_range, init_scale_from_stats
from repro_torch.data import FRONTEND_DIMS
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.common import (activation, apply_norm, apply_rope,
                                       dense_init, embed_init, norm_init)
from repro_torch.models.quant_layers import (QuantContext,
                                             embed_lookup_pinned,
                                             pinned_init, pinned_table,
                                             qdense_init, qeinsum,
                                             qeinsum_pinned)
from repro_torch.runtime import kv_cache as qkv

# the layer kinds whose first sub-block is self-attention over a KV cache
ATTN_KINDS = ("attn", "dense", "moe")
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
    kind: str          # attn | dense | moe | rwkv | rec
    segment: str       # "prefix.0" | "body.2" | "suffix.1"
    unit: int          # repeat index within body, else 0
    gidx: int          # global execution index


def build_schedule(cfg: ModelConfig) -> Schedule:
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense decoder, moe, rwkv (ssm), "
            f"hybrid and audio families only (family {cfg.family!r} comes "
            "with a later slice)")
    L = cfg.n_layers
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        return Schedule(("dense",) * fd, ("moe",), L - fd, ())
    if cfg.family == "hybrid":
        bp = tuple(cfg.block_pattern)
        return Schedule((), bp, L // len(bp), bp[:L % len(bp)])
    if cfg.family == "ssm":
        return Schedule((), ("rwkv",), L, ())
    return Schedule((), ("attn",), L, ())     # dense / audio


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


def _layer_ff(cfg: ModelConfig, kind: str) -> int:
    """The MLP width of a ``kind`` layer: a MoE config's leading dense
    layers take ``moe.dense_d_ff``."""
    if kind == "dense" and cfg.moe and cfg.moe.dense_d_ff:
        return cfg.moe.dense_d_ff
    return cfg.d_ff


# ===========================================================================
# init
# ===========================================================================
def layer_init(gen, cfg: ModelConfig, kind: str, *, stacked=(), device=None):
    """Seeded params of one ``kind`` layer (``stacked`` leading axes: the
    body's repeats), drawn from ``gen`` on ``device``."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    ff = _layer_ff(cfg, kind)

    def nrm():
        return {k: v.expand(tuple(stacked) + tuple(v.shape)).contiguous()
                for k, v in norm_init(d, cfg.norm_type, device).items()}

    if kind == "rwkv":
        p = {"norm1": nrm(), "norm2": nrm()}
        p.update(rec.rwkv_init(gen, d, cfg.n_heads, cfg.rwkv_head_dim, ff,
                               cfg.bits, stacked=stacked, device=device))
        return p
    if kind not in ATTN_KINDS + ("rec",):
        raise NotImplementedError(f"layer kind {kind!r}")

    def qd_(i, o):
        return qdense_init(gen, i, o, cfg.bits, stacked=stacked, device=device)

    if kind == "rec":
        p = {"norm1": nrm(), "norm2": nrm(),
             "rg": rec.rglru_init(gen, d, cfg.lru_width, cfg.n_heads,
                                  cfg.conv1d_width, cfg.bits,
                                  stacked=stacked, device=device)}
    else:
        p = {"norm1": nrm(), "norm2": nrm(),
             "wq": qd_(d, qd), "wk": qd_(d, kvd), "wv": qd_(d, kvd),
             "wo": qd_(qd, d)}
    if cfg.qk_norm and kind != "rec":
        p["q_norm"] = torch.ones(tuple(stacked) + (cfg.hd,), device=device)
        p["k_norm"] = torch.ones(tuple(stacked) + (cfg.hd,), device=device)
    if kind == "moe":
        p["moe"] = moe_mod.moe_init(gen, d, cfg.moe, cfg.bits, cfg.mlp_gated,
                                    stacked=stacked, device=device)
        return p
    p["mlp_wi"] = qd_(d, ff)
    p["mlp_wo"] = qd_(ff, d)
    if cfg.mlp_gated:
        p["mlp_wg"] = qd_(d, ff)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device=None
                ) -> Dict[str, Any]:
    """Seeded random params with the reference's tree layout (one explicit
    ``torch.Generator`` on ``device``; the values differ from JAX's, whose
    PRNG differs -- carry JAX params across with ``interop`` instead). On
    the ``meta`` device it gives the tree's shapes and dtypes only (a
    checkpoint restore's template) and allocates nothing."""
    sched = build_schedule(cfg)
    meta = torch.device(device or "cpu").type == "meta"
    gen = torch.Generator(device="cpu" if meta else device or "cpu"
                          ).manual_seed(int(seed))
    if cfg.frontend == "audio_stub":     # frame embeddings, no vocab table
        params: Dict[str, Any] = {"embed": pinned_init(
            gen, FRONTEND_DIMS["audio_stub"], cfg.d_model, device=device)}
    else:
        w = embed_init(gen, cfg.vocab, cfg.d_model, device=device)
        params = {"embed": {
            "w": w, "s_w8": init_scale_from_stats(w, bit_range(8, True)[1])}}
    params["prefix"] = {str(i): layer_init(gen, cfg, k, device=device)
                        for i, k in enumerate(sched.prefix)}
    params["body"] = {str(p): layer_init(gen, cfg, k, stacked=(sched.repeats,),
                                         device=device)
                      for p, k in enumerate(sched.pattern)} \
        if sched.repeats else {}
    params["suffix"] = {str(i): layer_init(gen, cfg, k, device=device)
                        for i, k in enumerate(sched.suffix)}
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm_type, device)
    if cfg.tie_embeddings:
        params["head"] = {"s_a8": torch.tensor(0.1 / 8, dtype=torch.float32,
                                               device=device)}
    else:
        params["head"] = pinned_init(gen, cfg.d_model, cfg.vocab,
                                     device=device)
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
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    ff = _layer_ff(cfg, kind)
    if kind == "rwkv":
        return [((name,), i, o, 1, i * o, i * o, "rwkv") for name, i, o in (
            ("wr", d, d), ("wk", d, d), ("wv", d, d), ("wg", d, d),
            ("wo", d, d), ("cm_wk", d, ff), ("cm_wv", ff, d),
            ("cm_wr", d, d))]
    if kind == "rec":
        W = cfg.lru_width or d
        defs = [(("rg", name), i, o, 1, i * o, i * o, "rec")
                for name, i, o in (("wx", d, W), ("wgate", d, W),
                                   ("wo", W, d))]
    elif kind in ATTN_KINDS:
        defs = [
            (("wq",), d, qd, 1, d * qd, d * qd, "attn"),
            (("wk",), d, kvd, 1, d * kvd, d * kvd, "attn"),
            (("wv",), d, kvd, 1, d * kvd, d * kvd, "attn"),
            (("wo",), qd, d, 1, qd * d, qd * d, "attn")]
        if kind == "moe":
            return defs + [(("moe",) + path, i, o, n, macs, w, "moe")
                           for path, i, o, n, macs, w, _k
                           in moe_mod.moe_qlayer_defs(d, cfg.moe,
                                                      cfg.mlp_gated)]
    else:
        raise NotImplementedError(f"layer kind {kind!r}")
    defs += [
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
def _sinusoid_pos(S: int, d: int, dtype, device) -> torch.Tensor:
    """(1, S, d) position table: sin then cos of pos / 10000^(2i/d),
    computed in float32 and then cast, as the reference computes it."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)[None]


def embed_inputs(params, cfg: ModelConfig, inputs, ctx: QuantContext,
                 table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Input embeddings (B, S, D). ``inputs`` is a batch dict (``tokens``;
    the audio frontend's ``feats`` (B, S, 512)) or a token tensor. Tokens
    read the 8-bit pinned table (the hybrid family scales them by
    sqrt(d_model), gemma's, the factor first rounded to the activation
    dtype as the reference rounds it); frames go through the 8-bit pinned
    projection, plus the sinusoid position table."""
    dev = params["embed"]["w"].device
    if cfg.frontend == "audio_stub":
        feats = torch.as_tensor(inputs["feats"], device=dev)
        x = qeinsum_pinned("bsf,fd->bsd", feats.to(ctx.compute_dtype),
                           params["embed"], ctx)
        return x + _sinusoid_pos(x.shape[1], cfg.d_model, x.dtype, dev)
    tokens = inputs["tokens"] if isinstance(inputs, dict) else inputs
    x = embed_lookup_pinned(torch.as_tensor(tokens, device=dev),
                            params["embed"], ctx, table)
    if cfg.family == "hybrid":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


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


def _rope_qk(q, k, cfg: ModelConfig, mode: str, p_, S: int):
    """q and k rotated at their positions: ``0..S-1`` in ``train`` and
    ``prefill``, else ``p_`` (the int32 positions on the device)."""
    B = q.shape[0]
    per_slot = mode == "decode" and p_.dim() == 1
    if mode == "decode":
        positions = torch.clamp(p_, min=0) if per_slot else p_.reshape(1)
    elif mode == "verify":
        # one angle per (slot, token); sentinel rows (-1) take angle 0 and
        # are masked everywhere
        positions = torch.clamp(p_, min=0).reshape(-1)
    elif mode == "append":
        # pad rows carry -1: their angle is irrelevant (the write drops them)
        positions = torch.clamp(p_, min=0)
    else:
        positions = torch.arange(S, device=q.device)
    cos, sin = _rope_cos_sin(cfg, positions)
    if per_slot:              # (B, hd/2) -> (B, 1, 1, hd/2): one angle per slot
        cos, sin = cos[:, None, None], sin[:, None, None]
    elif mode == "verify":    # (B*S, hd/2) -> (B, S, 1, hd/2), over the heads
        cos, sin = cos.reshape(B, S, 1, -1), sin.reshape(B, S, 1, -1)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _bget(bits, key):
    return None if bits is None else bits[key]


def check_decodes(cfg: ModelConfig) -> None:
    """Raise the reference's ``ValueError`` for an encoder-only config: it
    has no decode step, so no engine, session or server takes it."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")


def attn_window(cfg: ModelConfig) -> Optional[int]:
    """The attention window of ``cfg``'s self-attention sites: the hybrid
    family's local window, else the sliding window (None: full)."""
    if cfg.family == "hybrid":
        return cfg.local_window or None
    return cfg.sliding_window


def _attn_sublayer(x, p, bits, cfg: ModelConfig, ctx: QuantContext,
                   mode: str, state, pos, prefill_cap=None, slot=None):
    """Self-attention residual sub-block. ``mode`` is ``train``,
    ``prefill``, ``decode`` (one token per slot), ``verify`` (S tokens per
    slot: ``pos (B, S)`` absolute positions, -1 on inactive slots) or
    ``append`` (a chunk of one paged slot ``slot``: ``pos`` the chunk's
    absolute positions, -1 on pad rows). Returns (x, new_state)."""
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
    p_ = None
    if mode in ("decode", "verify", "append"):
        p_ = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if cfg.family != "audio":          # audio: the sinusoid table, no rope
        q, k = _rope_qk(q, k, cfg, mode, p_, S)
    k = k.to(ctx.compute_dtype)
    window = attn_window(cfg)
    if mode == "train":
        out = attn.self_attention(q.to(ctx.compute_dtype), k, v,
                                  causal=cfg.causal, window=window)
        new_state = None
    elif mode in ("decode", "verify"):
        if ctx.kv_quant == "fake":
            # reference view of an int8 slot: the new row is stored (and
            # attended) quantize-dequantized, in an fp cache
            k = qkv.fake_quant_kv(k)
            v = qkv.fake_quant_kv(v)
        fn = attn.decode_attention if mode == "decode" \
            else attn.verify_attention
        out, new_state = fn(q, state, k, v, pos, window=window)
    elif mode == "append":
        out, new_state = attn.append_attention(q, state, k, v, p_, slot,
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


def _rwkv_layer(x, p, bits, cfg: ModelConfig, ctx: QuantContext, mode: str,
                state):
    """RWKV6 block: time-mix, then channel-mix, each a pre-norm residual.
    ``state`` (x_prev time-mix, wkv, x_prev channel-mix) or None (zero).
    Returns (x, new_state), no state in ``train`` mode."""
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(
            f"rwkv layers run train, prefill and decode; mode {mode!r} "
            "(speculative verify, paged append) comes with a later slice")
    st = state or (None, None, None)
    h = apply_norm(x, p["norm1"], cfg.norm_type, cfg.norm_eps)
    tm_state = None if st[0] is None else (st[0], st[1])
    out, (xp_tm, wkv) = rec.rwkv_time_mix(h, p, bits, ctx, cfg.n_heads,
                                          cfg.rwkv_head_dim, state=tm_state)
    x = x + out
    h2 = apply_norm(x, p["norm2"], cfg.norm_type, cfg.norm_eps)
    out2, xp_cm = rec.rwkv_channel_mix(h2, p, bits, ctx, state=st[2])
    new_st = (xp_tm, wkv, xp_cm) if mode != "train" else None
    return x + out2, new_st


def _rec_layer(x, p, bits, cfg: ModelConfig, ctx: QuantContext, mode: str,
               state):
    """Griffin residual layer: the RG-LRU block, then the MLP, each
    pre-norm. ``state`` (conv_buf, h) or None (zero). Returns (x,
    new_state), no state in ``train`` mode."""
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(
            f"rec layers run train, prefill and decode; mode {mode!r} "
            "(speculative verify, paged append) is refused by the engine")
    h = apply_norm(x, p["norm1"], cfg.norm_type, cfg.norm_eps)
    out, st = rec.rglru_block(h, p["rg"], _bget(bits, "rg"), ctx,
                              cfg.n_heads, state=state)
    x = _mlp_sublayer(x + out, p, bits, cfg, ctx)
    return x, st if mode != "train" else None


def apply_layer(kind: str, x, p, bits, cfg: ModelConfig, ctx: QuantContext, *,
                mode: str, state=None, pos=None, prefill_cap=None, slot=None):
    """One residual layer. Returns (x, new_state, aux): aux the MoE layer's
    load-balance loss (None for every other kind)."""
    if kind == "rwkv":
        return _rwkv_layer(x, p, bits, cfg, ctx, mode, state) + (None,)
    if kind == "rec":
        return _rec_layer(x, p, bits, cfg, ctx, mode, state) + (None,)
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r}")
    x, st = _attn_sublayer(x, p, bits, cfg, ctx, mode, state, pos, prefill_cap,
                           slot)
    if kind == "moe":
        h = apply_norm(x, p["norm2"], cfg.norm_type, cfg.norm_eps)
        out, aux = moe_mod.moe_ffn(h, p["moe"], cfg.moe, _bget(bits, "moe"),
                                   ctx, cfg.act, cfg.mlp_gated)
        return x + out, st, aux
    return _mlp_sublayer(x, p, bits, cfg, ctx), st, None


def _add_aux(aux, a):
    return a if aux is None else (aux if a is None else aux + a)


def run_sites(x, sites, cfg: ModelConfig, ctx: QuantContext, *, mode: str,
              states=None, pos=None, prefill_cap=None, slot=None):
    """Run ``sites`` -- ``[(LayerSite, params, bits)]`` in execution order --
    and collect their new decode state under ``{"sites": {key: ...}}``.
    Returns (x, new_states, aux): aux the MoE layers' losses summed in
    execution order, as the reference accumulates them (None without MoE
    layers)."""
    new_states = {"sites": {}}
    aux = None
    for site, p, b in sites:
        key = site_key(site.gidx)
        st = None if states is None else states["sites"][key]
        x, st, a = apply_layer(site.kind, x, p, b, cfg, ctx, mode=mode,
                               state=st, pos=pos, prefill_cap=prefill_cap,
                               slot=slot)
        aux = _add_aux(aux, a)
        new_states["sites"][key] = st
    return x, new_states, aux


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


def map_caches(states, fn):
    """``fn`` applied to every KV cache of a decode state; recurrent site
    state passes through."""
    return {"sites": {k: fn(c) if isinstance(c, qkv.CACHE_TYPES) else c
                      for k, c in states["sites"].items()}}


def trim_decode_state(states, true_len: int):
    """Invalidate KV rows at positions >= ``true_len`` (a prompt padded at
    the end leaves pad-token rows whose positions would look valid)."""
    return map_caches(states, lambda c: c._replace(
        pos=torch.where(c.pos < true_len, c.pos, torch.full_like(c.pos, -1))))


def rollback_decode_state(states, cut):
    """Invalidate KV rows at positions >= the per-slot ``cut`` ((B,) int32)
    in every cache of a per-slot decode state: the speculative rollback.
    Draft rows past the first rejection are rewound (ring: the pos stamp;
    paged: the pos stamp through the table), so the cache is the one a
    token-at-a-time engine that decoded only the accepted tokens holds (pos
    exactly, codes and scales on every valid row)."""
    return map_caches(states, lambda c: c.rollback(cut))


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


def run_sites_remat(x, sites, cfg: ModelConfig, ctx: QuantContext):
    """``run_sites`` in ``train`` mode with each body unit's sites under
    activation checkpointing, the reference's granularity (it wraps each
    ``lax.scan`` step of the body in ``jax.checkpoint``): the backward
    recomputes a unit's forward from its input, so only the units' inputs
    stay alive between the passes. Prefix and suffix sites run as they are.
    The recompute runs the same deterministic ops on the same inputs, so
    loss and gradients are the ones without it, bit for bit; the kernels
    inside a unit (fake-quant forward, flash forward) launch twice. The
    forward draws no random numbers, so no RNG state is stashed. Returns
    (x, aux) as ``run_sites``."""
    from torch.utils.checkpoint import checkpoint

    def unit(group):
        def run(h):
            out, _, a = run_sites(h, group, cfg, ctx, mode="train")
            return out, a
        return run

    def key(site):
        return site[0].segment.startswith("body."), site[0].unit

    aux = None
    for (body, _), group in itertools.groupby(sites, key):
        group = list(group)
        if body:
            x, a = checkpoint(unit(group), x, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, _, a = run_sites(x, group, cfg, ctx, mode="train")
        aux = _add_aux(aux, a)
    return x, aux


def apply_train(params, cfg: ModelConfig, inputs, bits, ctx: QuantContext,
                remat: bool = True):
    """Full-sequence logits. Returns (logits (B, S, V) f32, aux loss).
    ``remat`` recomputes each body unit in the backward
    (``run_sites_remat``), as the reference checkpoints its scan body."""
    x = embed_inputs(params, cfg, inputs, ctx)
    sites = reference_sites(params, bits, cfg)
    if remat:
        x, aux = run_sites_remat(x, sites, cfg, ctx)
    else:
        x, _, aux = run_sites(x, sites, cfg, ctx, mode="train")
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_head(x, params, cfg, ctx), aux


def loss_fn(params, cfg: ModelConfig, inputs, bits, ctx: QuantContext,
            remat: bool = True):
    """Next-token cross entropy (+ MoE aux); an encoder-only model's CE is
    over its ``labels`` at every position, unshifted. Returns (loss,
    metrics)."""
    logits, aux = apply_train(params, cfg, inputs, bits, ctx, remat)
    if cfg.encoder_only:
        lg = logits
        tg = torch.as_tensor(inputs["labels"], device=logits.device).long()
    else:
        tokens = torch.as_tensor(inputs["tokens"],
                                 device=logits.device).long()
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
    x, states, _ = run_sites(x, reference_sites(params, bits, cfg), cfg, ctx,
                             mode="prefill", prefill_cap=prefill_cap)
    return finish_prefill(x, states, params, cfg, ctx, true_len, table)


def apply_decode(params, cfg: ModelConfig, token, pos, states, bits,
                 ctx: QuantContext, table=None):
    """One decode step of the fake-quant graph. token (B, 1); ``pos`` a
    scalar (shared positions) or a (B,) vector (per-slot). Returns (logits
    (B, V), new states)."""
    x = embed_inputs(params, cfg, token, ctx, table)
    x, new_states, _ = run_sites(x, reference_sites(params, bits, cfg), cfg,
                                 ctx, mode="decode", states=states, pos=pos)
    return lm_head(x, params, cfg, ctx, table)[:, 0], new_states


def apply_verify(params, cfg: ModelConfig, tokens, pos, states, bits,
                 ctx: QuantContext, table=None):
    """Speculative multi-token verify of the fake-quant graph: ``tokens (B,
    S)`` at per-slot positions ``pos (B, S)`` (-1 rows for inactive
    slots). Writes the S KV rows per slot computed under these params and
    returns (logits (B, S, V), new states): position j's logits and rows
    are what S one-token ``apply_decode`` calls give."""
    x = embed_inputs(params, cfg, tokens, ctx, table)
    x, new_states, _ = run_sites(x, reference_sites(params, bits, cfg), cfg,
                                 ctx, mode="verify", states=states, pos=pos)
    return lm_head(x, params, cfg, ctx, table), new_states


def apply_append(params, cfg: ModelConfig, tokens, pos, slot: int,
                 last_idx: int, states, bits, ctx: QuantContext, table=None):
    """Chunked (paged) prefill of the fake-quant graph for ONE slot:
    ``tokens (1, C)`` at absolute positions ``pos (C,)`` (-1 on pad rows,
    which the cache write drops) into that slot's pages. Returns (logits of
    row ``last_idx`` (1, V), new states)."""
    x = embed_inputs(params, cfg, tokens, ctx, table)
    x, new_states, _ = run_sites(x, reference_sites(params, bits, cfg), cfg,
                                 ctx, mode="append", states=states, pos=pos,
                                 slot=slot)
    logits = lm_head(x[:, last_idx:last_idx + 1], params, cfg, ctx, table)
    return logits[:, 0], new_states


# ===========================================================================
# decode state
# ===========================================================================
def init_site_state(cfg: ModelConfig, kind: str, batch: int, capacity: int, *,
                    dtype=torch.float32, per_slot: bool = False,
                    kv_quant: str = "none", layout=None, device=None,
                    rec_dtype=None):
    """Fresh decode state for ONE site. An attention site gets a KV cache:
    ``kv_quant="int8"`` selects codes + scales, and ``layout`` (a
    ``runtime.kv_cache.KVCacheLayout``) overrides both -- it is how the
    paged pool layout is selected. An rwkv site gets zeros ``(x_prev (B, 1,
    D), wkv (B, H, hd, hd), x_prev (B, 1, D))`` in ``rec_dtype`` (default
    ``dtype``), the wkv state in float32 or wider; a rec site ``(conv_buf
    (B, cw-1, W), h (B, W))``, h in float32 or wider."""
    if kind == "rwkv":
        dt = rec_dtype or dtype
        hd, D = cfg.rwkv_head_dim, cfg.d_model
        return (torch.zeros((batch, 1, D), dtype=dt, device=device),
                torch.zeros((batch, cfg.n_heads, hd, hd),
                            dtype=torch.promote_types(dt, torch.float32),
                            device=device),
                torch.zeros((batch, 1, D), dtype=dt, device=device))
    if kind == "rec":
        dt = rec_dtype or dtype
        W = cfg.lru_width or cfg.d_model
        return (torch.zeros((batch, cfg.conv1d_width - 1, W), dtype=dt,
                            device=device),
                torch.zeros((batch, W),
                            dtype=torch.promote_types(dt, torch.float32),
                            device=device))
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r}")
    window = attn_window(cfg)
    cap = min(capacity, window) if window else capacity
    layout = layout or qkv.KVCacheLayout(
        quant="int8" if kv_quant == "int8" else "none")
    return layout.alloc(batch, cap, cfg.n_kv_heads, cfg.hd, dtype=dtype,
                        per_slot=per_slot, device=device)


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int, *,
                      dtype=torch.float32, per_slot: bool = False,
                      kv_quant: str = "none", layout=None, device=None,
                      rec_dtype=None):
    return {"sites": {site_key(s.gidx): init_site_state(
        cfg, s.kind, batch, capacity, dtype=dtype, per_slot=per_slot,
        kv_quant=kv_quant, layout=layout, device=device, rec_dtype=rec_dtype)
        for s in iter_sites(cfg)}}


def decode_state_per_slot(states):
    """Widen a prefill-produced decode state to the per-slot layout
    (recurrent site state carries its batch axis already)."""
    return {"sites": {k: attn.cache_per_slot(c)
                      for k, c in states["sites"].items()}}
