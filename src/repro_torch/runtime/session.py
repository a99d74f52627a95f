"""QuantizedSession: compile a searched MPQPolicy into a servable model.

Construction packs once:

1. validate the policy against the model's QLayer table (stale files fail
   loudly),
2. split the stacked param tree into per-site subtrees (one per
   ``lm.iter_sites`` entry), so every site holds its *own* searched
   bit-widths in packed storage -- or take each site's subtree from a
   ``site_source`` as it is packed, when the whole float32 tree would not
   fit the device beside its packing,
3. for every searched projection, select the trained indicator-bank scales
   at the policy's bit-widths and quantize + bit-pack the weight
   (``runtime.packing.pack_linear``) -- device memory then holds
   ``ceil(bits/8)`` bytes per weight, ``MPQPolicy.size_bytes`` to within
   padding.

Packing also measures each projection's health (``obs.health.site_health``:
code saturation and scale utilization, from the weight and the scale the
packing used) once, into ``pack_health``; the engine publishes it into its
metrics registry.

Packing also tags activation-reuse groups: projections of one site whose
(a_bits, signedness, trained bank scale values) coincide share a
``PackedLinear.a_group``, so ``dispatch.act_reuse_scope`` quantizes their
common input once per forward (wq/wk/wv; mlp_wi/mlp_wg).

The session exposes the engine's model-adapter interface (``prefill`` /
``decode`` / ``verify`` / ``append`` / ``init_state`` / ``state_per_slot``;
``verify`` is the speculative multi-token pass, ``append`` the chunked
prefill of the paged layout); matmuls route through
``runtime.dispatch.packed_qeinsum`` (CUDA kernels on the card, the
bit-exact dequant-then-fp route on the CPU). The 8-bit fake-quantized
embedding table -- read by the embedding lookup and by the tied head -- is a
pure function of the weights and is computed once here.

``QuantizedSession.from_checkpoint`` restores a serving bundle
(``checkpoint.save_serving_bundle``: params + policy) and packs it;
``ElasticSession`` packs N policy variants of one weight set for elastic
precision serving (``launch.elastic``), keyed by ``bank_fingerprint``.

Numerics: with per-tensor bank scales (per-expert ones on an expert
stack, in the ``(E, 1, 1)`` broadcast form), the dequantized weights and the
on-the-fly activation fake-quant reproduce the fake-quant graph *bitwise*
on the dequant-fp route, so its greedy tokens equal an ``LMAdapter``
reference engine's -- with int8 KV slots too, whose reference is
``kv_quant="fake"``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import MPQPolicy
from repro_torch.core.quantizer import (bit_range, grad_scale,
                                        lsq_grad_scale_factor)
from repro_torch.models import lm
from repro_torch.models.quant_layers import QuantContext, pinned_table
from repro_torch.obs import health as obs_health
from repro_torch.runtime import dispatch, packing


def _get_path(tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _copy_dicts(tree):
    """``tree``'s nested dicts copied, its leaves shared: one site's params
    packed under another policy without touching the first."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _set_path(tree, path: Tuple[str, ...], leaf):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = leaf


def effective_weight_scale(s_bank: torch.Tensor, idx: int, numel: int,
                           bits: int, w_ndim: Optional[int] = None
                           ) -> torch.Tensor:
    """The scale value the fake-quant graph actually divides by: bank entry
    ``idx`` (selected on the LAST axis: leading axes are expert stacks) ->
    floor at 1e-9 -> LSQ grad-scale wrapper (the identity in exact
    arithmetic, replicated op for op for bitwise parity). A per-expert
    selection comes back in ``fake_quant_indexed``'s trailing-ones form
    (``(E, 1, 1)`` for a rank-3 weight, via ``w_ndim``)."""
    qmax = float(bit_range(bits, True)[1])
    s = torch.clamp(s_bank[..., idx].to(torch.float32), min=1e-9)
    s = grad_scale(s, lsq_grad_scale_factor(numel, qmax, device=s.device))
    if s.dim() and w_ndim is not None:
        s = s.reshape(tuple(s.shape) + (1,) * (w_ndim - s.dim()))
    return s


class QuantizedSession:
    """A packed, policy-quantized model behind the engine adapter API."""

    def __init__(self, cfg: ModelConfig, params, policy: MPQPolicy,
                 ctx: Optional[QuantContext] = None, *,
                 kv_quant: str = "int8", site_source=None):
        lm.check_decodes(cfg)
        self.cfg = cfg
        # where each site's param subtree comes from: the site's slice of
        # ``params`` (None), or ``site_source(site)``, called once per site
        # and packed tree, so that a tree too large for the device beside
        # its packing can be made, packed and dropped site by site
        self.site_source = site_source
        self.policy = policy
        self.ctx = dataclasses.replace(
            ctx or QuantContext.make(cfg.bits, cfg.quant_act_signed,
                                     compute_dtype=torch.float32),
            kv_quant=kv_quant)
        self.qlayers = lm.enumerate_qlayers(cfg)
        policy.validate(self.qlayers, bits=cfg.bits)
        self.sites = lm.iter_sites(cfg)
        self._lut = {int(b): i for i, b in enumerate(cfg.bits)}
        self.act_quant_reused = 0
        # dispatch route tallies of every forward (``dispatch.Counts``); the
        # engine reads them
        self.route_counts = dispatch.Counts()
        # the engine's metrics registry (it assigns this at build and
        # reset): _forward counts its activation-quantize reuse there
        self.metrics = None
        # per-projection pack-time health, measured in _pack_trees from
        # the weights and the scales the packing used
        trees = self._pack_trees(params, [policy] + self._side_policies())
        self.params, self.pack_health = trees[0]
        self.side_trees = trees[1:]
        self.table = pinned_table(params["embed"], self.ctx)

    # -- construction -------------------------------------------------------
    def _side_policies(self) -> List[MPQPolicy]:
        """Policies packed beside the served one, each into a tree of its
        own (``side_trees``), from the same site params: a speculative
        session's draft."""
        return []

    def _pack_trees(self, params, policies: List[MPQPolicy]
                    ) -> List[Tuple[Dict[str, Any], Dict[str, Dict]]]:
        """(packed tree, pack health) for each of ``policies``. Each site's
        params are taken once (``site_source`` is called once a site) and
        packed under every policy before the next site."""
        by_site: Dict[Tuple[str, int], List] = {}
        for q in self.qlayers:
            by_site.setdefault((q.segment, q.unit), []).append(q)
        outer = {k: params[k] for k in params
                 if k not in ("prefix", "body", "suffix")}
        outs = [(dict(outer, sites={}), {}) for _ in policies]
        for site in self.sites:
            key = lm.site_key(site.gidx)
            src = (self.site_source(site) if self.site_source is not None
                   else lm.site_params(params, site))
            for policy, (tree, health) in zip(policies, outs):
                sp = _copy_dicts(src)
                packed_paths: List[Tuple[str, ...]] = []
                for q in by_site[(site.segment, site.unit)]:
                    leaf = _get_path(src, q.path)
                    wb = int(policy.w_bits[q.name])
                    s_w = effective_weight_scale(leaf["s_w"], self._lut[wb],
                                                 leaf["w"].numel(), wb,
                                                 w_ndim=leaf["w"].dim())
                    a_idx = self._lut[int(policy.a_bits[q.name])]
                    pl = packing.pack_linear(
                        leaf["w"], wb, s_w, int(policy.a_bits[q.name]),
                        leaf["s_a"][..., a_idx],
                        a_signed=self.cfg.quant_act_signed)
                    health[q.name] = obs_health.site_health(
                        leaf["w"], wb, pl.scale)
                    _set_path(sp, q.path, pl)
                    packed_paths.append(q.path)
                _tag_act_groups(sp, packed_paths, key)
                tree["sites"][key] = sp
        return outs

    # -- accounting ---------------------------------------------------------
    def packed_bytes(self) -> int:
        """Measured device bytes of the packed weight codes."""
        return packing.tree_packed_bytes(self.params)

    def scale_bytes(self) -> int:
        return packing.tree_scale_bytes(self.params)

    def policy_bytes(self) -> float:
        """What the ILP accounted for: ``MPQPolicy.size_bytes``."""
        return self.policy.size_bytes(self.qlayers)

    def fp_bytes(self, bytes_per_param: int = 4) -> int:
        """Unquantized weight bytes of the searched projections."""
        return sum(q.w_params for q in self.qlayers) * bytes_per_param

    @property
    def kv_quant(self) -> str:
        return self.ctx.kv_quant

    @property
    def w_bits_total(self) -> float:
        """Exact packed weight-storage bits, the roofline's bytes term."""
        return self.policy_bytes() * 8.0

    # -- engine adapter API -------------------------------------------------
    def _forward(self, params, x, mode, states, pos, prefill_cap, slot=None):
        sites = [(s, params["sites"][lm.site_key(s.gidx)], None)
                 for s in self.sites]
        with dispatch.counts_scope(self.route_counts), \
                dispatch.act_reuse_scope() as scope:
            x, new_states, _ = lm.run_sites(
                x, sites, self.cfg, self.ctx, mode=mode, states=states,
                pos=pos, prefill_cap=prefill_cap, slot=slot)
        self.act_quant_reused += scope["hits"]
        if self.metrics is not None and scope["hits"]:
            self.metrics.counter("dispatch.act_reuse_hits").inc(scope["hits"])
        return x, new_states

    def prefill(self, params, tokens, *, prefill_cap, true_len=None):
        x = lm.embed_inputs(params, self.cfg, tokens, self.ctx, self.table)
        x, states = self._forward(params, x, "prefill", None, None,
                                  prefill_cap)
        return lm.finish_prefill(x, states, params, self.cfg, self.ctx,
                                 true_len, self.table)

    def decode(self, params, tok, pos, states):
        x = lm.embed_inputs(params, self.cfg, tok, self.ctx, self.table)
        x, new_states = self._forward(params, x, "decode", states, pos, None)
        return lm.lm_head(x, params, self.cfg, self.ctx, self.table)[:, 0], \
            new_states

    def verify(self, params, tok, pos, states):
        """Speculative verify: S = k + 1 tokens per slot in one multi-token
        step (``lm`` mode ``verify``): all S rows appended, each query
        attending rows at positions up to its own, so hidden states and KV
        rows are what S ``decode`` calls give. ``tok``/``pos`` (B, S);
        returns (logits (B, S, V), states)."""
        x = lm.embed_inputs(params, self.cfg, tok, self.ctx, self.table)
        x, new_states = self._forward(params, x, "verify", states, pos, None)
        return lm.lm_head(x, params, self.cfg, self.ctx, self.table), \
            new_states

    def append(self, params, tok, pos, slot: int, last_idx: int, states):
        """Chunked (paged) prefill: run a (1, C) token chunk through the
        model for ONE slot, writing KV rows at absolute positions ``pos``
        ((C,), -1 on pad rows, which the cache write drops) into that
        slot's pages. Returns (logits of row ``last_idx`` (1, V), states)."""
        x = lm.embed_inputs(params, self.cfg, tok, self.ctx, self.table)
        x, new_states = self._forward(params, x, "append", states, pos, None,
                                      slot=slot)
        logits = lm.lm_head(x[:, last_idx:last_idx + 1], params, self.cfg,
                            self.ctx, self.table)
        return logits[:, 0], new_states

    def init_state(self, batch, capacity, dtype, per_slot=True, device=None,
                   layout=None):
        return lm.init_decode_state(
            self.cfg, batch, capacity, dtype=dtype, per_slot=per_slot,
            kv_quant=self.ctx.kv_quant, layout=layout, device=device,
            rec_dtype=torch.promote_types(dtype, self.ctx.compute_dtype))

    def state_per_slot(self, row):
        return lm.decode_state_per_slot(row)

    # -- persistence --------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, directory: str, cfg: ModelConfig, *,
                        step: Optional[int] = None,
                        ctx: Optional[QuantContext] = None, device=None,
                        **kwargs) -> "QuantizedSession":
        """Restore a ``checkpoint.save_serving_bundle`` artifact (params +
        policy) onto ``device`` and pack it there.

        The bundled policy is validated against ``cfg``'s QLayer table
        BEFORE any array is read: a stale or foreign bundle fails with the
        ``MPQPolicy.validate`` message, not a missing-array or shape error
        from the checkpoint reader. The restore's template is the param
        tree's shapes alone (``lm.init_params`` on the ``meta`` device)."""
        from repro_torch import checkpoint as ckpt

        params, policy, _ = ckpt.load_serving_bundle(
            directory, lm.init_params(cfg, device="meta"), step=step,
            device=device,
            validate=lambda p: p.validate(lm.enumerate_qlayers(cfg),
                                          bits=cfg.bits))
        return cls(cfg, params, policy, ctx, **kwargs)


def draft_policy(policy: MPQPolicy, qlayers, bits,
                 draft_w_bits: int = 2) -> MPQPolicy:
    """The self-speculative draft policy of a searched target: the same
    layers and a_bits (so activation quantization and its reuse groups are
    the target's), every weight at ``draft_w_bits``. Both policies read
    the same trained indicator banks, so the width must be one of the
    searched ``bits``."""
    db = int(draft_w_bits)
    if db not in {int(b) for b in bits}:
        raise ValueError(
            f"draft_w_bits={db} is not in the searched bit set "
            f"{sorted(int(b) for b in bits)}; the draft policy can only "
            "read bit-widths the indicator banks were trained for")
    return MPQPolicy({q.name: db for q in qlayers}, dict(policy.a_bits),
                     meta={"kind": "spec-draft", "draft_w_bits": db,
                           "target": dict(policy.meta)})


class SpecSession(QuantizedSession):
    """Two packed trees of one set of trained weights and banks, for
    self-speculative decoding: ``params`` under the searched target policy
    (the emitted tokens are its greedy tokens) and ``draft_params`` under
    the uniform low-bit :func:`draft_policy`, which only proposes tokens.
    Both run through the same adapter methods; the engine drafts with
    ``draft_params`` and verifies with ``params``. A ``site_source`` hands
    each site over once; it is packed under both policies before the
    next."""

    def __init__(self, cfg: ModelConfig, params, policy: MPQPolicy,
                 ctx: Optional[QuantContext] = None, *,
                 kv_quant: str = "int8", draft_w_bits: int = 2,
                 site_source=None):
        lm.check_decodes(cfg)
        self.draft_w_bits = int(draft_w_bits)
        self.policy_draft = draft_policy(policy, lm.enumerate_qlayers(cfg),
                                         cfg.bits, self.draft_w_bits)
        super().__init__(cfg, params, policy, ctx, kv_quant=kv_quant,
                         site_source=site_source)
        (self.draft_params, self.draft_pack_health), = self.side_trees

    def _side_policies(self) -> List[MPQPolicy]:
        return [self.policy_draft]

    def draft_bytes(self) -> int:
        """Measured device bytes of the draft tree's packed codes: what a
        round reads k times."""
        return packing.tree_packed_bytes(self.draft_params)


def bank_fingerprint(params) -> str:
    """Fingerprint of the trained indicator-bank scales: every ``s_w`` /
    ``s_a`` leaf in sorted "/"-path order, its path and then its float32
    bytes, hashed -- the reference's bytes in the reference's order, so a
    policy stamped by either package validates in the other. Policy
    variants searched over the same banks carry this stamp in
    ``meta["indicator_family"]``; ``MPQPolicy.validate(family=...)`` then
    rejects a variant from another training, whose hot-swap would break
    the shared activation-quantization contract."""
    picked = []

    def walk(node, keys):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + (str(k),))
        elif keys and keys[-1] in ("s_w", "s_a"):
            picked.append((keys, node))

    walk(params, ())
    if not picked:
        raise ValueError(
            "no indicator-bank scale leaves (s_w/s_a) in params: cannot "
            "fingerprint the bank family — was this checkpoint trained "
            "with learned importance indicators?")
    h = hashlib.sha1()
    for keys, leaf in sorted(picked, key=lambda kv: kv[0]):
        h.update("/".join(keys).encode())
        h.update(np.asarray(leaf.detach().cpu().numpy(),
                            np.float32).tobytes())
    return h.hexdigest()[:16]


class ElasticSession(QuantizedSession):
    """A bank of policy variants for elastic precision serving: one set of
    trained weights and indicator banks, one packed tree per ``MPQPolicy``
    variant (e.g. 3/4/6-bit average budgets searched over the same banks,
    ``launch.elastic.build_variant_bank``). Every variant packs once at
    build, through ``_pack_trees``, as ``SpecSession`` packs its draft;
    ``set_active`` then hands the engine a resident pre-packed tree, so
    nothing is packed on the serving path.

    Per-variant state follows the active variant: ``policy``,
    ``pack_health`` and ``route_counts`` (each variant tallies its own
    routes: a swap moves sites between the int8, nib4 and sub-byte-unpack
    matmul routes). The act-reuse groups live in each packed tree.

    The build fails if a variant's ``meta["indicator_family"]`` stamp is
    not ``bank_fingerprint(params)``."""

    def __init__(self, cfg: ModelConfig, params,
                 variants: Mapping[str, MPQPolicy],
                 ctx: Optional[QuantContext] = None, *,
                 active: Optional[str] = None, mode: str = "packed",
                 kv_quant: str = "int8"):
        lm.check_decodes(cfg)
        if mode != "packed":
            raise ValueError(
                "ElasticSession packs N policy variants over one weight "
                "set; mode='reference' keeps fake-quant params and has "
                "nothing to swap — build a plain QuantizedSession instead")
        items = [(str(pid), pol) for pid, pol in variants.items()]
        if len(items) < 2:
            raise ValueError(
                "ElasticSession needs >= 2 policy variants; a single "
                "policy is a plain QuantizedSession")
        family = bank_fingerprint(params)
        qlayers = lm.enumerate_qlayers(cfg)
        for pid, pol in items:
            try:
                pol.validate(qlayers, bits=cfg.bits, family=family)
            except ValueError as e:
                raise ValueError(f"policy variant {pid!r}: {e}") from e
        by_id = dict(items)
        active = items[0][0] if active is None else str(active)
        if active not in by_id:
            raise ValueError(
                f"active variant {active!r} not in bank {sorted(by_id)}")
        super().__init__(cfg, params, by_id[active], ctx, kv_quant=kv_quant)
        self.family = family
        self.active_policy = active
        self.variant_policies: Dict[str, MPQPolicy] = by_id
        self.variants: Dict[str, Any] = {active: self.params}
        self.variant_pack_health: Dict[str, Dict[str, Dict[str, float]]] = {
            active: self.pack_health}
        self.variant_route_counts: Dict[str, dispatch.Counts] = {
            pid: (self.route_counts if pid == active else dispatch.Counts())
            for pid, _ in items}
        for pid, pol in items:
            if pid != active:
                (self.variants[pid], self.variant_pack_health[pid]), = \
                    self._pack_trees(params, [pol])

    # -- variant bank -------------------------------------------------------
    def params_for(self, pid: str):
        """The pre-packed param tree of one variant (no packing here)."""
        return self.variants[str(pid)]

    def set_active(self, pid: str):
        """Make ``pid`` the serving variant (``policy``, ``pack_health``,
        ``route_counts`` and ``packed_bytes`` follow) and return its
        resident pre-packed tree."""
        pid = str(pid)
        if pid not in self.variants:
            raise KeyError(
                f"unknown policy variant {pid!r}: {sorted(self.variants)}")
        self.active_policy = pid
        self.policy = self.variant_policies[pid]
        self.pack_health = self.variant_pack_health[pid]
        self.route_counts = self.variant_route_counts[pid]
        self.params = self.variants[pid]
        return self.params

    def variant_bytes(self) -> Dict[str, int]:
        """Measured device bytes of each resident variant's packed codes:
        what keeping the whole bank on the card costs."""
        return {pid: packing.tree_packed_bytes(tree)
                for pid, tree in self.variants.items()}


def _tag_act_groups(sp, packed_paths, site_key: str) -> None:
    """Assign ``PackedLinear.a_group`` reuse tags within one site: equal
    a_bits, equal signedness and equal selected bank-scale *values*; only
    groups of two or more get a tag, which embeds the site key so equal
    banks on different sites never alias."""
    groups: Dict[Tuple, List[Tuple[str, ...]]] = {}
    for path in packed_paths:
        pl = _get_path(sp, path)
        fp = (pl.a_bits, pl.a_signed,
              np.asarray(pl.s_a.detach().cpu(), np.float32).tobytes())
        groups.setdefault(fp, []).append(path)
    gi = 0
    for paths in groups.values():
        if len(paths) < 2:
            continue
        tag = f"{site_key}.a{gi}"
        gi += 1
        for path in paths:
            _set_path(sp, path, dataclasses.replace(_get_path(sp, path),
                                                    a_group=tag))


def summarize(session: QuantizedSession) -> Dict[str, Any]:
    """Device-memory accounting for logs and the serve gate."""
    packed = session.packed_bytes()
    target = session.policy_bytes()
    return {
        "packed_bytes": int(packed),
        "scale_bytes": int(session.scale_bytes()),
        "policy_bytes": float(target),
        "fp32_bytes": int(session.fp_bytes()),
        "packed_vs_policy": packed / target if target else float("nan"),
        "compression_vs_fp32": (session.fp_bytes() / packed if packed
                                else float("nan")),
        "avg_bits": session.policy.avg_bits(),
        "kv_quant": session.kv_quant,
        "act_quant_reused": int(session.act_quant_reused),
    }
