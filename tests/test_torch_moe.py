"""The MoE family's serving slice (deepseek-moe-16b: routed experts with
top-k routing and per-expert capacity, always-on shared experts, a leading
dense layer), port against the JAX reference, on the CPU.

Config: deepseek-moe-16b's smoke config (3 layers: one dense layer of d_ff
128, then two MoE layers of 8 experts of d_ff 64, top-2, 2 shared experts;
d_model 128, 4 heads of 32, vocab 512). JAX's own ``lm.init_params``
weights cross over through ``repro_torch.interop``; the full config's
schedule, QLayer table and policy bytes are compared without allocating
anything.

Tolerances. Routing is float32 on both sides, so the experts each token
picks and the tokens each expert keeps are compared as sets (a capacity
that binds included). Expert outputs, ``moe_ffn`` and whole forwards are
float32 contractions whose summation order differs between XLA and
PyTorch: held at ``tests/test_decode.py``'s 2e-4 (logits) and rtol 1e-5
with an atol of 1e-5 of the output's scale (one MoE layer); the aux loss at
rtol 1e-5. With quantization on, a last-bit difference can land an
activation on the other side of a code step, so one layer is held at 1e-3
of its scale. Inside the port the packed dequant-fp route and the
fake-quant graph are one op chain: bit for bit. Greedy tokens: equal on
decisive steps (top-2 margin above 1e-2).
"""
import dataclasses

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import get_config as j_get                # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
from repro.core.quantizer import fake_quant as j_fake_quant  # noqa: E402
from repro.dist.axes import NO_AXES                          # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.launch.scheduler import Request as JRequest       # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.models import moe as jmoe                         # noqa: E402
from repro.models.quant_layers import QuantContext as JCtx   # noqa: E402
from repro.runtime.session import QuantizedSession as JSess  # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import get_config as t_get          # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.kernels import ops, ref                     # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch.scheduler import Request as TRequest  # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.models import moe as tmoe                   # noqa: E402
from repro_torch.models.quant_layers import QuantContext as TCtx  # noqa: E402
from repro_torch.models.quant_layers import qdense_init, qeinsum  # noqa: E402
from repro_torch.runtime import dispatch, packing            # noqa: E402
from repro_torch.runtime.session import QuantizedSession as TSess  # noqa: E402
from repro_torch.runtime.session import effective_weight_scale  # noqa: E402

ARCH = "deepseek-moe-16b"
LOGIT_TOL = dict(atol=2e-4, rtol=2e-4)   # tests/test_decode.py
DECISIVE = 1e-2
MOE_LEAVES = ("router/w", "wi/w", "wi/s_w", "wi/s_a", "wo/w", "wo/s_w",
              "wo/s_a", "wg/w", "wg/s_w", "wg/s_a", "shared_wi/w",
              "shared_wi/s_w", "shared_wi/s_a", "shared_wo/w",
              "shared_wo/s_a", "shared_wg/w", "shared_wg/s_w")


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jpol=jpol, tpol=tpol)


def _ctxs(cfg, enabled=True):
    if not enabled:
        from repro.models.quant_layers import fp_context as jfp
        from repro_torch.models.quant_layers import fp_context as tfp
        return jfp(jnp.float32), tfp(torch.float32)
    return (JCtx.make(cfg.bits, True, compute_dtype=jnp.float32),
            TCtx.make(cfg.bits, True, compute_dtype=torch.float32))


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n).astype(
        np.int32)


def _close(t, j, rtol):
    """rtol ``rtol`` with an atol of ``rtol`` of the reference's scale."""
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-30))


# ---------------------------------------------------------------------------
# schedule, QLayer table, params
# ---------------------------------------------------------------------------
def test_schedule_qlayers_and_policy_bytes_match_reference():
    """The full config's schedule, its 277 QLayers in order (names, sites,
    paths, dims, MACs, weight counts, kinds) and the demo policy's bytes
    are the reference's (nothing is allocated); mixtral's schedule too."""
    jcfg, tcfg = j_get(ARCH), t_get(ARCH)
    assert tuple(tlm.build_schedule(tcfg)) == tuple(jlm.build_schedule(jcfg))
    assert tlm.build_schedule(tcfg) == (("dense",), ("moe",), 27, ())
    jq, tq = jlm.enumerate_qlayers(jcfg), tlm.enumerate_qlayers(tcfg)
    assert len(tq) == 277
    assert [dataclasses.astuple(q) for q in tq] == \
        [dataclasses.astuple(q) for q in jq]
    assert tq[4].name == "L000.mlp_wi" and tq[4].out_dim == 10944
    assert sum(q.kind == "moe" and q.n_mats == 64 for q in tq) == 3 * 27
    jp, tp = jserve.demo_mixed_policy(jcfg), tserve.demo_mixed_policy(tcfg)
    assert tp.w_bits == jp.w_bits and tp.a_bits == jp.a_bits
    assert tp.size_bytes(tq) == jp.size_bytes(jq)
    assert 7.9e9 < tp.size_bytes(tq) < 8.0e9
    mix = "mixtral-8x7b"
    assert tuple(tlm.build_schedule(t_get(mix))) == \
        tuple(jlm.build_schedule(j_get(mix)))


def test_interop_carries_every_moe_array(world):
    """Every reference array crosses unchanged -- the router, the stacked
    (layers, experts, ...) leaves with their (layers, experts, bits) banks
    and the shared experts -- and the port's own init lays out the same
    tree, key for key and shape for shape."""
    jparams, tparams, tcfg = world["jparams"], world["tparams"], \
        world["tcfg"]
    flat = jckpt._flatten(jparams)
    want = {f"body/0/moe/{leaf}" for leaf in MOE_LEAVES}
    assert want <= set(flat)
    assert flat["body/0/moe/wi/w"].shape == (2, 8, 128, 64)
    assert flat["body/0/moe/wi/s_w"].shape == (2, 8, tcfg.n_bits)
    assert flat["prefix/0/mlp_wi/w"].shape == (128, 128)
    for key, arr in flat.items():
        node = tparams
        for k in key.split("/"):
            node = node[k]
        np.testing.assert_array_equal(node.numpy(), arr)
    mine = tlm.init_params(tcfg, seed=0)
    for key, arr in flat.items():
        node = mine
        for k in key.split("/"):
            node = node[k]
        assert tuple(node.shape) == arr.shape, key
    assert tlm.param_count(mine) == sum(a.size for a in flat.values())


# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------
def _moe_case(world, skew: bool):
    """Layer 1's MoE params (per-expert banks made distinct) and a (2, 128,
    128) input; ``skew`` makes expert 3 the top pick of every token, so 256
    tokens are offered to an expert of capacity 128."""
    jp = jax.tree.map(lambda a: np.array(a[0]),
                      world["jparams"]["body"]["0"]["moe"])
    rng = np.random.default_rng(5 + skew)
    for name in ("wi", "wo", "wg"):
        for bank in ("s_w", "s_a"):
            jp[name][bank] = (jp[name][bank] * rng.uniform(
                0.5, 2.0, (8, 1))).astype(np.float32)
    x = _f32(rng, 2, 128, 128)
    if skew:
        x[..., 0] = 2.0 + 0.1 * x[..., 0]
        jp["router"]["w"][0, 3] = 4.0
    tp = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()})
          for k, v in jp.items()}
    return jp, tp, x


def _jax_routing(jp, x, moe):
    """The reference's routing, as ``moe_ffn`` computes it at G = 1: each
    token's experts and each expert's kept tokens, as sets."""
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xf @ jnp.asarray(jp["router"]["w"]), axis=-1)
    top_w, top_i = jax.lax.top_k(probs, moe.top_k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    gates = jnp.sum(jax.nn.one_hot(top_i, moe.n_experts) * top_w[..., None],
                    axis=1)
    gv, gi = jax.lax.top_k(gates.T, jmoe.capacity(xf.shape[0], moe))
    kept = {(e, int(t)) for e in range(moe.n_experts)
            for t, v in zip(np.asarray(gi[e]), np.asarray(gv[e])) if v > 0}
    return {tuple(sorted(r)) for r in np.asarray(top_i).tolist()}, kept


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("skew", [False, True])
def test_moe_ffn_matches_jax(world, quant, skew):
    """``moe_ffn`` on the same numpy inputs, quantization off and on (a
    mixed bit assignment, distinct per-expert scales): the same experts per
    token and kept tokens per expert (with ``skew``, capacity drops 128 of
    the 256 tokens offered to one expert), output and aux within the
    module's tolerances."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    moe = tcfg.moe
    jp, tp, x = _moe_case(world, skew)
    bits = {"wi": {"w": 0, "a": 1}, "wo": {"w": 2, "a": 3},
            "wg": {"w": 4, "a": 0}, "shared_wi": {"w": 1, "a": 2},
            "shared_wo": {"w": 3, "a": 4}, "shared_wg": {"w": 2, "a": 2}} \
        if quant else None
    jctx, tctx = _ctxs(jcfg, quant)
    jo, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(
        x, p, jcfg.moe, bits, jctx, jcfg.act, jcfg.mlp_gated, NO_AXES))(
        jp, jnp.asarray(x))
    to, taux = tmoe.moe_ffn(torch.from_numpy(x), tp, moe, bits, tctx,
                            tcfg.act, tcfg.mlp_gated)
    experts, kept = _jax_routing(jp, x, moe)
    r = tmoe.route(torch.from_numpy(x).reshape(-1, 128), tp["router"]["w"],
                   moe)
    assert {tuple(sorted(e)) for e in r.top_i.tolist()} == experts
    assert {(e, t) for e in range(moe.n_experts)
            for t, k in zip(r.gi[e].tolist(), r.keep[e].tolist())
            if k} == kept
    if skew:
        assert r.gi.shape[1] == 128
        assert sum(e == 3 for e, _ in kept) == 128    # capacity binds
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    _close(to, jo, 1e-3 if quant else 1e-5)


def test_combine_sums_in_expert_order_and_repeats():
    """The combine equals the reference's scatter-add (index order,
    expert-major: each token's rows in ascending expert order from zero)
    bit for bit, with capacity dropping picks (200 tokens, one expert
    offered nearly all of them), and two equal calls are equal."""
    from repro_torch.configs.base import MoEConfig
    moe = MoEConfig(n_experts=6, top_k=3, d_ff=4)
    rng = np.random.default_rng(3)
    xf = _f32(rng, 200, 8)
    w = _f32(rng, 8, 6) * 0.3
    xf[:, 0], w[0, 2] = 2.0, 3.0
    r = tmoe.route(torch.from_numpy(xf), torch.from_numpy(w), moe)
    E, C = r.gi.shape
    assert C == 128 and int(r.keep[2].sum()) == 128     # capacity binds
    y = torch.from_numpy(_f32(rng, E, C, 5)) * (r.gv * r.keep)[..., None]
    want = torch.zeros((200, 5))
    for e in range(E):
        for c in range(C):
            t = int(r.gi[e, c])
            want[t] = want[t] + y[e, c]
    got = tmoe.combine(y, r.gi, r.keep, r.top_i, 200)
    assert torch.equal(got, want)
    assert torch.equal(tmoe.combine(y, r.gi, r.keep, r.top_i, 200), got)


# ---------------------------------------------------------------------------
# the per-expert scale: plain fake-quant and the packed expert route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 4, 128), (4, 6, 9), (3, 1)])
def test_fake_quant_ref_per_slice_matches_reference(shape):
    """The plain per-slice fake-quant (one scale for each leading slice, the
    wrapper's trailing-ones form) equals the reference's broadcasting
    ``fake_quant`` bit for bit, and one scale is the old plain version; the
    backward takes the same scales."""
    rng = np.random.default_rng(len(shape))
    v = _f32(rng, *shape) * 3
    s = rng.uniform(0.05, 0.5, (shape[0],) + (1,) * (len(shape) - 1)) \
        .astype(np.float32)
    s[0] = 0.0                                    # the 1e-9 floor
    want = np.asarray(j_fake_quant(jnp.asarray(v), jnp.asarray(s), -8, 7))
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    assert ops.fq_scale_slices(tv, ts) == shape[0]
    got = ops.fake_quant_fwd(tv, ts, -8.0, 7.0)
    np.testing.assert_array_equal(got.numpy(), want)
    one = torch.tensor(0.3)
    assert torch.equal(ref.fake_quant_ref(tv, one, -8.0, 7.0),
                       torch.round(torch.clamp(tv / one, -8, 7)) * one)
    with pytest.raises(TypeError, match="leading"):
        ops.fq_scale_slices(tv, ts.reshape(-1))
    # the backward takes the same scales: one ds per slice
    dv, ds = ops.fake_quant_bwd(tv, ts, tv, -8.0, 7.0)
    assert dv.shape == tv.shape and ds.shape == (shape[0],)
    with pytest.raises(TypeError, match="leading"):
        ops.fake_quant_bwd(tv, ts.reshape(-1), tv, -8.0, 7.0)


def test_packed_expert_route_bitwise_equals_fake_quant_graph():
    """Expert-stacked (E, K, N) weights with DISTINCT per-expert bank
    scales pack with their (E, 1, 1) scale and (E,) activation scale; the
    packed route (dequant-fp, not kernel-eligible) equals the fake-quant
    ``qeinsum`` bit for bit at every width's layout."""
    bits = (2, 3, 4, 5, 6)
    ctx = TCtx.make(bits, True, compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(9)
    x = torch.from_numpy(_f32(np.random.default_rng(2), 3, 4, 8))  # (E,T,d)
    for w_idx in range(len(bits)):
        p = qdense_init(gen, 8, 6, bits, stacked=(3,))
        p["s_w"] = p["s_w"] * torch.tensor([1.0, 1.6, 0.5])[:, None]
        p["s_a"] = p["s_a"] * torch.tensor([1.0, 2.0, 0.7])[:, None]
        a_idx = (w_idx + 2) % len(bits)
        want = qeinsum("etd,edf->etf", x, p, {"w": w_idx, "a": a_idx}, ctx)
        s_w = effective_weight_scale(p["s_w"], w_idx, p["w"].numel(),
                                     bits[w_idx], w_ndim=3)
        assert s_w.shape == (3, 1, 1)
        pl = packing.pack_linear(p["w"], bits[w_idx], s_w, bits[a_idx],
                                 p["s_a"][..., a_idx])
        assert pl.scale.shape == (3, 1, 1) and pl.s_a.shape == (3,)
        assert dispatch.kernel_eligible("etd,edf->etf", pl) is None
        got = dispatch.packed_qeinsum("etd,edf->etf", x, pl, ctx)
        assert torch.equal(got, want), w_idx


# ---------------------------------------------------------------------------
# whole forwards against the reference
# ---------------------------------------------------------------------------
def test_train_logits_and_loss_with_aux_match_jax(world):
    """``apply_train`` logits and ``loss_fn`` (CE + 0.01 x the MoE aux,
    summed over the two MoE layers) at S = 40, quantized at a uniform
    width."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    jctx, tctx = _ctxs(jcfg)
    toks = np.stack([_prompt(tcfg, 40, 1), _prompt(tcfg, 40, 2)])
    jb, tb = jlm.bits_uniform(jcfg, 2), tlm.bits_uniform(tcfg, 2)
    (jl, jm) = jax.jit(lambda p, t: jlm.loss_fn(
        p, jcfg, {"tokens": t}, jb, jctx, NO_AXES, remat=False))(
        world["jparams"], jnp.asarray(toks))
    tl, tm = tlm.loss_fn(world["tparams"], tcfg, {"tokens": toks}, tb, tctx,
                         remat=False)
    assert float(tm["moe_aux"]) > 0
    for k in ("loss", "ce", "moe_aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    jlog, _ = jax.jit(lambda p, t: jlm.apply_train(
        p, jcfg, {"tokens": t}, jb, jctx, NO_AXES, remat=False))(
        world["jparams"], jnp.asarray(toks))
    tlog, taux = tlm.apply_train(world["tparams"], tcfg, {"tokens": toks},
                                 tb, tctx, remat=True)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               **LOGIT_TOL)
    assert torch.equal(taux, tm["moe_aux"])


def test_prefill_and_decode_logits_match_jax(world):
    """A 20-token prefill, then 4 decode steps on the prompt's own
    continuation (``tests/test_decode.py``), unquantized: logits within
    2e-4 at every step (each call routes its own tokens)."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    jctx, tctx = _ctxs(jcfg, enabled=False)
    toks = np.stack([_prompt(tcfg, 24, 3), _prompt(tcfg, 24, 4)])
    P = 20
    jl, jst = jax.jit(lambda p, t: jlm.apply_prefill(
        p, jcfg, {"tokens": t}, None, jctx, NO_AXES, prefill_cap=24))(
        world["jparams"], jnp.asarray(toks[:, :P]))
    tl, tst = tlm.apply_prefill(world["tparams"], tcfg,
                                torch.from_numpy(toks[:, :P]), None, tctx,
                                prefill_cap=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    j_decode = jax.jit(lambda p, t, pos, st: jlm.apply_decode(
        p, jcfg, t, pos, st, None, jctx, NO_AXES))
    for t in range(P, 24):
        tok = toks[:, t:t + 1]
        jl, jst = j_decode(world["jparams"], jnp.asarray(tok),
                           jnp.asarray(t, jnp.int32), jst)
        tl, tst = tlm.apply_decode(world["tparams"], tcfg,
                                   torch.from_numpy(tok), t, tst, None, tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the packed session and the engines
# ---------------------------------------------------------------------------
LENS, GENS = [12, 9, 16], [5, 4, 6]


def _requests(cls, cfg):
    return [cls(i, _prompt(cfg, n, 40 + i), g)
            for i, (n, g) in enumerate(zip(LENS, GENS))]


def test_packed_session_serves_the_reference_tokens(world):
    """Three requests on two slots: the packed session's greedy tokens
    equal the JAX packed engine's on decisive steps (the same decode
    steps), and the port's own fake-quant engine's with its float64
    control; the packed route is that graph bit for bit at the prefill
    and a decode step."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    tparams, tpol = world["tparams"], world["tpol"]
    kw = dict(slots=2, cache_len=24, prefill_chunk=16, device="cpu")
    ts, te, tout = tserve.serve_quantized(tcfg, tparams, tpol,
                                          _requests(TRequest, tcfg), **kw)
    assert ts.route_counts.routes["matmul"]["dequant-fp"] > 0
    js = JSess(jcfg, world["jparams"], world["jpol"])
    je = jeng.DecodeEngine(js.params, jcfg, None, js.ctx, adapter=js,
                           ecfg=jeng.EngineConfig(
                               slots=2, cache_len=24, prefill_chunk=16,
                               kv_quant="int8", trace=False))
    je.submit_all(_requests(JRequest, jcfg))
    jout = je.run()
    assert te.stats.decode_steps == je.stats.decode_steps
    compared = 0
    for rid, c in tout.items():
        assert len(c.tokens) == len(jout[rid].tokens) == GENS[rid]
        n, miss = teng.decisive_prefix(jout[rid].tokens, c.tokens,
                                       te.margins[rid], DECISIVE)
        assert miss is None, (rid, jout[rid].tokens, c.tokens)
        compared += n
    assert compared >= len(LENS)
    n, bad, _ = tserve.check_greedy(tcfg, tparams, tpol,
                                    _requests(TRequest, tcfg), tout, **kw)
    assert not bad and n >= len(LENS)
    # inside the port: the packed route is the fake-quant graph
    bits = tlm.bits_from_policy(tcfg, tpol)
    ref_ctx = dataclasses.replace(tserve.make_context(tcfg), kv_quant="fake")
    toks = torch.from_numpy(_prompt(tcfg, 14, 7))[None]
    pl, ps = ts.prefill(ts.params, toks, prefill_cap=24)
    rl, rs = tlm.apply_prefill(tparams, tcfg, toks, bits, ref_ctx,
                               prefill_cap=24)
    assert torch.equal(pl, rl)
    tok = torch.argmax(pl, -1)[:, None].to(torch.int32)
    pos = torch.tensor([14], dtype=torch.int32)
    pl, _ = ts.decode(ts.params, tok, pos, ts.state_per_slot(ps))
    rl, _ = tlm.apply_decode(tparams, tcfg, tok, pos,
                             tlm.decode_state_per_slot(rs), bits, ref_ctx)
    assert torch.equal(pl, rl)


def test_site_source_packs_site_by_site(world):
    """A session packed from a site source (each site's subtree handed over
    when it is packed) holds the codes of one packed from the whole tree."""
    tcfg, tparams, tpol = world["tcfg"], world["tparams"], world["tpol"]
    calls = []

    def source(site):
        calls.append(site.gidx)
        return tlm.site_params(tparams, site)

    outer = {k: v for k, v in tparams.items()
             if k not in ("prefix", "body", "suffix")}
    a = TSess(tcfg, outer, tpol, site_source=source)
    b = TSess(tcfg, tparams, tpol)
    assert calls == [s.gidx for s in tlm.iter_sites(tcfg)]
    la, lb = packing.packed_leaves(a.params), packing.packed_leaves(b.params)
    assert len(la) == len(lb) == len(tlm.enumerate_qlayers(tcfg))
    for pa, pb in zip(la, lb):
        assert torch.equal(pa.codes, pb.codes)
        assert torch.equal(pa.scale, pb.scale)
