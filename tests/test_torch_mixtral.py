"""mixtral-8x7b's serving slice (8 routed experts, top-2, no shared experts
and no dense layer; GQA 32 / 8 heads; a 4096-row sliding window), port
against the JAX reference, on the CPU.

Config: the arch's smoke config (2 MoE layers, d_model 128, 4 query heads
over 2 kv heads of 32, 8 experts of d_ff 64, top-2, a 64-row window, vocab
512). JAX's own ``lm.init_params`` weights cross over through
``repro_torch.interop``; the full config's schedule, QLayer table, policy
bytes and parameter count are compared without allocating anything.

Tolerances (ROADMAP "Exactness classes"). Routing is float32 on both sides,
so each token's experts and each expert's kept tokens are compared as
sets. One MoE layer is held to rtol 1e-5 with an atol of 1e-5 of its
output's scale unquantized, 1e-3 quantized (a last bit can land an
activation on the other side of a code step); the aux loss to rtol 1e-5.
Whole forwards are held to ``tests/test_decode.py``'s 2e-4 (unquantized)
and the packed sessions to ``tests/test_torch_serve.py``'s atol 2e-4 /
rtol 1e-4, with greedy tokens equal on decisive rows (top-2 margin above
1e-2). Inside the port, packing site by site and packing the whole tree
give the same codes and scales bit for bit.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import get_config as j_get                # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
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
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch.scheduler import Request as TRequest  # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.models import moe as tmoe                   # noqa: E402
from repro_torch.models.quant_layers import QuantContext as TCtx  # noqa: E402
from repro_torch.runtime import packing                      # noqa: E402
from repro_torch.runtime.session import QuantizedSession as TSess  # noqa: E402

ARCH = "mixtral-8x7b"
LOGIT_TOL = dict(atol=2e-4, rtol=2e-4)          # tests/test_decode.py
SESSION_TOL = dict(atol=2e-4, rtol=1e-4)        # tests/test_torch_serve.py
DECISIVE = 1e-2
EXPERT_LEAVES = ("wi/w", "wi/s_w", "wi/s_a", "wo/w", "wo/s_w", "wo/s_a",
                 "wg/w", "wg/s_w", "wg/s_a")
LONG = 80                   # a prompt past the smoke config's 64-row window


@pytest.fixture(scope="module")
def world():
    """The reference's own mixtral serving case
    (``tests/test_runtime.py::test_session_packed_moe_arch_token_identical``):
    ``PRNGKey(1)`` params and a policy cycling the widths over the QLayer
    table, which is ``demo_mixed_policy``'s assignment."""
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jpol=jpol, tpol=tpol)


@pytest.fixture(scope="module")
def jsess(world):
    """The reference's packed session (int8 KV), packed once."""
    return JSess(world["jcfg"], world["jparams"], world["jpol"])


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n).astype(
        np.int32)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close_scaled(t, j, rtol):
    """rtol ``rtol`` with an atol of ``rtol`` of the reference's scale."""
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-30))


def _decisive_argmax_equal(a, b):
    """Rows of ``b`` whose top-2 margin exceeds ``DECISIVE``: argmax of
    ``a`` equals ``b``'s there. Returns how many rows were decisive."""
    a, b = np.asarray(a).reshape(-1, a.shape[-1]), np.asarray(b)
    b = b.reshape(-1, b.shape[-1])
    top2 = np.sort(b, axis=-1)[:, -2:]
    dec = top2[:, 1] - top2[:, 0] > DECISIVE
    np.testing.assert_array_equal(a.argmax(-1)[dec], b.argmax(-1)[dec])
    return int(dec.sum())


def _flat_keys(tree, pre=""):
    if isinstance(tree, dict):
        return {k for n, v in tree.items()
                for k in _flat_keys(v, f"{pre}{n}/")}
    return {pre[:-1]}


def _leaf(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# schedule, QLayers, policy, params
# ---------------------------------------------------------------------------
def test_full_config_schedule_qlayers_and_policy_match_jax(world):
    """At full size, with nothing allocated: the schedule (no prefix, 32
    MoE layers), the 224 QLayers in order (96 of them (8, ...) expert
    stacks), the demo policy's bits and its 23,155,703,808 B, the 46.70 B
    parameters and the 4096-row window are the reference's."""
    jfull, tfull = j_get(ARCH), t_get(ARCH)
    sched = tlm.build_schedule(tfull)
    assert tuple(sched) == tuple(jlm.build_schedule(jfull))
    assert tuple(sched) == ((), ("moe",), 32, ())
    assert tlm.attn_window(tfull) == 4096
    jq, tq = jlm.enumerate_qlayers(jfull), tlm.enumerate_qlayers(tfull)
    assert [dataclasses.astuple(q) for q in tq] == \
        [dataclasses.astuple(q) for q in jq]
    assert len(tq) == 224
    assert sum(q.kind == "moe" and q.n_mats == 8 for q in tq) == 96
    assert sum(q.w_params for q in tq) == 46_439_333_888
    jpol, tpol = jserve.demo_mixed_policy(jfull), tserve.demo_mixed_policy(
        tfull)
    assert tpol.w_bits == jpol.w_bits and tpol.a_bits == jpol.a_bits
    assert tpol.size_bytes(tq) == jpol.size_bytes(jq) == 23_155_703_808
    n_t = tlm.param_count(tlm.init_params(tfull, device="meta"))
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jfull),
                            jax.random.PRNGKey(0))
    n_j = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert n_t == n_j and round(n_t / 1e9, 2) == 46.70
    assert [s.kind for s in tlm.iter_sites(world["tcfg"])] == ["moe"] * 2


def test_interop_carries_every_array(world):
    """Every reference array crosses unchanged by key -- the router and the
    (layers, 8, ...) expert stacks with their (layers, 8, bits) banks, and
    no shared-expert leaf -- and the port's own init lays out the same
    tree, key for key and shape for shape."""
    tcfg, tparams = world["tcfg"], world["tparams"]
    flat = jckpt._flatten(world["jparams"])
    want = {"body/0/moe/router/w"} | {f"body/0/moe/{x}"
                                      for x in EXPERT_LEAVES}
    assert want <= set(flat)
    assert not any("shared" in k or k.startswith("prefix") for k in flat)
    assert flat["body/0/moe/router/w"].shape == (2, 128, 8)
    assert flat["body/0/moe/wi/w"].shape == (2, 8, 128, 64)
    assert flat["body/0/moe/wo/w"].shape == (2, 8, 64, 128)
    assert flat["body/0/moe/wg/s_w"].shape == (2, 8, tcfg.n_bits)
    assert set(flat) == _flat_keys(tparams)
    for key, arr in flat.items():
        np.testing.assert_array_equal(_leaf(tparams, key).numpy(), arr)
    mine = tlm.init_params(tcfg, seed=0)
    assert _flat_keys(mine) == set(flat)
    for key, arr in flat.items():
        assert tuple(_leaf(mine, key).shape) == arr.shape, key
    assert tlm.param_count(mine) == sum(a.size for a in flat.values())


# ---------------------------------------------------------------------------
# one MoE layer: top-2 over 8 experts, no shared experts
# ---------------------------------------------------------------------------
def _moe_case(world, skew: bool):
    """Layer 1's MoE params (per-expert banks made distinct) and a (2, 128,
    128) input (C = 128 of 256 tokens); ``skew`` makes expert 5 the top
    pick of every token, so 256 tokens are offered to an expert of
    capacity 128."""
    jp = jax.tree.map(lambda a: np.array(a[1]),
                      world["jparams"]["body"]["0"]["moe"])
    rng = np.random.default_rng(7 + skew)
    for name in ("wi", "wo", "wg"):
        for bank in ("s_w", "s_a"):
            jp[name][bank] = (jp[name][bank] * rng.uniform(
                0.5, 2.0, (8, 1))).astype(np.float32)
    x = _f32(rng, 2, 128, 128)
    if skew:
        x[..., 0] = 2.0 + 0.1 * x[..., 0]
        jp["router"]["w"][0, 5] = 4.0
    tp = {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
          for k, v in jp.items()}
    return jp, tp, x


def _jax_routing(jp, x, moe):
    """The reference's routing, as its ``moe_ffn`` computes it at G = 1:
    each token's experts and each expert's kept tokens, as sets."""
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
    """``moe_ffn`` at top-2 with no shared experts, quantization off and on
    (a mixed bit assignment, distinct per-expert scales): the same experts
    per token and kept tokens per expert (with ``skew``, capacity drops 128
    of the 256 tokens offered to one expert), output and aux within the
    module's tolerances."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    moe = tcfg.moe
    assert (moe.n_experts, moe.top_k, moe.n_shared) == (8, 2, 0)
    jp, tp, x = _moe_case(world, skew)
    assert not any(k.startswith("shared") for k in tp)
    bits = {"wi": {"w": 0, "a": 1}, "wo": {"w": 2, "a": 3},
            "wg": {"w": 4, "a": 0}} if quant else None
    if quant:
        jctx = JCtx.make(jcfg.bits, True, compute_dtype=jnp.float32)
        tctx = TCtx.make(tcfg.bits, True, compute_dtype=torch.float32)
    else:
        from repro.models.quant_layers import fp_context as jfp
        from repro_torch.models.quant_layers import fp_context as tfp
        jctx, tctx = jfp(jnp.float32), tfp(torch.float32)
    jo, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(
        x, p, jcfg.moe, bits, jctx, jcfg.act, jcfg.mlp_gated, NO_AXES))(
        jp, jnp.asarray(x))
    to, taux = tmoe.moe_ffn(torch.from_numpy(x), tp, moe, bits, tctx,
                            tcfg.act, tcfg.mlp_gated)
    experts, kept = _jax_routing(jp, x, moe)
    r = tmoe.route(torch.from_numpy(x).reshape(-1, 128), tp["router"]["w"],
                   moe)
    assert r.gi.shape == (8, 128)
    assert {tuple(sorted(e)) for e in r.top_i.tolist()} == experts
    assert {(e, t) for e in range(moe.n_experts)
            for t, k in zip(r.gi[e].tolist(), r.keep[e].tolist())
            if k} == kept
    if skew:
        assert sum(e == 5 for e, _ in kept) == 128    # capacity binds
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    _close_scaled(to, jo, 1e-3 if quant else 1e-5)


def test_capacity_at_the_served_call_sizes():
    """The capacity each expert takes at the full config's calls, the
    reference's: 4 rows a decode step of 4 slots (every pick kept), 1536 of
    the 4608-token prompt, 128 of the 224-token one."""
    jmoe_cfg, tmoe_cfg = j_get(ARCH).moe, t_get(ARCH).moe
    for T, C in ((4, 4), (224, 128), (4608, 1536)):
        assert tmoe.capacity(T, tmoe_cfg) == jmoe.capacity(T, jmoe_cfg) == C


# ---------------------------------------------------------------------------
# whole forwards past the window
# ---------------------------------------------------------------------------
def test_prefill_and_decode_past_the_window_match_jax(world):
    """An 80-token prefill (16 tokens past the 64-row window, the cache
    clamped to the window), then 8 decode steps over the wrapped ring on
    the prompt's own continuation, unquantized: logits within 2e-4 at
    every step (each call routes its own tokens)."""
    from repro.models.quant_layers import fp_context as jfp
    from repro_torch.models.quant_layers import fp_context as tfp
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    jctx, tctx = jfp(jnp.float32), tfp(torch.float32)
    toks = np.stack([_prompt(tcfg, LONG + 8, 3), _prompt(tcfg, LONG + 8, 4)])
    jl, jst = jax.jit(lambda p, t: jlm.apply_prefill(
        p, jcfg, {"tokens": t}, None, jctx, NO_AXES, prefill_cap=LONG + 8))(
        world["jparams"], jnp.asarray(toks[:, :LONG]))
    tl, tst = tlm.apply_prefill(world["tparams"], tcfg,
                                torch.from_numpy(toks[:, :LONG]), None, tctx,
                                prefill_cap=LONG + 8)
    key = tlm.site_key(0)
    assert tst["sites"][key].k.shape[1] == 64          # clamped to the window
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    j_decode = jax.jit(lambda p, t, pos, st: jlm.apply_decode(
        p, jcfg, t, pos, st, None, jctx, NO_AXES))
    for t in range(LONG, LONG + 8):
        tok = toks[:, t:t + 1]
        jl, jst = j_decode(world["jparams"], jnp.asarray(tok),
                           jnp.asarray(t, jnp.int32), jst)
        tl, tst = tlm.apply_decode(world["tparams"], tcfg,
                                   torch.from_numpy(tok), t, tst, None, tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_packed_session_past_the_window_matches_jax(world, jsess):
    """The packed sessions of both packages (int8 ring, the demo policy):
    an 80-token prefill's logits, then 8 decode steps over the wrapped ring
    within atol 2e-4 / rtol 1e-4, greedy tokens equal on decisive rows; the
    packed bytes are the reference's. Both decode from the reference's
    prefill ring (carried into the port's cache type): its jitted
    prefill sums float32 ops in another order than its own op-by-op
    evaluation, and a last bit can move a KV row by int8 code steps (up to
    13 on one prompt, ROADMAP 3), which the decode logits then show."""
    tcfg, js = world["tcfg"], jsess
    ts = TSess(tcfg, world["tparams"], world["tpol"])
    assert ts.packed_bytes() == js.packed_bytes()
    toks = _prompt(tcfg, LONG, 5)
    jl, jst = jax.jit(lambda p, t: js.prefill(
        p, {"tokens": t}, prefill_cap=96))(js.params,
                                           jnp.asarray(toks)[None])
    tl, tst = ts.prefill(ts.params, torch.from_numpy(toks)[None],
                         prefill_cap=96)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SESSION_TOL)
    n_dec = _decisive_argmax_equal(tl, jl)
    jst = js.state_per_slot(jst)
    tst = ts.state_per_slot(tst)
    assert tst["sites"].keys() == jst["sites"].keys()
    for key, c in tst["sites"].items():
        assert c.k.shape[1] == tcfg.sliding_window     # clamped to it
        tst["sites"][key] = type(c)._make(
            torch.from_numpy(np.array(a)) for a in jst["sites"][key])
    j_decode = jax.jit(js.decode)
    tok = int(np.asarray(jl).argmax())
    for step in range(8):
        pos = LONG + step
        jl, jst = j_decode(js.params, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray([pos], jnp.int32), jst)
        tl, tst = ts.decode(ts.params, torch.tensor([[tok]],
                                                    dtype=torch.int32),
                            torch.tensor([pos], dtype=torch.int32), tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **SESSION_TOL)
        n_dec += _decisive_argmax_equal(tl, jl)
        tok = int(np.asarray(jl).argmax())
    for key, c in tst["sites"].items():
        np.testing.assert_array_equal(c.pos.numpy(),
                                      np.asarray(jst["sites"][key].pos))
    assert n_dec >= 5


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
# the reference's own case (the world's params and policy, two requests on
# 2 slots of 12 rows), and the same with a third request past the window
# on slots of the window's 64 rows
ENGINE_CASES = {
    "reference-case": dict(cache_len=12, prefill_chunk=0, lens=[]),
    "past-the-window": dict(cache_len=64, prefill_chunk=96,
                            lens=[(LONG, 6)]),
}


def _engine_requests(cls, extra):
    r = np.random.default_rng(11)
    pairs = [(6, 3), (4, 3)] + extra
    return [cls(rid=i, tokens=r.integers(0, 500, size=p).astype(np.int32),
                max_new=g, arrival=0) for i, (p, g) in enumerate(pairs)]


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_packed_engine_serves_the_jax_packed_engines_tokens(world, jsess,
                                                            case):
    """The packed session through the port's engine gives the JAX packed
    engine's greedy tokens on every decisive step, with the same decode
    steps: the reference's own case, and one with a request past the
    window (its prompt prefilled whole, its decode over the wrapped ring).
    Windowed admission takes the request past the cache, and no prompt is
    bucketed though the config asks for it."""
    c = ENGINE_CASES[case]
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    ql = jlm.enumerate_qlayers(jcfg)
    widths = sorted(int(b) for b in jcfg.bits)
    assert world["jpol"].w_bits == {q.name: widths[i % len(widths)]
                                    for i, q in enumerate(ql)}
    je = jeng.DecodeEngine(jsess.params, jcfg, None, jsess.ctx, NO_AXES,
                           jeng.EngineConfig(
                               slots=2, cache_len=c["cache_len"],
                               prefill_chunk=c["prefill_chunk"],
                               kv_quant="int8", trace=False),
                           adapter=jsess)
    je.submit_all(_engine_requests(JRequest, c["lens"]))
    jout = je.run()
    ts = TSess(tcfg, world["tparams"], world["tpol"])
    te = teng.DecodeEngine(ts.params, tcfg, None, ts.ctx, adapter=ts,
                           device="cpu", ecfg=teng.EngineConfig(
                               slots=2, cache_len=c["cache_len"],
                               prefill_chunk=c["prefill_chunk"],
                               kv_quant="int8", bucket_prompts=True,
                               trace=False))
    assert not te._bucket
    reqs = _engine_requests(TRequest, c["lens"])
    if c["lens"]:
        assert max(r.prompt_len for r in reqs) > tcfg.sliding_window
    te.submit_all(reqs)
    tout = te.run()
    assert te.stats.decode_steps == je.stats.decode_steps
    compared = 0
    for r in reqs:
        a, b = tout[r.rid].tokens, jout[r.rid].tokens
        assert len(a) == len(b) == r.max_new
        n, miss = teng.decisive_prefix(b, a, te.margins[r.rid], DECISIVE)
        assert miss is None, (r.rid, b, a)
        compared += n
    assert compared >= len(reqs)


def test_site_source_packs_site_by_site_with_no_prefix(world):
    """A session packed from a site source with an empty prefix (each MoE
    site's subtree handed over when it is packed, the outer tree only the
    embedding, final norm and head) holds the codes and scales of one
    packed from the whole tree, bit for bit, and serves the same logits."""
    tcfg, tparams, tpol = world["tcfg"], world["tparams"], world["tpol"]
    assert tlm.build_schedule(tcfg).prefix == ()
    calls = []

    def source(site):
        calls.append(site.gidx)
        return tlm.site_params(tparams, site)

    outer = {k: v for k, v in tparams.items()
             if k not in ("prefix", "body", "suffix")}
    assert not tparams.get("prefix")
    a = TSess(tcfg, outer, tpol, site_source=source)
    b = TSess(tcfg, tparams, tpol)
    assert calls == [s.gidx for s in tlm.iter_sites(tcfg)] == [0, 1]
    la, lb = packing.packed_leaves(a.params), packing.packed_leaves(b.params)
    assert len(la) == len(lb) == len(tlm.enumerate_qlayers(tcfg)) == 14
    for pa, pb in zip(la, lb):
        assert torch.equal(pa.codes, pb.codes)
        assert torch.equal(pa.scale, pb.scale)
        assert torch.equal(pa.s_a, pb.s_a)
    assert a.packed_bytes() == b.packed_bytes()
    toks = torch.from_numpy(_prompt(tcfg, LONG, 6))[None]
    assert torch.equal(a.prefill(a.params, toks, prefill_cap=96)[0],
                       b.prefill(b.params, toks, prefill_cap=96)[0])


# ---------------------------------------------------------------------------
# what a windowed arch refuses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("what", ["paged", "speculate"])
def test_pages_and_speculation_refused_with_the_references_message(world,
                                                                   what):
    """Pages and speculation refuse the windowed arch with the reference's
    own messages, in the port's checks, its engine and the serve CLI; the
    JAX engine is handed a stand-in adapter that offers what each path
    needs, so it reaches its window check without packing a session."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    if what == "paged":
        jecfg = jeng.EngineConfig(kv_quant="int8", kv_layout="paged")
        stand_in = types.SimpleNamespace(kv_quant="int8", append=None)
        tecfg = teng.EngineConfig(kv_quant="int8", kv_layout="paged")
        check = lambda: teng.check_kv_layout(tcfg, "paged")  # noqa: E731
        argv = ["--kv-layout", "paged"]
    else:
        jecfg = jeng.EngineConfig(kv_quant="int8", speculate=2)
        stand_in = types.SimpleNamespace(kv_quant="int8", verify=None,
                                         draft_params={})
        tecfg = teng.EngineConfig(kv_quant="int8", speculate=2)
        check = lambda: teng.check_speculate(tcfg, 2)  # noqa: E731
        argv = ["--speculate", "2"]
    with pytest.raises(ValueError, match="sliding-window") as j_err:
        jeng.DecodeEngine(world["jparams"], jcfg, None, None,
                          adapter=stand_in, ecfg=jecfg)
    with pytest.raises(ValueError) as t_err:
        check()
    assert str(t_err.value) == str(j_err.value)
    ts = TSess(tcfg, world["tparams"], world["tpol"])
    with pytest.raises(ValueError) as e_err:
        teng.DecodeEngine(ts.params, tcfg, None, ts.ctx, adapter=ts,
                          device="cpu", ecfg=tecfg)
    assert str(e_err.value) == str(j_err.value)
    with pytest.raises(SystemExit, match="sliding-window"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"] + argv)
    teng.check_kv_layout(tcfg, "ring")
    teng.check_speculate(tcfg, 0)
