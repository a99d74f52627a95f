"""The vision family's serving slice (llama-3.2-vision-11b: self-attention
layers with a gated cross-attention layer after every fifth, its queries
over the image's patch embeddings), port against the JAX reference, on the
CPU.

Config: the arch's smoke config (d_model 128, 4 query heads over 2 kv heads
of 32, d_ff 256, vocab 512, 16 image tokens of 1280 features): one unit of
the pattern, 5 self-attention layers then a cross layer, 6 sites. JAX's own
``lm.init_params`` weights cross over through ``repro_torch.interop``. The
reference initialises the cross layers' ``gate_attn`` and ``gate_mlp`` to
zero, and tanh(0) = 0 makes a fresh model's tokens independent of the
image, so every comparison sets both gates to 0.5 in the params both
packages take; a wrong cross branch then moves the logits.

Tolerances. Across frameworks the float32 matmuls and reductions sum in
another order, and a quantization grid can turn an ulp into a code step:
the unquantized attention and layer are held to rtol 1e-5 (with an atol of
1e-5 of the output's scale), whole forwards to ``tests/test_torch_serve.py``'s
atol 2e-4 / rtol 1e-4, and greedy tokens to equality on decisive rows (top-2
margin above 1e-2). Inside the port the packed dequant-fp route and the
fake-quant graph are one op chain: bit for bit. One module-scoped world and
one JAX engine run are shared.
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
from repro.dist.axes import NO_AXES                          # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.launch.scheduler import Request as JRequest       # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.models.quant_layers import QuantContext as JCtx   # noqa: E402
from repro.runtime.session import QuantizedSession as JSess  # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import get_config as t_get          # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch.scheduler import Request as TRequest  # noqa: E402
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.models.quant_layers import QuantContext as TCtx  # noqa: E402
from repro_torch.runtime.session import QuantizedSession as TSess  # noqa: E402

ARCH = "llama-3.2-vision-11b"
LOGIT_ATOL, LOGIT_RTOL = 2e-4, 1e-4      # tests/test_torch_serve.py
DECISIVE = 1e-2
GATE = 0.5
GATES = ("gate_attn", "gate_mlp")
PROMPT_LEN = 10
GENS = [6, 3, 5, 2]                      # 4 requests on 2 slots


def _gated(jparams, value=GATE):
    """``jparams`` with every cross layer's gates set to ``value``."""
    def one(path, a):
        if str(getattr(path[-1], "key", path[-1])) in GATES:
            return jnp.full_like(a, value)
        return a
    return jax.tree_util.tree_map_with_path(one, jparams)


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n).astype(
        np.int32)


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jparams = _gated(jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    rng = np.random.default_rng(1280)
    imgs = [rng.standard_normal((jcfg.n_image_tokens, 1280)).astype(
        np.float32) for _ in range(2)]
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jpol=jpol, tpol=tpol, imgs=imgs)


@pytest.fixture(scope="module")
def jsess(world):
    return JSess(world["jcfg"], world["jparams"], world["jpol"])


def _requests(cls, world):
    cfg, imgs = world["tcfg"], world["imgs"]
    return [cls(i, _prompt(cfg, PROMPT_LEN, 10 + i), g,
                extra_inputs={"img": imgs[i % 2]})
            for i, g in enumerate(GENS)]


@pytest.fixture(scope="module")
def jengine_run(world, jsess):
    """The JAX engine over the int8 ring: 4 requests with 2 images on 2
    slots (slots reused across the images). Returns (stats, completions)."""
    je = jeng.DecodeEngine(jsess.params, world["jcfg"], None, jsess.ctx,
                           adapter=jsess,
                           ecfg=jeng.EngineConfig(slots=2, cache_len=16,
                                                  prefill_chunk=10,
                                                  kv_quant="int8",
                                                  trace=False))
    je.submit_all(_requests(JRequest, world))
    out = je.run()
    return je.stats, out


def _close(a, b, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _close_scaled(t, j, rtol=1e-5):
    """rtol ``rtol`` with an atol of ``rtol`` of the reference's scale."""
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-30))


def _decisive_argmax_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    top2 = np.sort(b, axis=-1)[:, -2:]
    dec = top2[:, 1] - top2[:, 0] > DECISIVE
    np.testing.assert_array_equal(a.argmax(-1)[dec], b.argmax(-1)[dec])
    return int(dec.sum())


def _leaf(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


def _flat_keys(tree, pre=""):
    if isinstance(tree, dict):
        return {k for n, v in tree.items()
                for k in _flat_keys(v, f"{pre}{n}/")}
    return {pre[:-1]}


# ---------------------------------------------------------------------------
# schedule, QLayers, policy, params
# ---------------------------------------------------------------------------
def test_full_config_schedule_qlayers_and_policy_match_jax(world):
    """At full size, with nothing allocated: the 48-site schedule, the 336
    QLayers (160 attn, 32 cross, 144 mlp), the demo policy's bits and bytes
    (5.23 GB) and the parameter count (11.53 B) are the reference's."""
    jfull, tfull = j_get(ARCH), t_get(ARCH)
    sched = tlm.build_schedule(tfull)
    assert tuple(sched) == tuple(jlm.build_schedule(jfull))
    assert (sched.prefix, sched.pattern, sched.repeats, sched.suffix) == (
        (), ("attn",) * 5 + ("cross",), 8, ())
    assert len(tlm.iter_sites(tfull)) == 48
    jq, tq = jlm.enumerate_qlayers(jfull), tlm.enumerate_qlayers(tfull)
    assert [(q.name, q.segment, q.unit, q.path, q.in_dim, q.out_dim,
             q.macs_per_token, q.w_params, q.kind) for q in tq] == \
        [(q.name, q.segment, q.unit, q.path, q.in_dim, q.out_dim,
          q.macs_per_token, q.w_params, q.kind) for q in jq]
    kinds = [q.kind for q in tq]
    assert (len(tq), kinds.count("attn"), kinds.count("cross"),
            kinds.count("mlp")) == (336, 160, 32, 144)
    jpol, tpol = jserve.demo_mixed_policy(jfull), tserve.demo_mixed_policy(
        tfull)
    assert tpol.w_bits == jpol.w_bits and tpol.a_bits == jpol.a_bits
    assert tpol.size_bytes(tq) == jpol.size_bytes(jq)
    assert round(tpol.size_bytes(tq) / 1e9, 2) == 5.23
    n_t = tlm.param_count(tlm.init_params(tfull, device="meta"))
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jfull),
                            jax.random.PRNGKey(0))
    n_j = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert n_t == n_j and round(n_t / 1e9, 2) == 11.53
    # the smoke config: one unit of the pattern
    assert [s.kind for s in tlm.iter_sites(world["tcfg"])] == \
        ["attn"] * 5 + ["cross"]


def test_interop_carries_every_array(world):
    """Every reference array crosses unchanged by key (the pinned image
    projection and the cross layers' gates among them), and the port's own
    init lays out the same tree, key for key and shape for shape, with the
    gates at zero as the reference's."""
    tcfg, tparams = world["tcfg"], world["tparams"]
    flat = jckpt._flatten(world["jparams"])
    want = {"img_proj/w", "img_proj/s_w8", "img_proj/s_a8",
            "body/5/gate_attn", "body/5/gate_mlp", "body/5/wk/w",
            "body/5/wv/s_w", "body/5/mlp_wg/s_a", "head/w"}
    assert want <= set(flat)
    assert set(flat) == _flat_keys(tparams)
    for key, arr in flat.items():
        np.testing.assert_array_equal(_leaf(tparams, key).numpy(), arr)
    mine = tlm.init_params(tcfg, seed=0)
    assert _flat_keys(mine) == set(flat)
    for key, arr in flat.items():
        assert tuple(_leaf(mine, key).shape) == arr.shape, key
    assert all(not _leaf(mine, f"body/5/{g}").any() for g in GATES)
    assert tlm.param_count(mine) == sum(a.size for a in flat.values())


# ---------------------------------------------------------------------------
# cross attention and one cross layer, unquantized
# ---------------------------------------------------------------------------
def test_cross_attention_and_one_cross_layer_match_jax(world):
    """``cross_attention`` on random q / k / v, then the cross layer (unit
    0 of body slot 5, gates 0.5) in prefill over a 7-token prompt and its
    image, and two decode steps on the state it returned: outputs and the
    image K/V within rtol 1e-5 of the reference's."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = jattn.cross_attention(*map(jnp.asarray, (q, k, v)))
    _close_scaled(tattn.cross_attention(*map(torch.from_numpy, (q, k, v))),
                  want)

    jp = jax.tree.map(lambda a: a[0], world["jparams"]["body"]["5"])
    tp = tlm.site_params(world["tparams"], tlm.iter_sites(tcfg)[5])
    jctx = JCtx.make(jcfg.bits, True, compute_dtype=jnp.float32)
    tctx = TCtx.make(tcfg.bits, True, compute_dtype=torch.float32)
    x = rng.standard_normal((2, 7, 128)).astype(np.float32)
    img_x = rng.standard_normal((2, 16, 128)).astype(np.float32)
    jx, jst, _ = jlm.apply_layer("cross", jnp.asarray(x), jp, None, jcfg,
                                 jctx, NO_AXES, mode="prefill",
                                 img_x=jnp.asarray(img_x))
    tx, tst, _ = tlm.apply_layer("cross", torch.from_numpy(x), tp, None,
                                 tcfg, tctx, mode="prefill",
                                 img_x=torch.from_numpy(img_x))
    _close_scaled(tx, jx)
    for a, b in zip(tst, jst):
        _close_scaled(a, b)
    for step in range(2):
        xd = rng.standard_normal((2, 1, 128)).astype(np.float32)
        jx, jst, _ = jlm.apply_layer("cross", jnp.asarray(xd), jp, None,
                                     jcfg, jctx, NO_AXES, mode="decode",
                                     state=jst, pos=jnp.asarray([7 + step] * 2))
        tx, tst, _ = tlm.apply_layer("cross", torch.from_numpy(xd), tp, None,
                                     tcfg, tctx, mode="decode", state=tst,
                                     pos=torch.tensor([7 + step] * 2))
        _close_scaled(tx, jx)


# ---------------------------------------------------------------------------
# the packed session and the engine against the reference's
# ---------------------------------------------------------------------------
def test_session_prefill_and_decode_match_jax(world, jsess):
    """The packed sessions of both packages, one prompt and its image:
    prefill and 3 decode steps within atol 2e-4 / rtol 1e-4, greedy
    tokens equal on decisive rows; the packed bytes are the reference's."""
    tcfg, js = world["tcfg"], jsess
    ts = TSess(tcfg, world["tparams"], world["tpol"])
    assert ts.packed_bytes() == js.packed_bytes()
    toks, img = _prompt(tcfg, 13, 0), world["imgs"][0]
    cap = 20
    jl, jst = jax.jit(lambda p, t, i: js.prefill(
        p, {"tokens": t, "img": i}, prefill_cap=cap))(
        js.params, jnp.asarray(toks)[None], jnp.asarray(img)[None])
    tl, tst = ts.prefill(ts.params, {"tokens": torch.from_numpy(toks)[None],
                                     "img": torch.from_numpy(img)[None]},
                         prefill_cap=cap)
    _close(tl, jl)
    n_dec = _decisive_argmax_equal(tl, jl)
    jst, tst = js.state_per_slot(jst), ts.state_per_slot(tst)
    j_decode = jax.jit(js.decode)
    tok = int(np.asarray(jl).argmax())
    for step in range(3):
        pos = 13 + step
        jl, jst = j_decode(js.params, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray([pos], jnp.int32), jst)
        tl, tst = ts.decode(ts.params, torch.tensor([[tok]],
                                                    dtype=torch.int32),
                            torch.tensor([pos], dtype=torch.int32), tst)
        _close(tl, jl)
        n_dec += _decisive_argmax_equal(tl, jl)
        tok = int(np.asarray(jl).argmax())
    assert n_dec >= 2


def test_engine_matches_jax_engine(world, jengine_run):
    """4 requests on 2 slots, 2 images (each slot serves both in turn) over
    the int8 ring, the same explicit prefill chunk: the same decode-step
    count, and the same greedy tokens on every decisive step."""
    jstats, jout = jengine_run
    _, te, tout = tserve.serve_quantized(
        world["tcfg"], world["tparams"], world["tpol"],
        _requests(TRequest, world), slots=2, cache_len=16, prefill_chunk=10,
        device="cpu")
    assert te.stats.decode_steps == jstats.decode_steps
    assert te.stats.slot_steps == jstats.slot_steps
    compared = 0
    for rid, c in tout.items():
        assert len(c.tokens) == len(jout[rid].tokens) == GENS[rid]
        n, miss = teng.decisive_prefix(jout[rid].tokens, c.tokens,
                                       te.margins[rid], DECISIVE)
        assert miss is None, (rid, jout[rid].tokens, c.tokens)
        compared += n
    assert compared >= len(GENS)


def test_packed_dequant_route_bitwise_equals_fake_quant_graph(world):
    """Inside the port: the packed session (dequant-fp on the CPU, int8 KV,
    the cross sites packed under the policy, ``img_proj`` pinned) and the
    fake-quant graph give identical logits and image K/V, prefill and
    decode; and the served tokens equal the port's fake-quant reference
    engine's on decisive steps, with its float64 control."""
    tcfg, tparams, tpol = world["tcfg"], world["tparams"], world["tpol"]
    ts = TSess(tcfg, tparams, tpol)
    cross = ts.params["sites"][tlm.site_key(5)]
    assert all(type(cross[k]).__name__ == "PackedLinear"
               for k in ("wq", "wk", "wv", "wo", "mlp_wi"))
    assert "w" in ts.params["img_proj"]           # pinned: not packed
    bits = tlm.bits_from_policy(tcfg, tpol)
    ref_ctx = dataclasses.replace(tserve.make_context(tcfg), kv_quant="fake")
    inputs = {"tokens": torch.from_numpy(_prompt(tcfg, 9, 1))[None],
              "img": torch.from_numpy(world["imgs"][1])[None]}
    pl, ps = ts.prefill(ts.params, inputs, prefill_cap=16)
    rl, rs = tlm.apply_prefill(tparams, tcfg, inputs, bits, ref_ctx,
                               prefill_cap=16)
    assert torch.equal(pl, rl)
    key = tlm.site_key(5)
    assert all(torch.equal(a, b) for a, b in zip(ps["sites"][key],
                                                 rs["sites"][key]))
    ps, rs = ts.state_per_slot(ps), tlm.decode_state_per_slot(rs)
    tok = torch.argmax(pl, -1)[:, None].to(torch.int32)
    for p in (9, 10):
        pos = torch.tensor([p], dtype=torch.int32)
        pl, ps = ts.decode(ts.params, tok, pos, ps)
        rl, rs = tlm.apply_decode(tparams, tcfg, tok, pos, rs, bits, ref_ctx)
        assert torch.equal(pl, rl)
        tok = torch.argmax(pl, -1)[:, None].to(torch.int32)
    kw = dict(slots=2, cache_len=16, prefill_chunk=10, device="cpu")
    reqs = _requests(TRequest, world)
    _, _, out = tserve.serve_quantized(tcfg, tparams, tpol, reqs, **kw)
    n, bad, _ = tserve.check_greedy(tcfg, tparams, tpol, reqs, out, **kw)
    assert not bad and n >= len(GENS)


@pytest.mark.parametrize("gate", [0.0, GATE])
def test_the_image_is_read_unless_the_gates_are_zero(world, gate):
    """One prompt under the two images: with the gates at 0 (the
    reference's init) prefill and decode logits are bit for bit equal,
    with the gates at 0.5 they differ."""
    tcfg = world["tcfg"]
    params = interop.params_from_numpy(
        jckpt._flatten(_gated(world["jparams"], gate)), "cpu")
    ts = TSess(tcfg, params, world["tpol"])
    toks = torch.from_numpy(_prompt(tcfg, 9, 2))[None]
    tok = torch.tensor([[3]], dtype=torch.int32)
    pos = torch.tensor([9], dtype=torch.int32)
    outs = []
    for img in world["imgs"]:
        pl, st = ts.prefill(ts.params, {"tokens": toks,
                                        "img": torch.from_numpy(img)[None]},
                            prefill_cap=16)
        dl, _ = ts.decode(ts.params, tok, pos, ts.state_per_slot(st))
        outs.append((pl, dl))
    (pa, da), (pb, db) = outs
    if gate:
        assert (pa - pb).abs().max() > 1e-3 and (da - db).abs().max() > 1e-3
    else:
        assert torch.equal(pa, pb) and torch.equal(da, db)


def test_pages_speculation_and_a_missing_image_raise(world):
    """Pages refuse a cross-attention schedule (the reference's paged
    admission drops the image), speculation refuses it with the
    reference's own message, and a prefill without the image says what it
    lacks, in the session and through the engine."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    with pytest.raises(ValueError, match="extra_inputs"):
        teng.check_kv_layout(tcfg, "paged")
    teng.check_kv_layout(tcfg, "ring")
    with pytest.raises(ValueError, match=r"attention-only schedule: "
                       r"\['cross'\] state is sequential") as t_err:
        teng.check_speculate(tcfg, 2)
    stand_in = type("Spec", (), {"kv_quant": "int8", "verify": None,
                                 "draft_params": {}})()
    with pytest.raises(ValueError) as j_err:
        jeng.DecodeEngine(world["jparams"], jcfg, None, None,
                          adapter=stand_in,
                          ecfg=jeng.EngineConfig(kv_quant="int8",
                                                 speculate=2))
    assert str(t_err.value) == str(j_err.value)
    ts = TSess(tcfg, world["tparams"], world["tpol"])
    with pytest.raises(ValueError, match="extra_inputs"):
        teng.DecodeEngine(ts.params, tcfg, None, ts.ctx, adapter=ts,
                          device="cpu",
                          ecfg=teng.EngineConfig(kv_quant="int8",
                                                 kv_layout="paged"))
    toks = torch.from_numpy(_prompt(tcfg, 5, 3))[None]
    with pytest.raises(ValueError, match="needs the image"):
        ts.prefill(ts.params, toks, prefill_cap=8)
    eng = teng.DecodeEngine(ts.params, tcfg, None, ts.ctx, adapter=ts,
                            device="cpu",
                            ecfg=teng.EngineConfig(slots=1, cache_len=8,
                                                   prefill_chunk=8,
                                                   kv_quant="int8"))
    eng.submit(TRequest(0, toks[0].numpy(), 2))
    with pytest.raises(ValueError, match="needs the image"):
        eng.run()
