"""The hybrid family's serving slice (recurrentgemma-2b: RG-LRU blocks beside
local multi-query attention), port against the JAX reference, on the CPU.

Config: recurrentgemma-2b's smoke config (d_model 128, 4 query heads on one
kv head of 32, lru_width 128, conv1d width 4, d_ff 256, vocab 512) at 5
layers, so the (rec, rec) suffix exists beside the one (rec, rec, attn)
repeat, with a 16-row local window, so prompts longer than it wrap the
ring. JAX's own ``lm.init_params`` weights cross over through
``repro_torch.interop``, after seeded numpy noise on the leaves the
reference initialises to zero (the conv and gate biases).

Tolerances. The RG-LRU scan and the causal conv1d are the reference's op
chain (the scan its odd/even combine tree): bit for bit against the
reference's functions run op by op. The block-diagonal gates are a float32
contraction whose summation order differs between XLA and PyTorch, so the
gates and the whole block are held to rtol 1e-6 with an atol of 1e-6 of
the output's scale. Whole forwards are held at ``tests/test_decode.py``'s
2e-4 (the reference compiles its layer stack, which may fuse multiplies and
adds); greedy tokens on decisive rows (top-2 margin above 1e-2). Inside the
port the packed dequant-fp route and the fake-quant graph are one op chain:
bit for bit. All tests share one module-scoped world.
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
from repro.kernels.flash_attention import flash_fwd_pallas   # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.models import recurrent as jrec                   # noqa: E402
from repro.models.quant_layers import QuantContext as JCtx   # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import get_config as t_get          # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.kernels import ops, ref                     # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch.scheduler import Request as TRequest  # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.models import recurrent as trec             # noqa: E402
from repro_torch.models.quant_layers import QuantContext as TCtx  # noqa: E402
from repro_torch.runtime import kv_cache as tkv              # noqa: E402
from repro_torch.runtime.session import QuantizedSession as TSess  # noqa: E402

LOGIT_TOL = dict(atol=2e-4, rtol=2e-4)   # tests/test_decode.py
N_LAYERS, WINDOW = 5, 16
NOISE = ("conv_b", "gate_a_b", "gate_x_b")
RG_LEAVES = ("conv_w", "conv_b", "gate_a_w", "gate_a_b", "gate_x_w",
             "gate_x_b", "lam")


def _noised(jparams, seed=7):
    """``jparams`` with N(0, 0.3) noise on the zero-initialised biases."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        if str(getattr(path[-1], "key", path[-1])) not in NOISE:
            return a
        return jnp.asarray(np.asarray(a) + 0.3 * rng.standard_normal(
            a.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(one, jparams)


def _cfg(smoke):
    return dataclasses.replace(smoke("recurrentgemma-2b"), n_layers=N_LAYERS,
                               local_window=WINDOW)


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = _cfg(j_smoke), _cfg(t_smoke)
    jparams = _noised(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    return jcfg, tcfg, jparams, tparams, jpol, tpol


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n).astype(
        np.int32)


def _close(t, j, rtol=1e-6):
    """rtol ``rtol`` with an atol of ``rtol`` of the reference's scale."""
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-30))


def _ctxs(jcfg, tcfg):
    return (JCtx.make(jcfg.bits, True, compute_dtype=jnp.float32),
            TCtx.make(tcfg.bits, True, compute_dtype=torch.float32))


# ---------------------------------------------------------------------------
# the RG-LRU pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 5, 8, 40])
@pytest.mark.parametrize("given_h0", [False, True])
def test_rglru_scan_is_the_reference_bit_for_bit(S, given_h0):
    """The odd/even combine tree of ``jax.lax.associative_scan`` (odd and
    even lengths at every level of the recursion) gives the reference's h
    bit for bit, with and without a carried h0 (the reference run op by op:
    compiled, XLA may fuse a multiply and an add)."""
    rng = np.random.default_rng(S + given_h0)
    W = 16
    a = rng.uniform(0.5, 1.0, (2, S, W)).astype(np.float32)
    bx = _f32(rng, 2, S, W)
    h0 = _f32(rng, 2, W) if given_h0 else None
    want = jrec.rglru_scan(jnp.asarray(a), jnp.asarray(bx),
                           None if h0 is None else jnp.asarray(h0))
    got = trec.rglru_scan(torch.from_numpy(a), torch.from_numpy(bx),
                          None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and it is the recurrence h_t = a_t h_{t-1} + bx_t
    h = np.zeros((2, W), np.float64) if h0 is None else h0.astype(np.float64)
    for t in range(S):
        h = a[:, t] * h + bx[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=1e-5,
                                   atol=1e-5)


def test_causal_conv1d_state_carry_bit_for_bit(world):
    """A prefill of 11 rows, then two one-row calls on the carried buffer:
    outputs and buffers the reference's bit for bit, and the split run
    equals one 13-row call."""
    _, _, jparams, tparams, _, _ = world
    jp, tp = jparams["suffix"]["0"]["rg"], tparams["suffix"]["0"]["rg"]
    u = _f32(np.random.default_rng(3), 2, 13, 128)
    j_st = t_st = None
    outs = []
    for lo, hi in ((0, 11), (11, 12), (12, 13)):
        jo, j_st = jrec._causal_conv1d(jnp.asarray(u[:, lo:hi]),
                                       jp["conv_w"], jp["conv_b"], j_st)
        to, t_st = trec._causal_conv1d(torch.from_numpy(u[:, lo:hi]),
                                       tp["conv_w"], tp["conv_b"], t_st)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(t_st.numpy(), np.asarray(j_st))
        outs.append(to)
    whole, _ = trec._causal_conv1d(torch.from_numpy(u), tp["conv_w"],
                                   tp["conv_b"], None)
    assert torch.equal(torch.cat(outs, 1), whole)


def test_block_diag_gate_matches(world):
    _, tcfg, jparams, tparams, _, _ = world
    jp, tp = jparams["suffix"]["1"]["rg"], tparams["suffix"]["1"]["rg"]
    u = _f32(np.random.default_rng(4), 2, 9, 128)
    for w, b in (("gate_a_w", "gate_a_b"), ("gate_x_w", "gate_x_b")):
        want = jrec._block_diag_gate(jnp.asarray(u), jp[w], jp[b],
                                     tcfg.n_heads)
        got = trec._block_diag_gate(torch.from_numpy(u), tp[w], tp[b],
                                    tcfg.n_heads)
        _close(got, want)


@pytest.mark.parametrize("S", [24, 1])
def test_rglru_block_prefill_then_decode(world, S):
    """The block from zero state over S rows, then two one-token decode
    steps on the carried (conv_buf, h): outputs and state within rtol 1e-6
    (the gates' float32 contraction order; the reference compiled)."""
    jcfg, tcfg, jparams, tparams, _, _ = world
    jp = jax.tree.map(lambda a: np.asarray(a[0]),
                      jparams["body"]["1"]["rg"])
    tp = tlm.site_params(tparams, tlm.iter_sites(tcfg)[1])["rg"]
    jctx, tctx = _ctxs(jcfg, tcfg)
    block = jax.jit(lambda x, st: jrec.rglru_block(x, jp, None, jctx,
                                                   tcfg.n_heads, state=st))
    rng = np.random.default_rng(S)
    jst = tst = None
    for n in (S, 1, 1):
        x = _f32(rng, 2, n, tcfg.d_model)
        jo, jst = block(jnp.asarray(x), jst)
        to, tst = trec.rglru_block(torch.from_numpy(x), tp, None, tctx,
                                   tcfg.n_heads, state=tst)
        _close(to, jo)
        for a, b in zip(tst, jst):
            _close(a, b)


# ---------------------------------------------------------------------------
# schedule, qlayers, params
# ---------------------------------------------------------------------------
def test_schedule_qlayers_and_policy_match_jax(world):
    jcfg, tcfg, _, _, jpol, tpol = world
    full = tlm.build_schedule(t_get("recurrentgemma-2b"))
    assert tuple(full) == tuple(jlm.build_schedule(j_get("recurrentgemma-2b")))
    assert (full.prefix, full.pattern, full.repeats, full.suffix) == (
        (), ("rec", "rec", "attn"), 8, ("rec", "rec"))
    assert tuple(tlm.build_schedule(tcfg)) == tuple(jlm.build_schedule(jcfg))
    assert [s.kind for s in tlm.iter_sites(tcfg)] == \
        ["rec", "rec", "attn", "rec", "rec"]
    jq, tq = jlm.enumerate_qlayers(jcfg), tlm.enumerate_qlayers(tcfg)
    assert [(q.name, q.path, q.in_dim, q.out_dim, q.kind) for q in tq] == \
        [(q.name, q.path, q.in_dim, q.out_dim, q.kind) for q in jq]
    assert tpol.size_bytes(tq) == jpol.size_bytes(jq)
    own = tserve.demo_mixed_policy(tcfg)
    assert own.w_bits == jpol.w_bits and own.a_bits == jpol.a_bits
    assert len(tlm.enumerate_qlayers(t_get("recurrentgemma-2b"))) == 164
    assert tlm.attn_window(tcfg) == WINDOW
    for name in ("mixtral-8x7b", "deepseek-moe-16b", "llama-3.2-vision-11b"):
        assert tuple(tlm.build_schedule(t_get(name))) == \
            tuple(jlm.build_schedule(j_get(name)))


def test_interop_carries_every_rg_array(world):
    """Every reference array crosses unchanged, the RG-LRU leaves of the
    stacked body and of both suffix layers among them; the port's own init
    lays out the same tree, key for key and shape for shape."""
    _, tcfg, jparams, tparams, _, _ = world
    flat = jckpt._flatten(jparams)
    want = {f"{seg}/{i}/rg/{leaf}" for seg, idx in (("body", "01"),
                                                    ("suffix", "01"))
            for i in idx for leaf in RG_LEAVES + ("wx/w", "wgate/s_w",
                                                  "wo/s_a")}
    assert want <= set(flat)
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
# the whole forward, unquantized
# ---------------------------------------------------------------------------
def test_train_logits_match_jax(world):
    jcfg, tcfg, jparams, tparams, _, _ = world
    jctx, tctx = _ctxs(jcfg, tcfg)
    toks = np.stack([_prompt(tcfg, 40, 1), _prompt(tcfg, 40, 2)])
    jl, _ = jax.jit(lambda p, t: jlm.apply_train(
        p, jcfg, {"tokens": t}, None, jctx, NO_AXES, remat=False))(
        jparams, jnp.asarray(toks))
    tl, _ = tlm.apply_train(tparams, tcfg, {"tokens": toks}, None, tctx,
                            remat=False)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               **LOGIT_TOL)


def test_prefill_and_decode_logits_match_jax(world):
    """A prefill longer than the window, then 6 greedy decode steps (JAX's
    tokens fed to both, the ring wrapping), unquantized: logits within
    2e-4 at every step, the recurrent state carried through the suffix."""
    jcfg, tcfg, jparams, tparams, _, _ = world
    jctx, tctx = _ctxs(jcfg, tcfg)
    prompt_len = 24
    toks = np.stack([_prompt(tcfg, prompt_len, 1),
                     _prompt(tcfg, prompt_len, 2)])
    jl, jst = jax.jit(lambda p, t: jlm.apply_prefill(
        p, jcfg, {"tokens": t}, None, jctx, NO_AXES, prefill_cap=64))(
        jparams, jnp.asarray(toks))
    tl, tst = tlm.apply_prefill(tparams, tcfg, torch.from_numpy(toks), None,
                                tctx, prefill_cap=64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    j_decode = jax.jit(lambda p, t, pos, st: jlm.apply_decode(
        p, jcfg, t, pos, st, None, jctx, NO_AXES))
    for t in range(6):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        pos = prompt_len + t
        jl, jst = j_decode(jparams, jnp.asarray(tok),
                           jnp.asarray(pos, jnp.int32), jst)
        tl, tst = tlm.apply_decode(tparams, tcfg, torch.from_numpy(tok),
                                   pos, tst, None, tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the packed session and the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prompt_len", [24, 9])
def test_packed_route_bitwise_equals_fake_quant_graph(world, prompt_len):
    """Inside the port: the packed session (dequant-fp on the CPU) and the
    fake-quant graph give identical logits and state, prefill (a prompt
    past the window, and one inside it) and decode."""
    _, tcfg, _, tparams, _, tpol = world
    ts = TSess(tcfg, tparams, tpol)
    assert all(isinstance(ts.params["sites"][tlm.site_key(s.gidx)]["rg"][p],
                          type(ts.params["sites"]["000"]["mlp_wi"]))
               for s in tlm.iter_sites(tcfg) if s.kind == "rec"
               for p in trec.RGLRU_QLAYER_PATHS)
    bits = tlm.bits_from_policy(tcfg, tpol)
    ref_ctx = dataclasses.replace(tserve.make_context(tcfg), kv_quant="fake")
    toks = torch.from_numpy(_prompt(tcfg, prompt_len, 1))[None]
    pl, ps = ts.prefill(ts.params, toks, prefill_cap=32)
    rl, rs = tlm.apply_prefill(tparams, tcfg, toks, bits, ref_ctx,
                               prefill_cap=32)
    assert torch.equal(pl, rl)
    ps, rs = ts.state_per_slot(ps), tlm.decode_state_per_slot(rs)
    tok = torch.argmax(pl, -1)[:, None].to(torch.int32)
    for p in (prompt_len, prompt_len + 1):
        pos = torch.tensor([p], dtype=torch.int32)
        pl, ps = ts.decode(ts.params, tok, pos, ps)
        rl, rs = tlm.apply_decode(tparams, tcfg, tok, pos, rs, bits, ref_ctx)
        assert torch.equal(pl, rl)
        tok = torch.argmax(pl, -1)[:, None].to(torch.int32)
    for s in tlm.iter_sites(tcfg):
        if s.kind == "rec":
            key = tlm.site_key(s.gidx)
            for a, b in zip(ps["sites"][key], rs["sites"][key]):
                assert torch.equal(a, b)


def test_rec_site_state_passes_through_the_cache_helpers(world):
    _, tcfg, _, _, _, _ = world
    st = tlm.init_decode_state(tcfg, 3, 40, per_slot=True, kv_quant="int8",
                               rec_dtype=torch.float64)
    rec = st["sites"][tlm.site_key(0)]
    assert [tuple(t.shape) for t in rec] == [(3, 3, 128), (3, 128)]
    assert all(t.dtype == torch.float64 for t in rec)
    assert tlm.init_site_state(tcfg, "rec", 1, 8, dtype=torch.bfloat16)[1]\
        .dtype == torch.float32            # h: float32 or wider
    attn = st["sites"][tlm.site_key(2)]
    assert attn.k.shape[1] == WINDOW       # the ring holds the window
    for out in (tlm.trim_decode_state(st, 5), tlm.decode_state_per_slot(st)):
        for s in tlm.iter_sites(tcfg):
            if s.kind == "rec":
                key = tlm.site_key(s.gidx)
                assert all(a is b for a, b in zip(out["sites"][key],
                                                  st["sites"][key]))
    assert tkv.tree_inventory(st)["codes"] == 2 * 3 * WINDOW * 32


LENS, GENS = [24, 24, 24], [6, 4, 5]


def _requests(cls, cfg, lens=LENS, gens=GENS):
    return [cls(i, _prompt(cfg, n, 40 + i), g)
            for i, (n, g) in enumerate(zip(lens, gens))]


def test_engine_matches_fake_quant_reference(world):
    """Three requests on two slots (the third reuses a slot; prompts past
    the 16-row window, and the ring wrapping in decode): the served tokens
    equal the port's fake-quant reference engine's on decisive steps, with
    its float64 control. That graph is the JAX package's to 2e-4
    (``test_prefill_and_decode_logits_match_jax``), and the packed route
    is that graph bit for bit (``test_packed_route_bitwise_equals_fake_
    quant_graph``)."""
    _, tcfg, _, tparams, _, tpol = world
    kw = dict(slots=2, cache_len=32, prefill_chunk=64, device="cpu")
    tsess, teng_, tout = tserve.serve_quantized(
        tcfg, tparams, tpol, _requests(TRequest, tcfg), **kw)
    assert teng_.stats.admitted == len(LENS) > kw["slots"]
    assert [len(tout[i].tokens) for i in range(len(LENS))] == GENS
    n, bad, _ = tserve.check_greedy(tcfg, tparams, tpol,
                                    _requests(TRequest, tcfg), tout, **kw)
    assert not bad and n >= len(LENS)


def test_layouts_and_speculation_refuse_the_hybrid_family(world):
    """The reference's refusals, in both packages: pages refuse a windowed
    arch, speculation a schedule with recurrent sites; the CLI exits with
    the same messages. The JAX engine is handed a stand-in adapter that
    offers int8 pages and ``append``, so it reaches its window check
    without packing a session."""
    jcfg, tcfg, jparams, tparams, jpol, tpol = world
    with pytest.raises(ValueError, match="sliding-window"):
        teng.check_kv_layout(tcfg, "paged")
    teng.check_kv_layout(tcfg, "ring")
    ts = TSess(tcfg, tparams, tpol)
    with pytest.raises(ValueError, match="sliding-window"):
        teng.DecodeEngine(ts.params, tcfg, None, ts.ctx, adapter=ts,
                          device="cpu",
                          ecfg=teng.EngineConfig(kv_quant="int8",
                                                 kv_layout="paged"))
    pager = types.SimpleNamespace(kv_quant="int8", append=None)
    with pytest.raises(ValueError, match="sliding-window"):
        jeng.DecodeEngine(jparams, jcfg, None, None, adapter=pager,
                          ecfg=jeng.EngineConfig(kv_quant="int8",
                                                 kv_layout="paged"))
    with pytest.raises(ValueError, match="attention-only"):
        teng.check_speculate(tcfg, 2)
    with pytest.raises(SystemExit, match="sliding-window"):
        tserve.main(["--arch", "recurrentgemma-2b", "--smoke", "--device",
                     "cpu", "--kv-layout", "paged"])
    with pytest.raises(SystemExit, match="attention-only"):
        tserve.main(["--arch", "recurrentgemma-2b", "--smoke", "--device",
                     "cpu", "--speculate", "2"])
    # a full-attention arch still refuses a request past its cache; the
    # windowed one takes it (its ring wraps)
    eng = teng.DecodeEngine(ts.params, tcfg, None, ts.ctx, adapter=ts,
                            device="cpu",
                            ecfg=teng.EngineConfig(slots=1, cache_len=8))
    eng.submit(TRequest(0, _prompt(tcfg, 30, 0), 4))


def test_serve_cli_serves_recurrentgemma_on_the_cpu(capsys, tmp_path):
    """``serve --arch recurrentgemma-2b --smoke --device cpu --policy P``
    on a policy file the CLI wrote: it serves and passes its greedy gate."""
    pol = tmp_path / "P.json"
    tserve.main(["--arch", "recurrentgemma-2b", "--smoke",
                 "--write-demo-policy", str(pol)])
    tserve.main(["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu",
                 "--policy", str(pol), "--check", "--no-trace"])
    out = capsys.readouterr().out
    assert "greedy tokens equal the fake-quant reference on" in out
    assert "kv=int8 layout=ring" in out


# ---------------------------------------------------------------------------
# flash at head dim 256
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_flash_plain_version_at_hd_256_matches_pallas(causal, window):
    """``ops.flash_fwd`` on CPU tensors (the plain version) at
    recurrentgemma's head dim and G = 10 against ``flash_fwd_pallas`` in
    interpret mode: out to 2e-5, lse to 1e-5."""
    rng = np.random.default_rng(256 + (window or 0) + causal)
    B, S, KV, G, hd = 1, 128, 1, 10, 256
    q = (_f32(rng, B, S, KV, G, hd) * hd ** -0.5).astype(np.float32)
    k, v = _f32(rng, B, S, KV, hd), _f32(rng, B, S, KV, hd)
    kw = dict(causal=causal, window=window, q_block=64, kv_block=64)
    jo, jl = flash_fwd_pallas(*map(jnp.asarray, (q, k, v)), interpret=True,
                              **kw)
    n0 = ops.launches["flash_fwd"]
    out, lse = ops.flash_fwd(*map(torch.from_numpy, (q, k, v)), **kw)
    assert ops.launches["flash_fwd"] == n0
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    want, want_lse = ref.flash_fwd_ref(*map(torch.from_numpy, (q, k, v)),
                                       **kw)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert ops.FLASH_HEAD_DIMS == (32, 64, 80, 128, 256)
