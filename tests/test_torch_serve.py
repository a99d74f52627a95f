"""The serving slice end to end, port against the JAX reference, on the CPU.

Config: Qwen3-0.6B's smoke config with head_dim 48, which keeps q_dim (192)
!= d_model (128), per-head qk-norm and tied embeddings. JAX's own
``lm.init_params`` weights cross over through ``repro_torch.interop`` (the
two PRNGs differ, so nothing is re-initialised).

Across frameworks the float32 matmuls and reductions sum in another order,
and a quantization grid can turn an ulp into a code step, so logits are
held to a stated tolerance and greedy tokens to equality on decisive rows
(top-2 margin above 1e-2). Inside the port, the packed dequant-fp route
and the fake-quant graph are the same op chain: held bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.launch.scheduler import Request as JRequest       # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.runtime.session import QuantizedSession as JSess  # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch.scheduler import Request as TRequest  # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.runtime.session import QuantizedSession as TSess  # noqa: E402

# logits of one forward, JAX vs port: |diff| <= LOGIT_ATOL + LOGIT_RTOL*|ref|.
# Measured here: |diff| < 1e-6 at |logit| ~ 6 (float32 summation order); the
# bound leaves room for that, not for a wrong op or a flipped weight code.
LOGIT_ATOL, LOGIT_RTOL = 2e-4, 1e-4
DECISIVE = 1e-2


@pytest.fixture(scope="module")
def world():
    jcfg = j_smoke("qwen3-0.6b").scaled(head_dim=48)
    tcfg = t_smoke("qwen3-0.6b").scaled(head_dim=48)
    assert tcfg.q_dim != tcfg.d_model and tcfg.qk_norm and tcfg.tie_embeddings
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    return jcfg, tcfg, jparams, tparams, jpol, tpol


@pytest.fixture(scope="module")
def jsess(world):
    jcfg, _, jparams, _, jpol, _ = world
    return JSess(jcfg, jparams, jpol)


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n).astype(np.int32)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def _decisive_argmax_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    top2 = np.sort(b, axis=-1)[:, -2:]
    dec = top2[:, 1] - top2[:, 0] > DECISIVE
    np.testing.assert_array_equal(a.argmax(-1)[dec], b.argmax(-1)[dec])
    return int(dec.sum())


def test_interop_carries_the_param_tree(world):
    jcfg, tcfg, jparams, tparams, _, _ = world
    flat = jckpt._flatten(jparams)
    assert tparams["body"]["0"]["wq"]["w"].shape == (tcfg.n_layers, 128, 192)
    for key, arr in flat.items():
        node = tparams
        for k in key.split("/"):
            node = node[k]
        np.testing.assert_array_equal(node.numpy(), arr)
    # the port's own init lays out the same tree, key for key and shape for
    # shape (its values differ: another PRNG)
    own = jckpt._flatten(jax.tree.map(np.asarray, jparams))
    mine = tlm.init_params(tcfg, seed=0)
    for key, arr in own.items():
        node = mine
        for k in key.split("/"):
            node = node[k]
        assert tuple(node.shape) == arr.shape, key


def test_session_prefill_and_decode_match_jax(world, jsess):
    jcfg, tcfg, jparams, tparams, jpol, tpol = world
    js = jsess
    ts = TSess(tcfg, tparams, tpol)
    assert ts.packed_bytes() == js.packed_bytes()
    toks = _prompt(jcfg, 13, 0)
    cap = 20
    j_prefill = jax.jit(lambda p, t: js.prefill(p, {"tokens": t},
                                                prefill_cap=cap))
    j_decode = jax.jit(js.decode)
    jl, jst = j_prefill(js.params, jnp.asarray(toks)[None])
    tl, tst = ts.prefill(ts.params, torch.from_numpy(toks)[None],
                         prefill_cap=cap)
    _close(tl, jl)
    n_dec = _decisive_argmax_equal(tl, jl)
    jst, tst = js.state_per_slot(jst), ts.state_per_slot(tst)
    tok = int(np.asarray(jl).argmax())
    for step in range(3):
        pos = 13 + step
        jl, jst = j_decode(js.params, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray([pos], jnp.int32), jst)
        tl, tst = ts.decode(ts.params, torch.tensor([[tok]], dtype=torch.int32),
                            torch.tensor([pos], dtype=torch.int32), tst)
        _close(tl, jl)
        n_dec += _decisive_argmax_equal(tl, jl)
        tok = int(np.asarray(jl).argmax())
    assert n_dec >= 2


def test_packed_dequant_route_bitwise_equals_fake_quant_graph(world):
    """Inside the port: the packed session (dequant-fp on the CPU, int8 KV)
    and the fake-quant graph (quantize-dequantize KV) give identical
    logits, prefill and decode."""
    _, tcfg, _, tparams, _, tpol = world
    ts = TSess(tcfg, tparams, tpol)
    bits = tlm.bits_from_policy(tcfg, tpol)
    ctx = tserve.make_context(tcfg)
    ref_ctx = dataclasses.replace(ctx, kv_quant="fake")
    toks = torch.from_numpy(_prompt(tcfg, 9, 1))[None]
    pl, ps = ts.prefill(ts.params, toks, prefill_cap=16)
    rl, rs = tlm.apply_prefill(tparams, tcfg, toks, bits, ref_ctx,
                               prefill_cap=16)
    assert torch.equal(pl, rl)
    ps, rs = tlm.decode_state_per_slot(ps), tlm.decode_state_per_slot(rs)
    tok = torch.argmax(pl, -1)[:, None].to(torch.int32)
    for p in (9, 10):
        pos = torch.tensor([p], dtype=torch.int32)
        pl, ps = ts.decode(ts.params, tok, pos, ps)
        rl, rs = tlm.apply_decode(tparams, tcfg, tok, pos, rs, bits, ref_ctx)
        assert torch.equal(pl, rl)
        tok = torch.argmax(pl, -1)[:, None].to(torch.int32)


def test_engine_matches_jax_engine(world, jsess):
    """Same requests, same explicit prefill chunk: the same decode-step
    count, and the same greedy tokens on every decisive step."""
    jcfg, tcfg, jparams, tparams, jpol, tpol = world
    gens = [6, 3, 5, 2]
    prompts = [_prompt(jcfg, 10, 10 + i) for i in range(4)]
    js = jsess
    jecfg = jeng.EngineConfig(slots=2, cache_len=16, prefill_chunk=10,
                              kv_quant="int8", trace=False)
    je = jeng.DecodeEngine(js.params, jcfg, None, js.ctx, ecfg=jecfg,
                           adapter=js)
    je.submit_all([JRequest(i, p, g) for i, (p, g) in
                   enumerate(zip(prompts, gens))])
    jout = je.run()
    ts, te, tout = tserve.serve_quantized(
        tcfg, tparams, tpol,
        [TRequest(i, p, g) for i, (p, g) in enumerate(zip(prompts, gens))],
        slots=2, cache_len=16, prefill_chunk=10, device="cpu")
    assert te.stats.decode_steps == je.stats.decode_steps
    assert te.stats.slot_steps == je.stats.slot_steps
    compared = 0
    for rid, c in tout.items():
        assert len(c.tokens) == len(jout[rid].tokens) == gens[rid]
        n, miss = teng.decisive_prefix(jout[rid].tokens, c.tokens,
                                       te.margins[rid], DECISIVE)
        assert miss is None, (rid, jout[rid].tokens, c.tokens)
        compared += n
    assert compared >= len(gens)


def test_jax_written_policy_loads_with_the_same_bits(tmp_path):
    path = str(tmp_path / "demo.json")
    jpol = jserve.write_demo_policy(path, "qwen3-0.6b", smoke=True)
    tpol = TPolicy.load(path)
    assert tpol.w_bits == jpol.w_bits and tpol.a_bits == jpol.a_bits
    jcfg, tcfg = j_smoke("qwen3-0.6b"), t_smoke("qwen3-0.6b")
    jb = jlm.bits_from_policy(jcfg, jpol)
    tb = tlm.bits_from_policy(tcfg, tpol)
    flat_j = jckpt._flatten(jb)
    flat_t = jckpt._flatten(jax.tree.map(np.asarray, tb))
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_j[k], flat_t[k])
    own = tserve.demo_mixed_policy(tcfg)
    assert own.w_bits == jpol.w_bits and own.a_bits == jpol.a_bits


def test_serve_entry_point_refuses_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(["--smoke", "--requests", "1"])


def test_serve_cli_on_the_cpu_passes_its_token_check(capsys):
    tserve.main(["--smoke", "--device", "cpu", "--requests", "3", "--slots",
                 "2", "--prompt-len", "8", "--gen", "4", "--stagger",
                 "--check"])
    out = capsys.readouterr().out
    assert "decode_attn_route=dequant-fp" in out
    assert "greedy tokens equal the fake-quant reference" in out


def test_activation_reuse_groups_quantize_once_and_change_nothing(world):
    """A uniform policy puts wq/wk/wv (and mlp_wi/mlp_wg) of a site in one
    reuse group: their shared input quantizes once per forward, and the
    logits stay bit for bit the fake-quant graph's."""
    _, tcfg, _, tparams, _, _ = world
    pol = TPolicy.uniform(tlm.enumerate_qlayers(tcfg), 4)
    ts = TSess(tcfg, tparams, pol)
    toks = torch.from_numpy(_prompt(tcfg, 7, 3))[None]
    pl, _ = ts.prefill(ts.params, toks, prefill_cap=8)
    assert ts.act_quant_reused == 3 * tcfg.n_layers
    ref_ctx = dataclasses.replace(tserve.make_context(tcfg), kv_quant="fake")
    rl, _ = tlm.apply_prefill(tparams, tcfg, toks,
                              tlm.bits_from_policy(tcfg, pol), ref_ctx,
                              prefill_cap=8)
    assert torch.equal(pl, rl)


def test_continuous_batching_beats_fixed_with_the_same_tokens(world):
    """The scheduler's fixed policy holds every slot until its round
    drains: the same greedy tokens in strictly more decode steps."""
    _, tcfg, _, tparams, _, tpol = world
    prompts = [_prompt(tcfg, 6 + 2 * i, 20 + i) for i in range(4)]
    reqs = [TRequest(i, p, g) for i, (p, g) in
            enumerate(zip(prompts, [6, 2, 5, 3]))]
    steps, outs = {}, {}
    for policy in ("continuous", "fixed"):
        sess = TSess(tcfg, tparams, tpol)
        eng = teng.DecodeEngine(
            sess.params, tcfg, None, sess.ctx, adapter=sess,
            ecfg=teng.EngineConfig(slots=2, cache_len=16, prefill_chunk=16,
                                   policy=policy, kv_quant="int8"))
        eng.submit_all(reqs)
        outs[policy] = {r: c.tokens for r, c in eng.run().items()}
        steps[policy] = eng.stats.decode_steps
    assert outs["continuous"] == outs["fixed"]
    assert steps["continuous"] < steps["fixed"]
