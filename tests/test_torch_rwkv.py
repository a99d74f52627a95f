"""The RWKV6 serving slice, port against the JAX reference, on the CPU.

Config: rwkv6-7b's smoke config (2 layers, d_model 128, 2 heads of 64,
d_ff 256, vocab 512). JAX's own ``lm.init_params`` weights cross over
through ``repro_torch.interop``, after seeded numpy noise on the leaves the
reference initialises to zero or constants (``lora_B``, ``wd2``, ``mu``,
``mu_x``, ``mu_ck``, ``mu_cr``), so the data-dependent decay and the token
mixing are live on both sides.

The wkv plain versions are held to the reference's kernel contract (2e-4,
``tests/test_kernels.py``: the cumulative sums run in another order), the
mixers to 1e-5 (float32 summation order over a few hundred terms), a whole
forward to ``tests/test_decode.py``'s 2e-4. Under quantization a last-bit
difference can move an activation code, so greedy tokens are held to
equality on decisive rows (top-2 margin above 1e-2). Inside the port the
packed dequant-fp route and the fake-quant graph are one op chain: held
bit for bit.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
from repro.dist.axes import NO_AXES                          # noqa: E402
from repro.kernels import ops as jops                        # noqa: E402
from repro.kernels import ref as jref                        # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.launch.scheduler import Request as JRequest       # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.models import recurrent as jrec                   # noqa: E402
from repro.models.quant_layers import QuantContext as JCtx   # noqa: E402
from repro.runtime.session import QuantizedSession as JSess  # noqa: E402
from repro_torch import interop                              # noqa: E402
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

WKV_TOL = dict(atol=2e-4, rtol=2e-4)     # the reference's wkv_pallas contract
MIX_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=2e-4, rtol=2e-4)   # tests/test_decode.py
# served session vs JAX's, as tests/test_torch_serve.py
SESS_TOL = dict(atol=2e-4, rtol=1e-4)
DECISIVE = 1e-2
NOISE = {"lora_B": 0.1, "wd2": 0.3, "mu": None, "mu_x": None, "mu_ck": None,
         "mu_cr": None}


def _noised(jparams, seed=11):
    """``jparams`` with seeded noise on the zero-initialised mixing and
    decay leaves: N(0, s) for the loras, U(0, 1) for the lerp weights."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name not in NOISE:
            return a
        s = NOISE[name]
        noise = rng.uniform(0.0, 1.0, a.shape) if s is None \
            else rng.standard_normal(a.shape) * s
        return jnp.asarray(np.asarray(a) + noise.astype(np.float32))

    return jax.tree_util.tree_map_with_path(one, jparams)


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = j_smoke("rwkv6-7b"), t_smoke("rwkv6-7b")
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.rwkv_head_dim) \
        == (2, 128, 2, 64)
    jparams = _noised(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    return jcfg, tcfg, jparams, tparams, jpol, tpol


@pytest.fixture(scope="module")
def jsess(world):
    jcfg, _, jparams, _, jpol, _ = world
    return JSess(jcfg, jparams, jpol)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _wkv_inputs(seed, B, S, H, hd):
    rng = np.random.default_rng(seed)
    r, k, v = (_f32(rng, B, S, H, hd) for _ in range(3))
    lw = -rng.uniform(0.01, 2.0, (B, S, H, hd)).astype(np.float32)
    u = (_f32(rng, H, hd) * 0.5).astype(np.float32)
    return r, k, v, lw, u


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n).astype(np.int32)


def _decisive_argmax_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    top2 = np.sort(b, axis=-1)[:, -2:]
    dec = top2[:, 1] - top2[:, 0] > DECISIVE
    np.testing.assert_array_equal(a.argmax(-1)[dec], b.argmax(-1)[dec])
    return int(dec.sum())


def _layer(tree, unit=0):
    """Unit ``unit`` of a stacked JAX layer tree."""
    return jax.tree.map(lambda a: a[unit], tree)


# ---------------------------------------------------------------------------
# wkv plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bshd", [(2, 64, 2, 8), (1, 96, 4, 16),
                                  (3, 32, 1, 32)])
@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv_plain_versions_match_the_pallas_kernel(bshd, chunk):
    """``ops.wkv`` on CPU tensors (the chunked plain version) and the
    step-by-step ``ref.wkv_ref`` against JAX ``ops.wkv`` (``wkv_pallas``
    in interpret mode) and its oracle, at the reference test's shapes."""
    args = _wkv_inputs(sum(bshd) + chunk, *bshd)
    want = np.asarray(jops.wkv(*map(jnp.asarray, args), chunk=chunk))
    np.testing.assert_allclose(np.asarray(jref.wkv_ref(*map(jnp.asarray,
                                                            args))),
                               want, **WKV_TOL)
    n0 = ops.launches["wkv"]
    y, state = ops.wkv(*map(torch.from_numpy, args), chunk=chunk)
    assert ops.launches["wkv"] == n0        # CPU tensors launch nothing
    np.testing.assert_allclose(y.numpy(), want, **WKV_TOL)
    np.testing.assert_allclose(ref.wkv_ref(*map(torch.from_numpy, args))
                               .numpy(), want, **WKV_TOL)
    # the final state is the step-by-step recurrence's
    B, _, H, hd = bshd
    _, s_step = ref.wkv_scan_ref(*map(torch.from_numpy, args),
                                 torch.zeros((B, H, hd, hd)))
    np.testing.assert_allclose(state.numpy(), s_step.numpy(), **WKV_TOL)


def test_wkv_strong_decay_stays_finite():
    r, k, v, _, _ = _wkv_inputs(3, 1, 32, 2, 8)
    lw = np.full(r.shape, -8.0, np.float32)
    u = np.zeros((2, 8), np.float32)
    args = (r, k, v, lw, u)
    y, state = ops.wkv(*map(torch.from_numpy, args), chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    want = np.asarray(jops.wkv(*map(jnp.asarray, args), chunk=16))
    np.testing.assert_allclose(y.numpy(), want, **WKV_TOL)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_wkv_chunked_from_a_given_state_matches_jax(chunk):
    """The chunked plain version from a non-zero state: y and the final
    state against JAX ``wkv_chunked``, at ``tests/test_recurrent.py``'s
    shapes (B=2, S=64, H=2, hd=8, log-decay in -[0.02, 3], state x 0.3)."""
    rng = np.random.default_rng(chunk)
    r, k, v = (_f32(rng, 2, 64, 2, 8) for _ in range(3))
    lw = -rng.uniform(0.02, 3.0, (2, 64, 2, 8)).astype(np.float32)
    u = _f32(rng, 2, 8) * 0.5
    s0 = _f32(rng, 2, 2, 8, 8) * 0.3
    jy, js = jrec.wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u, s0)),
                              chunk=chunk)
    ty, ts = ref.wkv_chunked_ref(*map(torch.from_numpy, (r, k, v, lw, u, s0)),
                                 chunk=chunk)
    # 1e-5 of the output's scale: the two cumulative sums of 64 float32
    # steps part by up to 1.3e-5 on elements of ~0.3 (measured)
    for t, j in ((ty, jy), (ts, js)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                   atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("n_chunks", [1, 2, 8])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv_chunk_parallel_mirror_matches(chunk, hd, n_chunks):
    """``ref.wkv_chunkpar_ref``, the CUDA kernel's decomposition (chunks on
    their own with the pair exponent factored across sub-chunks, then the
    carry over chunk states), against the chunked plain version and JAX to
    the 2e-4 contract, y and the final state: from zero state (JAX
    ``wkv_pallas`` in interpret mode) and from a given one (JAX
    ``wkv_chunked``), at log-decays in -[0.01, 2], at log w = -8 and at
    log w = -40 (where e^{-L} alone would overflow within 3 rows)."""
    B, H = 1, 2
    S = chunk * n_chunks
    r, k, v, lw, u = _wkv_inputs(chunk + hd + n_chunks, B, S, H, hd)
    s0 = _f32(np.random.default_rng(hd), B, H, hd, hd) * 0.3
    for lw_ in (lw, np.full_like(lw, -8.0), np.full_like(lw, -40.0)):
        for st in (None, s0):
            args = (r, k, v, lw_, u)
            t_args = [torch.from_numpy(a) for a in args]
            t_s0 = None if st is None else torch.from_numpy(st)
            y, state = ref.wkv_chunkpar_ref(*t_args, t_s0, chunk=chunk)
            yp, sp = ref.wkv_chunked_ref(*t_args, t_s0, chunk=chunk)
            assert torch.isfinite(y).all() and torch.isfinite(state).all()
            torch.testing.assert_close(y, yp, **WKV_TOL)
            torch.testing.assert_close(state, sp, **WKV_TOL)
            j_args = [jnp.asarray(a) for a in args]
            if st is None:
                want = np.asarray(jops.wkv(*j_args, chunk=chunk))
            else:
                want, jst = jrec.wkv_chunked(*j_args, jnp.asarray(st),
                                             chunk=chunk)
                np.testing.assert_allclose(state.numpy(), np.asarray(jst),
                                           **WKV_TOL)
                want = np.asarray(want)
            np.testing.assert_allclose(y.numpy(), want, **WKV_TOL)


def test_wkv_rejects_a_ragged_length():
    args = _wkv_inputs(0, 1, 40, 1, 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.wkv(*map(torch.from_numpy, args), chunk=16)


# ---------------------------------------------------------------------------
# mixers and the whole forward, unquantized
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [64, 24])
def test_time_and_channel_mix_match_jax(world, S):
    """Both wkv branches: S = 64 runs the chunked wkv (``ops.wkv``), S = 24
    the step-by-step scan; each from zero state and then again from the
    state the first call left."""
    jcfg, tcfg, jparams, tparams, _, _ = world
    jp = _layer(jparams["body"]["0"], 1)
    tp = tlm.site_params(tparams, tlm.iter_sites(tcfg)[1])
    jctx = JCtx.make(jcfg.bits, True, compute_dtype=jnp.float32)
    tctx = TCtx.make(tcfg.bits, True, compute_dtype=torch.float32)
    H, hd = tcfg.n_heads, tcfg.rwkv_head_dim
    x = _f32(np.random.default_rng(S), 2, S, tcfg.d_model)
    jstate = tstate = None
    for _ in range(2):
        jo, jstate = jrec.rwkv_time_mix(jnp.asarray(x), jp, None, jctx, H,
                                        hd, state=jstate)
        to, tstate = trec.rwkv_time_mix(torch.from_numpy(x), tp, None, tctx,
                                        H, hd, state=tstate)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MIX_TOL)
        for a, b in zip(tstate, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **MIX_TOL)
    jo, jxp = jrec.rwkv_channel_mix(jnp.asarray(x), jp, None, jctx,
                                    state=jstate[0])
    to, txp = trec.rwkv_channel_mix(torch.from_numpy(x), tp, None, tctx,
                                    state=tstate[0])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MIX_TOL)
    np.testing.assert_array_equal(txp.numpy(), np.asarray(jxp))


def _prefill_decode(world, jbits, tbits, prompt_len=32, steps=4):
    """Logits of a prefill and ``steps`` greedy decode steps (JAX's tokens
    fed to both), from each package's fake-quant graph."""
    jcfg, tcfg, jparams, tparams, _, _ = world
    jctx = JCtx.make(jcfg.bits, True, compute_dtype=jnp.float32)
    tctx = TCtx.make(tcfg.bits, True, compute_dtype=torch.float32)
    toks = np.stack([_prompt(tcfg, prompt_len, 1), _prompt(tcfg, prompt_len,
                                                           2)])
    jl, jst = jlm.apply_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                jbits, jctx, NO_AXES, prefill_cap=64)
    tl, tst = tlm.apply_prefill(tparams, tcfg, torch.from_numpy(toks), tbits,
                                tctx, prefill_cap=64)
    out = [(tl, jl)]
    for t in range(steps):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        pos = prompt_len + t
        jl, jst = jlm.apply_decode(jparams, jcfg, jnp.asarray(tok),
                                   jnp.asarray(pos, jnp.int32), jst, jbits,
                                   jctx, NO_AXES)
        tl, tst = tlm.apply_decode(tparams, tcfg, torch.from_numpy(tok),
                                   pos, tst, tbits, tctx)
        out.append((tl, jl))
    return out


def test_prefill_and_decode_logits_match_jax_unquantized(world):
    for tl, jl in _prefill_decode(world, None, None):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_prefill_and_decode_greedy_match_jax_quantized(world):
    jcfg, tcfg, _, _, jpol, tpol = world
    n = sum(_decisive_argmax_equal(tl, jl) for tl, jl in _prefill_decode(
        world, jlm.bits_from_policy(jcfg, jpol),
        tlm.bits_from_policy(tcfg, tpol)))
    assert n >= 4


# ---------------------------------------------------------------------------
# the packed session
# ---------------------------------------------------------------------------
def test_interop_carries_the_rwkv_tree(world):
    jcfg, tcfg, jparams, tparams, _, _ = world
    flat = jckpt._flatten(jparams)
    assert "body/0/lora_B" in flat and "body/0/cm_wv/s_w" in flat
    for key, arr in flat.items():
        node = tparams
        for k in key.split("/"):
            node = node[k]
        np.testing.assert_array_equal(node.numpy(), arr)
    # the port's own init lays out the same tree, key for key and shape for
    # shape (its values differ: another PRNG)
    mine = tlm.init_params(tcfg, seed=0)
    for key, arr in flat.items():
        node = mine
        for k in key.split("/"):
            node = node[k]
        assert tuple(node.shape) == arr.shape, key
    assert tlm.param_count(mine) == sum(a.size for a in flat.values())


def test_qlayer_table_and_policy_match_jax(world):
    jcfg, tcfg, _, _, jpol, tpol = world
    jq, tq = jlm.enumerate_qlayers(jcfg), tlm.enumerate_qlayers(tcfg)
    assert [(q.name, q.in_dim, q.out_dim, q.kind) for q in tq] == \
        [(q.name, q.in_dim, q.out_dim, q.kind) for q in jq]
    assert len(tq) == 8 * tcfg.n_layers
    assert tpol.size_bytes(tq) == jpol.size_bytes(jq)
    own = tserve.demo_mixed_policy(tcfg)
    assert own.w_bits == jpol.w_bits and own.a_bits == jpol.a_bits


def test_session_packs_jax_bytes_and_matches_its_logits(world, jsess):
    jcfg, tcfg, _, tparams, _, tpol = world
    js = jsess
    ts = TSess(tcfg, tparams, tpol)
    assert ts.packed_bytes() == js.packed_bytes()
    for site in tlm.iter_sites(tcfg):
        key = tlm.site_key(site.gidx)
        for path in trec.RWKV_QLAYER_PATHS:
            tpl = ts.params["sites"][key][path]
            jpl = js.params["sites"][key][path]
            assert (tpl.layout, tpl.w_bits, tpl.a_bits) == \
                (jpl.layout, jpl.w_bits, jpl.a_bits)
            np.testing.assert_array_equal(tpl.codes.numpy(),
                                          np.asarray(jpl.codes))
            np.testing.assert_array_equal(tpl.scale.numpy(),
                                          np.asarray(jpl.scale))
    toks = _prompt(tcfg, 32, 5)            # a multiple of the chunk
    j_decode = jax.jit(js.decode)
    jl, jst = jax.jit(lambda p, t: js.prefill(p, {"tokens": t},
                                              prefill_cap=48))(
        js.params, jnp.asarray(toks)[None])
    tl, tst = ts.prefill(ts.params, torch.from_numpy(toks)[None],
                         prefill_cap=48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SESS_TOL)
    n_dec = _decisive_argmax_equal(tl, jl)
    jst, tst = js.state_per_slot(jst), ts.state_per_slot(tst)
    tok = int(np.asarray(jl).argmax())
    for step in range(3):
        pos = 32 + step
        jl, jst = j_decode(js.params, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray([pos], jnp.int32), jst)
        tl, tst = ts.decode(ts.params, torch.tensor([[tok]],
                                                    dtype=torch.int32),
                            torch.tensor([pos], dtype=torch.int32), tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SESS_TOL)
        n_dec += _decisive_argmax_equal(tl, jl)
        tok = int(np.asarray(jl).argmax())
    assert n_dec >= 2
    assert ts.act_quant_reused == 0


def test_activation_reuse_never_hits_on_rwkv_sites(world):
    """Under a uniform policy every projection of a site shares one reuse
    tag (equal a_bits and bank scales), but wr/wk/wv/wg read four different
    mixes of the input and the channel-mix two more: the identity-keyed
    cache must not hit once, and the logits stay the fake-quant graph's bit
    for bit."""
    _, tcfg, _, tparams, _, _ = world
    pol = TPolicy.uniform(tlm.enumerate_qlayers(tcfg), 4)
    ts = TSess(tcfg, tparams, pol)
    tags = {ts.params["sites"][tlm.site_key(s.gidx)][p].a_group
            for s in tlm.iter_sites(tcfg) for p in trec.RWKV_QLAYER_PATHS}
    assert len(tags) == tcfg.n_layers and "" not in tags
    toks = torch.from_numpy(_prompt(tcfg, 32, 3))[None]
    pl, _ = ts.prefill(ts.params, toks, prefill_cap=40)
    assert ts.act_quant_reused == 0
    ref_ctx = dataclasses.replace(tserve.make_context(tcfg), kv_quant="fake")
    rl, _ = tlm.apply_prefill(tparams, tcfg, toks,
                              tlm.bits_from_policy(tcfg, pol), ref_ctx,
                              prefill_cap=40)
    assert torch.equal(pl, rl)


@pytest.mark.parametrize("prompt_len", [32, 13])
def test_packed_route_bitwise_equals_fake_quant_graph(world, prompt_len):
    """Inside the port, both wkv branches: the packed session (dequant-fp
    on the CPU) and the fake-quant graph give identical logits and state,
    prefill and decode."""
    _, tcfg, _, tparams, _, tpol = world
    ts = TSess(tcfg, tparams, tpol)
    bits = tlm.bits_from_policy(tcfg, tpol)
    ref_ctx = dataclasses.replace(tserve.make_context(tcfg), kv_quant="fake")
    toks = torch.from_numpy(_prompt(tcfg, prompt_len, 1))[None]
    pl, ps = ts.prefill(ts.params, toks, prefill_cap=48)
    rl, rs = tlm.apply_prefill(tparams, tcfg, toks, bits, ref_ctx,
                               prefill_cap=48)
    assert torch.equal(pl, rl)
    tok = torch.argmax(pl, -1)[:, None].to(torch.int32)
    for p in (prompt_len, prompt_len + 1):
        pos = torch.tensor([p], dtype=torch.int32)
        pl, ps = ts.decode(ts.params, tok, pos, ps)
        rl, rs = tlm.apply_decode(tparams, tcfg, tok, pos, rs, bits, ref_ctx)
        assert torch.equal(pl, rl)
        tok = torch.argmax(pl, -1)[:, None].to(torch.int32)
    for key in ps["sites"]:
        for a, b in zip(ps["sites"][key], rs["sites"][key]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# state plumbing
# ---------------------------------------------------------------------------
def test_recurrent_site_state_passes_through_the_cache_helpers(world):
    _, tcfg, _, _, _, _ = world
    st = tlm.init_decode_state(tcfg, 3, 40, per_slot=True,
                               rec_dtype=torch.float64)
    site = st["sites"][tlm.site_key(0)]
    D, H, hd = tcfg.d_model, tcfg.n_heads, tcfg.rwkv_head_dim
    assert [tuple(t.shape) for t in site] == [(3, 1, D), (3, H, hd, hd),
                                              (3, 1, D)]
    assert all(t.dtype == torch.float64 for t in site)
    assert tlm.init_site_state(tcfg, "rwkv", 1, 8, dtype=torch.bfloat16)[1]\
        .dtype == torch.float32           # the wkv state: float32 or wider
    for out in (tlm.trim_decode_state(st, 5),
                tlm.rollback_decode_state(st, torch.tensor([1, 2, 3])),
                tlm.decode_state_per_slot(st)):
        assert all(a is b for k in st["sites"]
                   for a, b in zip(out["sites"][k], st["sites"][k]))
    assert tkv.tree_inventory(st) == {"codes": 0, "scales": 0, "pos": 0}
    assert tkv.find_paged(st) is None


def test_engine_inserts_a_prefilled_row_into_its_slot(world):
    _, tcfg, _, tparams, _, tpol = world
    ts = TSess(tcfg, tparams, tpol)
    full = ts.init_state(3, 40, torch.float32)
    _, row = ts.prefill(ts.params, torch.from_numpy(_prompt(tcfg, 9, 4))[None],
                        prefill_cap=40)
    teng._insert(full, ts.state_per_slot(row), 1)
    for key in full["sites"]:
        for t, r in zip(full["sites"][key], row["sites"][key]):
            assert torch.equal(t[1], r[0]) and not t[0].any() \
                and not t[2].any()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _requests(cls, cfg, lens, gens):
    return [cls(i, _prompt(cfg, n, 40 + i), g)
            for i, (n, g) in enumerate(zip(lens, gens))]


LENS, GENS = [32, 20, 64, 13, 32], [6, 4, 5, 3, 4]


def test_engine_matches_fake_quant_reference_and_jax_engine(world, jsess):
    """Five requests on two slots (slots reused by later requests; prompts
    of 32 and 64 take the chunked wkv, 13 and 20 the scan): the served
    tokens equal the port's fake-quant reference engine's on decisive steps
    (with its float64 control), and JAX's engine on decisive steps, in the
    same number of decode steps."""
    jcfg, tcfg, _, tparams, jpol, tpol = world
    kw = dict(slots=2, cache_len=72, prefill_chunk=64, device="cpu")
    tsess, teng_, tout = tserve.serve_quantized(
        tcfg, tparams, tpol, _requests(TRequest, tcfg, LENS, GENS), **kw)
    assert teng_.stats.act_quant_reused == 0
    assert teng_.stats.admitted == len(LENS) > kw["slots"]
    n, bad, _ = tserve.check_greedy(tcfg, tparams, tpol,
                                    _requests(TRequest, tcfg, LENS, GENS),
                                    tout, **kw)
    assert not bad and n >= len(LENS)
    js = jsess
    je = jeng.DecodeEngine(js.params, jcfg, None, js.ctx, adapter=js,
                           ecfg=jeng.EngineConfig(slots=2, cache_len=72,
                                                  prefill_chunk=64,
                                                  kv_quant="int8",
                                                  trace=False))
    je.submit_all(_requests(JRequest, jcfg, LENS, GENS))
    jout = je.run()
    assert teng_.stats.decode_steps == je.stats.decode_steps
    compared = 0
    for rid, c in tout.items():
        assert len(c.tokens) == len(jout[rid].tokens) == GENS[rid]
        n, miss = teng.decisive_prefix(jout[rid].tokens, c.tokens,
                                       teng_.margins[rid], DECISIVE)
        assert miss is None, (rid, jout[rid].tokens, c.tokens)
        compared += n
    assert compared >= len(LENS)


def test_speculation_and_paged_layout_refuse_rwkv(world):
    _, tcfg, _, tparams, _, tpol = world
    with pytest.raises(ValueError, match="attention-only"):
        teng.check_speculate(tcfg, 2)
    with pytest.raises(ValueError, match="attention-only"):
        tserve.check_spec(tcfg, 2, 2)
    teng.check_speculate(tcfg, 0)
    with pytest.raises(NotImplementedError, match="later slice"):
        teng.check_kv_layout(tcfg, "paged")
    teng.check_kv_layout(tcfg, "ring")
    sess = TSess(tcfg, tparams, tpol)
    with pytest.raises(NotImplementedError, match="later slice") as e:
        teng.DecodeEngine(sess.params, tcfg, None, sess.ctx, adapter=sess,
                          ecfg=teng.EngineConfig(kv_quant="int8",
                                                 kv_layout="paged"))
    with pytest.raises(SystemExit, match=re.escape(str(e.value))):
        tserve.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                     "--kv-layout", "paged"])
    with pytest.raises(SystemExit, match="attention-only"):
        tserve.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                     "--speculate", "2"])


def test_serve_cli_serves_rwkv_on_the_cpu(capsys, tmp_path):
    """The CLI on a policy file the reference wrote for this config."""
    path = str(tmp_path / "rwkv.json")
    jserve.write_demo_policy(path, "rwkv6-7b", smoke=True)
    tserve.main(["--arch", "rwkv6-7b", "--smoke", "--policy", path,
                 "--device", "cpu", "--requests", "3", "--slots", "2",
                 "--prompt-len", "32", "--gen", "4", "--stagger", "--check"])
    out = capsys.readouterr().out
    assert "act_quant_reused=0" in out
    assert "greedy tokens equal the fake-quant reference" in out

