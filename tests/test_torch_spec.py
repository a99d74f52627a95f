"""Self-speculative decoding in the port, on the CPU.

The verify attention's plain versions are held against the reference's
``verify_attn_quant[_paged]`` (Pallas in interpret mode) at the int8
decode-attention contract (rtol 2e-5 / atol 2e-6,
``tests/test_quant_attention.py:93``), and the batched cache writes and the
rollback against the reference's bit for bit. Everything else is held
against the port's own token-at-a-time engine, as ROADMAP section 3 says: on
this tree the reference's KV-bitwise spec test fails (its S-row verify
projections round differently from its 1-row decode ones), so the reference
is no oracle for the KV. Within the port:

* a verify pass writes the KV rows of S sequential decodes bit for bit and
  computes the same hidden states; its logits come out of one float32 GEMM
  over S rows (the tied or untied head), whose rounding may differ from
  the one-row GEMM's in the last bits (``HEAD_ATOL``);
* a rollback at any cut leaves the cache of a token-at-a-time engine that
  decoded only the accepted tokens (pos exactly, codes and scales on
  every valid row), and touches no shared page;
* the speculative engine emits the token-at-a-time engine's tokens.

The engines run ``limpq-demo``'s smoke config under the reference's spec
test policy (4/6-bit weights, 4-bit activations, ``tests/test_spec_decode
.py:34``): its greedy tokens vary and the int2 draft is often rejected, so
the rounds roll back. Cross-framework cases skip without jax.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
from repro.core.policy import MPQPolicy as JPolicy           # noqa: E402
from repro.kernels import quant_attention as jqa             # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.runtime import kv_cache as jkv                    # noqa: E402
from repro.runtime.session import SpecSession as JSpec       # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch.scheduler import Request             # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.runtime import dispatch as tdisp            # noqa: E402
from repro_torch.runtime import kv_cache as tkv              # noqa: E402
from repro_torch.runtime.session import (QuantizedSession,   # noqa: E402
                                         SpecSession)

ATTN_RTOL, ATTN_ATOL = 2e-5, 2e-6
# logits of one forward, JAX vs port (tests/test_torch_serve.py's bound)
LOGIT_ATOL, LOGIT_RTOL = 2e-4, 1e-4
# the head's float32 GEMM over S rows vs over 1 row (measured ~2e-6 here)
HEAD_ATOL = 2e-5
QUANT_FIELDS = ("k", "v", "k_scale", "v_scale")


# ---------------------------------------------------------------------------
# verify attention: plain versions vs the reference's Pallas kernels
# ---------------------------------------------------------------------------
def _paged_arrays(rng, B, P, ps, KV, hd, n_pages, written, share=2):
    """A paged cache state: page ids permuted, slots 1.. sharing slot 0's
    first ``share`` pages, a -1 hole in slot 2's table, the last slot's
    last entry unmapped, positions written up to ``written[b]``."""
    perm = list(rng.permutation(n_pages))
    table = np.full((B, P), -1, np.int32)
    for b in range(B):
        for j in range(P - (1 if b == B - 1 else 0)):
            table[b, j] = table[0, j] if (b and j < share) else perm.pop()
    if B > 2:
        table[2, share + 1] = -1
    pos = np.full((n_pages, ps), -1, np.int32)
    for b in range(B):
        for t in range(written[b]):
            pid = table[b, t // ps]
            if pid >= 0:
                pos[pid, t % ps] = t
    return dict(
        k=rng.integers(-127, 128, (n_pages, ps, KV, hd)).astype(np.int8),
        v=rng.integers(-127, 128, (n_pages, ps, KV, hd)).astype(np.int8),
        k_scale=rng.uniform(1e-3, 2e-2, (n_pages, ps, KV)).astype(np.float32),
        v_scale=rng.uniform(1e-3, 2e-2, (n_pages, ps, KV)).astype(np.float32),
        pos=pos, page_table=table)


def _ring_arrays(rng, B, Sc, KV, hd, written):
    pos = np.full((B, Sc), -1, np.int32)
    for b, n in enumerate(written):
        pos[b, :n] = np.arange(n)
    return dict(
        k=rng.integers(-127, 128, (B, Sc, KV, hd)).astype(np.int8),
        v=rng.integers(-127, 128, (B, Sc, KV, hd)).astype(np.int8),
        k_scale=rng.uniform(1e-3, 2e-2, (B, Sc, KV)).astype(np.float32),
        v_scale=rng.uniform(1e-3, 2e-2, (B, Sc, KV)).astype(np.float32),
        pos=pos)


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("S", [1, 4])
def test_plain_verify_matches_pallas_interpret(layout, window, S):
    """Query positions past a slot's written rows, a -1 (inactive) slot,
    shared and unmapped pages: the port's plain verify against the
    reference's verify (S launches of the one-token Pallas kernel in
    interpret mode), and against S calls of the port's one-token wrapper
    bit for bit. CPU tensors launch nothing."""
    B, KV, G, hd, ps, P = 4, 2, 2, 16, 4, 5
    rng = np.random.default_rng(S + (window or 0) + len(layout))
    written = [14, 9, 12, 0]
    start = np.array([13, 8, 11, -1], np.int32)
    q_pos = np.where(start[:, None] < 0, -1,
                     start[:, None] + np.arange(S, dtype=np.int32))
    q_pos = q_pos.astype(np.int32)
    q = rng.standard_normal((B, S, KV * G, hd)).astype(np.float32)
    if layout == "paged":
        a = _paged_arrays(rng, B, P, ps, KV, hd, B * P + 3, written)
        fields = ("k", "k_scale", "v", "v_scale", "pos", "page_table")
        jfn, tfn = jqa.verify_attn_quant_paged, ops.verify_attn_quant_paged
        one = ops.decode_attn_quant_paged
    else:
        a = _ring_arrays(rng, B, P * ps, KV, hd, written)
        fields = ("k", "k_scale", "v", "v_scale", "pos")
        jfn, tfn = jqa.verify_attn_quant, ops.verify_attn_quant
        one = ops.decode_attn_quant
    jo = jfn(jnp.asarray(q), *(jnp.asarray(a[f]) for f in fields),
             jnp.asarray(q_pos), window=window, interpret=True)
    t = [torch.from_numpy(a[f]) for f in fields]
    n0 = dict(ops.launches)
    to = tfn(torch.from_numpy(q), *t, torch.from_numpy(q_pos), window=window)
    assert ops.launches == n0                      # plain versions: no launch
    assert to.shape == (B, S, KV * G, hd)
    live = q_pos[:, 0] >= 0
    np.testing.assert_allclose(to.numpy()[live], np.asarray(jo)[live],
                               rtol=ATTN_RTOL, atol=ATTN_ATOL)
    for j in range(S):
        oj = one(torch.from_numpy(q[:, j:j + 1].copy()), *t,
                 torch.from_numpy(q_pos[:, j].copy()), window=window)
        assert torch.equal(to[:, j:j + 1], oj), j


def test_verify_wrappers_reject_bad_shapes():
    rng = np.random.default_rng(0)
    a = _ring_arrays(rng, 2, 8, 2, 8, [4, 4])
    t = [torch.from_numpy(a[f]) for f in ("k", "k_scale", "v", "v_scale",
                                          "pos")]
    q = torch.zeros((2, 3, 4, 8))
    with pytest.raises(ValueError, match="does not match"):
        ops.verify_attn_quant(q[:1], *t, torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="does not match"):   # S=3 one-token
        ops.decode_attn_quant(q, *t, torch.zeros((2,), dtype=torch.int32))


# ---------------------------------------------------------------------------
# cache writes and rollback, bit for bit against the reference
# ---------------------------------------------------------------------------
def _jax_cache(kind, a):
    if kind == "paged":
        return jkv.PagedKVCache(*(jnp.asarray(a[f])
                                  for f in jkv.PagedKVCache._fields))
    return jkv.QuantKVCache(*(jnp.asarray(a[f])
                              for f in jkv.QuantKVCache._fields))


def _torch_cache(kind, a):
    if kind == "paged":
        return interop.paged_cache_from_numpy(a, "cpu")
    return tkv.QuantKVCache(*(torch.from_numpy(a[f])
                              for f in tkv.QuantKVCache._fields))


def _assert_equal(jc, tc, what):
    for f in jc._fields:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)),
                                      f"{what}:{f}")


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_append_batch_and_rollback_match_jax(kind):
    """``append_batch`` of S rows per slot (a sentinel slot, a slot whose
    last rows run past capacity on the paged layout) and ``rollback`` at
    per-slot cuts, both packages from one numpy state: bit for bit."""
    B, KV, hd, ps, P, S = 3, 2, 8, 4, 4, 4
    rng = np.random.default_rng(1)
    written = [9, 5, 0]
    a = (_paged_arrays(rng, B, P, ps, KV, hd, 16, written) if kind == "paged"
         else _ring_arrays(rng, B, P * ps, KV, hd, written))
    pos = np.array([[9, 10, 11, 12], [5, 6, 7, 8], [-1] * 4], np.int32)
    if kind == "paged":
        pos[0] = [14, 15, 16, 17]                 # 16, 17 past capacity
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    jc, tc = _jax_cache(kind, a), _torch_cache(kind, a)
    jn = jc.append_batch(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    tn = tc.append_batch(torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(pos))
    if kind == "ring":
        # a sentinel slot's S writes collide on ring index 0 (pos -1 there
        # either way); the codes of that row are never read
        m = np.asarray(jn.pos) >= 0
        np.testing.assert_array_equal(tn.pos.numpy(), np.asarray(jn.pos))
        for f in QUANT_FIELDS:
            np.testing.assert_array_equal(getattr(tn, f).numpy()[m],
                                          np.asarray(getattr(jn, f))[m], f)
    else:
        _assert_equal(jn, tn, "append_batch")
    cut = np.array([11, 5, 2 ** 30], np.int32)
    _assert_equal(jn.rollback(jnp.asarray(cut)),
                  tn.rollback(torch.from_numpy(cut)), "rollback")


@pytest.mark.parametrize("kind", ["ring", "fp", "paged"])
def test_append_batch_equals_single_appends(kind):
    """One ``append_batch`` of S rows per slot leaves the cache that S
    single-row ``append`` calls leave: positions exactly, codes and scales
    (or fp rows) on every valid row."""
    B, KV, hd, ps, P, S = 3, 2, 8, 4, 4, 3
    rng = np.random.default_rng(2)
    if kind == "paged":
        cache = _torch_cache("paged", _paged_arrays(rng, B, P, ps, KV, hd, 16,
                                                    [9, 5, 0]))
    elif kind == "ring":
        cache = _torch_cache("ring", _ring_arrays(rng, B, P * ps, KV, hd,
                                                  [9, 5, 0]))
    else:
        cache = tkv.init_kv_cache(B, P * ps, KV, hd, per_slot=True)
    pos = torch.tensor([[9, 10, 11], [5, 6, 7], [-1, -1, -1]],
                       dtype=torch.int32)
    k = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    batch = cache.append_batch(k, v, pos)
    seq = cache
    for j in range(S):
        seq = seq.append(k[:, j:j + 1], v[:, j:j + 1], pos[:, j])
    if kind == "paged":
        batch, seq = batch.gather(), seq.gather()
    assert torch.equal(batch.pos, seq.pos)
    m = seq.pos >= 0
    for f in seq._fields[:-1]:
        assert torch.equal(getattr(batch, f)[m], getattr(seq, f)[m]), f


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 5), st.integers(0, 5),
       st.integers(0, 5))
def test_paged_rollback_never_touches_a_shared_page(seed, S, acc0, acc1):
    """Two slots share full prompt pages (refcount 2 in a ``PagePool``),
    each appends S rows past its prompt and rolls back at any accepted
    count: the shared pages are unchanged in every field, every row the
    rollback cleared lies on a refcount-1 page, and the positions are those
    of a cache that appended only the accepted rows
    (``test_append_batch_and_rollback_match_jax`` holds both operations
    against the reference's)."""
    ps, P, KV, hd = 4, 5, 1, 8
    rng = np.random.default_rng(seed)
    pool = tkv.PagePool(12, ps)
    prompt = [9, 11]                    # two full pages shared, then tails
    shared = pool.alloc(2)
    pool.ref(shared)                    # slot 1 maps them too
    table = np.array([shared + pool.alloc(P - 2),
                      shared + pool.alloc(P - 2)], np.int32)
    a = _paged_arrays(rng, 2, P, ps, KV, hd, 12, [0, 0])
    a["page_table"] = table
    for b, n in enumerate(prompt):
        t = np.arange(n)
        a["pos"][table[b, t // ps], t % ps] = t
    pos = np.array([np.arange(n, n + S) for n in prompt], np.int32)
    k = rng.standard_normal((2, S, KV, hd)).astype(np.float32)
    cut = np.array(prompt, np.int32) + np.minimum([acc0, acc1], S)
    tc = _torch_cache("paged", a)
    appended = tc.append_batch(torch.from_numpy(k), torch.from_numpy(k),
                               torch.from_numpy(pos))
    rolled = appended.rollback(torch.from_numpy(cut))
    shared_rows = np.isin(np.arange(12), shared)
    for f in tkv.PagedKVCache._fields[:-1]:
        assert torch.equal(getattr(rolled, f)[shared_rows],
                           getattr(tc, f)[shared_rows]), f
    cleared = (appended.pos >= 0) & (rolled.pos < 0)
    for pid in torch.nonzero(cleared)[:, 0].tolist():
        assert pool.refcount[pid] == 1, (pid, pool.refcount[pid])
    keep = np.where(pos < cut[:, None], pos, -1)
    only = tc.append_batch(torch.from_numpy(k), torch.from_numpy(k),
                           torch.from_numpy(keep))
    assert torch.equal(only.pos, rolled.pos)


# ---------------------------------------------------------------------------
# session layer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    """limpq-demo smoke, params made by the reference and carried across,
    the reference spec test's 4/6-bit target policy."""
    jcfg, tcfg = j_smoke("limpq-demo"), t_smoke("limpq-demo")
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    names = [q.name for q in tlm.enumerate_qlayers(tcfg)]
    w = {n: (4 if i % 2 else 6) for i, n in enumerate(names)}
    tpol = TPolicy(w, {n: 4 for n in names})
    jpol = JPolicy(dict(w), {n: 4 for n in names})
    sess = SpecSession(tcfg, tparams, tpol, draft_w_bits=2)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jpol=jpol, tpol=tpol, sess=sess)


def _init_state(sess, B, cap, layout):
    lay = None
    if layout == "paged":
        lay = tkv.KVCacheLayout(kind="paged", quant="int8", page_size=4)
    st0 = sess.init_state(B, cap, torch.float32, per_slot=True, layout=lay)
    if layout == "paged":
        P = lay.pages_per_slot(cap)
        perm = torch.from_numpy(np.random.default_rng(5).permutation(B * P)
                                .astype(np.int32)).reshape(B, P)
        st0 = {"sites": {k: c._replace(page_table=perm)
                         for k, c in st0["sites"].items()}}
    return st0


def _dense(cache):
    return cache.gather() if isinstance(cache, tkv.PagedKVCache) else cache


def _assert_kv_bitwise(sa, sb, what=""):
    """pos exactly, codes and scales on every valid row (paged caches
    through their dense gather)."""
    for key in sa["sites"]:
        a, b = _dense(sa["sites"][key]), _dense(sb["sites"][key])
        assert torch.equal(a.pos, b.pos), f"{what} pos {key}"
        m = a.pos >= 0
        for f in QUANT_FIELDS:
            assert torch.equal(getattr(a, f)[m], getattr(b, f)[m]), \
                f"{what} {f} {key}"


def _hidden(sess, params, tok, pos, states, mode):
    from repro_torch.models import lm
    x, _ = lm.embed_inputs(params, sess.cfg, tok, sess.ctx, sess.table)
    return sess._forward(params, x, mode, states, pos, None)


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("route", [None, "cuda-int8"])
def test_verify_bitwise_matches_sequential(world, layout, route):
    """One verify pass over S tokens: the KV rows and the hidden states of
    S one-token decodes bit for bit, on the dequant-fp route and on the
    integer-kernel route's plain versions; the logits to the head's
    float32 rounding."""
    sess, cfg = world["sess"], world["tcfg"]
    B, S = 2, 4
    st0 = _init_state(sess, B, 16, layout)
    r = np.random.default_rng(0)
    toks = torch.from_numpy(r.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    pos = torch.tensor([[0, 1, 2, 3], [3, 4, 5, 6]], dtype=torch.int32)
    with tdisp.force_route("matmul", route):
        # slot 1 first decodes three rows, so its queries see history
        _, st0 = sess.verify(sess.params, toks[:, :3],
                             torch.tensor([[-1] * 3, [0, 1, 2]],
                                          dtype=torch.int32), st0)
        st_seq, xs, ls = st0, [], []
        for j in range(S):
            x, _ = _hidden(sess, sess.params, toks[:, j:j + 1], pos[:, j],
                           st_seq, "decode")
            lj, st_seq = sess.decode(sess.params, toks[:, j:j + 1],
                                     pos[:, j], st_seq)
            xs.append(x)
            ls.append(lj)
        xv, _ = _hidden(sess, sess.params, toks, pos, st0, "verify")
        lv, st_ver = sess.verify(sess.params, toks, pos, st0)
    _assert_kv_bitwise(st_seq, st_ver, "verify")
    for j in range(S):
        assert torch.equal(xv[:, j:j + 1], xs[j]), j
        torch.testing.assert_close(lv[:, j], ls[j], rtol=0, atol=HEAD_ATOL)
    # the draft pack runs through the same adapter: another function of the
    # same weights
    ld, _ = sess.decode(sess.draft_params, toks[:, :1], pos[:, 0], st0)
    assert ld.shape == ls[0].shape and not torch.equal(ld, ls[0])


def _sequential_reference(sess, toks, pos, st0, cuts):
    """A token-at-a-time oracle: decode one token at a time, freezing slot
    b's state once it has consumed ``cuts[b]`` tokens -- the cache an
    engine that decoded only the accepted tokens holds."""
    st = st0
    for j in range(toks.shape[1]):
        _, nxt = sess.decode(sess.params, toks[:, j:j + 1], pos[:, j], st)
        keep = torch.as_tensor(np.asarray(cuts) > j)
        out = {}
        for key, new in nxt["sites"].items():
            old = st["sites"][key]
            if isinstance(new, tkv.PagedKVCache):
                # pages are pooled: a frozen slot's pages keep the old rows
                frozen = torch.zeros(new.n_pages, dtype=torch.bool)
                for b in np.flatnonzero(~keep.numpy()):
                    ids = new.page_table[b]
                    frozen[ids[ids >= 0].long()] = True
                sel = ~frozen
            else:
                sel = keep
            out[key] = new._replace(**{
                f: torch.where(sel.reshape((-1,) + (1,) * (
                    getattr(new, f).dim() - 1)), getattr(new, f),
                    getattr(old, f))
                for f in new._fields if f != "page_table"})
        st = {"sites": out}
    return st


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from([2, 3, 5]),
       st.integers(0, 5), st.integers(0, 5),
       st.sampled_from(["ring", "paged"]))
def test_rollback_any_rejection_pattern(world, seed, S, cut0, cut1, layout):
    """After a verify pass and a rollback at any per-slot cut (0: all
    rejected, S: all accepted), the cache equals the token-at-a-time
    oracle's that decoded only the accepted tokens, bit for bit (the
    reference's property, run here without its deadline)."""
    sess, cfg = world["sess"], world["tcfg"]
    cuts = np.minimum([cut0, cut1], S).astype(np.int32)
    st0 = _init_state(sess, 2, 16, layout)
    r = np.random.default_rng(seed)
    toks = torch.from_numpy(r.integers(0, cfg.vocab, (2, S)).astype(np.int32))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(2, S).contiguous()
    _, st_ver = sess.verify(sess.params, toks, pos, st0)
    rolled = tlm.rollback_decode_state(st_ver, torch.from_numpy(cuts))
    ref = _sequential_reference(sess, toks, pos, st0, cuts)
    _assert_kv_bitwise(rolled, ref, f"cuts={cuts.tolist()}")


def test_session_verify_matches_jax(world):
    """``SpecSession.verify`` of both packages on one paged state: logits
    to the serve tolerance; codes, v-scales, positions and tables bit for
    bit, k-scales to rtol 1e-6 (qk-norm-free here, but RoPE's cos/sin round
    differently in XLA and PyTorch, ``test_session_append_matches_jax``)."""
    jsess = JSpec(world["jcfg"], world["jparams"], world["jpol"],
                  draft_w_bits=2, kv_quant="int8")
    sess = world["sess"]
    jlay = jkv.KVCacheLayout(kind="paged", quant="int8", page_size=4)
    jst = jsess.init_state(2, 16, jnp.float32, per_slot=True, layout=jlay)
    tst = _init_state(sess, 2, 16, "paged")
    perm = jnp.asarray(next(iter(tst["sites"].values())).page_table.numpy())
    jst = jax.tree.map(lambda c: c._replace(page_table=perm), jst,
                       is_leaf=lambda x: isinstance(x, jkv.PagedKVCache))
    toks = np.random.default_rng(3).integers(0, 512, (2, 5)).astype(np.int32)
    pos = np.array([[0, 1, 2, 3, 4], [-1] * 5], np.int32)
    jl, jst = jax.jit(jsess.verify)(jsess.params, jnp.asarray(toks),
                                    jnp.asarray(pos), jst)
    tl, tst = sess.verify(sess.params, torch.from_numpy(toks),
                          torch.from_numpy(pos), tst)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    for key, tc in tst["sites"].items():
        jc = jst["sites"][key]
        for f in jc._fields:
            if f == "k_scale":
                np.testing.assert_allclose(tc.k_scale.numpy(),
                                           np.asarray(jc.k_scale), rtol=1e-6)
            else:
                np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                              np.asarray(getattr(jc, f)), f)


def test_apply_verify_matches_jax_and_sequential_decodes(world):
    """The fake-quant graph's ``apply_verify`` (``kv_quant="fake"``: the new
    rows fake-quantized into an fp per-slot cache) against the reference's
    on the same numpy state, and against S of the port's ``apply_decode``:
    the cache rows bit for bit, the logits to the head's rounding."""
    from repro.models.quant_layers import QuantContext as JCtx
    from repro_torch.models.quant_layers import QuantContext as TCtx
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    jbits = jlm.bits_from_policy(jcfg, world["jpol"])
    tbits = tlm.bits_from_policy(tcfg, world["tpol"])
    jctx = JCtx.make(jcfg.bits, jcfg.quant_act_signed,
                     compute_dtype=jnp.float32, kv_quant="fake")
    tctx = TCtx.make(tcfg.bits, tcfg.quant_act_signed,
                     compute_dtype=torch.float32, kv_quant="fake")
    r = np.random.default_rng(9)
    toks = r.integers(0, tcfg.vocab, (2, 3)).astype(np.int32)
    pos = np.array([[0, 1, 2], [-1, -1, -1]], np.int32)
    jst = jlm.init_decode_state(jcfg, 2, 8, jnp.float32, per_slot=True)
    tst = tlm.init_decode_state(tcfg, 2, 8, per_slot=True)
    jl, jst = jlm.apply_verify(world["jparams"], jcfg, jnp.asarray(toks),
                               jnp.asarray(pos), jst, jbits, jctx)
    tl, tst2 = tlm.apply_verify(world["tparams"], tcfg, torch.from_numpy(toks),
                                torch.from_numpy(pos), tst, tbits, tctx)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    seq = tst
    for j in range(3):
        lj, seq = tlm.apply_decode(world["tparams"], tcfg,
                                   torch.from_numpy(toks[:, j:j + 1]),
                                   torch.from_numpy(pos[:, j]), seq, tbits,
                                   tctx)
        torch.testing.assert_close(tl[0, j], lj[0], rtol=0, atol=HEAD_ATOL)
    jbody = jst["body"]["0"]           # the reference scans the stacked body
    for u, (key, c) in enumerate(sorted(tst2["sites"].items())):
        np.testing.assert_array_equal(c.pos.numpy(), np.asarray(jbody.pos[u]))
        m = c.pos >= 0
        assert torch.equal(c.k[m], seq["sites"][key].k[m])
        assert torch.equal(c.v[m], seq["sites"][key].v[m])
        np.testing.assert_allclose(c.k[m].numpy(),
                                   np.asarray(jbody.k[u])[m.numpy()],
                                   rtol=1e-5, atol=1e-6)


def test_draft_bytes_match_jax(world):
    jsess = JSpec(world["jcfg"], world["jparams"], world["jpol"],
                  draft_w_bits=2, kv_quant="int8")
    sess = world["sess"]
    assert sess.draft_bytes() == jsess.draft_bytes()
    assert sess.packed_bytes() == jsess.packed_bytes()
    assert sess.draft_bytes() < sess.packed_bytes()
    assert sess.policy_draft.w_bits == dict(jsess.policy_draft.w_bits)
    assert sess.policy is world["tpol"]


# ---------------------------------------------------------------------------
# engine layer
# ---------------------------------------------------------------------------
def _requests(vocab):
    """Three prompts share a 16-token (two-page) prefix, one does not; the
    last request fills its cache exactly (prompt + max_new == cache_len)."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, vocab, size=16)

    def mk(rid, tail, max_new, arrival=0):
        toks = np.concatenate([shared, rng.integers(1, vocab, size=tail)])
        return Request(rid=rid, tokens=toks.astype(np.int32), max_new=max_new,
                       arrival=arrival)

    return [mk(0, 5, 6), mk(1, 3, 5, 1),
            Request(rid=2, tokens=rng.integers(1, vocab, size=9).astype(
                np.int32), max_new=4, arrival=2),
            mk(3, 4, 9)]


def _engine(sess, layout, k, **kw):
    ecfg = teng.EngineConfig(**dict(dict(
        slots=2, cache_len=29, prefill_chunk=16, kv_quant="int8",
        kv_layout=layout, page_size=8, speculate=k), **kw))
    return teng.DecodeEngine(sess.params, sess.cfg, None, sess.ctx,
                             adapter=sess, ecfg=ecfg, device="cpu")


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_engine_spec_token_identical(world, layout, monkeypatch):
    """The speculating engine emits the token-at-a-time engine's tokens
    (one request fills its cache), books acceptance per request, drains to
    empty caches, and every row a paged rollback clears lies on a
    refcount-1 page of the engine's pool."""
    sess = world["sess"]
    reqs = _requests(world["tcfg"].vocab)
    assert reqs[-1].prompt_len + reqs[-1].max_new == 29
    base = _engine(sess, layout, 0)
    base.submit_all(reqs)
    base_out = base.run()
    spec = _engine(sess, layout, 3)
    checked = []
    if layout == "paged":
        rollback = tkv.PagedKVCache.rollback

        def audited(cache, cut):
            new = rollback(cache, cut)
            cleared = (cache.pos >= 0) & (new.pos < 0)
            for pid in torch.nonzero(cleared)[:, 0].unique().tolist():
                assert spec.pool.refcount[pid] == 1, pid
                checked.append(pid)
            return new

        monkeypatch.setattr(tkv.PagedKVCache, "rollback", audited)
    spec.submit_all(reqs)
    out = spec.run()
    for r in reqs:
        assert out[r.rid].tokens == base_out[r.rid].tokens, r.rid
    s = spec.stats
    assert s.spec_rounds == s.decode_steps > 0
    assert s.decode_steps < base.stats.decode_steps
    assert 0 < s.spec_accepted_tokens < s.spec_draft_tokens
    assert s.as_dict()["spec_accept_rate"] == s.spec_accept_rate
    assert sum(c.spec_drafted for c in out.values()) == s.spec_draft_tokens
    assert sum(c.spec_accepted for c in out.values()) == \
        s.spec_accepted_tokens
    assert all(c.spec_drafted == 0 for c in base_out.values())
    assert {r: len(spec.margins[r]) for r in out} == \
        {r: len(c.tokens) for r, c in out.items()}
    for c in spec.state["sites"].values():
        if layout == "paged":
            assert bool((c.page_table == -1).all())
        else:
            assert bool((c.pos == -1).all())
    if layout == "paged":
        assert checked, "no rollback cleared a row"
        spec.pool.check()
        assert s.prefill_flops_saved > 0


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_engine_spec_kv_bitwise_midflight(world, layout):
    """Mid-flight, one request in one slot: the speculating engine's cache
    is the token-at-a-time engine's at the same generated length, bit for
    bit (paged, page size 8, prompt 13: rounds cross the pages at rows 16
    and 24, so rollbacks cut partial tail pages). The projections take the
    integer-kernel route the card takes, here through its plain versions:
    integer sums are exact for any row count. On the dequant-fp route the
    decode's one-row float32 einsum takes another path than the verify's
    S-row one and rounds differently (the cause of the reference's failing
    midflight test); with one slot that reaches the KV rows."""
    sess = world["sess"]
    rng = np.random.default_rng(3)
    req = Request(rid=0, tokens=rng.integers(
        1, world["tcfg"].vocab, size=13).astype(np.int32), max_new=16)
    with tdisp.force_route("matmul", "cuda-int8"):
        spec = _engine(sess, layout, 3, slots=1, cache_len=32)
        spec.submit(req)
        for now in range(4):     # four rounds, the first with the admission
            assert spec.step(now)
        slot = spec.slots[0]
        assert slot is not None and not slot.done
        assert slot.spec_accepted < slot.spec_drafted   # rows rolled back
        base = _engine(sess, layout, 0, slots=1, cache_len=32)
        base.submit(req)
        now = 0
        while base.slots[0] is None or len(base.slots[0].gen) < len(slot.gen):
            assert base.step(now)
            now += 1
    assert base.slots[0].gen == slot.gen
    _assert_kv_bitwise(spec.state, base.state, "midflight")


def test_self_draft_is_always_accepted(world):
    """A target policy at the draft's own width packs the draft's tree:
    every proposal is the target's token."""
    cfg, names = world["tcfg"], world["tpol"].w_bits
    pol = TPolicy({n: 2 for n in names}, dict(world["tpol"].a_bits))
    sess = SpecSession(cfg, world["tparams"], pol, draft_w_bits=2)
    eng = _engine(sess, "ring", 4)
    eng.submit_all(_requests(cfg.vocab)[:2])
    eng.run()
    assert eng.stats.spec_draft_tokens > 0
    assert eng.stats.spec_accept_rate == 1.0


def test_eos_truncates_a_round_like_token_at_a_time_decode(world):
    """An EOS id among the target's tokens ends the request at the same
    token in both engines."""
    sess = world["sess"]
    reqs = _requests(world["tcfg"].vocab)
    base = _engine(sess, "ring", 0)
    base.submit_all(reqs)
    full = base.run()
    eos = full[3].tokens[4]
    outs = []
    for k in (0, 3):
        eng = _engine(sess, "ring", k, eos_id=eos)
        eng.submit_all(reqs)
        outs.append({r: c.tokens for r, c in eng.run().items()})
    assert outs[0] == outs[1]
    assert outs[0][3][-1] == eos and len(outs[0][3]) <= 5


# ---------------------------------------------------------------------------
# guards, dispatch, CLI
# ---------------------------------------------------------------------------
def test_spec_guards(world):
    cfg, tparams, tpol = world["tcfg"], world["tparams"], world["tpol"]
    with pytest.raises(ValueError, match="searched bit set"):
        SpecSession(cfg, tparams, tpol, draft_w_bits=7)
    mono = QuantizedSession(cfg, tparams, tpol)
    with pytest.raises(ValueError, match="dual-policy"):
        _engine(mono, "ring", 2)
    swa = cfg.scaled(sliding_window=8)
    with pytest.raises(ValueError, match="sliding-window"):
        _engine(SpecSession(swa, tparams, tpol), "ring", 2)
    with pytest.raises(ValueError, match="speculate must be >= 0"):
        _engine(world["sess"], "ring", -1)
    for kw, match in ((dict(kv="fp"), "int8"),
                      (dict(policy_given=False), "--policy"),
                      (dict(draft_bits=1), r"\[2, 8\]"),
                      (dict(draft_bits=9), r"\[2, 8\]")):
        args = dict(dict(speculate=2, draft_bits=2), **kw)
        with pytest.raises(ValueError, match=match):
            tserve.check_spec(cfg, args.pop("speculate"),
                              args.pop("draft_bits"), **args)
    # the hybrid family's recurrent sites refuse speculation as the
    # reference refuses them; the rule is also held on a mocked schedule
    with pytest.raises(ValueError, match="attention-only"):
        tserve.check_spec(t_smoke("recurrentgemma-2b"), 2, 2)
    # and its local window refuses the paged layout, as the reference's
    # engine refuses windowed archs on pages
    with pytest.raises(ValueError, match="sliding-window"):
        teng.check_kv_layout(t_smoke("recurrentgemma-2b"), "paged")
    rec = tlm.Schedule((), ("attn", "rglru"), 1, ())
    with mock.patch.object(tlm, "build_schedule", lambda c: rec):
        with pytest.raises(ValueError, match="attention-only"):
            tserve.check_spec(cfg, 2, 2)
        with pytest.raises(ValueError, match="attention-only"):
            _engine(world["sess"], "ring", 2)
    with pytest.raises(ValueError, match="sliding-window"):
        tserve.check_spec(swa, 2, 2)
    with pytest.raises(ValueError, match=">= 0"):
        tserve.check_spec(cfg, -1, 2)
    tserve.check_spec(cfg, 0, 2)
    tserve.check_spec(cfg, 4, 2)
    with pytest.raises(SystemExit, match="--policy"):
        tserve.main(["--device", "cpu", "--speculate", "2"])
    with pytest.raises(SystemExit, match="int8"):
        tserve.main(["--smoke", "--device", "cpu", "--speculate", "2",
                     "--kv", "fp"])
    assert tdisp.ROUTES.routes("spec") == ("off", "self")


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_serve_cli_speculate_on_the_cpu_passes_its_gate(capsys, layout):
    tserve.main(["--smoke", "--device", "cpu", "--speculate", "4",
                 "--draft-bits", "2", "--kv-layout", layout,
                 "--requests", "4", "--slots", "2", "--prompt-len", "16",
                 "--gen", "6", "--stagger"])
    out = capsys.readouterr().out
    assert "speculate k=4 draft_bits=2:" in out
    assert "speculative tokens equal token-at-a-time packed decode" in out


def test_serve_quantized_speculates_the_demo_policy(world):
    """``serve_quantized(speculate=)`` packs a ``SpecSession`` and matches
    ``serve_quantized`` without it token for token."""
    cfg, tparams = world["tcfg"], world["tparams"]
    pol = tserve.demo_mixed_policy(cfg)
    reqs = _requests(cfg.vocab)
    kw = dict(slots=2, cache_len=29, prefill_chunk=16, device="cpu")
    _, _, want = tserve.serve_quantized(cfg, tparams, pol, reqs, **kw)
    sess, eng, got = tserve.serve_quantized(cfg, tparams, pol, reqs,
                                            speculate=3, draft_bits=3, **kw)
    assert isinstance(sess, SpecSession) and sess.draft_w_bits == 3
    assert eng.ecfg.speculate == 3 and eng.stats.spec_rounds > 0
    assert {r: c.tokens for r, c in got.items()} == \
        {r: c.tokens for r, c in want.items()}
    base, base_out = tserve.token_at_a_time(sess, cfg, reqs, eng)
    assert base.ecfg == dataclasses.replace(eng.ecfg, speculate=0)
    same, total, compared, bad = tserve.compare_spec(got, base, base_out)
    assert same == total == compared and not bad
