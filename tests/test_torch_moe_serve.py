"""The MoE family over pooled int8 pages and self-speculatively
(deepseek-moe-16b), port against the JAX reference, on the CPU.

Config: deepseek-moe-16b's smoke config (3 layers: one dense layer, then
two MoE layers of 8 experts, top-2, 2 shared experts); JAX's own
``lm.init_params`` weights cross over through ``repro_torch.interop``,
under ``demo_mixed_policy``.

An expert's capacity comes from the tokens of the call
(``moe.capacity``): an append chunk of the paged layout routes one slot's
chunk, pad rows included, so past 128 rows a chunk can drop tokens. A pad
row sits at position -1, admits no key, and so attends the slot's whole
gathered view uniformly, rows that earlier requests left in its pages
included: which tokens an expert drops depends on the pool's history. The
reference's paged engine does the same: under the CLI's traffic its
continuous and fixed schedules part on a request, and the port's part on
the same one, each token for token the reference's (with the pad rows'
attention zeroed, both schedules agree). So a MoE run over pages is held
to the reference's paged engine and to the port's fake-quant reference
served over pages under the same schedule (``serve.reference_engine(
kv_layout="paged")``), not to another schedule.

Tolerances: greedy tokens across frameworks on decisive steps (top-2
margin above 1e-2, as ``tests/test_torch_moe.py``); inside the port the
packed dequant-fp route is the fake-quant graph bit for bit, so the paged
run equals its fake-quant reference over pages token for token; the
speculative engine equals the token-at-a-time engine token for token
(verify at 2 slots x 3 rows never reaches a capacity).
"""
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
from repro.data import SyntheticLM as JData                  # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.launch.scheduler import Request as JRequest       # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.runtime.session import QuantizedSession as JSess  # noqa: E402
from repro.runtime.session import SpecSession as JSpec       # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.data import SyntheticLM as TData            # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch.scheduler import Request as TRequest  # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.runtime import packing                      # noqa: E402
from repro_torch.runtime.session import QuantizedSession as TSess  # noqa: E402
from repro_torch.runtime.session import SpecSession as TSpec  # noqa: E402

ARCH = "deepseek-moe-16b"
DECISIVE = 1e-2
# the serve CLI's --smoke traffic over pages: 6 staggered requests of up
# to 16 prompt tokens, the first 8 shared, 4 slots of 24 rows, one append
# chunk of 194 rows (the roofline budget the CLI picks on the CPU)
CLI = dict(slots=4, cache_len=24, prefill_chunk=194, kv_quant="int8",
           kv_layout="paged", page_size=8)


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jpol=jpol, tpol=tpol, tsess=TSess(tcfg, tparams, tpol))


def _cli_requests(mod, data):
    return mod.build_requests(data, 6, 16, 8, stagger=True, share_prefix=8)


def _port_run(sess, reqs, **kw):
    eng = teng.DecodeEngine(sess.params, sess.cfg, None, sess.ctx,
                            adapter=sess, device="cpu",
                            ecfg=teng.EngineConfig(**kw))
    eng.submit_all(reqs)
    return eng, eng.run()


def _jax_run(sess, cfg, reqs, **kw):
    eng = jeng.DecodeEngine(sess.params, cfg, None, sess.ctx, adapter=sess,
                            ecfg=jeng.EngineConfig(trace=False, **kw))
    eng.submit_all(reqs)
    return eng, eng.run()


def _decisive_equal(jout, tout, margins):
    compared = 0
    for rid, c in tout.items():
        assert len(c.tokens) == len(jout[rid].tokens), rid
        n, miss = teng.decisive_prefix(jout[rid].tokens, c.tokens,
                                       margins[rid], DECISIVE)
        assert miss is None, (rid, jout[rid].tokens, c.tokens)
        compared += n
    return compared


# ---------------------------------------------------------------------------
# pages
# ---------------------------------------------------------------------------
def test_paged_engine_matches_reference_paged_engine(world):
    """The CLI's traffic over pages, under the continuous and the fixed
    schedule: the port's paged engine against the reference's (the same
    prefix hits, prefill tokens and decode steps; tokens on decisive
    steps); and where the reference's two schedules part, the port's part
    in the same requests."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    js = JSess(jcfg, world["jparams"], world["jpol"])
    toks = {}
    for policy in ("continuous", "fixed"):
        je, jout = _jax_run(js, jcfg, _cli_requests(jserve, JData(jcfg)),
                            policy=policy, **CLI)
        te, tout = _port_run(world["tsess"],
                             _cli_requests(tserve, TData(tcfg)),
                             policy=policy, **CLI)
        for f in ("prefix_hit_tokens", "prefill_tokens", "decode_steps",
                  "prefill_flops_saved"):
            assert getattr(te.stats, f) == getattr(je.stats, f), f
        assert te.stats.prefix_hit_tokens > 0
        assert _decisive_equal(jout, tout, te.margins) >= 6
        te.pool.check()
        toks[policy] = ({r: c.tokens for r, c in jout.items()},
                        {r: c.tokens for r, c in tout.items()})
    (jc, tc), (jf, tf) = toks["continuous"], toks["fixed"]
    ref_parts = sorted(r for r in jc if jc[r] != jf[r])
    assert ref_parts, "the reference's schedules no longer part: the " \
        "capacity finding (ROADMAP §3) needs a new look"
    assert sorted(r for r in tc if tc[r] != tf[r]) == ref_parts


def test_paged_engine_equals_the_fake_quant_reference_over_pages(world):
    """Inside the port: the packed paged run equals the fake-quant graph
    served over pages under the same schedule token for token (the dequant-fp
    route is that graph bit for bit), and ``check_greedy`` over pages
    compares decisive steps against it and its float64 control."""
    tcfg, tparams, tpol = world["tcfg"], world["tparams"], world["tpol"]
    reqs = _cli_requests(tserve, TData(tcfg))
    te, tout = _port_run(world["tsess"], reqs, **CLI)
    kw = dict(slots=CLI["slots"], cache_len=CLI["cache_len"],
              prefill_chunk=CLI["prefill_chunk"], device="cpu",
              kv_layout="paged", page_size=CLI["page_size"])
    ref, ref_out = tserve.reference_engine(tcfg, tparams, tpol, reqs, **kw)
    assert ref.stats.prefix_hit_tokens == te.stats.prefix_hit_tokens > 0
    assert {r: c.tokens for r, c in ref_out.items()} == \
        {r: c.tokens for r, c in tout.items()}
    n, bad, _ = tserve.check_greedy(tcfg, tparams, tpol, reqs, tout, **kw)
    assert not bad and n > 0
    # over the ring the prompts prefill whole: another capacity per call
    assert tserve.moe_over_pages(tcfg, "paged")
    assert not tserve.moe_over_pages(tcfg, "ring")
    assert not tserve.moe_over_pages(t_smoke("qwen3-0.6b"), "paged")


# ---------------------------------------------------------------------------
# speculation
# ---------------------------------------------------------------------------
def _spec_requests(cls, cfg):
    """Three prompts share a 16-token prefix (two pages), one does not."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, cfg.vocab, size=16)

    def mk(rid, tail, max_new, arrival=0):
        toks = np.concatenate([shared, rng.integers(1, cfg.vocab, size=tail)])
        return cls(rid=rid, tokens=toks.astype(np.int32), max_new=max_new,
                   arrival=arrival)

    return [mk(0, 5, 6), mk(1, 3, 5, 1),
            cls(rid=2, tokens=rng.integers(1, cfg.vocab, size=9).astype(
                np.int32), max_new=4, arrival=2),
            mk(3, 4, 8)]


SPEC = dict(slots=2, cache_len=29, prefill_chunk=16, kv_quant="int8",
            page_size=8)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_speculative_engine_matches_reference_and_token_at_a_time(world,
                                                                  layout):
    """``speculate=2`` with the 2-bit draft: the port's speculative engine
    emits its token-at-a-time engine's tokens token for token, and the
    reference's speculative engine's on decisive steps."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    ts = TSpec(tcfg, world["tparams"], world["tpol"], draft_w_bits=2)
    base, base_out = _port_run(ts, _spec_requests(TRequest, tcfg),
                               kv_layout=layout, **SPEC)
    spec, out = _port_run(ts, _spec_requests(TRequest, tcfg),
                          kv_layout=layout, speculate=2, **SPEC)
    assert {r: c.tokens for r, c in out.items()} == \
        {r: c.tokens for r, c in base_out.items()}
    s = spec.stats
    assert s.spec_rounds == s.decode_steps > 0
    assert s.decode_steps < base.stats.decode_steps
    assert 0 < s.spec_accepted_tokens <= s.spec_draft_tokens
    if layout == "paged":
        spec.pool.check()
        assert s.prefix_hit_tokens == base.stats.prefix_hit_tokens > 0
    js = JSpec(jcfg, world["jparams"], world["jpol"], draft_w_bits=2)
    je, jout = _jax_run(js, jcfg, _spec_requests(JRequest, jcfg),
                        kv_layout=layout, speculate=2, **SPEC)
    assert _decisive_equal(jout, out, spec.margins) >= 4
    assert ts.draft_bytes() == js.draft_bytes() < ts.packed_bytes()


def test_spec_session_from_a_site_source_packs_the_same_trees(world):
    """``SpecSession(site_source=)`` takes each site once and packs it under
    the target and the draft policy: both trees hold the codes and scales
    of the session packed from the whole tree."""
    tcfg, tparams, tpol = world["tcfg"], world["tparams"], world["tpol"]
    calls = []

    def source(site):
        calls.append(site.gidx)
        return tlm.site_params(tparams, site)

    outer = {k: v for k, v in tparams.items()
             if k not in ("prefix", "body", "suffix")}
    a = TSpec(tcfg, outer, tpol, draft_w_bits=2, site_source=source)
    b = TSpec(tcfg, tparams, tpol, draft_w_bits=2)
    assert calls == [s.gidx for s in tlm.iter_sites(tcfg)]
    for ta, tb in ((a.params, b.params), (a.draft_params, b.draft_params)):
        la, lb = packing.packed_leaves(ta), packing.packed_leaves(tb)
        assert len(la) == len(lb) == len(tlm.enumerate_qlayers(tcfg))
        for pa, pb in zip(la, lb):
            assert torch.equal(pa.codes, pb.codes)
            assert torch.equal(pa.scale, pb.scale)
            assert pa.a_group == pb.a_group
    assert a.draft_bytes() == b.draft_bytes() < a.packed_bytes()
    assert a.draft_pack_health == b.draft_pack_health
    # through the serve helper too
    c = tserve.build_session(tcfg, outer, tpol, speculate=2, draft_bits=2,
                             site_source=source)
    assert isinstance(c, TSpec) and c.draft_bytes() == a.draft_bytes()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flags, expect", [
    (["--kv-layout", "paged", "--check"],
     ["prompt tokens from shared pages",
      "greedy tokens equal the fake-quant reference on"]),
    (["--speculate", "2", "--draft-bits", "2"],
     ["speculative tokens equal token-at-a-time packed decode on",
      "tokens equal the fixed batch's on"]),
    (["--kv-layout", "paged", "--speculate", "2", "--draft-bits", "2"],
     ["speculative tokens equal token-at-a-time packed decode on"]),
])
def test_serve_cli_serves_moe_over_pages_and_speculatively(flags, expect,
                                                           capsys):
    res = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    for line in expect:
        assert line in out, (line, out[-2000:])
    assert res["eng"].ecfg.kv_layout == (
        "paged" if "paged" in flags else "ring")
    if "paged" in flags:
        # the continuous and fixed schedules' pools differ in history: the
        # CLI names the requests that differ instead of failing
        assert "token-identical with fixed batch" in out or \
            "a MoE schedule over pages routes each append chunk" in out


def test_expert_products_take_one_shape_for_decode_and_verify(world,
                                                              monkeypatch):
    """A decode step's 4 tokens and a verify pass's 12 (4 slots x 3 rows)
    run the router's and the expert stacks' float32 products at one
    shape, their rows padded to ``ROW_ALIGN``: the card's GEMM picks its
    kernel, and a row's sum order with it, by shape. The 4 tokens' outputs
    are then the same bits in both calls."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models.common import ROW_ALIGN
    tcfg, sess = world["tcfg"], world["tsess"]
    p = sess.params["sites"]["001"]["moe"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (12, 1, tcfg.d_model)).astype(np.float32))
    shapes = []
    real = torch.einsum

    def recording(eqn, *ops_):
        shapes.append((eqn, tuple(tuple(o.shape) for o in ops_)))
        return real(eqn, *ops_)

    monkeypatch.setattr(torch, "einsum", recording)
    outs = []
    for n in (4, 12):
        shapes.clear()
        y, _ = tmoe.moe_ffn(x[:n], p, tcfg.moe, None, sess.ctx, tcfg.act,
                            tcfg.mlp_gated)
        outs.append((y, [s for s in shapes if s[0].startswith(("ec", "td,de"))]))
    (y4, s4), (y12, s12) = outs
    assert s4 == s12 and len(s4) == 4            # router, wi, wg, wo
    assert all(sh[0][0] == ROW_ALIGN for e, sh in s4 if e == "td,de->te")
    assert all(sh[0][1] == ROW_ALIGN for e, sh in s4 if e.startswith("ec"))
    assert torch.equal(y4, y12[:4])


def test_norms_reduce_over_padded_rows(monkeypatch):
    """The norms' row statistics are taken over rows padded to
    ``ROW_ALIGN`` (the card's reduction splits a row's sum by the number of
    rows): 4 rows and 20 rows reduce at one shape, and each row's value is
    the unpadded formula's."""
    from repro_torch.models import common
    shapes = []
    real = torch.Tensor.mean

    def recording(self, *a, **kw):
        shapes.append(tuple(self.shape))
        return real(self, *a, **kw)

    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (20, 1, 256)).astype(np.float32))
    scale = torch.ones(256)
    monkeypatch.setattr(torch.Tensor, "mean", recording)
    a = common.rms_norm(x[:4], scale, 1e-6)
    b = common.rms_norm(x, scale, 1e-6)
    ln = common.layer_norm(x[:4], scale, torch.zeros(256), 1e-6)
    monkeypatch.setattr(torch.Tensor, "mean", real)
    assert shapes == [(common.ROW_ALIGN, 256)] * 4
    assert torch.equal(a, b[:4])
    x32 = x[:4]
    torch.testing.assert_close(
        a, x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6),
        rtol=1e-6, atol=1e-6)
    mu = x32.mean(-1, keepdim=True)
    torch.testing.assert_close(
        ln, (x32 - mu) * torch.rsqrt((x32 - mu).square().mean(
            -1, keepdim=True) + 1e-6), rtol=1e-6, atol=1e-6)
