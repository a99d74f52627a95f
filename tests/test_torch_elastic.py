"""Elastic precision serving, port against the JAX reference, on the CPU.

limpq-demo smoke, 2 slots, a 32-row cache, budgets 3/4/6 (the reference's
``tests/test_elastic.py``). JAX's own weights cross over through
``interop``. Held equal across the packages: the indicator-bank fingerprint,
the variant bank key for key, the controller's decisions on frozen
signals, the refusals and their messages, and on the reference's request
ramp the swap decisions of the two engines. Tokens across frameworks are
held on decisive steps (top-2 margin above 1e-2); inside the port each
completion is held bit for bit against its own variant's single-policy
packed engine (the same layout, slots, cache and prefill chunk).
"""
import copy

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
from repro.dist.axes import NO_AXES                          # noqa: E402
from repro.launch import elastic as jelastic                 # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.launch.scheduler import Request as JRequest       # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.models.quant_layers import QuantContext as JCtx   # noqa: E402
from repro.runtime import session as jsession                # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.launch import elastic as telastic           # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch.scheduler import Request as TRequest  # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.obs import trace as ttrace                  # noqa: E402
from repro_torch.runtime import packing as tpacking          # noqa: E402
from repro_torch.runtime import session as tsession          # noqa: E402

CACHE_LEN, SLOTS, BUDGETS = 32, 2, (3.0, 4.0, 6.0)
RAMP = [(8, 6, 0)] + [(8, 6, 1)] * 7     # one request per tick, 2 slots
DECISIVE = 1e-2


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = j_smoke("limpq-demo"), t_smoke("limpq-demo")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jql, tql = jlm.enumerate_qlayers(jcfg), tlm.enumerate_qlayers(tcfg)
    jfam = jsession.bank_fingerprint(jparams)
    tfam = tsession.bank_fingerprint(tparams)
    jbank = jelastic.build_variant_bank(jql, jcfg.bits, BUDGETS, family=jfam)
    tbank = telastic.build_variant_bank(tql, tcfg.bits, BUDGETS, family=tfam)
    tsess = tsession.ElasticSession(tcfg, tparams, tbank.policies,
                                    tserve.make_context(tcfg),
                                    active=tbank.full)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jql=jql, tql=tql, jfam=jfam, tfam=tfam, jbank=jbank,
                tbank=tbank, tsess=tsess)


def _specs_to_requests(cfg, specs, seed, cls):
    """specs [(prompt_len, max_new, arrival_gap)] -> staggered requests."""
    rng = np.random.default_rng(seed)
    reqs, arrival = [], 0
    for i, (p, g, gap) in enumerate(specs):
        arrival += gap
        toks = rng.integers(0, cfg.vocab, size=p).astype(np.int32)
        reqs.append(cls(rid=i, tokens=toks, max_new=g, arrival=arrival))
    return reqs


def _run_port(w, reqs, layout="ring", prefill_chunk=0):
    """One elastic serve over the module bank, restarted on the largest
    variant so every run sees the same downshift opportunity."""
    cfg, bank, sess = w["tcfg"], w["tbank"], w["tsess"]
    sess.set_active(bank.full)
    ctrl = telastic.ElasticController(cfg, bank, slots=SLOTS,
                                      cache_len=CACHE_LEN)
    eng = teng.DecodeEngine(
        sess.params, cfg, None, sess.ctx, adapter=sess, device="cpu",
        elastic=ctrl,
        ecfg=teng.EngineConfig(slots=SLOTS, cache_len=CACHE_LEN,
                               kv_quant="int8", kv_layout=layout,
                               prefill_chunk=prefill_chunk))
    eng.submit_all(reqs)
    return eng, ctrl, eng.run()


def _hold_to_single_policy_engines(w, reqs, eng, out):
    """Each completion bit for bit its stamped variant's single-policy
    packed engine over the requests that variant served: a swap changes who
    serves the next request, never what an admitted request decodes."""
    cfg, bank = w["tcfg"], w["tbank"]
    per_variant = {}
    for c in out.values():
        assert c.policy_id in bank.policies, c.policy_id
        per_variant.setdefault(c.policy_id, []).append(c.rid)
    for pid, rids in sorted(per_variant.items()):
        one = tsession.QuantizedSession(cfg, w["tparams"], bank.policies[pid],
                                        tserve.make_context(cfg))
        e1 = teng.DecodeEngine(
            one.params, cfg, None, one.ctx, adapter=one, device="cpu",
            ecfg=teng.EngineConfig(slots=SLOTS, cache_len=CACHE_LEN,
                                   kv_quant="int8",
                                   kv_layout=eng.ecfg.kv_layout,
                                   prefill_chunk=eng.prefill_chunk))
        e1.submit_all([r for r in reqs if r.rid in set(rids)])
        o1 = e1.run()
        for rid in rids:
            assert out[rid].tokens == o1[rid].tokens, (pid, rid)
    return per_variant


# ---------------------------------------------------------------------------
# fingerprint, bank, controller
# ---------------------------------------------------------------------------
def test_bank_fingerprint_equal_across_packages_and_scale_sensitive(world):
    assert world["tfam"] == world["jfam"] and len(world["tfam"]) == 16

    def bump(path, leaf):
        key = str(getattr(path[-1], "key", path[-1]))
        return leaf * 1.5 if key == "s_w" else leaf

    jother = jax.tree_util.tree_map_with_path(bump, world["jparams"])
    tother = interop.params_from_numpy(jckpt._flatten(jother), "cpu")
    assert tsession.bank_fingerprint(tother) != world["tfam"]
    assert tsession.bank_fingerprint(tother) == \
        jsession.bank_fingerprint(jother)
    with pytest.raises(ValueError, match="no indicator-bank scale leaves"):
        tsession.bank_fingerprint({"embed": {"w": torch.zeros(2)}})


def test_variant_bank_equal_key_for_key(world):
    jb, tb = world["jbank"], world["tbank"]
    assert list(tb.policies) == list(jb.policies) == \
        [telastic.variant_id(b) for b in BUDGETS]
    for pid, tp in tb.policies.items():
        jp = jb.policies[pid]
        assert tp.w_bits == jp.w_bits and tp.a_bits == jp.a_bits, pid
        keep = ("policy_id", "avg_bits_budget", "indicator_family")
        assert {k: tp.meta[k] for k in keep} == {k: jp.meta[k] for k in keep}
        assert tp.meta["indicator_family"] == world["jfam"]
    assert tb.size_bits == jb.size_bits
    assert (tb.full, tb.floor) == (jb.full, jb.floor)
    assert tb.layers == jb.layers and tb.bits == jb.bits
    np.testing.assert_array_equal(tb.values, jb.values)
    np.testing.assert_array_equal(tb.cost_size, jb.cost_size)
    for bad in ((4.0,), (4.0, 4.0), (4.0, 99.0)):
        with pytest.raises(ValueError) as te:
            telastic.build_variant_bank(world["tql"], world["tcfg"].bits, bad)
        with pytest.raises(ValueError) as je:
            jelastic.build_variant_bank(world["jql"], world["jcfg"].bits, bad)
        assert str(te.value) == str(je.value)


SIGNALS = [dict(queue_depth=0, occupied=0), dict(queue_depth=3, occupied=2,
                                                 deferred=1),
           dict(queue_depth=6, occupied=2, deferred=2),
           dict(queue_depth=1, occupied=1), dict(queue_depth=2, occupied=0),
           dict(queue_depth=0, occupied=1, cache_bytes=4096.0)]


@pytest.mark.parametrize("active", ["w6", "w4", "w3"])
def test_controller_decides_as_the_reference_on_frozen_signals(world, active):
    jc = jelastic.ElasticController(world["jcfg"], world["jbank"],
                                    slots=SLOTS, cache_len=CACHE_LEN)
    tc = telastic.ElasticController(world["tcfg"], world["tbank"],
                                    slots=SLOTS, cache_len=CACHE_LEN)
    for sig in SIGNALS:
        jd = jc.decide(active=active, slots=SLOTS, **sig)
        td = tc.decide(active=active, slots=SLOTS, **sig)
        assert (td.target, td.budget_bits, td.achieved_bits,
                td.target_bits) == (jd.target, jd.budget_bits,
                                    jd.achieved_bits, jd.target_bits), sig
        assert td.report.chosen_w == jd.report.chosen_w, sig
        assert td.report.chosen_a == jd.report.chosen_a, sig
    assert tc.solves == len(SIGNALS)


def test_elastic_session_rejects_what_the_reference_rejects(world):
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    jctx = JCtx.make(jcfg.bits, jcfg.quant_act_signed,
                     compute_dtype=jnp.float32)
    tctx = tserve.make_context(tcfg)

    def foreign(bank):
        pols = {pid: copy.deepcopy(p) for pid, p in bank.policies.items()}
        next(iter(pols.values())).meta["indicator_family"] = "0" * 16
        return pols

    one = {"w4": next(iter(world["tbank"].policies.values()))}
    cases = [((foreign(world["jbank"]),), (foreign(world["tbank"]),), {},
              "family"),
             (({"w4": next(iter(world["jbank"].policies.values()))},),
              (one,), {}, ">= 2"),
             ((world["jbank"].policies,), (world["tbank"].policies,),
              dict(active="w99"), "active"),
             ((world["jbank"].policies,), (world["tbank"].policies,),
              dict(mode="reference"), "reference")]
    for jargs, targs, kw, match in cases:
        with pytest.raises(ValueError, match=match) as je:
            jsession.ElasticSession(jcfg, world["jparams"], *jargs, jctx,
                                    **kw)
        with pytest.raises(ValueError, match=match) as te:
            tsession.ElasticSession(tcfg, world["tparams"], *targs, tctx,
                                    **kw)
        assert str(te.value) == str(je.value)


def test_set_active_swaps_accounting_without_packing(world, monkeypatch):
    sess, bank = world["tsess"], world["tbank"]
    calls = []
    monkeypatch.setattr(tpacking, "pack_linear",
                        lambda *a, **kw: calls.append(1))
    sizes = sess.variant_bytes()
    assert sizes["w3"] < sizes["w4"] < sizes["w6"]
    for pid in ("w3", "w6", "w4"):
        tree = sess.set_active(pid)
        assert tree is sess.params_for(pid) is sess.params
        assert sess.policy is bank.policies[pid]
        assert sess.packed_bytes() == sizes[pid]
        assert sess.route_counts is sess.variant_route_counts[pid]
        assert sess.pack_health is sess.variant_pack_health[pid]
    with pytest.raises(KeyError, match="unknown policy variant"):
        sess.set_active("w99")
    assert not calls
    sess.set_active(bank.full)


# ---------------------------------------------------------------------------
# the drain-then-swap engine: the reference's ramp through both engines
# ---------------------------------------------------------------------------
def test_ramp_takes_the_reference_engines_swap_decisions(world, monkeypatch):
    jcfg, jbank = world["jcfg"], world["jbank"]
    jctx = JCtx.make(jcfg.bits, jcfg.quant_act_signed,
                     compute_dtype=jnp.float32)
    jsess = jsession.ElasticSession(jcfg, world["jparams"], jbank.policies,
                                    jctx, active=jbank.full)
    jctrl = jelastic.ElasticController(jcfg, jbank, slots=SLOTS,
                                       cache_len=CACHE_LEN)
    je = jeng.DecodeEngine(jsess.params, jcfg, None, jctx, NO_AXES,
                           jeng.EngineConfig(slots=SLOTS, cache_len=CACHE_LEN,
                                             kv_quant="int8"),
                           adapter=jsess, elastic=jctrl)
    je.submit_all(_specs_to_requests(jcfg, RAMP, 7, JRequest))
    jout = je.run()

    calls = {"n": 0}
    real = tpacking.pack_linear

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tpacking, "pack_linear", counting)
    reqs = _specs_to_requests(world["tcfg"], RAMP, 7, TRequest)
    eng, ctrl, out = _run_port(world, reqs, prefill_chunk=je.prefill_chunk)
    assert calls["n"] == 0, "a policy swap packed weights"
    monkeypatch.setattr(tpacking, "pack_linear", real)

    ts, js = eng.stats, je.stats
    assert ts.policy_swaps >= 1 and ts.policy_swaps_down >= 1
    assert ts.admissions_deferred_swap >= 1
    for k in ("policy_swaps", "policy_swaps_down", "admissions_deferred_swap",
              "ilp_solves", "decode_steps", "active_policy"):
        assert getattr(ts, k) == getattr(js, k), k
    assert {r: c.policy_id for r, c in out.items()} == \
        {r: c.policy_id for r, c in jout.items()}
    assert ts.latency["ilp_solve_max_ms"] == pytest.approx(ctrl.max_solve_ms)
    compared = 0
    for rid, c in out.items():
        n, miss = teng.decisive_prefix(jout[rid].tokens, c.tokens,
                                       eng.margins[rid], DECISIVE)
        assert miss is None, (rid, jout[rid].tokens, c.tokens)
        compared += n
    assert compared >= len(reqs)
    assert all(s is None for s in eng.slots)
    per_variant = _hold_to_single_policy_engines(world, reqs, eng, out)
    assert len(per_variant) >= 2
    assert ttrace.reconcile(eng.trace, ts.as_dict()) == []
    swaps = [e for e in eng.trace.events if e.name == "policy_swap"]
    assert swaps[0].args["initial"] and len(swaps) == ts.policy_swaps + 1
    assert eng.metrics.value("engine.policy_variants") == len(BUDGETS)


@settings(max_examples=4, deadline=None, database=None)
@given(st.lists(st.tuples(st.sampled_from([4, 6, 8]),   # prompt length
                          st.integers(1, 4),            # max_new
                          st.integers(0, 2)),           # arrival gap
                min_size=2, max_size=7))
def test_swap_points_never_perturb_inflight_kv(world, specs):
    """Whatever the arrivals (hence the swap points), every request
    completes under one variant, bit for bit that variant's single-policy
    engine, on both layouts; no slot leaks, and the paged pool holds no
    reference beyond the prefix registry's pins."""
    reqs = _specs_to_requests(world["tcfg"], specs, 11, TRequest)
    for layout in ("ring", "paged"):
        eng, _, out = _run_port(world, reqs, layout=layout)
        assert sorted(out) == [r.rid for r in reqs], layout
        assert all(s is None for s in eng.slots), layout
        _hold_to_single_policy_engines(world, reqs, eng, out)
        assert ttrace.reconcile(eng.trace, eng.stats.as_dict()) == [], layout
        if layout == "paged":
            pinned = sum(len(c) for c in eng.pool._registry.values())
            assert sum(eng.pool.refcount) == pinned
            eng.pool.check()


# ---------------------------------------------------------------------------
# refusals: engine and ServeConfig
# ---------------------------------------------------------------------------
def test_engine_refuses_elastic_without_a_bank_or_with_speculation(world):
    cfg, bank = world["tcfg"], world["tbank"]
    ctrl = telastic.ElasticController(cfg, bank, slots=SLOTS,
                                      cache_len=CACHE_LEN)
    with pytest.raises(ValueError, match="variant-bank"):
        teng.DecodeEngine(world["tparams"], cfg, tlm.bits_uniform(cfg, 4),
                          tserve.make_context(cfg), device="cpu",
                          ecfg=teng.EngineConfig(slots=SLOTS,
                                                 cache_len=CACHE_LEN),
                          elastic=ctrl)
    spec = tsession.SpecSession(cfg, world["tparams"], bank.policies["w6"],
                                tserve.make_context(cfg))
    spec.set_active = spec.params_for = lambda pid: spec.params
    with pytest.raises(ValueError, match="elastic \\+ speculate"):
        teng.DecodeEngine(spec.params, cfg, None, spec.ctx, adapter=spec,
                          device="cpu", elastic=ctrl,
                          ecfg=teng.EngineConfig(slots=SLOTS,
                                                 cache_len=CACHE_LEN,
                                                 kv_quant="int8",
                                                 speculate=2))


@pytest.mark.parametrize("kw", [
    dict(elastic=True),
    dict(elastic=True, policy_path="p.json", speculate=2),
    dict(elastic=True, policy_path="p.json", schedule="fixed"),
    dict(elastic=True, policy_path="p.json", kv="fp"),
    dict(elastic=True, policy_path="p.json", policy_variants="3,x"),
    dict(elastic=True, policy_path="p.json", policy_variants="4"),
    dict(elastic=True, policy_path="p.json", policy_variants="4,4"),
])
def test_serve_config_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError) as je:
        jserve.ServeConfig(**kw)
    with pytest.raises(ValueError) as te:
        tserve.ServeConfig(**kw)
    assert str(te.value) == str(je.value)


def test_serve_config_parses_the_bank_budgets():
    scfg = tserve.ServeConfig(elastic=True, policy_path="p.json",
                              policy_variants="6,3,4.5")
    assert scfg.variant_budgets == (3.0, 4.5, 6.0)
    assert scfg.variant_budgets == jserve.ServeConfig(
        elastic=True, policy_path="p.json",
        policy_variants="6,3,4.5").variant_budgets


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_serve_cli_elastic_smoke_passes_its_gates(tmp_path, capsys, layout):
    pol = str(tmp_path / "P.json")
    tserve.main(["--smoke", "--write-demo-policy", pol])
    res = tserve.main(["--smoke", "--device", "cpu", "--policy", pol,
                       "--elastic", "--arrive-every", "1", "--requests",
                       "12", "--kv-layout", layout,
                       "--trace-out", str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    st_ = res["eng"].stats
    assert len(res["completions"]) == 12
    assert st_.policy_swaps_down >= 1 and st_.admissions_deferred_swap >= 1
    assert len(res["per_variant"]) >= 2
    assert "elastic: trace reconciles with engine stats" in out
    assert "per-variant tokens identical" in out
    # on the CPU the served route is the dequant-fp replay's: the same
    # variants and tokens, bit for bit
    replay, rout = tserve.replay_on_dequant_routes(res, "cpu")
    assert replay is not res["eng"] and replay.stats.policy_swaps >= 1
    assert {r: (c.policy_id, c.tokens) for r, c in rout.items()} == \
        {r: (c.policy_id, c.tokens) for r, c in res["completions"].items()}
    assert all(c["decisive"] > 0 and not c["parted"]
               for c in res["checks"].values())
    with pytest.raises(SystemExit, match="--elastic needs --policy"):
        tserve.main(["--smoke", "--device", "cpu", "--elastic"])
    with pytest.raises(SystemExit, match="--uniform-bits"):
        tserve.main(["--smoke", "--device", "cpu", "--policy", pol,
                     "--elastic", "--uniform-bits", "4"])
