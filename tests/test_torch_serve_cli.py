"""The port's serving harness on the CPU at smoke size: ``ServeConfig``, the
serve CLI's flags and artifacts, prompt bucketing, and the request-lifecycle
trace of the ring, paged and speculative engines reconciled with their
stats; against the JAX reference where both packages render the same
thing (the demo policy json, the ``--explain-policy`` table, the
``--chip-table`` refusal)."""
import json

import numpy as np
import pytest
import _torch_threads  # noqa: F401

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.policy import MPQPolicy as TPolicy
from repro_torch.data import SyntheticLM
from repro_torch.launch import engine as teng
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.obs import export as texp
from repro_torch.obs import trace as ttrace


@pytest.fixture(scope="module")
def world():
    cfg = t_smoke("qwen3-0.6b")
    params = tlm.init_params(cfg, seed=0, device="cpu")
    policy = tserve.demo_mixed_policy(cfg)
    reqs = tserve.build_requests(SyntheticLM(cfg), 5, 24, 8, stagger=True,
                                 share_prefix=16)
    return cfg, params, policy, reqs


def _serve(world, **kw):
    cfg, params, policy, reqs = world
    kw = dict(dict(slots=2, cache_len=40), **kw)
    return tserve.serve_quantized(cfg, params, policy, reqs, device="cpu",
                                  **kw)


# ---------------------------------------------------------------------------
# the trace of every serving path reconciles with the engine's stats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_layout,speculate", [
    ("ring", 0), ("paged", 0), ("ring", 3), ("paged", 3)])
def test_trace_reconciles_on_every_path(world, kv_layout, speculate):
    _, eng, out = _serve(world, kv_layout=kv_layout, speculate=speculate)
    st = eng.stats
    assert ttrace.reconcile(eng.trace, st.as_dict()) == []
    names = [e.name for e in eng.trace.events]
    assert names.count("decode_step") == st.decode_steps
    assert names.count("token") + names.count("first_token") == \
        sum(len(c.tokens) for c in out.values())
    if kv_layout == "paged":
        hits = [e for e in eng.trace.events if e.name == "prefix_hit"]
        assert hits and sum(e.args["tokens"] for e in hits) == \
            st.prefix_hit_tokens > 0
    if speculate:
        assert names.count("spec_verify") == st.spec_rounds > 0
        draft = [e for e in eng.trace.events if e.name == "spec_draft"]
        verify = [e for e in eng.trace.events
                  if e.name == "spec_verify_phase"]
        steps = [e for e in eng.trace.events if e.name == "decode_step"]
        assert len(draft) == len(verify) == st.spec_rounds
        for d, v, s in zip(draft, verify, steps):
            # the two phases tile the round's fenced span
            assert d.ts == pytest.approx(s.ts) and d.dur > 0
            assert d.end() == pytest.approx(v.ts)
            assert v.end() == pytest.approx(s.end())
        # one accept-length observation per live slot per round
        h = eng.metrics.get("spec.accept_len")
        assert h.count == st.slot_steps
        assert h.sum == st.spec_accepted_tokens
    else:
        assert "spec_verify" not in names


def test_trace_and_health_cost_no_token(world):
    """Tracing and KV-scale sampling read what the steps produced: with both
    off the same tokens come out."""
    import dataclasses
    cfg, params, policy, reqs = world
    sess, eng, out = _serve(world)
    quiet = teng.DecodeEngine(sess.params, cfg, None, sess.ctx, adapter=sess,
                              device="cpu", ecfg=dataclasses.replace(
                                  eng.ecfg, trace=False, health_every=0))
    quiet.submit_all(reqs)
    q = quiet.run()
    assert {r: c.tokens for r, c in q.items()} == \
        {r: c.tokens for r, c in out.items()}
    assert quiet.trace is None
    assert "quant.kv_scale_mean" in eng.metrics
    assert "quant.kv_scale_mean" not in quiet.metrics


def test_kv_scale_drift_samples_every_health_every_steps(world):
    _, eng, _ = _serve(world)
    st = eng.stats
    h = eng.metrics.get("quant.kv_scale_drift")
    # the first sample sets the baseline; each later one observes a drift
    assert h.count == st.decode_steps // eng.ecfg.health_every - 1
    assert eng.metrics.value("quant.kv_scale_mean") > 0


# ---------------------------------------------------------------------------
# prompt bucketing
# ---------------------------------------------------------------------------
def test_bucketed_and_unbucketed_tokens_identical(world):
    cfg, params, policy, reqs = world
    sess = tserve.build_session(cfg, params, policy)
    got = {}
    for bucket in (False, True):
        eng = teng.DecodeEngine(
            sess.params, cfg, None, sess.ctx, adapter=sess, device="cpu",
            ecfg=teng.EngineConfig(slots=2, cache_len=40, kv_quant="int8",
                                   bucket_prompts=bucket, bucket_min=8))
        eng.submit_all(reqs)
        got[bucket] = ({r: c.tokens for r, c in eng.run().items()},
                       eng.stats)
    assert got[True][0] == got[False][0]
    # five prompt lengths (24, 21, 18, 15, 24) fall into two buckets
    assert got[False][1].prefill_compiles == 4
    assert got[True][1].prefill_compiles == 2
    assert got[True][1].prefill_tokens == got[False][1].prefill_tokens


def test_bucketing_stays_off_where_pads_would_change_results(world):
    cfg, params, policy, _ = world
    sess = tserve.build_session(cfg, params, policy)

    def bucketed(c, adapter, layout):
        return teng.DecodeEngine(
            adapter.params, c, None, adapter.ctx, adapter=adapter,
            device="cpu", ecfg=teng.EngineConfig(
                cache_len=40, kv_quant="int8", kv_layout=layout,
                bucket_prompts=True))._bucket

    assert bucketed(cfg, sess, "ring")
    assert not bucketed(cfg, sess, "paged")
    rcfg = t_smoke("rwkv6-7b")
    rsess = tserve.build_session(
        rcfg, tlm.init_params(rcfg, seed=0, device="cpu"),
        tserve.demo_mixed_policy(rcfg))
    assert not bucketed(rcfg, rsess, "ring")


# ---------------------------------------------------------------------------
# ServeConfig
# ---------------------------------------------------------------------------
def test_serve_config_validates_and_builds_engine_configs(tmp_path):
    s = tserve.ServeConfig(prompt_len=16, gen=8, kv_layout="paged",
                           speculate=2, schedule="continuous-sjf")
    e = s.engine_config()
    assert (e.cache_len, e.kv_layout, e.kv_quant, e.bucket_prompts,
            e.speculate, e.policy) == (24, "paged", "int8", True, 0,
                                       "continuous-sjf")
    assert s.engine_config(speculate=2).speculate == 2
    # a non-int8 engine serves the ring
    assert s.engine_config(kv_quant="none").kv_layout == "ring"
    assert s.chip is None and e.chip == teng.EngineConfig().chip
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"hbm_bytes_s": 1e9, "peak_flops": 1e10}))
    c = tserve.ServeConfig(chip_table=str(path))
    assert c.engine_config().chip.hbm_bytes_s == 1e9
    assert c.engine_config(calibrated=False).chip == teng.EngineConfig().chip
    for bad in (dict(schedule="lifo"), dict(kv="fp16"),
                dict(kv="fp", kv_layout="paged"), dict(decode_attn="magic"),
                dict(speculate=-1), dict(sampling="top-k")):
        with pytest.raises(ValueError):
            tserve.ServeConfig(**bad)


def test_build_requests_spaces_arrivals():
    cfg = t_smoke("qwen3-0.6b")
    reqs = tserve.build_requests(SyntheticLM(cfg), 4, 12, 4, arrive_every=3)
    assert [r.arrival for r in reqs] == [0, 3, 6, 9]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _prom_matches_registry(text, reg):
    samples = texp.samples_as_dict(texp.parse_prometheus_text(text))
    snap = reg.snapshot()
    for name, v in snap.items():
        base = texp.prom_name(name)
        if isinstance(v, dict):
            assert samples[base + "_count"] == v["count"]
            assert samples[base + "_sum"] == pytest.approx(v["sum"])
        else:
            key = base if base in samples else base + "_total"
            assert samples[key] == pytest.approx(v), name


def test_cli_writes_trace_metrics_and_stream(tmp_path, capsys):
    out = tmp_path / "out"
    res = tserve.main([
        "--smoke", "--device", "cpu",
        "--trace-out", str(out / "trace.json"),
        "--metrics-out", str(out / "metrics.json"),
        "--metrics-stream", str(out / "stream.jsonl"),
        "--metrics-interval", "0"])
    text = capsys.readouterr().out
    eng = res["eng"]
    assert "trace reconciles with engine stats" in text
    assert "token-identical with fixed batch" in text
    assert res["saved"] > 0 and res["calibration"]["finite"]
    rec = ttrace.TraceRecorder.from_chrome(str(out / "trace.json"))
    assert ttrace.reconcile(rec, eng.stats.as_dict()) == []
    assert json.load(open(out / "metrics.json"))["engine.decode_steps"] == \
        eng.stats.decode_steps
    snaps = texp.read_jsonl_snapshots(str(out / "stream.jsonl"))
    assert len(snaps) >= 2 + eng.stats.iterations - 1
    _prom_matches_registry((out / "stream.jsonl.prom").read_text(),
                           eng.metrics)
    assert "roofline.drift_max" in eng.metrics


@pytest.mark.parametrize("flags", [
    ["--schedule", "continuous-sjf", "--arrive-every", "1", "--seed", "3",
     "--no-bucket", "--decode-attn", "fused", "--compare"],
    ["--kv-layout", "paged", "--decode-attn", "dequant-fp",
     "--trace-out", "{tmp}/t.jsonl"],
    ["--speculate", "3", "--draft-bits", "3", "--kv-layout", "paged"],
    ["--uniform-bits", "4", "--compare", "--stagger"],
    ["--schedule", "fixed", "--compare"],
    ["--kv", "fp", "--check"],
], ids=["sjf-arrivals-seed-nobucket-fused", "paged-dequant-jsonl",
        "speculate-paged", "uniform-bits", "fixed-schedule", "fp-kv-check"])
def test_cli_runs_every_flag(tmp_path, capsys, flags):
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    smoke = ["--smoke"] if "fixed" not in flags else []
    dims = ["--requests", "4", "--slots", "2", "--prompt-len", "16",
            "--gen", "6"]
    if smoke:
        res = tserve.main(smoke + ["--device", "cpu"] + dims + flags)
    else:
        # the fixed schedule is refused under --smoke: the full widths of
        # limpq-demo are small
        res = tserve.main(["--arch", "limpq-demo", "--device", "cpu"] + dims
                          + flags)
    text = capsys.readouterr().out
    eng = res["eng"]
    assert ttrace.reconcile(eng.trace, eng.stats.as_dict()) == []
    if "--seed" in flags:
        assert eng.scheduler.policy == "continuous-sjf"
        assert not eng._bucket and eng.decode_attn_route == "fused"
        assert "token-identical with fixed batch" in text
    if "--uniform-bits" in flags:
        assert eng.decode_attn_route == "fp" and "int8 quant_matmul" in text
        assert res["int8_max_err"] < 1e-5
    if "fixed" in flags:
        assert "note: --compare has no effect" in text
    if "--speculate" in flags:
        assert res["sess"].draft_w_bits == 3
        assert "speculative tokens equal token-at-a-time" in text
    if "--check" in flags:
        assert "greedy tokens equal the fake-quant reference" in text
    if "--trace-out" in flags:
        rec = ttrace.TraceRecorder.from_jsonl(str(tmp_path / "t.jsonl"))
        assert any(e.name == "prefix_hit" for e in rec.events)


def test_cli_seed_changes_the_weights(capsys):
    toks = {}
    for seed in ("0", "1"):
        res = tserve.main(["--smoke", "--device", "cpu", "--seed", seed])
        toks[seed] = res["eng"].params["embed"]["w"]
    assert not np.array_equal(toks["0"].numpy(), toks["1"].numpy())


def test_cli_chip_table_prints_both_chunks(tmp_path, capsys):
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"device_table": {
        "name": "cpu-measured", "hbm_bytes_s": 2e9, "peak_flops": 3e10}}))
    res = tserve.main(["--smoke", "--device", "cpu", "--chip-table",
                       str(path)])
    text = capsys.readouterr().out
    assert res["eng"].ecfg.chip.name == "cpu-measured"
    assert res["fixed"].ecfg.chip == teng.EngineConfig().chip
    assert (f"calibrated prefill chunk {res['eng'].prefill_chunk} vs "
            f"default {res['fixed'].prefill_chunk}") in text


def test_cli_refuses_what_it_cannot_serve():
    with pytest.raises(SystemExit, match="continuous schedule"):
        tserve.main(["--smoke", "--device", "cpu", "--schedule", "fixed"])
    with pytest.raises(SystemExit, match="--uniform-bits"):
        tserve.main(["--smoke", "--device", "cpu", "--uniform-bits", "4",
                     "--speculate", "2"])
    with pytest.raises(SystemExit, match="--explain-policy needs"):
        tserve.main(["--smoke", "--explain-policy"])


# ---------------------------------------------------------------------------
# against the reference's CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,smoke", [("limpq-demo", True),
                                        ("qwen3-0.6b", False)])
def test_demo_policy_json_equals_reference(tmp_path, arch, smoke):
    pytest.importorskip("jax")
    from repro.configs import get_config as j_get
    from repro.configs import smoke_config as j_smoke
    from repro.launch import serve as jserve
    from repro_torch.configs import get_config as t_get
    jcfg = j_smoke(arch) if smoke else j_get(arch)
    tcfg = t_smoke(arch) if smoke else t_get(arch)
    jserve.demo_mixed_policy(jcfg).save(str(tmp_path / "j.json"))
    tserve.demo_mixed_policy(tcfg).save(str(tmp_path / "t.json"))
    j = json.load(open(tmp_path / "j.json"))
    t = json.load(open(tmp_path / "t.json"))
    assert t.keys() == j.keys()
    assert t == j
    assert "solve_report" in t["meta"]


@pytest.mark.parametrize("arch", ["limpq-demo", "qwen3-0.6b"])
def test_write_demo_policy_equals_reference(tmp_path, capsys, arch):
    pytest.importorskip("jax")
    from repro.launch import serve as jserve
    jserve.main(["--arch", arch, "--smoke", "--write-demo-policy",
                 str(tmp_path / "j.json")])
    assert tserve.main(["--arch", arch, "--smoke", "--write-demo-policy",
                        str(tmp_path / "t.json")]) is None
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace("j.json", "") == lines[1].replace("t.json", "")
    assert json.load(open(tmp_path / "t.json")) == \
        json.load(open(tmp_path / "j.json"))


@pytest.mark.parametrize("embedded", [True, False])
def test_explain_policy_renders_the_reference_table(tmp_path, capsys,
                                                    embedded):
    """The same policy json through both CLIs' ``--explain-policy``: the
    same table text and the same report json; a policy without an embedded
    ``solve_report`` gets the same descriptive report rebuilt."""
    pytest.importorskip("jax")
    from repro.launch import serve as jserve
    cfg = t_smoke("qwen3-0.6b")
    pol = tserve.demo_mixed_policy(cfg)
    if not embedded:
        pol = TPolicy(pol.w_bits, pol.a_bits, meta={"kind": "bare"})
    path = str(tmp_path / "p.json")
    pol.save(path)
    texts = {}
    for name, mod in (("j", jserve), ("t", tserve)):
        out = str(tmp_path / f"{name}-report.json")
        mod.main(["--arch", "qwen3-0.6b", "--smoke", "--policy", path,
                  "--explain-policy", out])
        texts[name] = capsys.readouterr().out.replace(out, "")
    assert texts["t"] == texts["j"]
    assert json.load(open(tmp_path / "t-report.json")) == \
        json.load(open(tmp_path / "j-report.json"))


def test_chip_table_refusal_matches_reference(tmp_path):
    pytest.importorskip("jax")
    from repro.launch import serve as jserve
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump({"device_table": {"hbm_bytes_s": 0.0,
                                    "peak_flops": 1e12}}, f)
    msgs = []
    for mod in (jserve, tserve):
        with pytest.raises(SystemExit) as e:
            mod.main(["--smoke", "--arch", "limpq-demo", "--device", "cpu",
                      "--chip-table", path] if mod is tserve else
                     ["--smoke", "--arch", "limpq-demo", "--chip-table",
                      path])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "must be positive" in msgs[1]


@pytest.mark.parametrize("n_requests,continuous,fixed", [(6, 58, 60),
                                                         (8, 64, 62)])
def test_decode_steps_saved_depend_on_the_request_order(n_requests,
                                                        continuous, fixed):
    """The full-width CLI run's request shapes (prompt 256, 32 new, four
    slots, a 320-row cache, staggered) at the prefill chunk the H100
    envelope gives Qwen3-0.6B (``dist.roofline``): the port's engine takes
    the reference engine's decode steps under both schedules. Six requests
    save steps against the fixed schedule; with eight (the full-width CLI
    run's), the staggered lengths put the longest requests last, and
    admission under the chunk fills the slots over several iterations, so
    continuous batching takes two more steps in both packages. The step
    counts depend on the scheduling alone, so a small model shows them."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import smoke_config as j_smoke
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.dist.axes import NO_AXES
    from repro.launch import engine as jeng
    from repro.launch import serve as jserve
    from repro.models import lm as jlm
    from repro.models.quant_layers import QuantContext
    from repro.runtime.session import QuantizedSession
    from repro_torch.configs import get_config
    from repro_torch.dist import roofline
    full = get_config("qwen3-0.6b")
    chunk = roofline.suggest_prefill_chunk(
        full, 4, cache_tokens=320, kv_bits=8.0,
        w_bits_total=tserve.demo_mixed_policy(full).size_bytes(
            tlm.enumerate_qlayers(full)) * 8.0)
    assert chunk == 194
    cfg = t_smoke("limpq-demo")
    sess = tserve.build_session(cfg, tlm.init_params(cfg, seed=0,
                                                     device="cpu"),
                                tserve.demo_mixed_policy(cfg))
    reqs = tserve.build_requests(SyntheticLM(cfg), n_requests, 256, 32,
                                 stagger=True)
    jcfg = j_smoke("limpq-demo")
    jctx = QuantContext.make(jcfg.bits, jcfg.quant_act_signed,
                             compute_dtype=jnp.float32)
    jsess = QuantizedSession(jcfg, jlm.init_params(jax.random.PRNGKey(0),
                                                   jcfg),
                             jserve.demo_mixed_policy(jcfg), jctx,
                             mode="packed", kv_quant="int8")
    jreqs = jserve.build_requests(JSyntheticLM(jcfg), n_requests, 256, 32,
                                  stagger=True)
    assert [(r.prompt_len, r.max_new) for r in reqs] == \
        [(r.prompt_len, r.max_new) for r in jreqs]
    steps = {}
    for policy in ("continuous", "fixed"):
        eng = teng.DecodeEngine(
            sess.params, cfg, None, sess.ctx, adapter=sess, device="cpu",
            ecfg=teng.EngineConfig(slots=4, cache_len=320, kv_quant="int8",
                                   prefill_chunk=chunk, policy=policy,
                                   trace=False))
        ref = jeng.DecodeEngine(
            jsess.params, jcfg, None, jctx, NO_AXES,
            jeng.EngineConfig(slots=4, cache_len=320, kv_quant="int8",
                              prefill_chunk=chunk, policy=policy,
                              trace=False), adapter=jsess)
        for e, rs in ((eng, reqs), (ref, jreqs)):
            e.submit_all(rs)
            e.run()
        assert eng.stats.decode_steps == ref.stats.decode_steps
        assert eng.stats.iterations == ref.stats.iterations
        steps[policy] = eng.stats.decode_steps
    assert steps == {"continuous": continuous, "fixed": fixed}


def test_engine_registry_counts_every_routed_call_once(world):
    """Each fenced prefill and step publishes the routes its session took:
    over an epoch the registry's route counters equal the session's
    tallies, and the latency of each phase goes to the dominant route."""
    sess, eng, _ = _serve(world)
    families = {"matmul": "route", "decode_attn": "decode_attn"}
    for op, routes in sess.route_counts.routes.items():
        for route, n in routes.items():
            assert eng.metrics.value(f"dispatch.{families[op]}.{route}") == n
    assert sess.route_counts.routes["matmul"]
    st = eng.stats
    h = eng.metrics.get(
        f"dispatch.latency_ms.decode_attn.{eng.decode_attn_route}")
    assert h.count == st.decode_steps
