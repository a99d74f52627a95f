"""The observability modules of both packages, and the port's against the
reference's, on the CPU.

``obs.trace``, ``obs.calibrate``, ``obs.export`` and ``obs.monitor`` are
copies in the port and ``obs.health`` a port; the module-level tests below
(``tests/test_health.py`` and ``tests/test_obs.py``'s, which the reference
package keeps as they are) run once per package (``pkg``: ``repro`` needs
jax, ``repro_torch`` does not). Parity: Prometheus text is byte for byte
the reference's for registries filled alike, calibration rows and device
table agree to rel 1e-12 on a fixed stats dict, a session's pack-time
health equals the reference session's on the same params (saturation
counts exact, ratios to 1e-6), and ``KVScaleDrift`` reads the same values
from the same cache contents. Last, the port engine's trace and stats on a
real run (the reference's engine tests, on the port's engine).
"""
import collections
import importlib
import json
import math
import types

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

PKGS = ("repro", "repro_torch")


@pytest.fixture(params=PKGS)
def pkg(request):
    """One package's obs modules and the helpers the tests use."""
    name = request.param
    if name == "repro":
        pytest.importorskip("jax")

    def mod(m):
        return importlib.import_module(f"{name}.{m}")

    return types.SimpleNamespace(
        name=name, export=mod("obs.export"), health=mod("obs.health"),
        monitor=mod("obs.monitor"), trace=mod("obs.trace"),
        calibrate=mod("obs.calibrate"), roofline=mod("dist.roofline"),
        Registry=mod("obs.metrics").MetricsRegistry,
        bit_range=mod("core.quantizer").bit_range,
        dispatch=mod("runtime.dispatch"), scheduler=mod("launch.scheduler"),
        kv_cache=mod("runtime.kv_cache"))


# ---------------------------------------------------------------------------
# pack-time site health
# ---------------------------------------------------------------------------
def _self_calibrated(pkg, w, bits):
    qmax = pkg.bit_range(bits, True)[1]
    return np.abs(w).max(axis=tuple(range(w.ndim - 1))) / qmax


def test_site_health_zero_saturation_on_self_calibrated_scale(pkg):
    rng = np.random.default_rng(0)
    for bits in (2, 4, 8):
        w = rng.normal(size=(16, 24)).astype(np.float32)
        h = pkg.health.site_health(w, bits, _self_calibrated(pkg, w, bits))
        assert h["saturation_rate"] == 0.0 and h["n_saturated"] == 0
        assert h["scale_utilization"] == pytest.approx(1.0, rel=1e-5)
        assert h["n_values"] == w.size and h["w_bits"] == bits


def test_site_health_counts_clipped_values(pkg):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(32, 32)).astype(np.float32)
    h = pkg.health.site_health(w, 4, _self_calibrated(pkg, w, 4) * 0.25)
    assert h["saturation_rate"] > 0.0 and h["scale_utilization"] > 1.0
    assert h["n_saturated"] == round(h["saturation_rate"] * h["n_values"])


def test_site_health_edge_values_not_saturated(pkg):
    qmax = pkg.bit_range(4, True)[1]
    w = np.array([[1.0 * qmax, -1.0 * qmax, 0.5]])
    h = pkg.health.site_health(w, 4, np.float32(1.0))
    assert h["saturation_rate"] == 0.0
    assert h["scale_utilization"] == pytest.approx(1.0)
    h2 = pkg.health.site_health(np.array([[qmax + 0.51]]), 4, np.float32(1.0))
    assert h2["n_saturated"] == 1


def test_pack_summary_and_publish(pkg):
    rng = np.random.default_rng(2)
    sites = {}
    for i, bits in enumerate((2, 4, 8)):
        w = rng.normal(size=(8, 8)).astype(np.float32)
        s = _self_calibrated(pkg, w, bits) * (0.5 if i == 0 else 1.0)
        sites[f"L{i}.w"] = pkg.health.site_health(w, bits, s)
    summary = pkg.health.pack_summary(sites)
    assert summary["sites"] == 3
    assert summary["saturation_rate_max"] == max(
        h["saturation_rate"] for h in sites.values())
    reg = pkg.Registry()
    assert pkg.health.publish_pack_health(reg, sites) == summary
    assert reg.value("quant.saturation_rate_max") == \
        summary["saturation_rate_max"]
    for name in sites:
        assert f"quant.saturation_rate.{name}" in reg
    assert reg.get("quant.scale_utilization").count == 3
    assert pkg.health.pack_summary({})["sites"] == 0


def test_site_health_of_a_tensor_equals_numpy():
    """The port's device path (torch float64) gives the numpy version's
    counts and ratios exactly, per-tensor and per-channel scales."""
    from repro_torch.obs import health
    rng = np.random.default_rng(3)
    for bits, shape in ((2, (64, 48)), (4, (3, 40, 24)), (6, (128, 96))):
        w = rng.normal(size=shape).astype(np.float32)
        for s in (np.float32(0.11), (np.abs(w).max(axis=(0,) if len(shape)
                                                    == 2 else (0, 1)) / 3.0
                                     ).astype(np.float32)):
            want = health.site_health(w, bits, s)
            got = health.site_health(torch.from_numpy(w), bits,
                                     torch.as_tensor(s))
            assert got == want


# ---------------------------------------------------------------------------
# KV-scale drift
# ---------------------------------------------------------------------------
FakeCache = collections.namedtuple("FakeCache", ["k_scale", "v_scale"])


def test_kv_scale_drift_tracks_population_mean(pkg):
    d = pkg.health.KVScaleDrift()
    tree = {"a": FakeCache(np.full((4, 8), 0.5, np.float32),
                           np.full((4, 8), 0.5, np.float32))}
    assert d.update(tree) is None
    assert d.update(tree) == pytest.approx(0.0)
    shifted = {"a": FakeCache(np.full((4, 8), 1.0, np.float32),
                              np.full((4, 8), 1.0, np.float32))}
    assert d.update(shifted) == pytest.approx(1.0)
    assert d.last["rows"] == 64
    reg = pkg.Registry()
    d.publish(reg, 1.0)
    d.publish(reg, 0.25)
    assert reg.value("quant.kv_scale_mean") == pytest.approx(1.0)
    assert reg.value("quant.kv_scale_drift_max") == pytest.approx(1.0)


def test_kv_scale_drift_ignores_zero_rows_and_fp_caches(pkg):
    d = pkg.health.KVScaleDrift()
    half = np.zeros((2, 8), np.float32)
    half[0] = 0.5
    assert d.update([FakeCache(half, half), {"fp": np.zeros(3)}]) is None
    assert d.last["rows"] == 16
    assert d.update({"empty": np.zeros(3)}) is None


def test_kv_scale_drift_reads_the_reference_values_from_port_caches():
    """The same scale contents in the reference's ring and pooled caches and
    in the port's: ``kv_scale_leaves`` returns equal arrays, and a sequence
    of updates the same drifts and summaries."""
    jax = pytest.importorskip("jax")
    from repro.obs import health as jh
    from repro.runtime import kv_cache as jkv
    from repro_torch import interop
    from repro_torch.obs import health as th
    from repro_torch.runtime import kv_cache as tkv
    rng = np.random.default_rng(5)
    B, Sc, KV, hd, P, ps = 2, 12, 2, 8, 6, 4

    def arrays(scale):
        k_s = (rng.random((B, Sc, KV)) * scale).astype(np.float32)
        k_s[:, -3:] = 0.0                     # unwritten rows
        return dict(k=rng.integers(-127, 128, (B, Sc, KV, hd), np.int8),
                    v=rng.integers(-127, 128, (B, Sc, KV, hd), np.int8),
                    k_scale=k_s,
                    v_scale=(rng.random((B, Sc, KV)) * scale).astype(
                        np.float32),
                    pos=np.tile(np.arange(Sc, dtype=np.int32), (B, 1)))

    def paged(scale):
        return dict(k=rng.integers(-127, 128, (P, ps, KV, hd), np.int8),
                    v=rng.integers(-127, 128, (P, ps, KV, hd), np.int8),
                    k_scale=(rng.random((P, ps, KV)) * scale).astype(
                        np.float32),
                    v_scale=(rng.random((P, ps, KV)) * scale).astype(
                        np.float32),
                    pos=np.full((P, ps), -1, np.int32),
                    page_table=np.arange(B * 3, dtype=np.int32).reshape(B, 3))

    jd, td = jh.KVScaleDrift(), th.KVScaleDrift()
    for scale in (0.1, 0.1, 0.3):
        ring, pool = arrays(scale), paged(scale)
        jtree = {"sites": {
            "000": jkv.QuantKVCache(**{f: jax.numpy.asarray(ring[f])
                                       for f in jkv.QuantKVCache._fields}),
            "001": jkv.PagedKVCache(**{f: jax.numpy.asarray(pool[f])
                                       for f in jkv.PagedKVCache._fields})}}
        ttree = {"sites": {
            "000": tkv.QuantKVCache(**{f: torch.from_numpy(ring[f])
                                       for f in tkv.QuantKVCache._fields}),
            "001": interop.paged_cache_from_numpy(pool, "cpu"),
            "002": (torch.zeros(B, 4), torch.ones(B, 4))}}  # recurrent state
        for a, b in zip(th.kv_scale_leaves(ttree), jh.kv_scale_leaves(jtree)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        assert td.update(ttree) == jd.update(jtree)
        assert td.last == jd.last


# ---------------------------------------------------------------------------
# latency attribution, roofline drift, dominant route
# ---------------------------------------------------------------------------
def test_attribute_latency_routes_to_histograms(pkg):
    reg = pkg.Registry()
    pkg.health.attribute_latency(reg, "matmul", "packed-int8", 0.002)
    pkg.health.attribute_latency(reg, "matmul", "fp", 0.004)
    pkg.health.attribute_latency(reg, "matmul", "packed-int8", 0.003)
    h = reg.get("dispatch.latency_ms.matmul.packed-int8")
    assert h.count == 2 and h.sum == pytest.approx(5.0)
    assert reg.get("dispatch.latency_ms.matmul.fp").count == 1


def test_roofline_drift_worst_factor_both_directions(pkg):
    rows = [{"phase": "a", "ratio": 4.0}, {"phase": "b", "ratio": 0.1},
            {"phase": "c", "ratio": float("nan")}]
    assert pkg.health.roofline_drift(rows) == pytest.approx(10.0)
    assert pkg.health.roofline_drift([]) == 1.0


def test_dominant_route_from_registry(pkg):
    reg = pkg.Registry()
    assert pkg.dispatch.dominant_route(reg) == "fp"
    reg.counter("dispatch.route.fp").inc(2)
    reg.counter("dispatch.route.cuda-int8").inc(5)
    assert pkg.dispatch.dominant_route(reg) == "cuda-int8"
    reg.counter("dispatch.decode_attn.fused").inc()
    assert pkg.dispatch.dominant_route(reg, "decode_attn") == "fused"


def test_port_dispatch_counts_routes_into_the_bound_registry():
    """The routes a ``Counts`` scope tallied reach the registry through
    ``publish_routes``, each call once however often it is published."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.runtime import dispatch
    reg, counts, seen = MetricsRegistry(), dispatch.Counts(), {}
    with dispatch.counts_scope(counts):
        assert dispatch.resolve_decode_attn(torch.device("cpu")) == \
            "dequant-fp"
    dispatch.resolve_decode_attn(torch.device("cpu"))   # outside: uncounted
    dispatch.publish_routes(reg, counts, seen)
    dispatch.publish_routes(reg, counts, seen)          # nothing new
    assert reg.value("dispatch.decode_attn.dequant-fp") == 1
    with dispatch.counts_scope(counts), \
            dispatch.force_route("decode_attn", "fused"):
        dispatch.resolve_decode_attn(torch.device("cpu"))
        dispatch.resolve_decode_attn(torch.device("cpu"))
    dispatch.publish_routes(reg, counts, seen)
    assert reg.value("dispatch.decode_attn.dequant-fp") == 1
    assert reg.value("dispatch.decode_attn.fused") == 2
    assert seen == counts.routes
    assert dispatch.dominant_route(reg, "decode_attn") == "fused"
    assert dispatch.decode_attn_route(torch.device("cpu")) == "dequant-fp"


# ---------------------------------------------------------------------------
# Prometheus text exposition and the JSONL streamer
# ---------------------------------------------------------------------------
def _fill(reg):
    reg.counter("engine.decode_steps", help="steps").inc(7)
    reg.counter("engine.t_decode_s").inc(0.125)
    reg.gauge("engine.kv_pool_free_pages").set(3)
    reg.gauge("quant.scale_utilization_p50").set(0.8125)
    h = reg.histogram("engine.decode_step_ms", buckets=(1.0, 2.0, 4.0),
                      help="fenced step time")
    for v in (0.5, 1.5, 3.0, 9.0):
        h.observe(v)
    reg.histogram("spec.accept_len").observe(3.0)
    return reg


def test_prometheus_text_parses_and_matches_snapshot(pkg):
    reg = _fill(pkg.Registry())
    text = pkg.export.prometheus_text(reg)
    samples = pkg.export.samples_as_dict(pkg.export.parse_prometheus_text(text))
    assert samples["repro_engine_decode_steps_total"] == 7.0
    assert samples["repro_engine_kv_pool_free_pages"] == 3.0
    buckets = samples["repro_engine_decode_step_ms_bucket"]
    assert [buckets[(("le", e),)] for e in ("1", "2", "4", "+Inf")] == \
        [1.0, 2.0, 3.0, 4.0]
    assert samples["repro_engine_decode_step_ms_sum"] == \
        pytest.approx(reg.snapshot()["engine.decode_step_ms"]["sum"])
    assert "# TYPE repro_engine_decode_step_ms histogram" in text
    with pytest.raises(ValueError):
        pkg.export.parse_prometheus_text("bad metric line\n")
    with pytest.raises(ValueError):
        pkg.export.parse_prometheus_text('m{le=unquoted} 1\n')
    assert pkg.export.prom_name("a-b c", prefix="") == "a_b_c"


def test_prometheus_text_is_the_reference_text():
    pytest.importorskip("jax")
    from repro.obs import export as jexp
    from repro.obs import health as jh
    from repro.obs.metrics import MetricsRegistry as JReg
    from repro_torch.obs import export as texp
    from repro_torch.obs import health as th
    from repro_torch.obs.metrics import MetricsRegistry as TReg
    jreg, treg = _fill(JReg()), _fill(TReg())
    rng = np.random.default_rng(6)
    sites = {f"L{i}.wq": {"saturation_rate": float(rng.random() * 1e-3),
                          "scale_utilization": float(rng.random() * 1.2)}
             for i in range(5)}
    jh.publish_pack_health(jreg, sites)
    th.publish_pack_health(treg, sites)
    assert texp.prometheus_text(treg) == jexp.prometheus_text(jreg)
    assert texp.prometheus_text(treg, prefix="x") == \
        jexp.prometheus_text(jreg, prefix="x")


def test_write_prometheus_round_trips(pkg, tmp_path):
    reg = _fill(pkg.Registry())
    path = str(tmp_path / "m.prom")
    text = pkg.export.write_prometheus(reg, path)
    assert open(path).read() == text
    for name, _, _ in pkg.export.parse_prometheus_text(text):
        assert pkg.export.prom_name(name, prefix="") == name


def test_streamer_emits_first_tick_and_close(pkg, tmp_path):
    reg = _fill(pkg.Registry())
    path = str(tmp_path / "s.jsonl")
    s = pkg.export.MetricsStreamer(path, interval_s=10.0)
    assert s.tick(reg, now=0.0)
    assert not s.tick(reg, now=1.0)
    reg.counter("engine.decode_steps").inc()
    s.close(reg, now=2.0)
    snaps = pkg.export.read_jsonl_snapshots(path)
    assert [o["seq"] for o in snaps] == [0, 1]
    assert snaps[-1]["metrics"]["engine.decode_steps"] == 8.0
    assert not s.tick(reg)


def test_streamer_interval_gating_and_gaps(pkg, tmp_path):
    reg = _fill(pkg.Registry())
    s = pkg.export.MetricsStreamer(str(tmp_path / "s.jsonl"), interval_s=0.5)
    assert s.tick(reg, now=0.0)
    assert not s.tick(reg, now=0.4)
    assert s.tick(reg, now=0.5)
    s.close(reg, now=0.6)
    assert s.seq == 3
    with pytest.raises(ValueError):
        pkg.export.MetricsStreamer(str(tmp_path / "x.jsonl"), interval_s=-1)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"ts": 0.0, "seq": 0, "metrics": {}}\n'
                   '{"ts": 1.0, "seq": 2, "metrics": {}}\n')
    with pytest.raises(ValueError):
        pkg.export.read_jsonl_snapshots(str(bad))


# ---------------------------------------------------------------------------
# threshold monitor
# ---------------------------------------------------------------------------
def test_watcher_fires_exactly_at_boundary(pkg):
    reg = pkg.Registry()
    w = pkg.monitor.saturation_watcher(ceiling=0.25)
    reg.gauge("quant.saturation_rate_max").set(0.2499)
    assert w.evaluate(reg) is None
    reg.gauge("quant.saturation_rate_max").set(0.25)
    assert w.evaluate(reg) == pytest.approx(0.25)
    assert pkg.monitor.roofline_drift_watcher(8.0).evaluate(reg) is None
    with pytest.raises(ValueError):
        pkg.monitor.Watcher("bad", "m", "==", 1.0)


def test_monitor_edge_triggered_alerts_into_registry_and_trace(pkg):
    reg = pkg.Registry()
    rec = pkg.trace.TraceRecorder()
    mon = pkg.monitor.Monitor([pkg.monitor.saturation_watcher(0.25)])
    g = reg.gauge("quant.saturation_rate_max")
    g.set(0.1)
    assert mon.check(reg, rec) == []
    g.set(0.3)
    (a,) = mon.check(reg, rec, now=1.0)
    assert a.name == "saturation_ceiling" and a.ts == 1.0
    assert mon.check(reg, rec) == []
    g.set(0.2)
    mon.check(reg, rec)
    g.set(0.4)
    assert len(mon.check(reg, rec, now=2.0)) == 1
    assert reg.value(pkg.monitor.ALERTS_FIRED) == 2.0
    alerts = [e for e in rec.events if e.name == "alert"]
    assert [e.args["watcher"] for e in alerts] == ["saturation_ceiling"] * 2
    assert {w.name for w in pkg.monitor.default_monitor(
        pool_min_free=1).watchers} == {"saturation_ceiling",
                                       "roofline_drift", "pool_pressure"}


# ---------------------------------------------------------------------------
# scheduler page-pool deferral and the pool's headroom
# ---------------------------------------------------------------------------
def test_scheduler_defers_admission_on_pool_pressure(pkg):
    reg = pkg.Registry()
    sch = pkg.scheduler.Scheduler("continuous", prefill_chunk=100,
                                  metrics=reg)
    for i in range(3):
        sch.submit(pkg.scheduler.Request(
            rid=i, tokens=np.arange(4, dtype=np.int32), max_new=2))
    assert len(sch.admit(0, free_slots=[0, 1, 2], occupied=0,
                         page_budget=3, page_need=2)) == 1
    assert reg.value("scheduler.admissions_deferred_pool") == 1.0
    out = sch.admit(1, free_slots=[1, 2], occupied=1, page_budget=10,
                    page_need=2)
    assert [r.rid for r, _ in out] == [1, 2]


def test_pagepool_available_counts_reclaimable(pkg):
    pool = pkg.kv_cache.PagePool(n_pages=4, page_size=8)
    a, b = pool.alloc(1), pool.alloc(1)
    assert pool.available_count == 2
    pool.register_prefix([b"k1"], a)
    pool.release(b)
    pool.release(a)
    assert (pool.free_count, pool.reclaimable_count,
            pool.available_count) == (3, 1, 4)


# ---------------------------------------------------------------------------
# trace schema and reconcile
# ---------------------------------------------------------------------------
def _demo_recorder(trace):
    rec = trace.TraceRecorder()
    tr = trace.req_track(0)
    rec.instant("admit", track=tr, ts=0.0, rid=0, prompt_len=4)
    rec.span("prefill", 0.0, 0.5, track=tr, rid=0)
    rec.instant("first_token", track=tr, ts=0.5, rid=0, token=7)
    rec.span("decode_step", 0.5, 0.75, slots=1)
    rec.instant("token", track=tr, ts=0.75, rid=0, token=3)
    rec.instant("complete", track=tr, ts=0.75, rid=0)
    return rec


def test_trace_round_trips(pkg, tmp_path):
    rec = _demo_recorder(pkg.trace)
    with pytest.raises(ValueError):
        rec.span("x", 1.0, 0.5)
    p1, p2 = str(tmp_path / "a.jsonl"), str(tmp_path / "a.json")
    rec.write(p1)
    rec.write(p2)
    assert pkg.trace.TraceRecorder.from_jsonl(p1).events == rec.events
    obj = json.load(open(p2))
    assert pkg.trace.validate_chrome(obj) == []
    back = pkg.trace.TraceRecorder.from_chrome(obj)
    assert [(e.name, e.track, e.args) for e in back.events] == \
        [(e.name, e.track, e.args) for e in rec.events]
    (tmp_path / "bad.jsonl").write_text(json.dumps({"schema": 999}) + "\n")
    with pytest.raises(ValueError):
        pkg.trace.TraceRecorder.from_jsonl(str(tmp_path / "bad.jsonl"))


def test_request_summaries_and_reconcile(pkg):
    rec = _demo_recorder(pkg.trace)
    r = pkg.trace.request_summaries(rec.events)[0]
    assert r["tokens"] == 2 and r["ttft_ms"] == pytest.approx(500.0)
    good = {"t_decode_s": 0.25, "t_prefill_s": 0.5, "decode_steps": 1,
            "tokens_generated": 2, "admitted": 1, "completed": 1}
    assert pkg.trace.reconcile(rec, good) == []
    problems = pkg.trace.reconcile(rec, dict(good, t_decode_s=1.0,
                                             tokens_generated=5))
    assert any("t_decode_s" in p for p in problems)
    assert any("tokens_generated" in p for p in problems)


def test_reconcile_checks_prefix_hits_and_spec_rounds(pkg):
    rec = pkg.trace.TraceRecorder()
    tr = pkg.trace.req_track(0)
    rec.instant("admit", track=tr, ts=0.0, rid=0, prompt_len=8,
                prefix_hit_tokens=8)
    rec.instant("prefix_hit", track=tr, ts=0.0, rid=0, pages_reused=1,
                tokens=8, flops_saved=100.0)
    rec.instant("first_token", track=tr, ts=0.1, rid=0, token=1)
    rec.span("decode_step", 0.1, 0.2, slots=1)
    rec.instant("spec_verify", ts=0.2, drafted=2, accepted=1, emitted=2)
    rec.instant("token", track=tr, ts=0.2, rid=0, token=2)
    rec.instant("token", track=tr, ts=0.2, rid=0, token=3)
    rec.instant("complete", track=tr, ts=0.2, rid=0)
    stats = {"t_decode_s": 0.1, "t_prefill_s": 0.0, "decode_steps": 1,
             "tokens_generated": 3, "admitted": 1, "completed": 1,
             "prefix_hit_tokens": 8, "prefill_flops_saved": 100.0,
             "spec_rounds": 1, "spec_draft_tokens": 2,
             "spec_accepted_tokens": 1}
    assert pkg.trace.reconcile(rec, stats) == []
    problems = pkg.trace.reconcile(rec, dict(stats, prefix_hit_tokens=4,
                                             spec_accepted_tokens=2))
    assert any("prefix_hit tokens" in p for p in problems)
    assert any("spec_accepted_tokens" in p for p in problems)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
STATS = {"decode_steps": 37, "t_decode_s": 3.4125, "prefill_tokens": 1893,
         "t_prefill_s": 1.2875, "prefill_calls": 8, "ttft_p50_ms": 161.5,
         "admitted": 8}


def test_calibrate_rows_and_table(pkg):
    cfg = importlib.import_module(f"{pkg.name}.configs").get_config(
        "qwen3-0.6b")
    rep = pkg.calibrate.calibrate(cfg, STATS, slots=4, cache_tokens=320,
                                  kv_bits=8.0, w_bits_total=8.8e8)
    assert rep["finite"]
    assert [r["phase"] for r in rep["rows"]] == \
        ["decode_step", "prefill_token", "ttft"]
    t = rep["device_table"]
    chip = pkg.roofline.chip_from_table(t)
    assert chip.hbm_bytes_s == pytest.approx(t["hbm_bytes_s"])
    assert chip.ici_bytes_s == pkg.roofline.DEFAULT_CHIP.ici_bytes_s
    assert "decode_step" in pkg.calibrate.render_table(rep["rows"])
    bad = pkg.calibrate.calibrate(cfg, {}, slots=4, cache_tokens=320)
    assert not bad["finite"]


@pytest.mark.parametrize("arch,kw", [
    ("qwen3-0.6b", dict(slots=4, cache_tokens=320, kv_bits=8.0,
                        w_bits_total=8.8e8)),
    ("qwen3-0.6b", dict(slots=4, cache_tokens=320, kv_bits=8.0,
                        kv_attend="dequant")),
    ("rwkv6-7b", dict(slots=4, cache_tokens=288, kv_bits=32.0,
                      w_bits_total=2.8e10)),
    ("limpq-demo", dict(slots=2, cache_tokens=24, tp_size=2))])
def test_calibrate_equals_reference(arch, kw):
    pytest.importorskip("jax")
    import dataclasses
    from repro.configs import get_config as j_get
    from repro.dist import roofline as jroof
    from repro.obs import calibrate as jcal
    from repro_torch.configs import get_config as t_get
    from repro_torch.dist import roofline as troof
    from repro_torch.obs import calibrate as tcal
    jchip = jroof.ChipSpec(**dataclasses.asdict(troof.DEFAULT_CHIP))
    t = tcal.calibrate(t_get(arch), STATS, **kw)
    j = jcal.calibrate(j_get(arch), STATS, chip=jchip, **kw)
    assert t["finite"] == j["finite"] and t["chip"] == j["chip"]
    for a, b in zip(t["rows"], j["rows"]):
        assert a["phase"] == b["phase"] and a["note"] == b["note"]
        for k in ("measured_s", "modeled_s", "ratio"):
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=0)
    assert t["device_table"]["name"] == j["device_table"]["name"]
    for k in ("hbm_bytes_s", "peak_flops"):
        assert t["device_table"][k] == pytest.approx(
            j["device_table"][k], rel=1e-12, abs=0)
    assert tcal.render_table(t["rows"]) == jcal.render_table(j["rows"])


# ---------------------------------------------------------------------------
# pack-time health of a session, against the reference session
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b"])
def test_session_pack_health_equals_reference(arch):
    jax = pytest.importorskip("jax")
    from repro import checkpoint as jckpt
    from repro.configs import smoke_config as j_smoke
    from repro.launch import serve as jserve
    from repro.models import lm as jlm
    from repro.obs import health as jh
    from repro.runtime import session as jsess
    from repro_torch import interop
    from repro_torch.configs import smoke_config as t_smoke
    from repro_torch.core.policy import MPQPolicy as TPolicy
    from repro_torch.launch import engine as teng
    from repro_torch.obs import health as th
    from repro_torch.runtime import session as tsess
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    pairs = [(tsess.QuantizedSession(tcfg, tparams, tpol),
              jsess.QuantizedSession(jcfg, jparams, jpol))]
    if arch == "qwen3-0.6b":
        ts = tsess.SpecSession(tcfg, tparams, tpol, draft_w_bits=2)
        js = jsess.SpecSession(jcfg, jparams, jpol, draft_w_bits=2)
        pairs.append((ts, js))
        assert ts.draft_pack_health.keys() == js.draft_pack_health.keys()
        for name, h in ts.draft_pack_health.items():
            assert h["n_saturated"] == js.draft_pack_health[name][
                "n_saturated"]
            assert h["w_bits"] == 2
    for t, j in pairs:
        assert t.pack_health.keys() == j.pack_health.keys()
        assert len(t.pack_health) == len(t.qlayers)
        for name, h in t.pack_health.items():
            r = j.pack_health[name]
            assert (h["n_saturated"], h["n_values"], h["w_bits"]) == \
                (r["n_saturated"], r["n_values"], r["w_bits"]), name
            for k in ("saturation_rate", "scale_utilization"):
                assert h[k] == pytest.approx(r[k], rel=1e-6, abs=0), (name, k)
        assert t.w_bits_total == j.w_bits_total
        assert th.pack_summary(t.pack_health) == pytest.approx(
            jh.pack_summary(j.pack_health), rel=1e-6)
    # the engine publishes the target pack's health into its registry
    sess = pairs[0][0]
    eng = teng.DecodeEngine(sess.params, tcfg, None, sess.ctx, adapter=sess,
                            device="cpu", ecfg=teng.EngineConfig(
                                kv_quant="int8", cache_len=16))
    assert eng.metrics.value("quant.saturation_rate_max") == \
        th.pack_summary(sess.pack_health)["saturation_rate_max"]
    assert eng.metrics.get("quant.scale_utilization").count == \
        len(sess.pack_health)
    assert sess.metrics is eng.metrics


# ---------------------------------------------------------------------------
# the port engine's trace and stats on a real run
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    from repro_torch.configs import smoke_config
    from repro_torch.launch.engine import DecodeEngine, EngineConfig
    from repro_torch.launch.scheduler import Request
    from repro_torch.launch.serve import make_context
    from repro_torch.models import lm
    cfg = smoke_config("limpq-demo")
    params = lm.init_params(cfg, seed=0, device="cpu")
    eng = DecodeEngine(params, cfg, lm.bits_uniform(cfg, 4),
                       make_context(cfg), device="cpu",
                       ecfg=EngineConfig(slots=2, cache_len=24))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, size=8 - i)
                    .astype(np.int32), max_new=3 + i) for i in range(3)]
    eng.submit_all(reqs)
    return dict(cfg=cfg, eng=eng, reqs=reqs, completions=eng.run())


def test_engine_trace_complete_lifecycles(served):
    from repro_torch.obs import trace
    eng = served["eng"]
    stats = eng.stats
    assert trace.reconcile(eng.trace, stats.as_dict()) == []
    reqs = trace.request_summaries(eng.trace.events)
    assert set(reqs) == {r.rid for r in served["reqs"]}
    for rid, r in reqs.items():
        chain = [r["admit"], r["first_token"]] + sorted(r["token_ts"]) + \
            [r["complete"], r["evict"]]
        assert all(b >= a for a, b in zip(chain, chain[1:])), (rid, chain)
        assert r["tokens"] == len(served["completions"][rid].tokens)
    durs = [e.dur for e in eng.trace.events if e.name == "decode_step"]
    assert len(durs) == stats.decode_steps
    assert sum(durs) == pytest.approx(stats.t_decode_s, rel=1e-6)


def test_engine_stats_snapshot_and_latency(served):
    from repro_torch.launch.engine import EngineStats
    eng = served["eng"]
    s = eng.stats
    assert isinstance(s, EngineStats)
    d = s.as_dict()
    for key in ("ttft_p50_ms", "itl_p50_ms", "decode_step_p50_ms",
                "prefill_p50_ms", "total_tokens_per_s"):
        assert d[key] > 0.0, key
    assert eng.metrics.value("scheduler.admitted") == s.admitted
    assert eng.metrics.value(
        f"engine.decode_attn_route.{eng.decode_attn_route}") == 1.0
    assert eng.metrics.get("dispatch.latency_ms.decode_attn.fp").count == \
        s.decode_steps
    assert d["alerts_fired"] == 0


def test_engine_reset_starts_fresh_epoch(served):
    eng = served["eng"]
    old_stats, old_registry, old_trace = eng.stats, eng.metrics, eng.trace
    eng.reset()
    assert eng.metrics is not old_registry and eng.trace is not old_trace
    assert eng.stats.completed == 0 and old_stats.completed > 0
    assert old_registry.value("engine.completed") == old_stats.completed
    eng.submit_all(served["reqs"])
    eng.run()
    assert eng.stats.completed == len(served["reqs"])


def test_engine_calibrates_finite(served):
    from repro_torch.dist import roofline
    from repro_torch.obs import calibrate
    eng, cfg = served["eng"], served["cfg"]
    rep = calibrate.calibrate(cfg, eng.stats.as_dict(), slots=eng.ecfg.slots,
                              cache_tokens=eng.ecfg.cache_len,
                              kv_bits=eng.kv_bits, kv_attend=eng.kv_attend,
                              chip=eng.ecfg.chip)
    assert rep["finite"]
    for r in rep["rows"]:
        assert math.isfinite(r["ratio"]) and r["ratio"] > 0
    chip = roofline.chip_from_table(rep["device_table"])
    assert chip.peak_flops == pytest.approx(rep["device_table"]["peak_flops"])


def test_engine_without_trace_records_none(served):
    import dataclasses
    from repro_torch.launch.engine import DecodeEngine
    eng = served["eng"]
    quiet = DecodeEngine(eng.params, served["cfg"], eng.adapter.bits,
                         eng.adapter.ctx, device="cpu",
                         ecfg=dataclasses.replace(eng.ecfg, trace=False,
                                                  health_every=0))
    quiet.submit_all(served["reqs"])
    out = quiet.run()
    assert quiet.trace is None
    assert {r: c.tokens for r, c in out.items()} == \
        {r: c.tokens for r, c in served["completions"].items()}
