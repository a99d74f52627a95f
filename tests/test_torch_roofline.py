"""The port's roofline step-cost model and the engine's auto prefill budget,
against the JAX reference, on the CPU.

``dist.roofline`` is a copy (imports renamed, the default envelope an
H100), so under one ``ChipSpec`` passed to both packages every term,
counter and chunk must agree to rel 1e-12 (the same float operations in the
same order over the same QLayer table). The engines' auto ``prefill_chunk``
(``EngineConfig.prefill_chunk = 0``) must then be the reference engine's
for the same ``ServeConfig`` and chip on the ring, paged and speculative
paths.
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import get_config as j_get                # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
from repro.configs.base import ShapeSpec as JShape           # noqa: E402
from repro.dist import roofline as jroof                     # noqa: E402
from repro.dist.axes import NO_AXES                          # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.runtime import session as jsess                   # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import get_config as t_get          # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.configs.base import ShapeSpec as TShape     # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.dist import roofline as troof               # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402

ARCHS = ("limpq-demo", "qwen3-0.6b", "rwkv6-7b", "recurrentgemma-2b",
         "deepseek-moe-16b")
REL = 1e-12

# the same envelope in both packages' ChipSpec types: the port's default
T_CHIP = troof.DEFAULT_CHIP
J_CHIP = jroof.ChipSpec(**dataclasses.asdict(T_CHIP))

# decode_step_cost keyword sets: slots, cache, KV bits and attend route,
# exact packed bits, tensor parallel, paged accounting, speculative rounds
COST_CASES = [
    dict(n_slots=1),
    dict(n_slots=4, cache_tokens=320),
    dict(n_slots=4, cache_tokens=320, kv_bits=8.0, kv_attend="fused"),
    dict(n_slots=4, cache_tokens=320, kv_bits=8.0, kv_attend="dequant"),
    dict(n_slots=8, cache_tokens=2048, tp_size=4, avg_weight_bits=4.0),
    dict(n_slots=4, cache_tokens=320, kv_bits=8.0, unique_pages=37,
         page_size=8),
    dict(n_slots=4, cache_tokens=320, kv_bits=8.0, spec_k=4,
         draft_w_bits=2.0),
    dict(n_slots=3, cache_tokens=96, kv_bits=8.0, kv_attend="dequant",
         spec_k=2, draft_w_bits=3.0, unique_pages=9, page_size=16),
]


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(b), 1e-300), (a, b)


def _cfgs(arch):
    return j_get(arch), t_get(arch)


def _w_bits(arch):
    """The demo policy's exact packed bits (the session's
    ``w_bits_total``), from the reference."""
    cfg = j_get(arch)
    pol = jserve.demo_mixed_policy(cfg)
    return pol.size_bytes(jlm.enumerate_qlayers(cfg)) * 8.0


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    for name, S, B, kind in (("t", 2048, 4, "train"), ("p", 512, 2, "prefill"),
                             ("d", 4096, 8, "decode")):
        _close(troof.model_flops(tcfg, TShape(name, S, B, kind)),
               jroof.model_flops(jcfg, JShape(name, S, B, kind)))


@pytest.mark.parametrize("case", range(len(COST_CASES)))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_cost_matches_reference(arch, case):
    jcfg, tcfg = _cfgs(arch)
    kw = dict(COST_CASES[case])
    n = kw.pop("n_slots")
    for wb in (None, _w_bits(arch)):
        t = troof.decode_step_cost(tcfg, n, w_bits_total=wb, chip=T_CHIP,
                                   **kw)
        j = jroof.decode_step_cost(jcfg, n, w_bits_total=wb, chip=J_CHIP,
                                   **kw)
        assert t.keys() == j.keys()
        assert t["dominant"] == j["dominant"]
        for k in t:
            if k != "dominant":
                _close(t[k], j[k])


@pytest.mark.parametrize("case", range(len(COST_CASES)))
@pytest.mark.parametrize("arch", ARCHS)
def test_suggest_prefill_chunk_matches_reference(arch, case):
    jcfg, tcfg = _cfgs(arch)
    kw = {k: v for k, v in COST_CASES[case].items()
          if k not in ("unique_pages", "page_size")}
    n = kw.pop("n_slots")
    for wb in (None, _w_bits(arch)):
        for lo, hi in ((16, 512), (1, 1 << 20)):
            assert troof.suggest_prefill_chunk(
                tcfg, n, w_bits_total=wb, chip=T_CHIP, min_chunk=lo,
                max_chunk=hi, **kw) == jroof.suggest_prefill_chunk(
                jcfg, n, w_bits_total=wb, chip=J_CHIP, min_chunk=lo,
                max_chunk=hi, **kw)


def test_default_chip_is_the_h100_envelope():
    chip = troof.DEFAULT_CHIP
    assert chip.name == "h100-sxm5"
    assert (chip.hbm_bytes_s, chip.peak_flops, chip.hbm_bytes) == \
        (3.35e12, 1979e12, 80e9)
    # Qwen3-0.6B's decode step under the demo policy and int8 KV is memory
    # bound on it, and its prefill budget lands inside the clamp
    cfg = t_get("qwen3-0.6b")
    cost = troof.decode_step_cost(cfg, 4, cache_tokens=320, kv_bits=8.0,
                                  w_bits_total=_w_bits("qwen3-0.6b"))
    assert cost["dominant"] == "memory"
    chunk = troof.suggest_prefill_chunk(cfg, 4, cache_tokens=320, kv_bits=8.0,
                                        w_bits_total=_w_bits("qwen3-0.6b"))
    assert 16 < chunk < 512


def test_chip_from_table_matches_reference():
    table = {"name": "x-measured", "hbm_bytes_s": 1.5e12,
             "peak_flops": 4.0e14, "source": "unit-test"}
    t = troof.chip_from_table(table)
    j = jroof.chip_from_table(table, base=J_CHIP)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for bad in ({"hbm_bytes_s": 0.0}, {"peak_flops": -1.0},
                {"ici_bytes_s": "fast"}):
        with pytest.raises(ValueError) as te:
            troof.chip_from_table(bad)
        with pytest.raises(ValueError) as je:
            jroof.chip_from_table(bad)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the engines' auto prefill budget
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    jcfg = j_smoke("qwen3-0.6b")
    tcfg = t_smoke("qwen3-0.6b")
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    return jcfg, tcfg, jparams, tparams, jpol, tpol


def _engines(world, kv_layout, speculate, chip_table=None):
    """(port engine, reference engine) built from one ServeConfig each with
    the same fields, the reference's chip set to the port's default."""
    jcfg, tcfg, jparams, tparams, jpol, tpol = world
    common = dict(slots=3, prompt_len=16, gen=8, kv_layout=kv_layout,
                  speculate=speculate, chip_table=chip_table)
    tscfg = tserve.ServeConfig(arch="qwen3-0.6b", **common)
    jscfg = jserve.ServeConfig(arch="qwen3-0.6b", policy_path="p.json",
                               **common)
    tsess = tserve.build_session(tcfg, tparams, tpol, speculate=speculate)
    if speculate:
        js = jsess.SpecSession(jcfg, jparams, jpol, draft_w_bits=2)
    else:
        js = jsess.QuantizedSession(jcfg, jparams, jpol)
    te = teng.DecodeEngine(tsess.params, tcfg, None, tsess.ctx, adapter=tsess,
                           device="cpu",
                           ecfg=tscfg.engine_config(speculate=speculate))
    jecfg = jscfg.engine_config(speculate=speculate)
    if chip_table is None:
        jecfg = dataclasses.replace(jecfg, chip=J_CHIP)
    je = jeng.DecodeEngine(js.params, jcfg, None, js.ctx, NO_AXES, jecfg,
                           adapter=js)
    return te, je


@pytest.mark.parametrize("kv_layout,speculate", [
    ("ring", 0), ("paged", 0), ("ring", 4), ("paged", 4)])
def test_engine_auto_prefill_chunk_matches_reference(world, kv_layout,
                                                     speculate):
    te, je = _engines(world, kv_layout, speculate)
    assert te.ecfg.prefill_chunk == 0 == je.ecfg.prefill_chunk
    assert (te.kv_bits, te.kv_attend) == (je.kv_bits, je.kv_attend)
    assert te.adapter.w_bits_total == je.adapter.w_bits_total
    assert te.prefill_chunk == je.prefill_chunk
    assert te.metrics.value("engine.prefill_chunk") == te.prefill_chunk


def test_engine_chunk_under_a_chip_table_matches_reference(world, tmp_path):
    """``--chip-table``: both packages read the same measured table (its
    bandwidth and rate set the single-card budget) into the same chunk."""
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"device_table": {
        "name": "h100-sxm5-measured", "hbm_bytes_s": 2.1e9,
        "peak_flops": 3.3e10, "source": "unit-test"}}))
    te, je = _engines(world, "ring", 0, chip_table=str(path))
    assert te.ecfg.chip.hbm_bytes_s == je.ecfg.chip.hbm_bytes_s == 2.1e9
    assert te.prefill_chunk == je.prefill_chunk
    default, _ = _engines(world, "ring", 0)
    assert te.prefill_chunk != default.prefill_chunk


def test_explicit_chunk_is_kept_and_negative_refused(world):
    _, tcfg, _, tparams, _, tpol = world
    sess = tserve.build_session(tcfg, tparams, tpol)
    eng = teng.DecodeEngine(sess.params, tcfg, None, sess.ctx, adapter=sess,
                            device="cpu",
                            ecfg=teng.EngineConfig(prefill_chunk=24,
                                                   kv_quant="int8"))
    assert eng.prefill_chunk == eng.scheduler.prefill_chunk == 24
    with pytest.raises(ValueError, match=">= 0"):
        teng.DecodeEngine(sess.params, tcfg, None, sess.ctx, adapter=sess,
                          device="cpu",
                          ecfg=teng.EngineConfig(prefill_chunk=-1))
    assert np.isfinite(eng.kv_bits)
