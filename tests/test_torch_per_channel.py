"""Per-channel packing (statistics scales, ``max|w| / qmax`` per output
channel), port against the JAX reference, on the CPU.

Numpy inputs made from a seed go through ``repro.runtime.packing`` and
``repro_torch.runtime.packing``; the sessions take JAX's own
``lm.init_params`` weights through ``repro_torch.interop``.

Tolerances, and why:

* ``channel_scales``, the codes, the scales and ``dequant()``: bit for bit
  (one max, one division and one multiply per element, rounded the same in
  both packages).
* pack health: the saturated counts exactly, the rates to rel 1e-6 (the
  float64 quotient of both packages; ``tests/test_torch_obs.py``'s bound).
* logits: ``tests/test_torch_serve.py``'s LOGIT_ATOL / LOGIT_RTOL (2e-4 /
  1e-4; float32 sums in another order), greedy tokens equal on decisive
  steps (top-2 margin above 1e-2).
"""
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
from repro.launch import elastic as jelastic                 # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.launch.scheduler import Request as JRequest       # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.runtime import packing as jpacking                # noqa: E402
from repro.runtime import session as jsession                # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.launch import elastic as telastic           # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch.scheduler import Request as TRequest  # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.obs import health as th                     # noqa: E402
from repro_torch.runtime import dispatch                     # noqa: E402
from repro_torch.runtime import packing as tpacking          # noqa: E402
from repro_torch.runtime import session as tsession          # noqa: E402

LOGIT_ATOL, LOGIT_RTOL = 2e-4, 1e-4      # tests/test_torch_serve.py
DECISIVE = 1e-2
ARCHS = ["limpq-demo", "deepseek-moe-16b"]
ROOT = Path(__file__).resolve().parent.parent
KERNEL_EQN = "btk,kn->btn"


def _np(t):
    return t.detach().cpu().numpy()


def _weight(shape, seed):
    """Columns of very different magnitudes, so per-channel scales differ
    from one per-tensor scale."""
    r = np.random.default_rng(seed)
    return (r.normal(size=shape) * r.uniform(0.1, 4.0, size=shape[-1])
            ).astype(np.float32)


def _leaves(tree, cls, pre=""):
    """{path: packed leaf} of a nested dict tree (either package)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, cls):
            out[pre + k] = v
        elif isinstance(v, dict):
            out.update(_leaves(v, cls, f"{pre}{k}/"))
    return out


def _same_leaves(ttree, jtree):
    """Every packed leaf of the port's tree bit for bit the reference's, and
    packed per channel."""
    tl = _leaves(ttree, tpacking.PackedLinear)
    jl = _leaves(jtree, jpacking.PackedLinear)
    assert tl.keys() == jl.keys() and tl
    for k, t in tl.items():
        j = jl[k]
        assert t.per_channel and j.per_channel, k
        assert (t.w_bits, t.layout, t.shape) == (j.w_bits, j.layout, j.shape)
        np.testing.assert_array_equal(_np(t.codes), np.asarray(j.codes),
                                      err_msg=k)
        np.testing.assert_array_equal(_np(t.scale), np.asarray(j.scale),
                                      err_msg=k)
        assert t.scale.shape == (t.shape[-1],), k
    return tl


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("shape", [(24, 10), (3, 14, 6)])
def test_pack_linear_per_channel_matches_reference(bits, shape):
    """``channel_scales`` and ``pack_linear(per_channel=True)``'s scale,
    codes and ``dequant()`` bit for bit the reference's, on a 2-D weight
    and an (E, K, N) expert stack (whose scale is (N,) too), in every
    layout; the trained scale it is given is ignored."""
    w = _weight(shape, bits + len(shape))
    s_trained = np.float32(np.abs(w).max() / 7.0)
    cs_t = tpacking.channel_scales(torch.from_numpy(w), bits)
    cs_j = jpacking.channel_scales(jnp.asarray(w), bits)
    np.testing.assert_array_equal(_np(cs_t), np.asarray(cs_j))
    assert cs_t.shape == (shape[-1],)
    t = tpacking.pack_linear(torch.from_numpy(w), bits,
                             torch.tensor(s_trained), 8, 0.02,
                             per_channel=True)
    j = jpacking.pack_linear(w, bits, s_trained, 8, 0.02, per_channel=True)
    assert t.per_channel and j.per_channel
    assert t.layout == j.layout == {8: "int8", 4: "nib4", 2: "quad2"}.get(
        bits, "bitstream")
    np.testing.assert_array_equal(_np(t.scale), np.asarray(j.scale))
    np.testing.assert_array_equal(_np(t.scale), _np(cs_t))
    assert t.codes.dtype == {"int8": torch.int8}.get(t.layout, torch.uint8)
    np.testing.assert_array_equal(_np(t.codes), np.asarray(j.codes))
    np.testing.assert_array_equal(_np(t.dequant()), np.asarray(j.dequant()))
    # a trained scale of another value packs the same bytes
    t2 = tpacking.pack_linear(torch.from_numpy(w), bits, torch.tensor(0.5),
                              8, 0.02, per_channel=True)
    assert torch.equal(t2.codes, t.codes) and torch.equal(t2.scale, t.scale)
    # no code leaves its grid: the largest |w| of a channel lands on qmax
    qmax = 2 ** (bits - 1) - 1
    q = t.unpack().to(torch.int32)
    red = tuple(range(len(shape) - 1))
    assert torch.equal(q.abs().amax(dim=red),
                       torch.full((shape[-1],), qmax, dtype=torch.int32))


def test_channel_scales_floor_at_scale_eps():
    w = np.zeros((4, 3), np.float32)
    w[:, 1] = 1.5
    got = tpacking.channel_scales(torch.from_numpy(w), 4)
    np.testing.assert_array_equal(
        _np(got), np.asarray(jpacking.channel_scales(jnp.asarray(w), 4)))
    assert got[0] == tpacking.SCALE_EPS and got[1] == np.float32(1.5) / 7


def test_pack_linear_per_channel_reduces_error():
    """The reference's own oracle (``tests/test_runtime.py``), on the
    port."""
    r = np.random.default_rng(0)
    w = (r.normal(size=(16, 8)) * r.uniform(0.1, 4.0, size=8)).astype(
        np.float32)
    s = np.float32(np.abs(w).max() / 7.0)
    wt = torch.from_numpy(w)
    pt = tpacking.pack_linear(wt, 4, torch.tensor(s), 8, 0.02)
    pc = tpacking.pack_linear(wt, 4, torch.tensor(s), 8, 0.02,
                              per_channel=True)
    err_pt = float(torch.sum((pt.dequant() - wt) ** 2))
    err_pc = float(torch.sum((pc.dequant() - wt) ** 2))
    assert pc.per_channel and not pt.per_channel
    assert err_pc <= err_pt


@pytest.mark.parametrize("bits", [4, 8])
def test_per_channel_leaf_never_reaches_a_matmul_kernel(bits):
    """``kernel_eligible`` refuses a per-channel leaf (the kernels' epilogue
    reads ``pl.scale[:1]``), so on a CUDA device it resolves to dequant-fp;
    the same weight packed per tensor takes its kernel; a kernel route
    forced onto a per-channel leaf raises."""
    w = torch.from_numpy(_weight((32, 8), bits))
    pt = tpacking.pack_linear(w, bits, torch.tensor(0.1), 8, 0.05)
    pc = tpacking.pack_linear(w, bits, torch.tensor(0.1), 8, 0.05,
                              per_channel=True)
    cuda = torch.device("cuda")
    want = "cuda-w4" if bits == 4 else "cuda-int8"
    assert dispatch.kernel_eligible(KERNEL_EQN, pt) == want
    assert dispatch.resolve(KERNEL_EQN, pt, cuda) == want
    assert dispatch.kernel_eligible(KERNEL_EQN, pc) is None
    assert dispatch.resolve(KERNEL_EQN, pc, cuda) == "dequant-fp"
    ctx = tserve.make_context(t_smoke("limpq-demo"))
    x = torch.randn(1, 2, 32, generator=torch.Generator().manual_seed(0))
    for route in ("cuda-int8", "cuda-w4"):
        with dispatch.force_route("matmul", route), \
                pytest.raises(ValueError, match="per-channel"):
            dispatch.packed_qeinsum(KERNEL_EQN, x, pc, ctx)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def world(request):
    arch = request.param
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    js = jsession.QuantizedSession(jcfg, jparams, jpol, per_channel=True)
    ts = tsession.QuantizedSession(tcfg, tparams, tpol,
                                   tserve.make_context(tcfg),
                                   per_channel=True)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=tparams, jpol=jpol, tpol=tpol, js=js, ts=ts)


def test_session_packs_per_channel_as_the_reference(world):
    """Every packed leaf bit for bit the JAX session's, its scale (N,) per
    channel (an expert stack's too); the code bytes those of the per-tensor
    session, the scales not."""
    ts, js = world["ts"], world["js"]
    assert ts.per_channel
    leaves = _same_leaves(ts.params, js.params)
    assert len(leaves) == len(ts.qlayers)
    if world["arch"] == "deepseek-moe-16b":
        assert any(len(pl.shape) == 3 for pl in leaves.values())
    per_tensor = tsession.QuantizedSession(world["tcfg"], world["tparams"],
                                           world["tpol"])
    assert ts.packed_bytes() == per_tensor.packed_bytes() == \
        js.packed_bytes()
    pt = _leaves(per_tensor.params, tpacking.PackedLinear)
    assert any(not torch.equal(pl.scale, pt[k].scale)
               for k, pl in leaves.items())


def test_session_pack_health_per_channel(world):
    """Pack health equal to the JAX session's; saturation exactly 0 and
    scale utilization at most 1 at every site (the reference's oracle,
    ``tests/test_health.py``), where the trained per-tensor scales
    saturate."""
    ts, js = world["ts"], world["js"]
    assert ts.pack_health.keys() == js.pack_health.keys()
    assert len(ts.pack_health) == len(ts.qlayers)
    for name, h in ts.pack_health.items():
        r = js.pack_health[name]
        assert (h["n_saturated"], h["n_values"], h["w_bits"]) == \
            (r["n_saturated"], r["n_values"], r["w_bits"]), name
        for k in ("saturation_rate", "scale_utilization"):
            assert h[k] == pytest.approx(r[k], rel=1e-6, abs=0), (name, k)
        assert h["saturation_rate"] == 0.0, (name, h)
        assert h["scale_utilization"] <= 1.0 + 1e-6, (name, h)
    assert th.pack_summary(ts.pack_health)["saturation_rate_max"] == 0.0


def test_session_prefill_and_decode_match_jax(world):
    """Prefill and three decode steps within the logit tolerance of the JAX
    session, every packed matmul on dequant-fp and none kernel-eligible."""
    jcfg, ts, js = world["jcfg"], world["ts"], world["js"]
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, 13).astype(
        np.int32)
    cap = 20
    j_prefill = jax.jit(lambda p, t: js.prefill(p, {"tokens": t},
                                                prefill_cap=cap))
    j_decode = jax.jit(js.decode)
    ts.route_counts = dispatch.Counts()
    jl, jst = j_prefill(js.params, jnp.asarray(toks)[None])
    tl, tst = ts.prefill(ts.params, torch.from_numpy(toks)[None],
                         prefill_cap=cap)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    jst, tst = js.state_per_slot(jst), ts.state_per_slot(tst)
    tok = int(np.asarray(jl).argmax())
    for step in range(3):
        pos = 13 + step
        jl, jst = j_decode(js.params, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray([pos], jnp.int32), jst)
        tl, tst = ts.decode(ts.params, torch.tensor([[tok]],
                                                    dtype=torch.int32),
                            torch.tensor([pos], dtype=torch.int32), tst)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)
        tok = int(np.asarray(jl).argmax())
    routes = ts.route_counts.routes["matmul"]
    assert set(routes) == {"dequant-fp"} and routes["dequant-fp"] > 0
    assert ts.route_counts.eligible_fp == 0
    for pl in _leaves(ts.params, tpacking.PackedLinear).values():
        assert dispatch.resolve(KERNEL_EQN, pl, torch.device("cuda")) == \
            "dequant-fp"


def test_engine_matches_jax_engine(world):
    """Four requests on two slots: the same decode steps as the JAX packed
    engine and its greedy tokens on every decisive step."""
    jcfg, tcfg, js = world["jcfg"], world["tcfg"], world["js"]
    gens = [6, 3, 5, 2]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab, 10).astype(np.int32)
               for _ in gens]
    je = jeng.DecodeEngine(js.params, jcfg, None, js.ctx, adapter=js,
                           ecfg=jeng.EngineConfig(
                               slots=2, cache_len=16, prefill_chunk=10,
                               kv_quant="int8", trace=False))
    je.submit_all([JRequest(i, p, g) for i, (p, g) in
                   enumerate(zip(prompts, gens))])
    jout = je.run()
    ts = world["ts"]
    te, tout = tserve.run_engine(
        None, tcfg, None, ts.ctx,
        [TRequest(i, p, g) for i, (p, g) in enumerate(zip(prompts, gens))],
        scfg=tserve.ServeConfig(arch=tcfg.name, slots=2, cache_len=16,
                                prefill_chunk=10, bucket=False),
        device="cpu", adapter=ts)
    assert te.stats.decode_steps == je.stats.decode_steps
    compared = 0
    for rid, c in tout.items():
        assert len(c.tokens) == len(jout[rid].tokens) == gens[rid]
        n, miss = teng.decisive_prefix(jout[rid].tokens, c.tokens,
                                       te.margins[rid], DECISIVE)
        assert miss is None, (rid, jout[rid].tokens, c.tokens)
        compared += n
    assert compared >= len(gens)


# ---------------------------------------------------------------------------
# every tree of a speculative and an elastic session
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def demo():
    jcfg, tcfg = j_smoke("limpq-demo"), t_smoke("limpq-demo")
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(2), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def test_spec_session_packs_target_and_draft_per_channel(demo):
    jcfg, tcfg, jparams, tparams = demo
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    js = jsession.SpecSession(jcfg, jparams, jpol, draft_w_bits=2,
                              per_channel=True)
    ts = tsession.SpecSession(tcfg, tparams, tpol, draft_w_bits=2,
                              per_channel=True)
    _same_leaves(ts.params, js.params)
    draft = _same_leaves(ts.draft_params, js.draft_params)
    assert {pl.w_bits for pl in draft.values()} == {2}
    assert ts.draft_bytes() == jpacking.tree_packed_bytes(js.draft_params)
    for name, h in ts.draft_pack_health.items():
        assert h["saturation_rate"] == 0.0, name
        assert h["n_saturated"] == js.draft_pack_health[name]["n_saturated"]


def test_elastic_session_packs_every_variant_per_channel(demo):
    jcfg, tcfg, jparams, tparams = demo
    jql, tql = jlm.enumerate_qlayers(jcfg), tlm.enumerate_qlayers(tcfg)
    jbank = jelastic.build_variant_bank(
        jql, jcfg.bits, (3.0, 4.0, 6.0),
        family=jsession.bank_fingerprint(jparams))
    tbank = telastic.build_variant_bank(
        tql, tcfg.bits, (3.0, 4.0, 6.0),
        family=tsession.bank_fingerprint(tparams))
    js = jsession.ElasticSession(jcfg, jparams, jbank.policies,
                                 active=jbank.full, per_channel=True)
    ts = tsession.ElasticSession(tcfg, tparams, tbank.policies,
                                 tserve.make_context(tcfg),
                                 active=tbank.full, per_channel=True)
    assert ts.variants.keys() == js.variants.keys()
    assert len(ts.variants) == 3
    for pid in ts.variants:
        _same_leaves(ts.variants[pid], js.variants[pid])
        assert all(h["saturation_rate"] == 0.0
                   for h in ts.variant_pack_health[pid].values()), pid
    assert ts.variant_bytes() == {
        pid: jpacking.tree_packed_bytes(t) for pid, t in js.variants.items()}


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------
def test_mixed_precision_serving_example_runs_on_the_cpu(capsys):
    """``examples/mixed_precision_serving_torch.py --device cpu`` to its
    end: the search at 10x, prefill and 15 decode steps, and the int8
    matmul (its plain version here) against the fake-quant graph."""
    import importlib.util
    path = ROOT / "examples" / "mixed_precision_serving_torch.py"
    spec = importlib.util.spec_from_file_location("mps_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("policy: ") and "compression" in lines[0]
    assert any(line.startswith("decode 15 steps") for line in lines)
    last = lines[-1]
    assert last.startswith("int8 kernel vs fake-quant graph")
    assert float(last.split("max_err=")[1]) < 1e-5
