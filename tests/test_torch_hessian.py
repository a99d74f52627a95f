"""The HAWQ Hessian-trace baseline (``repro_torch.core.hessian``), port
against the JAX reference (``repro.core.hessian``), on the CPU.

JAX's own weights cross over through ``repro_torch.interop``, and the
reference's own Rademacher probes are regenerated here with ``jax.random``
exactly as ``repro.core.hessian.hutchinson_traces`` draws them (one key per
QLayer per sample, the last key of a stacked body leaf winning) and handed
to the port. Tolerances, and why:

* the quantization perturbations: rtol 1e-5. The statistics-init scale is a
  float32 mean of |W|, summed in another order in each framework, so the
  two scales may sit an ulp apart; an ulp of the scale moves every
  dequantized value by up to qmax ulps, and the sum of squared errors by
  as much relative to itself (measured here up to 2.95e-6);
* the traces: ``<v, Hv>`` summed over a whole weight leaf, from a second
  derivative in float32 through both frameworks, within TRACE_RTOL of the
  reference trace plus TRACE_ATOL of the largest trace (measured here:
  up to ~2e-6 relative).

The reference's ``hutchinson_traces`` runs as written, but with its
``jax.jvp`` compiled whole (``_jit_jvp``): dispatched op by op it spends
~10 s per sequence length compiling each primitive on the CPU, ~4 s as
one program. The products are the same; only XLA's fusion of the float32
ops may differ.
"""
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                         # noqa: E402
from repro.configs import get_config as j_get                 # noqa: E402
from repro.core import hessian as jhess                       # noqa: E402
from repro.models import lm as jlm                            # noqa: E402
from repro_torch import interop                               # noqa: E402
from repro_torch.configs import get_config as t_get           # noqa: E402
from repro_torch.core import hessian as thess                 # noqa: E402
from repro_torch.models import attention as tattn             # noqa: E402
from repro_torch.models import lm as tlm                      # noqa: E402

TRACE_RTOL, TRACE_ATOL = 1e-4, 1e-5
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=64)


def test_hutchinson_on_quadratic():
    """loss = 0.5 x^T A x => H = A, Tr(H) known exactly (the reference's
    ``test_hutchinson_on_quadratic``): the port's reverse-over-reverse
    products on its Rademacher probes estimate it within rtol 0.25 over 400
    samples, and each product is A v."""
    rng = np.random.default_rng(0)
    n = 16
    A = rng.standard_normal((n, n))
    A = A @ A.T / n
    At = torch.as_tensor(A, dtype=torch.float32)
    x = torch.zeros(n, requires_grad=True)
    gen = torch.Generator().manual_seed(0)
    probes = ([thess.rademacher((n,), gen, "cpu")] for _ in range(400))
    est = 0.0
    for (v,), (hv,) in thess.hessian_vector_products(0.5 * x @ At @ x, [x],
                                                     probes):
        torch.testing.assert_close(hv, At @ v, rtol=1e-6, atol=1e-6)
        assert set(v.unique().tolist()) <= {-1.0, 1.0}
        est += float(v @ hv) / 400
    np.testing.assert_allclose(est, np.trace(A), rtol=0.25)


@pytest.fixture(scope="module")
def world():
    jcfg = j_get("limpq-demo").scaled(**TINY)
    tcfg = t_get("limpq-demo").scaled(**TINY)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    return jcfg, tcfg, jparams, tparams, tlm.enumerate_qlayers(tcfg)


def test_quantization_perturbations_match_jax(world):
    jcfg, tcfg, jparams, tparams, ql = world
    want = jhess.quantization_perturbations(jparams, jcfg,
                                            jlm.enumerate_qlayers(jcfg))
    got = thess.quantization_perturbations(tparams, tcfg, ql)
    assert got.keys() == want.keys()
    for name, errs in got.items():
        np.testing.assert_allclose(errs, want[name], rtol=1e-5)
        assert np.all(np.diff(errs) <= 1e-6), name     # decreasing with bits


class _JitJVP:
    """``jax`` as ``repro.core.hessian`` reads it, ``jvp`` compiled whole."""
    jvp = staticmethod(jax.jit(jax.jvp, static_argnums=0))

    def __getattr__(self, name):
        return getattr(jax, name)


def _reference_probes(jparams, qlayers, seed, n_samples):
    """The probes ``repro.core.hessian.hutchinson_traces`` draws from
    ``PRNGKey(seed)``: per sample one split, one key per QLayer, each a
    Rademacher draw over its QLayer's whole weight leaf."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_samples):
        rng, sub = jax.random.split(rng)
        keys = jax.random.split(sub, len(qlayers))
        out.append({q.name: np.asarray(jax.random.rademacher(
            key, jhess._weight_leaf(jparams, q).shape, jnp.float32))
            for key, q in zip(keys, qlayers)})
    return out


@pytest.mark.parametrize("S", [64, 2048])
def test_hutchinson_traces_match_jax_on_its_probes(world, S, monkeypatch):
    """Below S = 2048 both packages take the direct attention; at S = 2048
    the reference differentiates through its ``custom_vjp`` flash and the
    port through the plain ``"xla_scan"`` baseline, which
    ``hutchinson_traces`` selects (the kernel forward's saved logsumexp
    would drop a term of the second derivative). Every unit of a body slot
    gets the same trace, as in the reference."""
    jcfg, tcfg, jparams, tparams, ql = world
    jql = jlm.enumerate_qlayers(jcfg)
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab, (1, S)) \
        .astype(np.int32)
    with monkeypatch.context() as m:
        m.setattr(jhess, "jax", _JitJVP())
        want = jhess.hutchinson_traces(jparams, jcfg, {"tokens": tokens}, jql,
                                       jax.random.PRNGKey(11), n_samples=1)
    taken = []
    real = tattn.flash_attention

    def spy(*a, **kw):
        taken.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    got = thess.hutchinson_traces(
        tparams, tcfg, {"tokens": tokens}, ql, torch.Generator(),
        probes=_reference_probes(jparams, jql, 11, 1))
    assert len(taken) == (tcfg.n_layers if S >= 2048 else 0)
    assert tattn.FLASH_IMPL == "custom_vjp"
    assert got.keys() == want.keys()
    top = max(abs(t) for t in want.values())
    for name, t in got.items():
        assert abs(t - want[name]) <= TRACE_RTOL * abs(want[name]) + \
            TRACE_ATOL * top, (name, t, want[name])
    body = {}
    for q in ql:
        if q.segment.startswith("body."):
            body.setdefault((q.segment, q.path), set()).add(got[q.name])
    assert body and all(len(v) == 1 for v in body.values())


def test_hawq_table_feeds_the_search_monotone_in_bits(world):
    """The port's HAWQ table on its own probes: non-negative, non-increasing
    in bits per layer, activation half zero; the ILP on it under the
    uniform-3-bit BitOps budget gives a valid policy within budget."""
    from repro_torch.core import search
    _, tcfg, _, tparams, ql = world
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab, (1, 32))
    table = thess.hawq_sensitivities(tparams, tcfg, {"tokens": tokens},
                                     torch.Generator().manual_seed(0),
                                     qlayers=ql, n_samples=2)
    assert table.keys() == {q.name for q in ql}
    for name, t in table.items():
        assert np.all(t["w"] >= 0) and np.all(np.diff(t["w"]) <= 0), name
        assert not t["a"].any()
    budget = search.bitops_budget_for_uniform(ql, 3)
    res = search.search_policy(ql, table, tcfg.bits, alpha=1.0,
                               bitops_budget=budget)
    res.policy.validate(ql, bits=tcfg.bits)
    assert res.bitops <= budget * (1 + 1e-6)
