"""The MoE family's training slice (deepseek-moe-16b through the paper
pipeline: joint importance training, indicator extraction, the ILP, QAT),
port against the JAX reference, on the CPU.

Config: deepseek-moe-16b's smoke config (3 layers: one dense layer, then
two MoE layers of 8 experts, top-2, 2 shared experts). JAX's own
``lm.init_params`` weights cross over through ``repro_torch.interop``.

Tolerances, and why:

* indicator extraction reads the same float32 banks in both packages and
  averages an expert bank over its expert dim in float64: rtol 1e-12.
* the per-slice LSQ backward (a per-expert ``(E, 1, 1)`` scale): dv
  exactly the straight-through mask of the reference's ``v / s``; against
  ``jax.grad`` of the reference's STE composition with the same broadcast
  scale, dv atol 1e-6 and ds rtol 1e-3, the reference's own
  ``tests/test_kernels.py:54-55`` (jax.grad reaches dv as ``(g * s) / s``,
  which rounds off ``g`` in the last bit now and then, and ds through
  ``v / s`` and ``* s``, summed in another order).
* the model: ``tests/test_torch_train.py``'s LOOSE / TIGHT contract (a
  2-6-bit grid turns a last-bit difference between XLA's and PyTorch's
  float32 into a code step now and then); every MoE bank leaf's gradient is
  held to LOOSE's gradient tolerance on its own.
* inside the port, the kernels' autograd ``Function`` (the card's route,
  here on its plain versions) against the STE composition (the CPU's
  route): the forward is one op chain, so the loss is bit for bit; dv is
  ``g`` where the STE path computes ``(g * s) / s``, and ds sums in another
  order: the gradient tree within 1e-5 (relative L2).
"""
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
from repro.core import importance as jimp                    # noqa: E402
from repro.core import quantizer as jq                       # noqa: E402
from repro.core import search as jsearch                     # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.models.quant_layers import QuantContext as JQC    # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch import optim as toptim                      # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core import importance as timp              # noqa: E402
from repro_torch.core import quantizer as tq                 # noqa: E402
from repro_torch.core import search as tsearch               # noqa: E402
from repro_torch.data import SyntheticLM                     # noqa: E402
from repro_torch.kernels import ops, ref                     # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.models import quant_layers as tql           # noqa: E402
from repro_torch.models.quant_layers import QuantContext as TQC  # noqa: E402
from repro_torch.training import value_and_grad              # noqa: E402

ARCH = "deepseek-moe-16b"
TIGHT = (1e-5, 1e-4)      # tests/test_torch_train.py
LOOSE = (1e-3, 1e-1)
MOE_BANK = ("wi/s_w", "wi/s_a", "wg/s_w", "wg/s_a", "wo/s_w", "wo/s_a")


def _np(t):
    return t.detach().cpu().numpy()


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        key = f"{pre}/{k}" if pre else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: _np(v)})
    return out


def _rel(a, b, keys=None):
    keys = list(b) if keys is None else keys
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
    den = sum(float((b[k] ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def _moe_banks(flat):
    """The expert stacks' bank leaves, (MoE layers, E, n_bits) each."""
    return [k for k in flat if "/moe/" in k and k.endswith(MOE_BANK)
            and "shared" not in k]


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    flat = jckpt._flatten(jparams)
    # distinct banks per expert (the init makes every expert's bank the
    # same), so an extraction that keeps the expert dim or takes one expert
    # is told apart from the expert mean
    r = np.random.default_rng(3)
    for k in flat:
        if k.endswith(("s_w", "s_a")):
            flat[k] = (flat[k] * r.uniform(0.5, 1.5, flat[k].shape)).astype(
                np.float32)
    jparams = jax.tree.map(jnp.asarray, jckpt._unflatten(jparams, flat))
    tparams = interop.params_from_numpy(flat, "cpu")
    tokens = SyntheticLM(tcfg).batch(0, 2, 32)["tokens"]
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                flat=flat, tokens=tokens)


def _rand_bits(jcfg, seed):
    """One communication-pass assignment, drawn in numpy for both
    packages."""
    r = np.random.default_rng(seed)
    leaves, tdef = jax.tree.flatten(jlm.bits_uniform(jcfg, 0))
    return jax.tree.unflatten(tdef, [
        r.integers(0, jcfg.n_bits, np.shape(x)).astype(np.int32)
        for x in leaves])


# ---------------------------------------------------------------------------
# indicator extraction and the ILP on it
# ---------------------------------------------------------------------------
def test_extract_indicators_on_a_moe_tree_match_reference(world):
    """Every QLayer's indicators are ``(n_bits,)`` float64 magnitudes, an
    expert stack's the mean over its experts' banks: the reference's
    values."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    ind_t = timp.extract_indicators(world["tparams"], tcfg)
    ind_j = jimp.extract_indicators(world["jparams"], jcfg)
    assert list(ind_t) == list(ind_j)
    stacks = [q.name for q in tlm.enumerate_qlayers(tcfg) if q.n_mats > 1]
    assert stacks
    for name, d in ind_j.items():
        for wa in ("w", "a"):
            got = ind_t[name][wa]
            assert got.shape == (tcfg.n_bits,) and got.dtype == np.float64
            np.testing.assert_allclose(got, d[wa], rtol=1e-12, err_msg=name)
    # an expert stack's indicator is its experts' mean, not one expert's
    q = next(q for q in tlm.enumerate_qlayers(tcfg) if q.n_mats > 1)
    seg, idx = q.segment.split(".")
    bank = world["tparams"][seg][idx]
    for k in q.path:
        bank = bank[k]
    s_w = _np(bank["s_w"])[q.unit].astype(np.float64)
    assert s_w.shape == (tcfg.moe.n_experts, tcfg.n_bits)
    np.testing.assert_allclose(ind_t[q.name]["w"], np.abs(s_w.mean(0)),
                               rtol=1e-12)
    assert not np.allclose(ind_t[q.name]["w"], np.abs(s_w[0]))


@pytest.mark.parametrize("budget", [3, 4])
def test_search_on_moe_indicators_gives_the_reference_policy(world, budget):
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    jql, tql = jlm.enumerate_qlayers(jcfg), tlm.enumerate_qlayers(tcfg)
    ind_t = timp.extract_indicators(world["tparams"], tcfg)
    ind_j = jimp.extract_indicators(world["jparams"], jcfg)
    rj = jsearch.search_policy(
        jql, ind_j, jcfg.bits, alpha=1.0,
        bitops_budget=jsearch.bitops_budget_for_uniform(jql, budget))
    rt = tsearch.search_policy(
        tql, ind_t, tcfg.bits, alpha=1.0,
        bitops_budget=tsearch.bitops_budget_for_uniform(tql, budget))
    assert rt.policy.w_bits == rj.policy.w_bits
    assert rt.policy.a_bits == rj.policy.a_bits
    assert rt.bitops == rj.bitops
    rt.policy.validate(tql, bits=tcfg.bits)


# ---------------------------------------------------------------------------
# the LSQ backward with a scale per expert
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(8, 16, 32), (4, 3, 5)])
def test_fake_quant_grads_per_slice_match_jax_grad(bits, shape):
    """``ref.fake_quant_grads_ref`` with an (E, 1, 1) scale (E slices, a
    ragged one in the second shape) against ``jax.grad`` of the
    reference's fake-quant with the same broadcast scale; then the kernels'
    autograd Function (its plain versions on the CPU) and the STE
    composition through the grad-scale chain, against ``jax.grad`` with
    the LSQ grad-scale factor of the whole stack."""
    r = np.random.default_rng(bits + len(shape))
    v = (r.standard_normal(shape) * 0.2).astype(np.float32)
    g = (1 + 0.5 * r.standard_normal(shape)).astype(np.float32)
    qmin, qmax = jq.bit_range(bits, True)
    s = (r.uniform(0.5, 1.5, (shape[0], 1, 1)[:len(shape)])
         * 0.2 / 2 ** (bits - 1)).astype(np.float32)

    def f_j(v_, s_, gsf=None):
        return jnp.sum(jnp.asarray(g) * jq.fake_quant(
            v_, s_, qmin, qmax, grad_scale_factor=gsf))

    dv_j, ds_j = jax.grad(f_j, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(s))
    dv_t, ds_t = ref.fake_quant_grads_ref(torch.from_numpy(v),
                                          torch.from_numpy(s),
                                          torch.from_numpy(g), qmin, qmax)
    assert ds_t.shape == (shape[0],)
    # dv: exactly the straight-through mask of the reference's own v / s;
    # jax.grad reaches it as (g * s) / s, one rounding off g now and then
    vs = jnp.asarray(v) / jnp.maximum(jnp.asarray(s), 1e-9)
    np.testing.assert_array_equal(
        _np(dv_t), np.asarray(jnp.where((vs > qmin) & (vs < qmax), g, 0.0)))
    np.testing.assert_allclose(_np(dv_t), np.asarray(dv_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_np(ds_t), np.asarray(ds_j).reshape(-1),
                               rtol=1e-3)

    numel = v.size
    gv_j, gs_j = jax.grad(
        lambda a, b: f_j(a, b, jq.lsq_grad_scale_factor(numel, qmax)),
        argnums=(0, 1))(jnp.asarray(v), jnp.asarray(s))
    g_t = tq.lsq_grad_scale_factor(numel, qmax)

    def via_composition(vt, st):
        return tq.fake_quant(vt, st, qmin, qmax, grad_scale_factor=g_t)

    def via_function(vt, st):
        s_eff = tq.grad_scale(torch.clamp(st, min=1e-9), g_t)
        return ops.fake_quant(vt, s_eff, float(qmin), float(qmax))

    for f in (via_composition, via_function):
        vt = torch.from_numpy(v).requires_grad_(True)
        st = torch.from_numpy(s).requires_grad_(True)
        (torch.from_numpy(g) * f(vt, st)).sum().backward()
        assert st.grad.shape == s.shape
        np.testing.assert_allclose(_np(vt.grad), np.asarray(gv_j), atol=1e-6)
        np.testing.assert_allclose(_np(st.grad), np.asarray(gs_j), rtol=1e-3)


@pytest.mark.parametrize("shape", [(37, 1000), (5,), (3, 7, 11)])
def test_fake_quant_grads_with_one_scale_unchanged(shape):
    """At one scale the backward is the one of before: dv and the scalar
    ds bit for bit the one-scale formula."""
    r = np.random.default_rng(len(shape))
    v = torch.from_numpy((r.standard_normal(shape) * 0.3).astype(np.float32))
    g = torch.from_numpy((1 + 0.5 * r.standard_normal(shape)).astype(
        np.float32))
    for s in (torch.tensor(0.05), torch.tensor([0.05])):
        s_ = torch.clamp(s.to(torch.float32), min=1e-9)
        vs = v / s_
        inside = (vs > -8) & (vs < 7)
        c = torch.clamp(vs, -8, 7)
        want_ds = (g * torch.where(inside, torch.round(c) - vs, c)).sum()
        dv, ds = ref.fake_quant_grads_ref(v, s, g, -8.0, 7.0)
        assert ds.shape == () and torch.equal(ds, want_ds)
        assert torch.equal(dv, torch.where(inside, g, torch.zeros_like(g)))
        dv_o, ds_o = ops.fake_quant_bwd(v, s, g, -8.0, 7.0)
        assert torch.equal(dv_o, dv) and torch.equal(ds_o, ds)


# ---------------------------------------------------------------------------
# the model: loss and gradients, one importance step
# ---------------------------------------------------------------------------
def test_loss_and_grads_match_jax(world):
    """``loss_fn`` (CE + MoE aux) and every gradient at each uniform width
    and one random assignment; every MoE expert bank's gradient on its
    own."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    toks = world["tokens"]
    jctx = JQC.make(jcfg.bits, jcfg.quant_act_signed,
                    compute_dtype=jnp.float32)
    tctx = TQC.make(tcfg.bits, tcfg.quant_act_signed,
                    compute_dtype=torch.float32)
    jf = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(
        p, jcfg, {"tokens": jnp.asarray(toks)}, b, jctx)[0]))
    rand = _rand_bits(jcfg, 7)
    assignments = [(jlm.bits_uniform(jcfg, k), tlm.bits_uniform(tcfg, k))
                   for k in range(jcfg.n_bits)]
    assignments.append((jax.tree.map(jnp.asarray, rand), rand))
    tight = 0
    for jb, tb in assignments:
        jl, jg = jf(world["jparams"], jb)
        tl, metrics, tg = value_and_grad(lambda p: tlm.loss_fn(
            p, tcfg, {"tokens": toks}, tb, tctx), world["tparams"])
        assert float(metrics["moe_aux"].detach()) > 0
        ft = _flat(tg)
        fj = jckpt._flatten(jax.tree.map(np.asarray, jg))
        assert ft.keys() == fj.keys()
        banks = _moe_banks(fj)
        assert len(banks) == 6                  # 3 stacks x (s_w, s_a)
        dl = abs(float(tl) - float(jl)) / abs(float(jl))
        dg = _rel(ft, fj)
        assert dl <= LOOSE[0] and dg <= LOOSE[1], (dl, dg)
        for k in banks:
            assert np.abs(fj[k]).sum() > 0, k
            assert _rel(ft, fj, [k]) <= LOOSE[1], (k, _rel(ft, fj, [k]))
        tight += dl <= TIGHT[0] and dg <= TIGHT[1]
    assert tight >= 4, tight


def test_kernel_function_route_trains_the_expert_banks_as_ste(world,
                                                             monkeypatch):
    """The card's route into the model (``ops.fake_quant``, the autograd
    Function whose backward takes a ds per expert) against the CPU's STE
    composition on the same MoE loss: the same loss bit for bit, every
    gradient within 1e-5 (relative L2), each expert bank's too."""
    tcfg, toks = world["tcfg"], world["tokens"]
    tctx = TQC.make(tcfg.bits, tcfg.quant_act_signed,
                    compute_dtype=torch.float32)
    bits = tlm.bits_uniform(tcfg, 1)
    real = tql.fake_quant
    slices = []

    def through_function(v, s, qmin, qmax, *, grad_scale_factor=None):
        # core.quantizer.fake_quant's CUDA branch, taken on the CPU
        s = torch.clamp(torch.as_tensor(s).to(v.dtype), min=1e-9)
        s = tq.grad_scale(s, torch.as_tensor(grad_scale_factor).to(v.dtype))
        slices.append(ops.fq_scale_slices(v, s))
        return ops.fake_quant(v, s, float(qmin), float(qmax))

    out = {}
    for name, fn in (("ste", real), ("function", through_function)):
        monkeypatch.setattr(tql, "fake_quant", fn)
        ops.reset_launches()
        loss, _, g = value_and_grad(lambda p: tlm.loss_fn(
            p, tcfg, {"tokens": toks}, bits, tctx, remat=False),
            world["tparams"])
        out[name] = (loss, _flat(g))
    (l0, g0), (l1, g1) = out["ste"], out["function"]
    # per pass: 2 x 3 expert stacks x 2 MoE layers with a scale per expert
    assert slices.count(tcfg.moe.n_experts) == 12
    assert torch.equal(l0, l1)
    assert _rel(g1, g0) <= 1e-5
    for k in _moe_banks(g0):
        assert _rel(g1, g0, [k]) <= 1e-5, k


def test_importance_step_matches_jax(world, monkeypatch):
    """One joint step (the uniform passes + a numpy-drawn random pass, SGD
    on the banks only) on a two-width menu: every bank agrees (the expert
    banks moved), the backbone (router included) is bit for bit the input
    on both sides, and the extracted indicators agree."""
    jcfg = world["jcfg"].scaled(bits=(3, 6))
    tcfg = world["tcfg"].scaled(bits=(3, 6))
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    tp0 = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    rand = _rand_bits(jcfg, 8)
    monkeypatch.setattr(jlm, "bits_random",
                        lambda cfg, rng: jax.tree.map(jnp.asarray, rand))
    monkeypatch.setattr(tlm, "bits_random", lambda cfg, gen: rand)
    jctx = JQC.make(jcfg.bits, True, compute_dtype=jnp.float32)
    tctx = TQC.make(tcfg.bits, True, compute_dtype=torch.float32)
    jopt = jimp.importance_optimizer(0.01, freeze_backbone=True)
    jstep = jax.jit(jimp.make_importance_step(jcfg, jctx, jopt, remat=False))
    jp1, _, jm = jstep(jparams, jopt.init(jparams),
                       {"tokens": jnp.asarray(world["tokens"])},
                       jax.random.PRNGKey(0))
    topt = timp.importance_optimizer(0.01, freeze_backbone=True)
    tstep = timp.make_importance_step(tcfg, tctx, topt, remat=False)
    tp1, _, tm = tstep(tp0, topt.init(tp0), {"tokens": world["tokens"]},
                       torch.Generator())
    np.testing.assert_allclose(_np(tm["loss_uniform"]),
                               np.asarray(jm["loss_uniform"]), rtol=LOOSE[0])
    j0, j1 = jckpt._flatten(jparams), jckpt._flatten(jp1)
    t1 = _flat(tp1)
    moved = []
    for key in j0:
        if key.endswith(("s_w", "s_a")):
            upd = np.abs(np.asarray(j1[key]) - np.asarray(j0[key])).max()
            np.testing.assert_allclose(t1[key], np.asarray(j1[key]), rtol=0,
                                       atol=LOOSE[1] * upd + 1e-9, err_msg=key)
            if upd > 0:
                moved.append(key)
        else:
            np.testing.assert_array_equal(t1[key], np.asarray(j0[key]),
                                          err_msg=key)
            np.testing.assert_array_equal(np.asarray(j1[key]), t1[key],
                                          err_msg=key)
    banks = _moe_banks(j0)
    assert banks and set(banks) <= set(moved), sorted(set(banks) - set(moved))
    assert any("router" in k for k in j0)
    ind_t = timp.extract_indicators(tp1, tcfg)
    ind_j = jimp.extract_indicators(jp1, jcfg)
    assert list(ind_t) == list(ind_j)
    for name in ind_j:
        for wa in ("w", "a"):
            assert ind_t[name][wa].shape == (2,)
            np.testing.assert_allclose(ind_t[name][wa], ind_j[name][wa],
                                       rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("mode", ["importance", "qat"])
def test_train_cli_runs_deepseek_on_the_cpu(mode, tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mode", mode,
            "--steps", "2"]
    if mode == "importance":
        argv += ["--save-indicators", str(tmp_path / "ind.json")]
    params = train.main(argv)
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "nan" not in out
    assert all(torch.isfinite(t).all() for t in toptim.tree_leaves(params))
    if mode == "importance":
        import json
        ind = json.loads((tmp_path / "ind.json").read_text())
        cfg = t_smoke(ARCH)
        assert all(len(d["w"]) == len(d["a"]) == cfg.n_bits
                   for d in ind.values())
