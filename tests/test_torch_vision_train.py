"""The vision family's training slice (llama-3.2-vision-11b through the paper
pipeline: joint importance training, indicator extraction, the ILP, QAT),
port against the JAX reference, on the CPU.

Config: llama-3.2-vision-11b's smoke config, one unit of its pattern: 5
self-attention layers, then a gated cross-attention layer over 16 image
tokens of 1280 (through the 8-bit pinned ``img_proj``). JAX's own
``lm.init_params`` weights cross over through ``repro_torch.interop``; the
batches come from the data module, ``img`` included.

The reference inits the cross layer's ``gate_attn`` and ``gate_mlp`` to 0:
tanh(0) = 0 hides the cross site's output, so its 14 bank leaves (``s_w``
and ``s_a`` of wq, wk, wv, wo, mlp_wi, mlp_wg, mlp_wo) get a gradient of
exactly 0 in both packages and importance training cannot move them (the
last test pins this). Every other comparison sets both gates to 0.5.

Tolerances: ``tests/test_torch_moe_train.py``'s TIGHT / LOOSE contract (a
2-6-bit grid turns a last-bit difference between XLA's and PyTorch's
float32 into a code step now and then); every cross bank's gradient is held
to LOOSE's gradient tolerance on its own. Indicator extraction reads the
same float32 banks in float64: rtol 1e-12.
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
from repro.core import search as jsearch                     # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.models.quant_layers import QuantContext as JQC    # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch import optim as toptim                      # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core import importance as timp              # noqa: E402
from repro_torch.core import search as tsearch               # noqa: E402
from repro_torch.data import SyntheticLM                     # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.models.quant_layers import QuantContext as TQC  # noqa: E402
from repro_torch.training import value_and_grad              # noqa: E402

ARCH = "llama-3.2-vision-11b"
TIGHT = (1e-5, 1e-4)      # tests/test_torch_train.py
LOOSE = (1e-3, 1e-1)
GATE = 0.5
CROSS_PROJ = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wg", "mlp_wo")


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


def _cross_site(cfg) -> str:
    """The cross layer's body index ("5")."""
    sites = [s for s in tlm.iter_sites(cfg) if s.kind == "cross"]
    assert len(sites) == 1
    return sites[0].segment.split(".")[1]


def _cross_banks(flat, idx):
    keys = [f"body/{idx}/{p}/{s}" for p in CROSS_PROJ for s in ("s_w", "s_a")]
    assert all(k in flat for k in keys)
    return keys


def _with_gates(flat, idx, value):
    out = dict(flat)
    for g in ("gate_attn", "gate_mlp"):
        out[f"body/{idx}/{g}"] = np.full_like(flat[f"body/{idx}/{g}"], value)
    return out


def _pair(jtemplate, flat):
    """(JAX params, port params) of one flat numpy tree."""
    jp = jax.tree.map(jnp.asarray, jckpt._unflatten(jtemplate, flat))
    return jp, interop.params_from_numpy(flat, "cpu")


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    assert jcfg.family == tcfg.family == "vlm" and tcfg.n_image_tokens == 16
    idx = _cross_site(tcfg)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    flat = jckpt._flatten(jparams)
    assert not np.any(flat[f"body/{idx}/gate_attn"])   # the reference's init
    # distinct banks per layer, so extraction and the ILP see a real table
    r = np.random.default_rng(3)
    for k in flat:
        if k.endswith(("s_w", "s_a")):
            flat[k] = (flat[k] * r.uniform(0.5, 1.5, flat[k].shape)).astype(
                np.float32)
    flat = _with_gates(flat, idx, GATE)
    jparams, tparams = _pair(jparams, flat)
    batch = SyntheticLM(tcfg).batch(0, 2, 32)
    assert batch["img"].shape == (2, 16, 1280)
    jctx = JQC.make(jcfg.bits, jcfg.quant_act_signed,
                    compute_dtype=jnp.float32)
    tctx = TQC.make(tcfg.bits, tcfg.quant_act_signed,
                    compute_dtype=torch.float32)
    # one compiled JAX loss-and-gradient for every assignment and param set
    jvg = jax.jit(jax.value_and_grad(lambda p, b, bits: jlm.loss_fn(
        p, jcfg, b, bits, jctx)[0]))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                flat=flat, batch=batch, idx=idx, tctx=tctx, jvg=jvg)


def _rand_bits(jcfg, seed):
    """One communication-pass assignment, drawn in numpy for both
    packages."""
    r = np.random.default_rng(seed)
    leaves, tdef = jax.tree.flatten(jlm.bits_uniform(jcfg, 0))
    return jax.tree.unflatten(tdef, [
        r.integers(0, jcfg.n_bits, np.shape(x)).astype(np.int32)
        for x in leaves])


def _grads(world, jparams, tparams, jb, tb):
    """(JAX loss, JAX flat grads, port loss, port flat grads) of one
    assignment on the world's batch, image included."""
    tcfg, batch = world["tcfg"], world["batch"]
    jl, jg = world["jvg"](jparams, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jb)
    tl, _, tg = value_and_grad(lambda p: tlm.loss_fn(
        p, tcfg, batch, tb, world["tctx"]), tparams)
    return (float(jl), jckpt._flatten(jax.tree.map(np.asarray, jg)),
            float(tl), _flat(tg))


# ---------------------------------------------------------------------------
# the model: loss and gradients
# ---------------------------------------------------------------------------
def test_loss_and_grads_match_jax(world):
    """``loss_fn`` and every gradient (the gates' and the pinned image
    projection's included) at each uniform width and one random
    assignment; each cross bank's gradient on its own."""
    jcfg, tcfg, idx = world["jcfg"], world["tcfg"], world["idx"]
    rand = _rand_bits(jcfg, 7)
    assignments = [(jlm.bits_uniform(jcfg, k), tlm.bits_uniform(tcfg, k))
                   for k in range(jcfg.n_bits)]
    assignments.append((jax.tree.map(jnp.asarray, rand), rand))
    tight = 0
    for jb, tb in assignments:
        jl, fj, tl, ft = _grads(world, world["jparams"], world["tparams"],
                                jb, tb)
        assert ft.keys() == fj.keys()
        assert "img_proj/w" in ft and f"body/{idx}/gate_attn" in ft
        dl = abs(tl - jl) / abs(jl)
        dg = _rel(ft, fj)
        assert dl <= LOOSE[0] and dg <= LOOSE[1], (dl, dg)
        for k in _cross_banks(fj, idx) + [f"body/{idx}/gate_attn",
                                          f"body/{idx}/gate_mlp"]:
            assert np.abs(fj[k]).sum() > 0, k
            assert _rel(ft, fj, [k]) <= LOOSE[1], (k, _rel(ft, fj, [k]))
        tight += dl <= TIGHT[0] and dg <= TIGHT[1]
    assert tight >= jcfg.n_bits, tight


def test_cross_banks_get_no_gradient_with_the_gates_at_zero(world):
    """At the reference's init (both gates 0) the cross site's 14 bank
    leaves get a gradient of exactly 0 in both packages and the gates do
    not: importance training from that init cannot move the cross banks,
    which is why the card's vision training sets the gates first."""
    idx = world["idx"]
    flat0 = _with_gates(world["flat"], idx, 0.0)
    jp, tp = _pair(world["jparams"], flat0)
    jl, fj, tl, ft = _grads(world, jp, tp, jlm.bits_uniform(world["jcfg"], 2),
                            tlm.bits_uniform(world["tcfg"], 2))
    for k in _cross_banks(fj, idx):
        assert not np.any(fj[k]), k
        assert not np.any(ft[k]), k
    for g in ("gate_attn", "gate_mlp"):
        k = f"body/{idx}/{g}"
        assert np.all(fj[k] != 0) and np.all(ft[k] != 0), k
    # the self-attention layers' banks still learn
    assert np.abs(ft["body/0/wq/s_w"]).sum() > 0
    assert abs(tl - jl) / abs(jl) <= LOOSE[0]


# ---------------------------------------------------------------------------
# the pipeline: an importance step, indicators, the ILP
# ---------------------------------------------------------------------------
def test_importance_step_matches_jax(world, monkeypatch):
    """One joint step of ``train_importance`` (the uniform passes + a
    numpy-drawn random pass, SGD on the banks only) on a two-width menu:
    every bank agrees and moved (the cross site's 14 too), the backbone
    (gates and image projection included) is bit for bit the input on both
    sides, and the extracted indicators agree."""
    jcfg = world["jcfg"].scaled(bits=(3, 6))
    tcfg = world["tcfg"].scaled(bits=(3, 6))
    idx = world["idx"]
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    flat = _with_gates(jckpt._flatten(jparams), idx, GATE)
    jp0, tp0 = _pair(jparams, flat)
    rand = _rand_bits(jcfg, 8)
    monkeypatch.setattr(jlm, "bits_random",
                        lambda cfg, rng: jax.tree.map(jnp.asarray, rand))
    monkeypatch.setattr(tlm, "bits_random", lambda cfg, gen: rand)
    jctx = JQC.make(jcfg.bits, True, compute_dtype=jnp.float32)
    tctx = TQC.make(tcfg.bits, True, compute_dtype=torch.float32)
    batch = world["batch"]
    jp1, jh = jimp.train_importance(
        jp0, jcfg, jctx, [{k: jnp.asarray(v) for k, v in batch.items()}],
        lr=0.01)
    tp1, th = timp.train_importance(tp0, tcfg, tctx, [batch], lr=0.01)
    np.testing.assert_allclose(th[0]["loss_uniform"],
                               np.asarray(jh[0]["loss_uniform"]),
                               rtol=LOOSE[0])
    j0, j1 = flat, jckpt._flatten(jp1)
    t1 = _flat(tp1)
    moved = []
    for key in j0:
        if key.endswith(("s_w", "s_a")):
            upd = np.abs(np.asarray(j1[key]) - j0[key]).max()
            np.testing.assert_allclose(t1[key], np.asarray(j1[key]), rtol=0,
                                       atol=LOOSE[1] * upd + 1e-9, err_msg=key)
            if upd > 0:
                moved.append(key)
        else:
            np.testing.assert_array_equal(t1[key], j0[key], err_msg=key)
            np.testing.assert_array_equal(np.asarray(j1[key]), t1[key],
                                          err_msg=key)
    cross = _cross_banks(j0, idx)
    assert set(cross) <= set(moved), sorted(set(cross) - set(moved))
    ind_t = timp.extract_indicators(tp1, tcfg)
    ind_j = jimp.extract_indicators(jp1, jcfg)
    assert list(ind_t) == list(ind_j)
    for name in ind_j:
        for wa in ("w", "a"):
            assert ind_t[name][wa].shape == (2,)
            np.testing.assert_allclose(ind_t[name][wa], ind_j[name][wa],
                                       rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("budget", [3, 4])
def test_extract_and_search_give_the_reference_policy(world, budget):
    """Every QLayer's indicators (the cross layer's 7 included) the
    reference's, and the ILP under a uniform-``budget``-bit BitOps budget
    the reference's policy."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    jql, tql = jlm.enumerate_qlayers(jcfg), tlm.enumerate_qlayers(tcfg)
    assert len(tql) == 42
    ind_t = timp.extract_indicators(world["tparams"], tcfg)
    ind_j = jimp.extract_indicators(world["jparams"], jcfg)
    assert list(ind_t) == list(ind_j)
    for name, d in ind_j.items():
        for wa in ("w", "a"):
            np.testing.assert_allclose(ind_t[name][wa], d[wa], rtol=1e-12,
                                       err_msg=name)
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
# the train CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["importance", "qat"])
def test_train_cli_runs_vision_on_the_cpu(mode, tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mode", mode,
            "--steps", "2"]
    if mode == "importance":
        argv += ["--save-indicators", str(tmp_path / "ind.json")]
    params = train.main(argv)
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "nan" not in out
    assert all(torch.isfinite(t).all() for t in toptim.tree_leaves(params))
    assert "img_proj" in params
    if mode == "importance":
        import json
        ind = json.loads((tmp_path / "ind.json").read_text())
        cfg = t_smoke(ARCH)
        assert len(ind) == len(tlm.enumerate_qlayers(cfg)) == 42
        assert all(len(d["w"]) == len(d["a"]) == cfg.n_bits
                   for d in ind.values())
