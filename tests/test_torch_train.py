"""The training slice, port against the JAX reference, on the CPU.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``; the
Pallas kernels run in interpret mode, as the reference's own tests run
them. Tolerances, and why:

* fake-quant forward and dv: atol 0 (single IEEE float32 operations and
  an integer rounding in both frameworks); ds sums in another order:
  rtol 1e-5 against the kernel's partials, and the reference's own
  ``tests/test_kernels.py:54-55`` (dv atol 1e-6, ds rtol 1e-3) against
  ``jax.grad`` of the STE composition.
* flash attention: out 2e-5, lse 1e-5 (``tests/test_kernels.py:152-158``);
  gradients of the recompute backward 2e-5 relative to each gradient's
  largest entry (float32 sums in another order).
* the model: a 2-6-bit grid turns a last-bit difference between XLA's and
  PyTorch's float32 (a norm, a summation order) into a whole code step now
  and then, which moves the loss by ~2e-4 relative and the gradients by a
  few percent (measured here: 1 of 6 bit assignments on Qwen3's smoke
  config). A wrong op moves every assignment, so each assignment must
  agree within LOOSE and at least 4 of the 6 within TIGHT.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                         # noqa: E402
from repro import optim as joptim                             # noqa: E402
from repro.configs import smoke_config as j_smoke             # noqa: E402
from repro.core import importance as jimp                     # noqa: E402
from repro.core import quantizer as jq                        # noqa: E402
from repro.core import search as jsearch                      # noqa: E402
from repro.kernels import fake_quant as jfq                   # noqa: E402
from repro.kernels import flash_attention as jfa              # noqa: E402
from repro.models import attention as jattn                   # noqa: E402
from repro.models import lm as jlm                            # noqa: E402
from repro.models.quant_layers import QuantContext as JQC     # noqa: E402
from repro_torch import interop                               # noqa: E402
from repro_torch import optim as toptim                       # noqa: E402
from repro_torch.configs import smoke_config as t_smoke       # noqa: E402
from repro_torch.core import importance as timp               # noqa: E402
from repro_torch.core import quantizer as tq                  # noqa: E402
from repro_torch.core import search as tsearch                # noqa: E402
from repro_torch.data import SyntheticLM                      # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402
from repro_torch.models import attention as tattn             # noqa: E402
from repro_torch.models import lm as tlm                      # noqa: E402
from repro_torch.models.quant_layers import QuantContext as TQC  # noqa: E402
from repro_torch.training import value_and_grad               # noqa: E402

# (loss rtol, gradient tree rtol in the L2 norm)
TIGHT = (1e-5, 1e-4)
LOOSE = (1e-3, 1e-1)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# fake-quant: plain versions vs the Pallas kernels, autograd vs jax.grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("shape", [(37, 1000), (300, 130)])
def test_fake_quant_plain_equals_pallas(bits, shape):
    r = np.random.default_rng(bits * 10 + shape[0])
    v = (r.standard_normal(shape) * 0.3).astype(np.float32)
    # an output gradient with a mean, so that ds is a well-conditioned sum
    # (zero-mean g cancels ds down to ~1e-4 of sum |g * dsd|, where float32
    # summation order alone moves it by more than 1e-5)
    g = (1 + 0.5 * r.standard_normal(shape)).astype(np.float32)
    s = np.float32(0.3 / 2 ** (bits - 1))
    qmin, qmax = (float(x) for x in jq.bit_range(bits, True))
    want = jfq.fake_quant_fwd(jnp.asarray(v), jnp.asarray(s), qmin, qmax,
                              interpret=True)
    got = ref.fake_quant_ref(torch.from_numpy(v), torch.tensor(s), qmin, qmax)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    dv_j, ds_part = jfq.fake_quant_bwd(jnp.asarray(v), jnp.asarray(s),
                                       jnp.asarray(g), qmin, qmax,
                                       interpret=True)
    dv_t, ds_t = ref.fake_quant_grads_ref(torch.from_numpy(v), torch.tensor(s),
                                          torch.from_numpy(g), qmin, qmax)
    np.testing.assert_array_equal(_np(dv_t), np.asarray(dv_j))
    np.testing.assert_allclose(float(ds_t), float(jnp.sum(ds_part)), rtol=1e-5)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quant_autograd_matches_jax_grad(bits):
    """The port's STE composition (CPU path of ``core.quantizer``) and the
    ``ops.fake_quant`` Function on its plain bodies (the CUDA path's op
    chain: floor, grad-scale, Function), against ``jax.grad``."""
    r = np.random.default_rng(bits)
    v = (r.standard_normal((48, 96)) * 0.2).astype(np.float32)
    s = np.float32(0.2 / 2 ** (bits - 1))
    qmin, qmax = jq.bit_range(bits, True)
    numel = v.size

    def f_j(v_, s_):
        g = jq.lsq_grad_scale_factor(numel, qmax)
        return jnp.sum(jnp.cos(jq.fake_quant(v_, s_, qmin, qmax,
                                             grad_scale_factor=g)))

    gv_j, gs_j = jax.grad(f_j, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(s))
    g_t = tq.lsq_grad_scale_factor(numel, qmax)

    def via_composition(vt, st):
        return tq.fake_quant(vt, st, qmin, qmax, grad_scale_factor=g_t)

    def via_function(vt, st):
        s_eff = tq.grad_scale(torch.clamp(st, min=1e-9), g_t)
        return ops.fake_quant(vt, s_eff, float(qmin), float(qmax))

    for f in (via_composition, via_function):
        vt = torch.from_numpy(v).requires_grad_(True)
        st = torch.tensor(s).requires_grad_(True)
        torch.cos(f(vt, st)).sum().backward()
        np.testing.assert_allclose(_np(vt.grad), np.asarray(gv_j), atol=1e-6)
        np.testing.assert_allclose(float(st.grad), float(gs_j), rtol=1e-3)


def test_plain_on_cuda_names_training_kernels_only():
    """The test-only switch takes the training kernels' names, nests, and
    leaves every kernel to its device's route when it exits."""
    with pytest.raises(ValueError):
        with ops.plain_on_cuda("quant_matmul"):
            pass
    with ops.plain_on_cuda("flash_fwd"):
        assert ops._PLAIN[-1] == {"flash_fwd"}
        with ops.plain_on_cuda():
            assert ops._PLAIN[-1] == set(ops.TRAIN_KERNELS)
        assert ops._PLAIN[-1] == {"flash_fwd"}
    assert ops._PLAIN[-1] == set()


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_CASES = [(True, None), (True, 96), (False, None)]


def _qkv(seed, B=2, S=256, H=4, KV=2, hd=32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, S, H, hd)).astype(np.float32),
            r.standard_normal((B, S, KV, hd)).astype(np.float32),
            r.standard_normal((B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("causal,window", FLASH_CASES)
def test_flash_fwd_plain_equals_pallas(causal, window):
    q, k, v = _qkv(1)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qr = q.reshape(B, S, KV, H // KV, hd) * np.float32(hd ** -0.5)
    out_j, lse_j = jfa.flash_fwd_pallas(
        jnp.asarray(qr), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_block=64, kv_block=64, interpret=True)
    out_t, lse_t = ops.flash_fwd(torch.from_numpy(qr), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window, q_block=64, kv_block=64)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(_np(lse_t), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal,window", FLASH_CASES)
def test_flash_attention_cv_values_and_grads_match_jax(causal, window):
    q, k, v = _qkv(2)
    dout = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_block=64, kv_block=64)

    def f_j(q_, k_, v_):
        return jnp.sum(jattn.flash_attention_cv(q_, k_, v_, **kw)
                       * jnp.asarray(dout))

    out_j = jattn.flash_attention_cv(*map(jnp.asarray, (q, k, v)), **kw)
    grads_j = jax.grad(f_j, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out_t = tattn.flash_attention_cv(*ts, **kw)
    (out_t * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), atol=2e-5,
                               rtol=2e-5)
    for t, gj in zip(ts, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(_np(t.grad), gj, rtol=0,
                                   atol=2e-5 * np.abs(gj).max())


def test_self_attention_switches_to_flash_at_the_threshold(monkeypatch):
    """The reference's switch, at a threshold lowered to 128 (q_block 64):
    S=128 takes the flash path, S=96 (below) and S=160 (not a multiple of
    the q block) the direct one; both agree with JAX's self_attention."""
    taken = []
    real = tattn.flash_attention_cv

    def spy(*a, **kw):
        taken.append(True)
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_cv", spy)
    kw = dict(causal=True, window=None, flash_threshold=128, q_block=64,
              kv_block=64)
    for S, flash in ((128, True), (96, False), (160, False)):
        q, k, v = _qkv(S, S=S)
        taken.clear()
        out_t = tattn.self_attention(*map(torch.from_numpy, (q, k, v)), **kw)
        assert bool(taken) == flash, S
        out_j = jattn.self_attention(*map(jnp.asarray, (q, k, v)), **kw)
        np.testing.assert_allclose(_np(out_t), np.asarray(out_j), atol=2e-5,
                                   rtol=2e-5)


# ---------------------------------------------------------------------------
# the model: loss and gradients, one importance step
# ---------------------------------------------------------------------------
def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        key = f"{pre}/{k}" if pre else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: _np(v)})
    return out


@pytest.fixture(scope="module")
def world():
    jcfg = j_smoke("qwen3-0.6b").scaled(head_dim=48)
    tcfg = t_smoke("qwen3-0.6b").scaled(head_dim=48)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    tokens = SyntheticLM(tcfg).batch(0, 2, 32)["tokens"]
    jctx = JQC.make(jcfg.bits, jcfg.quant_act_signed,
                    compute_dtype=jnp.float32)
    tctx = TQC.make(tcfg.bits, tcfg.quant_act_signed,
                    compute_dtype=torch.float32)
    # one communication-pass assignment, drawn in numpy for both packages
    r = np.random.default_rng(7)
    ubits = jlm.bits_uniform(jcfg, 0)
    leaves, tdef = jax.tree.flatten(ubits)
    rand = jax.tree.unflatten(tdef, [
        r.integers(0, jcfg.n_bits, np.shape(x)).astype(np.int32)
        for x in leaves])
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                tokens=tokens, jctx=jctx, tctx=tctx, rand=rand)


def _rel(a, b):
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float((b[k] ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def test_bits_trees_match_reference(world):
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    for k in range(jcfg.n_bits):
        jb = jax.tree.map(np.asarray, jlm.bits_uniform(jcfg, k))
        tb = tlm.bits_uniform(tcfg, k)
        assert jax.tree.structure(jb) == jax.tree.structure(tb)
        for a, b in zip(jax.tree.leaves(jb), jax.tree.leaves(tb)):
            np.testing.assert_array_equal(a, b)
    rb = tlm.bits_random(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.structure(rb) == jax.tree.structure(world["rand"])
    assert all(0 <= int(x) < tcfg.n_bits
               for leaf in jax.tree.leaves(rb) for x in np.ravel(leaf))


def test_loss_and_grads_match_jax(world):
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    toks = world["tokens"]
    jf = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(
        p, jcfg, {"tokens": jnp.asarray(toks)}, b, world["jctx"])[0]))
    assignments = [(jlm.bits_uniform(jcfg, k), tlm.bits_uniform(tcfg, k))
                   for k in range(jcfg.n_bits)]
    assignments.append((jax.tree.map(jnp.asarray, world["rand"]),
                        world["rand"]))
    tight = 0
    for jb, tb in assignments:
        jl, jg = jf(world["jparams"], jb)
        tl, metrics, tg = value_and_grad(lambda p: tlm.loss_fn(
            p, tcfg, {"tokens": toks}, tb, world["tctx"]), world["tparams"])
        assert set(metrics) == {"ce", "moe_aux", "loss"}
        dl = abs(float(tl) - float(jl)) / abs(float(jl))
        dg = _rel(_flat(tg), jckpt._flatten(jax.tree.map(np.asarray, jg)))
        assert dl <= LOOSE[0] and dg <= LOOSE[1], (dl, dg)
        tight += dl <= TIGHT[0] and dg <= TIGHT[1]
    assert tight >= 4, tight


def test_importance_step_matches_jax(world, monkeypatch):
    """One joint step (the uniform passes + a numpy-drawn random pass, SGD
    on the banks only) on a two-width menu, which keeps JAX's compile of the
    whole step short: updated banks agree, the backbone is bit for bit the
    input on both sides."""
    jcfg = world["jcfg"].scaled(bits=(3, 6))
    tcfg = world["tcfg"].scaled(bits=(3, 6))
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    tp0 = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    r = np.random.default_rng(8)
    leaves, tdef = jax.tree.flatten(jlm.bits_uniform(jcfg, 0))
    rand = jax.tree.unflatten(tdef, [
        r.integers(0, jcfg.n_bits, np.shape(x)).astype(np.int32)
        for x in leaves])
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
    moved = 0
    for key in j0:
        if key.endswith(("s_w", "s_a")):
            # each bank entry agrees to LOOSE's gradient tolerance of the
            # bank's largest update (a pass may carry a code step)
            upd = np.abs(np.asarray(j1[key]) - np.asarray(j0[key])).max()
            np.testing.assert_allclose(t1[key], np.asarray(j1[key]), rtol=0,
                                       atol=LOOSE[1] * upd + 1e-9, err_msg=key)
            moved += upd > 0
        else:
            np.testing.assert_array_equal(t1[key], np.asarray(j0[key]),
                                          err_msg=key)
            np.testing.assert_array_equal(np.asarray(j1[key]), t1[key],
                                          err_msg=key)
    assert moved > 0
    ind_t = timp.extract_indicators(tp1, tcfg)
    ind_j = jimp.extract_indicators(jp1, jcfg)
    assert list(ind_t) == list(ind_j)
    for name in ind_j:
        for wa in ("w", "a"):
            np.testing.assert_allclose(ind_t[name][wa], ind_j[name][wa],
                                       rtol=1e-3, err_msg=name)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def _trees(seed, n=3):
    r = np.random.default_rng(seed)
    shapes = {"a": {"w": (4, 3), "s_w": (5,)}, "b": {"s_a": (2, 5)},
              "c": (7,)}

    def one():
        return {k: ({kk: r.standard_normal(sh).astype(np.float32)
                     for kk, sh in v.items()} if isinstance(v, dict)
                    else r.standard_normal(v).astype(np.float32))
                for k, v in shapes.items()}
    return [one() for _ in range(n)]


def _to(tree, f):
    return {k: _to(v, f) if isinstance(v, dict) else f(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["sgd", "sgd_clip_masked", "adamw",
                                  "adamw_cosine_wd_clip"])
def test_optimizers_match_jax(name):
    params, *grads = _trees(5, 4)
    sched_j = joptim.cosine_warmup(0.1, 2, 6)
    sched_t = toptim.cosine_warmup(0.1, 2, 6)
    if name == "sgd":
        oj, ot = joptim.sgd(0.05, 0.9), toptim.sgd(0.05, 0.9)
    elif name == "sgd_clip_masked":
        oj = joptim.masked(joptim.sgd(0.05, 0.9, clip_norm=0.5),
                           joptim.indicator_only_mask)
        ot = toptim.masked(toptim.sgd(0.05, 0.9, clip_norm=0.5),
                           toptim.indicator_only_mask)
    elif name == "adamw":
        oj, ot = joptim.adamw(3e-3), toptim.adamw(3e-3)
    else:
        oj = joptim.adamw(sched_j, weight_decay=0.1, clip_norm=1.0)
        ot = toptim.adamw(sched_t, weight_decay=0.1, clip_norm=1.0)
    pj, pt = _to(params, jnp.asarray), _to(params, torch.from_numpy)
    sj, st = oj.init(pj), ot.init(pt)
    for g in grads:
        uj, sj = oj.update(_to(g, jnp.asarray), sj, pj)
        ut, st = ot.update(_to(g, torch.from_numpy), st, pt)
        pj, pt = joptim.apply_updates(pj, uj), toptim.apply_updates(pt, ut)
    for a, b in zip(jax.tree.leaves(pj), toptim.tree_leaves(pt)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


def test_schedule_and_clip_match_jax():
    for step in range(9):
        np.testing.assert_allclose(
            float(toptim.cosine_warmup(0.3, 3, 8, 0.1)(step)),
            float(joptim.cosine_warmup(0.3, 3, 8, 0.1)(step)), rtol=1e-6)
    tree = _trees(9, 1)[0]
    cj, nj = joptim.clip_by_global_norm(_to(tree, jnp.asarray), 0.7)
    ct, nt = toptim.clip_by_global_norm(_to(tree, torch.from_numpy), 0.7)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(cj), toptim.tree_leaves(ct)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6)


# ---------------------------------------------------------------------------
# search, CLI
# ---------------------------------------------------------------------------
def test_search_gives_the_reference_policy():
    jcfg = j_smoke("qwen3-0.6b")
    tcfg = t_smoke("qwen3-0.6b")
    jql, tql = jlm.enumerate_qlayers(jcfg), tlm.enumerate_qlayers(tcfg)
    assert [q.name for q in jql] == [q.name for q in tql]
    r = np.random.default_rng(4)
    ind = {q.name: {"w": np.sort(r.uniform(0.01, 0.5, 5))[::-1],
                    "a": np.sort(r.uniform(0.01, 0.5, 5))[::-1]}
           for q in tql}
    for bud in (3, 4):
        rj = jsearch.search_policy(jql, ind, jcfg.bits, alpha=1.0,
                                   bitops_budget=jsearch.bitops_budget_for_uniform(jql, bud))
        rt = tsearch.search_policy(tql, ind, tcfg.bits, alpha=1.0,
                                   bitops_budget=tsearch.bitops_budget_for_uniform(tql, bud))
        assert rt.policy.w_bits == rj.policy.w_bits
        assert rt.policy.a_bits == rj.policy.a_bits
        assert rt.bitops == rj.bitops


@pytest.mark.parametrize("mode", ["importance", "qat"])
def test_train_cli_runs_on_the_cpu(mode, tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--smoke", "--device", "cpu", "--mode", mode, "--steps", "2"]
    if mode == "importance":
        argv += ["--save-indicators", str(tmp_path / "ind.json")]
    params = train.main(argv)
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "nan" not in out
    assert all(torch.isfinite(t).all() for t in toptim.tree_leaves(params))
    if mode == "importance":
        assert (tmp_path / "ind.json").exists()


def test_train_cli_raises_without_a_card():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--mode", "qat", "--steps", "1"])
