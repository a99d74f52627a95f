"""The audio family's training slice (hubert-xlarge: an encoder-only,
bidirectional transformer over frame embeddings from the stub frontend),
port against the JAX reference, on the CPU.

Config: hubert-xlarge's smoke config (2 layers, d_model 128, 4 heads of 32,
plain gelu d_ff 256, LayerNorm, 512 units) at S = 128, and for the flash
path a 1-layer config at the full head dim 80 (d_model 160, 2 heads) at
S = 2048, where attention switches to the flash path. JAX's own
``lm.init_params`` weights cross over through ``repro_torch.interop``; the
batches are the port's copy of the data module's audio branch (frames and
unit labels), equal to the reference's.

Tolerances, as ``tests/test_torch_train.py`` sets them: with quantization
off, loss and logits within TIGHT's loss rtol and the gradient tree within
its relative L2; with it on, every bit assignment within LOOSE and at least
4 of the 6 within TIGHT (a last-bit difference between XLA's and PyTorch's
float32 can land an activation on the other side of a code step). Flash:
out 2e-5, lse 1e-5 (``tests/test_kernels.py``). All tests share one
module-scoped world.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                         # noqa: E402
from repro.configs import get_config as j_get                 # noqa: E402
from repro.configs import smoke_config as j_smoke             # noqa: E402
from repro.core import importance as jimp                     # noqa: E402
from repro.core import policy as jpolicy                      # noqa: E402
from repro.data import SyntheticLM as JData                   # noqa: E402
from repro.kernels.flash_attention import flash_fwd_pallas    # noqa: E402
from repro.launch import engine as jeng                       # noqa: E402
from repro.launch import serve as jserve                      # noqa: E402
from repro.models import attention as jattn                   # noqa: E402
from repro.models import lm as jlm                            # noqa: E402
from repro.models import quant_layers as jql                  # noqa: E402
from repro_torch import interop                               # noqa: E402
from repro_torch.configs import get_config as t_get           # noqa: E402
from repro_torch.configs import smoke_config as t_smoke       # noqa: E402
from repro_torch.core import importance as timp               # noqa: E402
from repro_torch.core import policy as tpolicy                # noqa: E402
from repro_torch.data import SyntheticLM                      # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402
from repro_torch.launch import engine as teng                 # noqa: E402
from repro_torch.launch import serve as tserve                # noqa: E402
from repro_torch.models import attention as tattn             # noqa: E402
from repro_torch.models import lm as tlm                      # noqa: E402
from repro_torch.models import quant_layers as tql            # noqa: E402
from repro_torch.runtime.session import QuantizedSession      # noqa: E402
from repro_torch.training import value_and_grad               # noqa: E402

ARCH = "hubert-xlarge"
TIGHT = (1e-5, 1e-4)       # (loss rtol, gradient tree relative L2)
LOOSE = (1e-3, 1e-1)
B, S = 2, 128


def _np(t):
    return t.detach().cpu().numpy()


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        key = f"{pre}/{k}" if pre else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: _np(v)})
    return out


def _rel(a, b):
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float((b[k] ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def _ctxs(cfg, enabled):
    if not enabled:
        return jql.fp_context(jnp.float32), tql.fp_context(torch.float32)
    return (jql.QuantContext.make(cfg.bits, cfg.quant_act_signed,
                                  compute_dtype=jnp.float32),
            tql.QuantContext.make(cfg.bits, cfg.quant_act_signed,
                                  compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    batch = SyntheticLM(tcfg).batch(0, B, S)
    # one communication-pass assignment, drawn in numpy for both packages
    r = np.random.default_rng(7)
    leaves, tdef = jax.tree.flatten(jlm.bits_uniform(jcfg, 0))
    rand = jax.tree.unflatten(tdef, [
        r.integers(0, jcfg.n_bits, np.shape(x)).astype(np.int32)
        for x in leaves])
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                batch=batch, rand=rand)


# ---------------------------------------------------------------------------
# schedule, QLayer table, params, data
# ---------------------------------------------------------------------------
def test_schedule_qlayers_and_policy_bytes_match_reference():
    """The full config's schedule, its 288 QLayers in order (names, sites,
    paths, dims, MACs, weight counts, kinds) and a mixed policy's bytes are
    the reference's, and so are the MoE schedules; vlm still waits for its
    slice."""
    jcfg, tcfg = j_get(ARCH), t_get(ARCH)
    assert tuple(tlm.build_schedule(tcfg)) == tuple(jlm.build_schedule(jcfg))
    assert tlm.build_schedule(tcfg) == ((), ("attn",), 48, ())
    jq, tq = jlm.enumerate_qlayers(jcfg), tlm.enumerate_qlayers(tcfg)
    assert len(tq) == 288
    assert [dataclasses.astuple(q) for q in tq] == \
        [dataclasses.astuple(q) for q in jq]
    assert {q.path for q in tq} == {("wq",), ("wk",), ("wv",), ("wo",),
                                    ("mlp_wi",), ("mlp_wo",)}
    jp, tp = jserve.demo_mixed_policy(jcfg), tserve.demo_mixed_policy(tcfg)
    assert tp.w_bits == jp.w_bits and tp.a_bits == jp.a_bits
    assert tp.size_bytes(tq) == jp.size_bytes(jq)
    for b in (2, 4, 6):
        assert tpolicy.MPQPolicy.uniform(tq, b).size_bytes(tq) == \
            jpolicy.MPQPolicy.uniform(jq, b).size_bytes(jq)
    for name in ("mixtral-8x7b", "deepseek-moe-16b", "llama-3.2-vision-11b"):
        assert tuple(tlm.build_schedule(t_get(name))) == \
            tuple(jlm.build_schedule(j_get(name)))


def test_param_tree_and_data_match_reference(world):
    """The port's own init lays out the reference's tree at full width and
    depth (the 512 x 1280 pinned frontend, no vocab table, the untied
    pinned head, LayerNorm scale and bias, 48 stacked layers), key for key
    and shape for shape; the pinned leaves follow the reference's
    ``pinned_init``; the audio batches are the reference data module's."""
    want = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                  j_get(ARCH)))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(a.shape)
            for path, a in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {k: tuple(v.shape) for k, v in _shapes(
        tlm.init_params(t_get(ARCH), device="meta")).items()}
    assert got == want
    assert got["embed/w"] == (512, 1280) and got["head/w"] == (1280, 504)
    assert got["body/0/wq/w"] == (48, 1280, 1280)
    assert got["final_norm/bias"] == (1280,)
    # the pinned leaves of the port's init (smoke size)
    p = tlm.init_params(world["tcfg"], seed=3)
    for name, fan_in in (("embed", 512), ("head", world["tcfg"].d_model)):
        w = p[name]["w"]
        assert float(p[name]["s_a8"]) == np.float32(0.1 / 8)
        torch.testing.assert_close(
            p[name]["s_w8"], 2 * w.abs().mean() / torch.tensor(127.0).sqrt())
        assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.1
    jb = JData(world["jcfg"]).batch(0, B, S)
    assert set(jb) == set(world["batch"]) == {"feats", "labels"}
    for k in jb:
        np.testing.assert_array_equal(world["batch"][k], np.asarray(jb[k]))


def _shapes(tree, pre=""):
    out = {}
    for k, v in tree.items():
        key = f"{pre}/{k}" if pre else k
        out.update(_shapes(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_interop_carries_every_array(world):
    """Every reference array crosses unchanged: the frontend's and the
    head's w / s_w8 / s_a8, both LayerNorms' scale and bias, the stacked
    body's projections and banks."""
    flat = jckpt._flatten(world["jparams"])
    got = _flat(world["tparams"])
    assert set(got) == set(flat)
    for k, a in flat.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(a), err_msg=k)
    for k in ("embed/w", "embed/s_w8", "embed/s_a8", "head/w", "head/s_w8",
              "head/s_a8", "final_norm/scale", "final_norm/bias",
              "body/0/norm1/scale", "body/0/norm1/bias", "body/0/mlp_wi/s_w"):
        assert k in got, k
    assert got["embed/w"].shape == (512, world["tcfg"].d_model)
    assert got["body/0/wq/w"].shape[0] == world["tcfg"].n_layers


def test_sinusoid_table_matches_reference():
    """The position table within what one float32 rounding of the angle
    pos / 10000^(2i/d) moves a sine by: XLA's and PyTorch's ``pow`` part in
    the last bit on a few percent of the exponents (XLA's compiled and
    op-by-op ``pow`` part from each other too), so each entry is held to 2
    units in the last place of its angle."""
    for S_, d in ((128, 128), (2048, 1280)):
        want = np.asarray(jlm._sinusoid_pos(S_, d, jnp.float32))
        got = _np(tlm._sinusoid_pos(S_, d, torch.float32, "cpu"))
        assert got.shape == want.shape == (1, S_, d)
        ang = np.arange(S_, dtype=np.float64)[:, None] / 10000.0 ** (
            2 * np.arange(d // 2) / d)
        ulp = np.spacing(np.concatenate([ang, ang], -1).astype(np.float32))
        assert np.all(np.abs(got - want)[0] <= 2 * ulp + 2 ** -24)
        assert np.abs(got - want).mean() < 1e-7


# ---------------------------------------------------------------------------
# the model: logits, loss, gradients, one importance step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "quantized"])
def test_loss_and_grads_match_jax(world, quant):
    """The unshifted CE over every frame's label and the gradient tree of
    one step (and, quantization off, the logits). Quantization off: TIGHT.
    On: the five uniform assignments and a random one each within LOOSE, 4
    of 6 within TIGHT."""
    jcfg, tcfg, batch = world["jcfg"], world["tcfg"], world["batch"]
    jctx, tctx = _ctxs(jcfg, quant)
    jb_in = {k: jnp.asarray(v) for k, v in batch.items()}
    jf = jax.jit(jax.value_and_grad(
        lambda p, bits: jlm.loss_fn(p, jcfg, jb_in, bits, jctx)[0]))
    if quant:
        assignments = [(jlm.bits_uniform(jcfg, k), tlm.bits_uniform(tcfg, k))
                       for k in range(jcfg.n_bits)]
        assignments.append((jax.tree.map(jnp.asarray, world["rand"]),
                            world["rand"]))
    else:
        assignments = [(None, None)]
        jlogits, _ = jax.jit(lambda p: jlm.apply_train(
            p, jcfg, jb_in, None, jctx))(world["jparams"])
        tlogits, _ = tlm.apply_train(world["tparams"], tcfg, batch, None,
                                     tctx)
        assert tlogits.shape == (B, S, tcfg.vocab)
        np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits),
                                   rtol=0, atol=TIGHT[0] * float(
                                       np.abs(np.asarray(jlogits)).max()))
    tight = 0
    for jbits, tbits in assignments:
        jl, jg = jf(world["jparams"], jbits)
        tl, metrics, tg = value_and_grad(lambda p: tlm.loss_fn(
            p, tcfg, batch, tbits, tctx), world["tparams"])
        assert set(metrics) == {"ce", "moe_aux", "loss"}
        dl = abs(float(tl) - float(jl)) / abs(float(jl))
        dg = _rel(_flat(tg), jckpt._flatten(jax.tree.map(np.asarray, jg)))
        assert dl <= LOOSE[0] and dg <= LOOSE[1], (dl, dg)
        tight += dl <= TIGHT[0] and dg <= TIGHT[1]
    assert tight == 1 if not quant else tight >= 4, tight


def test_importance_step_freezes_the_backbone(world):
    """One joint step (the five uniform passes and a random one, SGD on the
    banks only) on the reference's weights: the backbone (the pinned
    frontend and head among it) bit for bit its input, every bank moved,
    each pass's loss finite and the uniform ones those of ``loss_fn``; the
    indicators carry the reference's keys in its order, and before the
    step the reference's values."""
    tcfg, jcfg, tp0 = world["tcfg"], world["jcfg"], world["tparams"]
    tctx = _ctxs(tcfg, True)[1]
    opt = timp.importance_optimizer(0.01, freeze_backbone=True)
    step = timp.make_importance_step(tcfg, tctx, opt, remat=False)
    tp1, _, m = step(tp0, opt.init(tp0), world["batch"],
                     torch.Generator().manual_seed(0))
    losses = m["loss_uniform"].tolist() + [float(m["loss_random"])]
    assert len(losses) == tcfg.n_bits + 1 and np.all(np.isfinite(losses))
    for k in (0, tcfg.n_bits - 1):
        want = tlm.loss_fn(tp0, tcfg, world["batch"], tlm.bits_uniform(tcfg, k),
                           tctx, remat=False)[0]
        assert losses[k] == float(want)
    t0, t1 = _flat(tp0), _flat(tp1)
    banks = [k for k in t0 if k.endswith(("s_w", "s_a"))]
    assert len(banks) == 2 * len(tlm.enumerate_qlayers(tcfg)) // tcfg.n_layers
    for key in t0:
        if key in banks:
            assert not np.array_equal(t1[key], t0[key]), key
        else:
            np.testing.assert_array_equal(t1[key], t0[key], err_msg=key)
    ind_j = jimp.extract_indicators(world["jparams"], jcfg)
    ind_t0 = timp.extract_indicators(tp0, tcfg)
    assert list(timp.extract_indicators(tp1, tcfg)) == list(ind_j) == \
        list(ind_t0)
    assert len(ind_j) == len(tlm.enumerate_qlayers(tcfg))
    for name in ind_j:
        for wa in ("w", "a"):
            np.testing.assert_array_equal(ind_t0[name][wa],
                                          np.asarray(ind_j[name][wa]))


# ---------------------------------------------------------------------------
# flash at head_dim 80, bidirectional
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window", [(False, None), (True, 48)])
def test_flash_plain_version_at_hd_80_matches_pallas(causal, window):
    """``ops.flash_fwd`` on CPU tensors (the plain version, no launch) at
    hubert's head dim against ``flash_fwd_pallas`` in interpret mode, in
    128-row blocks: out to 2e-5, lse to 1e-5."""
    rng = np.random.default_rng(80 + causal)
    Bf, Sf, KV, G, hd = 1, 256, 2, 1, 80
    q = (rng.standard_normal((Bf, Sf, KV, G, hd)) * hd ** -0.5
         ).astype(np.float32)
    k = rng.standard_normal((Bf, Sf, KV, hd)).astype(np.float32)
    v = rng.standard_normal((Bf, Sf, KV, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_block=128, kv_block=128)
    jo, jl = flash_fwd_pallas(*map(jnp.asarray, (q, k, v)), interpret=True,
                              **kw)
    n0 = ops.launches["flash_fwd"]
    out, lse = ops.flash_fwd(*map(torch.from_numpy, (q, k, v)), **kw)
    assert ops.launches["flash_fwd"] == n0
    np.testing.assert_allclose(_np(out), np.asarray(jo), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_np(lse), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    want, want_lse = ref.flash_fwd_ref(*map(torch.from_numpy, (q, k, v)),
                                       **kw)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert 80 in ops.FLASH_HEAD_DIMS


def test_flash_path_at_hd_80_matches_reference(monkeypatch):
    """A 1-layer encoder at the full head dim (d_model 160, 2 heads of 80)
    at S = 2048, where attention takes the flash path (the plain forward
    and the recompute backward here; the kernel on the card): loss and
    every gradient within TIGHT of the reference's ``flash_attention_cv``
    path, quantization off. The attention alone (S = 256 in 64-row
    blocks), out and q/k/v gradients, within 2e-5 of the reference's."""
    over = dict(d_model=160, n_heads=2, n_kv_heads=2, head_dim=80,
                n_layers=1)
    jcfg, tcfg = j_smoke(ARCH).scaled(**over), t_smoke(ARCH).scaled(**over)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(2), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    batch = SyntheticLM(tcfg).batch(1, 1, 2048)
    jctx, tctx = _ctxs(jcfg, False)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jlm.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, None,
        jctx)[0]))(jparams)
    taken = []
    real = tattn.flash_attention_cv
    monkeypatch.setattr(tattn, "flash_attention_cv", lambda *a, **kw: (
        taken.append(kw["causal"]) or real(*a, **kw)))
    n0 = ops.launches["flash_fwd"]
    tl, _, tg = value_and_grad(lambda p: tlm.loss_fn(
        p, tcfg, batch, None, tctx, remat=False), tparams)
    assert taken == [False] and ops.launches["flash_fwd"] == n0
    assert abs(float(tl) - float(jl)) <= TIGHT[0] * abs(float(jl))
    assert _rel(_flat(tg), jckpt._flatten(jax.tree.map(np.asarray, jg))) \
        <= TIGHT[1]
    # the attention alone, bidirectional, values and gradients
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 256, 2, 80)).astype(np.float32)
               for _ in range(3))
    dout = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=False, window=None, q_block=64, kv_block=64)

    def f_j(q_, k_, v_):
        return jnp.sum(jattn.flash_attention_cv(q_, k_, v_, **kw)
                       * jnp.asarray(dout))

    qkv = tuple(map(jnp.asarray, (q, k, v)))
    out_j = jattn.flash_attention_cv(*qkv, **kw)
    grads_j = jax.grad(f_j, argnums=(0, 1, 2))(*qkv)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out_t = real(*ts, **kw)
    (out_t * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), atol=2e-5,
                               rtol=2e-5)
    for t, gj in zip(ts, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(_np(t.grad), gj, rtol=0,
                                   atol=2e-5 * np.abs(gj).max())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def test_train_cli_trains_hubert_on_the_cpu(capsys):
    from repro_torch.launch import train
    params = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--mode", "importance", "--steps", "1"])
    out = capsys.readouterr().out
    assert out.count("step ") == 1 and "frames/s" in out and "nan" not in out
    assert all(bool(torch.isfinite(t).all())
               for t in _shapes(params).values())


def test_decode_paths_refuse_encoder_only(world):
    """The engine, the packed session and the serve CLI refuse the arch
    with the reference's words, before building anything."""
    tcfg, jcfg = world["tcfg"], world["jcfg"]
    msg = f"{tcfg.name} is encoder-only: no decode step"
    with pytest.raises(ValueError) as je:
        jeng.DecodeEngine(world["jparams"], jcfg, None,
                          _ctxs(jcfg, True)[0])
    assert str(je.value) == msg
    tctx = _ctxs(tcfg, True)[1]
    with pytest.raises(ValueError, match=re.escape(msg)):
        teng.DecodeEngine(world["tparams"], tcfg, None, tctx)
    policy = tpolicy.MPQPolicy.uniform(tlm.enumerate_qlayers(tcfg), 4)
    with pytest.raises(ValueError, match=re.escape(msg)):
        QuantizedSession(tcfg, world["tparams"], policy)
    with pytest.raises(SystemExit) as js:
        jserve.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(SystemExit) as ts:
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert str(ts.value) == str(js.value) == msg
