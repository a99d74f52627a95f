"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (they build ``csrc/*.cu``) and
skip elsewhere. The repository's ``conftest.py`` imports JAX, which the GPU
machine does not have, so run them there without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

# (K, N) of the Qwen3-0.6B projections: wq, wk/wv, wo, mlp_wi/wg, mlp_wo
QWEN3_KN = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
            (3072, 1024)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _codes(rng, shape, lo, hi, dev):
    return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(np.int8)).to(dev)


@pytest.mark.parametrize("M", [1, 4, 128, 37])
@pytest.mark.parametrize("KN", QWEN3_KN + [(200, 72), (130, 33)])
def test_quant_matmul_bitwise(dev, M, KN):
    K, N = KN
    rng = np.random.default_rng(K * 7 + N + M)
    x = _codes(rng, (M, K), -128, 127, dev)
    w = _codes(rng, (K, N), -128, 127, dev)
    s_x = torch.tensor(0.0123, device=dev)
    s_w = torch.tensor([0.0456], device=dev)
    n0 = ops.launches["quant_matmul"]
    out = ops.quant_matmul(x, w, s_x, s_w)
    torch.cuda.synchronize()
    assert ops.launches["quant_matmul"] == n0 + 1
    want = ref.quant_matmul_ref(x, w, s_x, s_w)
    assert torch.equal(out, want), float((out - want).abs().max())


@pytest.mark.parametrize("M", [1, 4, 128])
@pytest.mark.parametrize("KN", QWEN3_KN + [(202, 40)])
def test_quant_matmul_w4_bitwise(dev, M, KN):
    K, N = KN
    rng = np.random.default_rng(K + 3 * N + M)
    x = _codes(rng, (M, K), -128, 127, dev)
    w_p = torch.from_numpy(
        rng.integers(0, 256, size=(K // 2, N)).astype(np.uint8)).to(dev)
    s_x = torch.tensor(0.031, device=dev)
    s_w = torch.tensor(0.0072, device=dev)
    n0 = ops.launches["quant_matmul_w4"]
    out = ops.quant_matmul_w4(x, w_p, s_x, s_w)
    torch.cuda.synchronize()
    assert ops.launches["quant_matmul_w4"] == n0 + 1
    want = ref.quant_matmul_w4_ref(x, w_p, s_x, s_w)
    assert torch.equal(out, want), float((out - want).abs().max())


def _ring(rng, B, Sc, KV, hd, dev, q_pos):
    """A wrapped ring with some evicted (-1) slots: slot i of row b holds the
    absolute position whose ring index is i, the last ``q_pos + 1`` written."""
    pos = np.full((B, Sc), -1, np.int32)
    for b in range(B):
        for t in range(max(0, q_pos[b] + 1 - Sc), q_pos[b] + 1):
            pos[b, t % Sc] = t
    pos[1, rng.integers(0, Sc, size=Sc // 5)] = -1           # evicted rows
    kc = _codes(rng, (B, Sc, KV, hd), -127, 127, dev)
    vc = _codes(rng, (B, Sc, KV, hd), -127, 127, dev)
    ks = torch.from_numpy(rng.uniform(1e-3, 2e-2, (B, Sc, KV)).astype(np.float32)).to(dev)
    vs = torch.from_numpy(rng.uniform(1e-3, 2e-2, (B, Sc, KV)).astype(np.float32)).to(dev)
    return kc, ks, vc, vs, torch.from_numpy(pos).to(dev)


@pytest.mark.parametrize("Sc", [320, 4096, 100])
@pytest.mark.parametrize("G", [2, 1, 4])
def test_decode_attn_quant_allclose(dev, Sc, G):
    B, KV, hd = 4, 8, 128
    rng = np.random.default_rng(Sc + G)
    q_pos = np.array([Sc + 37, Sc - 1, Sc // 2, 3 * Sc], np.int32)
    kc, ks, vc, vs, pos = _ring(rng, B, Sc, KV, hd, dev, q_pos)
    q = torch.from_numpy(rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32)).to(dev)
    qp = torch.from_numpy(q_pos).to(dev)
    n0 = ops.launches["decode_attn_quant"]
    out = ops.decode_attn_quant(q, kc, ks, vc, vs, pos, qp)
    torch.cuda.synchronize()
    assert ops.launches["decode_attn_quant"] == n0 + 1
    qf = q.reshape(B, KV, G, hd) * (hd ** -0.5)
    want = ref.decode_attn_quant_ref(qf, kc, ks, vc, vs, pos, qp).reshape(out.shape)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-6)


def test_decode_attn_quant_window_and_zero_rows(dev):
    B, Sc, KV, G, hd = 2, 64, 2, 2, 64
    rng = np.random.default_rng(5)
    q_pos = np.array([80, 40], np.int32)
    kc, ks, vc, vs, pos = _ring(rng, B, Sc, KV, hd, dev, q_pos)
    kc[0, :8].zero_()                      # zero rows give exact zero logits
    q = torch.from_numpy(rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32)).to(dev)
    qp = torch.from_numpy(q_pos).to(dev)
    out = ops.decode_attn_quant(q, kc, ks, vc, vs, pos, qp, window=16)
    qf = q.reshape(B, KV, G, hd) * (hd ** -0.5)
    want = ref.decode_attn_quant_ref(qf, kc, ks, vc, vs, pos, qp, 16).reshape(out.shape)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-6)


def test_wrappers_reject_bad_operands(dev):
    x = torch.zeros((4, 64), dtype=torch.int8, device=dev)
    w = torch.zeros((64, 32), dtype=torch.int8, device=dev)
    s = torch.tensor(1.0, device=dev)
    with pytest.raises(TypeError):
        ops.quant_matmul(x.float(), w, s, s)
    with pytest.raises(ValueError):
        ops.quant_matmul(x, w.t(), s, s)
    with pytest.raises(ValueError):
        ops.quant_matmul(x, w.cpu(), s, s)
    with pytest.raises(ValueError):
        ops.quant_matmul_w4(x[:, :63].contiguous(), w[:31].view(torch.uint8), s, s)


# ---------------------------------------------------------------------------
# training kernels: fake-quant forward/backward, flash forward
# ---------------------------------------------------------------------------
def _ds_tol(v, s, g, qmin, qmax, ds_plain):
    """rtol 1e-4 of |ds| plus 1e-6 of sum |g * dsd|: float32 sums of the
    same terms in another order."""
    vs = v / torch.clamp(s, min=1e-9)
    inside = (vs > qmin) & (vs < qmax)
    c = torch.clamp(vs, qmin, qmax)
    terms = (g * torch.where(inside, torch.round(c) - vs, c)).abs().sum()
    return 1e-4 * abs(float(ds_plain)) + 1e-6 * float(terms)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("shape", [(37, 1000), (1, 1), (5,), (3, 7, 11),
                                   (1024, 3072), (4099,)])
def test_fake_quant_kernels_against_plain(dev, bits, shape):
    rng = np.random.default_rng(bits * 100 + len(shape))
    v = torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    qmin, qmax = float(-2 ** (bits - 1)), float(2 ** (bits - 1) - 1)
    s = torch.tensor([0.2 / qmax], device=dev)
    n0 = dict(ops.launches)
    out = ops.fake_quant_fwd(v, s, qmin, qmax)
    dv, ds = ops.fake_quant_bwd(v, s, g, qmin, qmax)
    torch.cuda.synchronize()
    assert ops.launches["fake_quant_fwd"] == n0["fake_quant_fwd"] + 1
    assert ops.launches["fake_quant_bwd"] == n0["fake_quant_bwd"] + 1
    assert torch.equal(out, ref.fake_quant_ref(v, s.reshape(()), qmin, qmax))
    dv_p, ds_p = ref.fake_quant_grads_ref(v, s.reshape(()), g, qmin, qmax)
    assert torch.equal(dv, dv_p)
    assert abs(float(ds) - float(ds_p)) <= _ds_tol(v, s, g, qmin, qmax, ds_p)


def test_fake_quant_kernels_on_unaligned_views(dev):
    """A view 4 bytes into its storage takes the scalar path."""
    rng = np.random.default_rng(11)
    base = torch.from_numpy(rng.standard_normal(1001).astype(np.float32)).to(dev)
    gbase = torch.from_numpy(rng.standard_normal(1001).astype(np.float32)).to(dev)
    v, g = base[1:], gbase[1:]
    s = torch.tensor(0.3, device=dev)
    assert v.data_ptr() % 16
    assert torch.equal(ops.fake_quant_fwd(v, s, -8.0, 7.0),
                       ref.fake_quant_ref(v, s, -8.0, 7.0))
    dv, ds = ops.fake_quant_bwd(v, s, g, -8.0, 7.0)
    dv_p, ds_p = ref.fake_quant_grads_ref(v, s, g, -8.0, 7.0)
    assert torch.equal(dv, dv_p)
    assert abs(float(ds) - float(ds_p)) <= _ds_tol(v, s, g, -8.0, 7.0, ds_p)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantizer_autograd_through_the_kernels(dev, bits):
    """core.quantizer.fake_quant on a CUDA tensor launches both kernels and
    gives the CPU STE composition's gradients (the reference's own
    tolerances, tests/test_kernels.py:54-55)."""
    from repro_torch.core import quantizer as tq
    rng = np.random.default_rng(bits)
    v = (rng.standard_normal((48, 96)) * 0.2).astype(np.float32)
    s = np.float32(0.2 / 2 ** (bits - 1))
    qmin, qmax = tq.bit_range(bits, True)
    grads = {}
    for d in ("cpu", dev):
        n0 = dict(ops.launches)
        vt = torch.from_numpy(v).to(d).requires_grad_(True)
        st = torch.tensor(s, device=d).requires_grad_(True)
        gsf = tq.lsq_grad_scale_factor(v.size, qmax, device=d)
        out = tq.fake_quant(vt, st, qmin, qmax, grad_scale_factor=gsf)
        torch.cos(out).sum().backward()
        launched = (ops.launches["fake_quant_fwd"] - n0["fake_quant_fwd"],
                    ops.launches["fake_quant_bwd"] - n0["fake_quant_bwd"])
        assert launched == ((0, 0) if d == "cpu" else (1, 1))
        grads[str(d)] = (out.detach().cpu(), vt.grad.cpu(), float(st.grad))
    (o_c, gv_c, gs_c), (o_g, gv_g, gs_g) = grads.values()
    assert torch.equal(o_c, o_g)
    torch.testing.assert_close(gv_g, gv_c, rtol=0, atol=1e-6)
    assert abs(gs_g - gs_c) <= 1e-3 * abs(gs_c)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", [64, 192])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None), (False, 100)])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_fwd_kernel_against_plain(dev, hd, S, causal, window, G):
    B, KV = 2, 2
    rng = np.random.default_rng(S + hd + G)
    q = torch.from_numpy((rng.standard_normal((B, S, KV, G, hd)) * hd ** -0.5)
                         .astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32)).to(dev)
    n0 = ops.launches["flash_fwd"]
    out, lse = ops.flash_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launches["flash_fwd"] == n0 + 1
    out_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=causal, window=window,
                                     q_block=64, kv_block=64)
    torch.testing.assert_close(out, out_p, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


def test_self_attention_takes_the_flash_kernel(dev):
    """At the reference's switch (S >= 2048, S % 512 == 0) training and
    prefill attention go through the kernel and equal the direct path."""
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 1, 2048, 4, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev)
               for sh in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    n0 = ops.launches["flash_fwd"]
    out = attn.self_attention(q, k, v, causal=True, window=None)
    assert ops.launches["flash_fwd"] == n0 + 1
    pos = torch.arange(S, device=dev)
    want = attn.direct_attention(q, k, v, pos, pos, causal=True, window=None)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


def test_training_wrappers_reject_bad_operands(dev):
    v = torch.zeros((8, 16), device=dev)
    s = torch.tensor(0.1, device=dev)
    with pytest.raises(TypeError):
        ops.fake_quant_fwd(v.double(), s, -8.0, 7.0)
    with pytest.raises(ValueError):
        ops.fake_quant_fwd(v.t(), s, -8.0, 7.0)
    with pytest.raises(ValueError):
        ops.fake_quant_fwd(v, s.cpu(), -8.0, 7.0)
    with pytest.raises(TypeError):
        ops.fake_quant_fwd(v, torch.ones(2, device=dev), -8.0, 7.0)
    with pytest.raises(ValueError):
        ops.fake_quant_bwd(v, s, torch.zeros((8, 15), device=dev), -8.0, 7.0)
    q = torch.zeros((1, 128, 2, 2, 64), device=dev)
    kv = torch.zeros((1, 128, 2, 64), device=dev)
    with pytest.raises(ValueError):                     # S not a tile multiple
        ops.flash_fwd(q[:, :100].contiguous(), kv[:, :100].contiguous(),
                      kv[:, :100].contiguous(), causal=True)
    with pytest.raises(ValueError):                     # unsupported head dim
        ops.flash_fwd(q[..., :48].contiguous(), kv[..., :48].contiguous(),
                      kv[..., :48].contiguous(), causal=True)
    with pytest.raises(ValueError):                     # k does not match q
        ops.flash_fwd(q, kv[:, :64].contiguous(), kv, causal=True)
    with pytest.raises(ValueError):                     # non-contiguous q
        ops.flash_fwd(q.transpose(2, 3), kv, kv, causal=True)
    with pytest.raises(TypeError):
        ops.flash_fwd(q.int(), kv, kv, causal=True)
    with pytest.raises(ValueError):
        ops.flash_fwd(q, kv.cpu(), kv, causal=True)


def test_plain_on_cuda_runs_the_named_plain_versions(dev):
    """Inside ``ops.plain_on_cuda(names)`` the named training kernels run
    their plain versions on CUDA tensors and launch nothing; the others
    still launch."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)).to(dev)
    s = torch.tensor(0.05, device=dev)
    q = torch.from_numpy((rng.standard_normal((1, 64, 2, 2, 64)) * 0.125)
                         .astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((1, 64, 2, 64)).astype(np.float32)).to(dev)
    n0 = dict(ops.launches)
    with ops.plain_on_cuda("fake_quant_fwd", "fake_quant_bwd"):
        out = ops.fake_quant_fwd(v, s, -8.0, 7.0)
        ops.fake_quant_bwd(v, s, v, -8.0, 7.0)
        ops.flash_fwd(q, k, k, causal=True, q_block=64, kv_block=64)
    assert ops.launches["fake_quant_fwd"] == n0["fake_quant_fwd"]
    assert ops.launches["fake_quant_bwd"] == n0["fake_quant_bwd"]
    assert ops.launches["flash_fwd"] == n0["flash_fwd"] + 1
    assert torch.equal(out, ref.fake_quant_ref(v, s, -8.0, 7.0))
    with ops.plain_on_cuda():
        ops.flash_fwd(q, k, k, causal=True, q_block=64, kv_block=64)
    assert ops.launches["flash_fwd"] == n0["flash_fwd"] + 1
