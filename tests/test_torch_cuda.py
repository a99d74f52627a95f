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
