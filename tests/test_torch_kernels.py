"""Each CUDA kernel's plain PyTorch version against the JAX package's Pallas
kernel run in interpret mode, on the same seeded numpy inputs.

Tolerances are the reference's own: both int8 matmuls are integer-exact
(atol 0); int8 decode attention sums in another order, rtol 2e-5 / atol
2e-6 (``tests/test_quant_attention.py``), over rows with at least one
attendable slot (a fully masked row softmaxes uniformly over the kernel's
padded block, which the plain version does not have).
"""
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import quant_attention as jqa            # noqa: E402
from repro.kernels import quant_matmul as jqm               # noqa: E402
from repro_torch.kernels import ops, ref                    # noqa: E402


@pytest.mark.parametrize("MKN", [(4, 256, 128), (9, 200, 72), (1, 64, 40)])
def test_quant_matmul_plain_equals_pallas(MKN):
    M, K, N = MKN
    r = np.random.default_rng(K + N)
    x = r.integers(-128, 128, (M, K)).astype(np.int8)
    w = r.integers(-128, 128, (K, N)).astype(np.int8)
    sx, sw = np.float32(0.0173), np.float32(0.0391)
    want = jqm.quant_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sx),
                            jnp.asarray(sw), blocks=(8, 128, 128),
                            interpret=True)
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           torch.tensor(sx), torch.tensor(sw))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("MKN", [(4, 256, 128), (3, 202, 40)])
def test_quant_matmul_w4_plain_equals_pallas(MKN):
    M, K, N = MKN
    r = np.random.default_rng(K * N)
    x = r.integers(-128, 128, (M, K)).astype(np.int8)
    w_p = r.integers(0, 256, (K // 2, N)).astype(np.uint8)
    sx, sw = np.float32(0.021), np.float32(0.0067)
    want = jqm.quant_matmul_w4(jnp.asarray(x), jnp.asarray(w_p),
                               jnp.asarray(sx), jnp.asarray(sw),
                               blocks=(8, 128, 128), interpret=True)
    got = ops.quant_matmul_w4(torch.from_numpy(x), torch.from_numpy(w_p),
                              torch.tensor(sx), torch.tensor(sw))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _ring(r, B, cap, KV, hd, next_pos):
    """Row b holds the last ``cap`` of its ``next_pos[b]`` tokens at their
    wrapped ring indices; unwritten slots and evicted rows carry -1."""
    pos = np.full((B, cap), -1, np.int32)
    for b, p in enumerate(next_pos):
        for t in range(max(0, p - cap), max(p, 0)):
            pos[b, t % cap] = t
    kc = r.integers(-127, 128, (B, cap, KV, hd)).astype(np.int8)
    vc = r.integers(-127, 128, (B, cap, KV, hd)).astype(np.int8)
    ks = r.uniform(1e-3, 3e-2, (B, cap, KV)).astype(np.float32)
    vs = r.uniform(1e-3, 3e-2, (B, cap, KV)).astype(np.float32)
    return kc, ks, vc, vs, pos


@pytest.mark.parametrize("kvg", [(1, 1), (2, 2), (2, 4), (1, 3)])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attn_plain_matches_pallas(kvg, window):
    KV, G = kvg
    B, cap, hd = 4, 11, 16
    r = np.random.default_rng(KV * 10 + G + (window or 0))
    next_pos = [cap + 7, cap // 2, 1, -1]      # wrapped, partial, one, evicted
    kc, ks, vc, vs, pos = _ring(r, B, cap, KV, hd, next_pos)
    pos[0, 3] = -1                             # an evicted slot mid-ring
    q = r.standard_normal((B, 1, KV * G, hd)).astype(np.float32)
    q_pos = np.array([max(p - 1, 0) for p in next_pos], np.int32)
    want = jqa.decode_attn_quant(
        *map(jnp.asarray, (q, kc, ks, vc, vs, pos, q_pos)), window=window,
        kv_block=4, interpret=True)
    got = ops.decode_attn_quant(*map(torch.from_numpy,
                                     (q, kc, ks, vc, vs, pos, q_pos)),
                                window=window)
    live = [b for b, p in enumerate(next_pos) if p > 0]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=2e-5, atol=2e-6)


def test_decode_attn_zero_row_gives_exact_zero_logit():
    """A zero K row quantizes to codes 0 with the eps-floored scale; the
    K-scale multiplies the logit after the dot, so that logit is exactly 0
    and a query attending only that row averages V exactly."""
    kc = np.zeros((1, 2, 1, 8), np.int8)
    ks = np.full((1, 2, 1), 1e-8, np.float32)
    vc = np.arange(16, dtype=np.int8).reshape(1, 2, 1, 8)
    vs = np.full((1, 2, 1), 0.5, np.float32)
    pos = np.array([[0, 1]], np.int32)
    q = np.ones((1, 1, 1, 8), np.float32)
    out = ref.decode_attn_quant_ref(torch.from_numpy(q).reshape(1, 1, 1, 8),
                                    *map(torch.from_numpy,
                                         (kc, ks, vc, vs, pos)),
                                    torch.tensor([1], dtype=torch.int32))
    want = 0.5 * (vc[0, 0, 0].astype(np.float32) + vc[0, 1, 0]) / 2
    np.testing.assert_array_equal(out.reshape(8).numpy(), want)


@pytest.mark.parametrize("per_slot", [True, False])
def test_attention_fused_route_matches_jax_fused_interpret(per_slot):
    """models.attention.decode_attention on an int8 ring: the port's fused
    route (the kernel's plain version on the CPU) against JAX's fused route
    in interpret mode, and against the port's own dequant-fp route; the
    cache writes are bit for bit the same on every route."""
    from repro.models import attention as jattn
    from repro.runtime import dispatch as jdisp
    from repro.runtime import kv_cache as jkv
    from repro_torch.models import attention as tattn
    from repro_torch.runtime import dispatch as tdisp
    from repro_torch.runtime import kv_cache as tkv
    KV, G, hd, cap = 2, 2, 16, 9
    B = 3 if per_slot else 2
    r = np.random.default_rng(per_slot)
    next_pos = [cap + 4, 5, -1] if per_slot else [cap + 4] * 2
    kc, ks, vc, vs, pos = _ring(r, B, cap, KV, hd, next_pos)
    if not per_slot:
        pos = pos[0]
    q = r.standard_normal((B, 1, KV * G, hd)).astype(np.float32)
    k_new = r.standard_normal((B, 1, KV, hd)).astype(np.float32)
    v_new = r.standard_normal((B, 1, KV, hd)).astype(np.float32)
    p_now = (np.array([max(p, -1) for p in next_pos], np.int32) if per_slot
             else np.int32(next_pos[0]))
    arrs = (kc, vc, ks, vs, pos)
    jc = jkv.QuantKVCache(*map(jnp.asarray, arrs))
    tc = tkv.QuantKVCache(*map(torch.from_numpy, arrs))
    with jdisp.force_decode_attn("fused-interpret"):
        jo, jn = jattn.decode_attention(jnp.asarray(q), jc, jnp.asarray(k_new),
                                        jnp.asarray(v_new),
                                        jnp.asarray(p_now), window=None)
    outs = {}
    for route in ("fused", "dequant-fp"):
        with tdisp.force_route("decode_attn", route):
            outs[route], tn = tattn.decode_attention(
                torch.from_numpy(q), tc, torch.from_numpy(k_new),
                torch.from_numpy(v_new), torch.as_tensor(p_now), window=None)
        for f in jn._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jn, f)),
                                          getattr(tn, f).numpy(), f)
    live = [b for b, p in enumerate(next_pos) if p >= 0]
    for route, o in outs.items():
        np.testing.assert_allclose(o.numpy()[live], np.asarray(jo)[live],
                                   rtol=2e-5, atol=2e-6, err_msg=route)
