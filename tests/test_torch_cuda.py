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
# (K, N) of the RWKV6-7B projections: time-mix and channel-mix receptance,
# channel-mix key, channel-mix value
RWKV6_KN = [(4096, 4096), (4096, 14336), (14336, 4096)]
# (K, N) of the RecurrentGemma-2B projections: wq, rg/wx, rg/wgate, rg/wo and
# wo; wk/wv (one kv head); mlp_wi/wg; mlp_wo
RGEMMA_KN = [(2560, 2560), (2560, 256), (2560, 7680), (7680, 2560)]
# (K, N) of the deepseek-moe-16b projections on the kernels: wq/wk/wv/wo,
# the shared experts' up and down, the dense layer's MLP up and down
DEEPSEEK_KN = [(2048, 2048), (2048, 2816), (2816, 2048), (2048, 10944),
               (10944, 2048)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _codes(rng, shape, lo, hi, dev):
    return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(np.int8)).to(dev)


@pytest.mark.parametrize("M", [1, 4, 128, 37, 2, 8, 16, 17])
@pytest.mark.parametrize("KN", QWEN3_KN + [(200, 72), (130, 33)] + RWKV6_KN
                         + RGEMMA_KN + DEEPSEEK_KN)
def test_quant_matmul_bitwise(dev, M, KN):
    """Both routes (split-K for M <= 16, tensor cores above) at every
    row instance and its neighbours, bit for bit the plain version."""
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


def _split_scratch_clean():
    return all(int(t.abs().sum()) == 0 for t in ops._TICKETS.values())


def test_quant_matmul_split_workspace_resets(dev):
    """Repeated split-K launches across grid sizes and row counts,
    interleaved on one stream with a tensor-core launch, give the same bits
    again and leave the workspace and the tickets zero: the last block of a
    column tile re-zeroes what the tile used."""
    rng = np.random.default_rng(5)
    s_x = torch.tensor(0.0213, device=dev)
    s_w = torch.tensor(0.0077, device=dev)
    calls = []
    for M, K, N in [(4, 4096, 14336), (1, 1024, 1024), (16, 3072, 1024),
                    (8, 14336, 4096), (3, 2048, 1000), (128, 1024, 3072)]:
        x = _codes(rng, (M, K), -128, 127, dev)
        w = _codes(rng, (K, N), -128, 127, dev)
        calls.append((x, w, ref.quant_matmul_ref(x, w, s_x, s_w)))
    outs = [[ops.quant_matmul(x, w, s_x, s_w) for x, w, _ in calls]
            for _ in range(3)]
    torch.cuda.synchronize()
    for rep in outs:
        for (_, _, want), got in zip(calls, rep):
            assert torch.equal(got, want)
    assert ops._TICKETS and _split_scratch_clean()


@pytest.mark.parametrize("x_off,w_off", [(1, 0), (0, 1), (8, 8), (1, 8)])
@pytest.mark.parametrize("M", [4, 8, 16, 37])
def test_quant_matmul_at_byte_offsets(dev, x_off, w_off, M):
    """x and w that start 1 or 8 bytes past an allocation (views the vector
    copies cannot take whole) stay bit for bit on both routes."""
    K, N = 1024, 1024
    rng = np.random.default_rng(x_off * 10 + w_off + M)
    xb = _codes(rng, (M * K + x_off,), -128, 127, dev)
    wb = _codes(rng, (K * N + w_off,), -128, 127, dev)
    x = xb[x_off:].view(M, K)
    w = wb[w_off:].view(K, N)
    assert x.data_ptr() % 16 == x_off % 16 and x.is_contiguous()
    s_x = torch.tensor(0.0123, device=dev)
    s_w = torch.tensor(0.0456, device=dev)
    out = ops.quant_matmul(x, w, s_x, s_w)
    want = ref.quant_matmul_ref(x, w, s_x, s_w)
    torch.cuda.synchronize()
    assert torch.equal(out, want), float((out - want).abs().max())
    assert _split_scratch_clean()


def _device_kernels(fn):
    """The names of what the device ran (kernels, copies, memsets) for one
    call of ``fn``. A profiler's first session can come back with no
    device event at all while CUPTI attaches, so one profiled call of
    ``fn`` runs first and the second session is the one read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    return names


@pytest.mark.parametrize("what", ["qmm_split", "qmm_mma", "w4_split",
                                  "w4_mma", "flash", "wkv"])
def test_one_device_kernel_per_call(dev, what):
    """Each wrapper call is one launch on the counter and one kernel on the
    device (the split-K combine and the wkv carry run inside it; no memset,
    no second kernel), once the workspace exists."""
    rng = np.random.default_rng(9)
    if what == "wkv":
        r, k, v, lw, u, s0 = _wkv_operands(dev, 1, 256, 64, 64, 9)
        name = "wkv"
        call = lambda: ops.wkv(r, k, v, lw, u, s0)  # noqa: E731
        kernel = "wkv_chunk_kernel"
    elif what.startswith("w4"):
        M = 4 if what == "w4_split" else 128
        x = _codes(rng, (M, 4096), -128, 127, dev)
        w = torch.from_numpy(rng.integers(0, 256, size=(2048, 14336))
                             .astype(np.uint8)).to(dev)
        s = torch.tensor(0.01, device=dev)
        name = "quant_matmul_w4"
        call = lambda: ops.quant_matmul_w4(x, w, s, s)  # noqa: E731
        kernel = "qmm_w4_splitk_kernel" if M == 4 else "qmm_w4_mma_kernel"
    elif what == "flash":
        B, S, KV, G, hd = 1, 256, 2, 2, 128
        q = torch.from_numpy(rng.standard_normal((B, S, KV, G, hd))
                             .astype(np.float32)).to(dev)
        k = torch.from_numpy(rng.standard_normal((B, S, KV, hd))
                             .astype(np.float32)).to(dev)
        name = "flash_fwd"
        call = lambda: ops.flash_fwd(q, k, k, causal=True)  # noqa: E731
        kernel = "flash_fwd_kernel"
    else:
        M = 4 if what == "qmm_split" else 128
        x = _codes(rng, (M, 1024), -128, 127, dev)
        w = _codes(rng, (1024, 3072), -128, 127, dev)
        s = torch.tensor(0.01, device=dev)
        name = "quant_matmul"
        call = lambda: ops.quant_matmul(x, w, s, s)  # noqa: E731
        kernel = "qmm_splitk_kernel" if M == 4 else "qmm_mma_kernel"
    call()
    n0 = ops.launches[name]
    names = _device_kernels(call)
    assert ops.launches[name] == n0 + 2       # the warm-up session's and ours
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 16, 17, 128])
@pytest.mark.parametrize("KN", QWEN3_KN + RWKV6_KN + [(202, 40)] + RGEMMA_KN
                         + DEEPSEEK_KN)
def test_quant_matmul_w4_bitwise(dev, M, KN):
    """Both nib4 routes (split-K for M <= 16 at every row instance and its
    neighbours, tensor cores above) bit for bit the plain version, at the
    Qwen3-0.6B and RWKV6-7B shapes and at K = 202 (not a multiple of a
    step: rows past K add nothing)."""
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


def test_split_scratch_zero_after_interleaved_calls(dev):
    """int8 and nib4 matmuls on both routes, one-token attention and wkv
    share one scratch of tickets and partial sums on a stream: interleaved
    calls keep their bits and leave it all zero."""
    rng = np.random.default_rng(17)
    s = torch.tensor(0.013, device=dev)
    x = _codes(rng, (4, 4096), -128, 127, dev)
    x128 = _codes(rng, (128, 1024), -128, 127, dev)
    w8 = _codes(rng, (4096, 1024), -128, 127, dev)
    w8b = _codes(rng, (1024, 3072), -128, 127, dev)
    w4 = torch.from_numpy(rng.integers(0, 256, size=(2048, 14336))
                          .astype(np.uint8)).to(dev)
    w4b = torch.from_numpy(rng.integers(0, 256, size=(512, 3072))
                           .astype(np.uint8)).to(dev)
    q_pos = np.full((4,), 300, np.int32)
    ring = _ring(rng, 4, 320, 8, 128, dev, q_pos)
    qp = torch.from_numpy(q_pos).to(dev)
    q = torch.from_numpy(rng.standard_normal((4, 1, 16, 128))
                         .astype(np.float32)).to(dev)
    wk = _wkv_operands(dev, 1, 256, 8, 64, 17)
    calls = [
        (lambda: ops.quant_matmul(x, w8, s, s),
         lambda: ref.quant_matmul_ref(x, w8, s, s)),
        (lambda: ops.quant_matmul_w4(x, w4, s, s),
         lambda: ref.quant_matmul_w4_ref(x, w4, s, s)),
        (lambda: ops.decode_attn_quant(q, *ring, qp), None),
        (lambda: ops.quant_matmul_w4(x128, w4b, s, s),
         lambda: ref.quant_matmul_w4_ref(x128, w4b, s, s)),
        (lambda: ops.wkv(*wk[:5], wk[5])[0], None),
        (lambda: ops.quant_matmul(x128, w8b, s, s),
         lambda: ref.quant_matmul_ref(x128, w8b, s, s)),
        (lambda: ops.quant_matmul_w4(x[:1], w4, s, s),
         lambda: ref.quant_matmul_w4_ref(x[:1], w4, s, s)),
    ]
    first = [kernel() for kernel, _ in calls]
    for _ in range(2):
        again = [kernel() for kernel, _ in calls]
        torch.cuda.synchronize()
        for (_, plain), a, b in zip(calls, first, again):
            if plain is not None:
                assert torch.equal(a, plain())
                assert torch.equal(b, a)
            else:                         # float sums: the same launch again
                assert torch.allclose(b, a, rtol=1e-6, atol=1e-6)
    assert ops._TICKETS and _split_scratch_clean()


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


@pytest.mark.parametrize("Sc", [320, 4096, 100, 1, 63, 65, 4097])
@pytest.mark.parametrize("G", [2, 1, 4, 9, 48])
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


def _paged(rng, B, P, ps, KV, hd, dev):
    """A page pool with ids permuted at random, slot 1 sharing slot 0's
    first pages, an unmapped (-1) entry inside slot 2's row and slot 3's
    tail unmapped, each slot written up to a position of its own, some rows
    evicted; slot 3 queries at -1."""
    rows = P * ps
    n_pages = B * P + 5
    perm = list(rng.permutation(n_pages))
    table = np.full((B, P), -1, np.int32)
    for b in range(B):
        for j in range(P):
            table[b, j] = table[0, j] if (b == 1 and j < P // 4) else perm.pop()
    table[2, P // 2] = -1
    table[3, P - max(1, P // 8):] = -1
    pos = np.full((n_pages, ps), -1, np.int32)
    for b, n in enumerate([rows, rows - 5, rows // 2 + 3, rows // 3]):
        t = np.arange(n)
        pid = table[b, t // ps]
        pos[pid[pid >= 0], (t % ps)[pid >= 0]] = t[pid >= 0]
    pos[rng.integers(0, n_pages, n_pages // 3), rng.integers(0, ps, n_pages // 3)] = -1
    q_pos = np.array([rows - 1, rows - 6, rows // 2, -1], np.int32)
    kp = _codes(rng, (n_pages, ps, KV, hd), -127, 127, dev)
    vp = _codes(rng, (n_pages, ps, KV, hd), -127, 127, dev)
    ks = torch.from_numpy(rng.uniform(1e-3, 2e-2, (n_pages, ps, KV)).astype(np.float32)).to(dev)
    vs = torch.from_numpy(rng.uniform(1e-3, 2e-2, (n_pages, ps, KV)).astype(np.float32)).to(dev)
    return (kp, ks, vp, vs, torch.from_numpy(pos).to(dev),
            torch.from_numpy(table).to(dev), torch.from_numpy(q_pos).to(dev))


@pytest.mark.parametrize("ps,rows", [(8, 320), (16, 320), (8, 4096),
                                     (16, 4096), (3, 30), (64, 128),
                                     (3, 99), (7, 70), (5, 4095)])
@pytest.mark.parametrize("G", [2, 1, 4, 9, 48])
def test_decode_attn_quant_paged_allclose_and_equals_ring(dev, ps, rows, G):
    """The paged kernel against its plain version (the reference contract)
    and against the ring kernel on the gathered dense view (bit for bit:
    the same code, each row resolved through the table)."""
    from repro_torch.runtime.kv_cache import PagedKVCache
    B, KV, hd = 4, 8, 128
    rng = np.random.default_rng(rows + ps + G)
    kp, ks, vp, vs, pos, tbl, qp = _paged(rng, B, rows // ps, ps, KV, hd, dev)
    q = torch.from_numpy(rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32)).to(dev)
    n0 = dict(ops.launches)
    out = ops.decode_attn_quant_paged(q, kp, ks, vp, vs, pos, tbl, qp)
    torch.cuda.synchronize()
    assert ops.launches["decode_attn_quant_paged"] == n0["decode_attn_quant_paged"] + 1
    assert ops.launches["decode_attn_quant"] == n0["decode_attn_quant"]
    qf = q.reshape(B, KV, G, hd) * (hd ** -0.5)
    want = ref.decode_attn_quant_paged_ref(qf, kp, ks, vp, vs, pos, tbl,
                                           qp).reshape(out.shape)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-6)
    d = PagedKVCache(kp, vp, ks, vs, pos, tbl).gather()
    ring = ops.decode_attn_quant(q, d.k.contiguous(), d.k_scale.contiguous(),
                                 d.v.contiguous(), d.v_scale.contiguous(),
                                 d.pos.contiguous(), qp)
    assert torch.equal(out, ring)


def test_decode_attn_quant_paged_window(dev):
    from repro_torch.runtime.kv_cache import PagedKVCache
    B, KV, G, hd, ps = 4, 2, 2, 64, 8
    rng = np.random.default_rng(9)
    kp, ks, vp, vs, pos, tbl, qp = _paged(rng, B, 8, ps, KV, hd, dev)
    q = torch.from_numpy(rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32)).to(dev)
    out = ops.decode_attn_quant_paged(q, kp, ks, vp, vs, pos, tbl, qp, window=12)
    qf = q.reshape(B, KV, G, hd) * (hd ** -0.5)
    want = ref.decode_attn_quant_paged_ref(qf, kp, ks, vp, vs, pos, tbl, qp,
                                           12).reshape(out.shape)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-6)
    d = PagedKVCache(kp, vp, ks, vs, pos, tbl).gather()
    assert torch.equal(out, ops.decode_attn_quant(
        q, d.k.contiguous(), d.k_scale.contiguous(), d.v.contiguous(),
        d.v_scale.contiguous(), d.pos.contiguous(), qp, window=12))


def test_paged_decode_write_and_attend_do_not_synchronise(dev):
    """One layer's paged decode -- the cache write, whose dropped rows go
    to a scratch row instead of through a boolean mask, and the kernel --
    raises no host-device synchronisation."""
    from repro_torch.models import attention as attn
    from repro_torch.runtime.kv_cache import PagedKVCache
    rng = np.random.default_rng(4)
    kp, ks, vp, vs, pos, tbl, qp = _paged(rng, 4, 8, 8, 2, 64, dev)
    cache = PagedKVCache(kp, vp, ks, vs, pos, tbl)
    q = torch.from_numpy(rng.standard_normal((4, 1, 4, 64)).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((4, 1, 2, 64)).astype(np.float32)).to(dev)
    p = torch.tensor([40, -1, 100, 3], dtype=torch.int32, device=dev)
    attn.decode_attention(q, cache, k, k, p, window=None)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, new = attn.decode_attention(q, cache, k, k, p, window=None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out.shape == (4, 1, 4, 64) and bool(torch.isfinite(out).all())
    assert int(new.pos[int(tbl[0, 5]), 0]) == 40


def test_paged_wrapper_rejects_bad_operands(dev):
    rng = np.random.default_rng(2)
    kp, ks, vp, vs, pos, tbl, qp = _paged(rng, 4, 4, 8, 2, 64, dev)
    q = torch.zeros((4, 1, 4, 64), device=dev)
    with pytest.raises(TypeError):                      # table not int32
        ops.decode_attn_quant_paged(q, kp, ks, vp, vs, pos, tbl.long(), qp)
    with pytest.raises(ValueError):                     # mixed devices
        ops.decode_attn_quant_paged(q, kp, ks, vp, vs, pos, tbl.cpu(), qp)
    with pytest.raises(ValueError):                     # non-contiguous pages
        ops.decode_attn_quant_paged(q, kp.transpose(0, 1).contiguous()
                                    .transpose(0, 1), ks, vp, vs, pos, tbl, qp)
    with pytest.raises(ValueError):                     # table too long
        big = torch.full((4, ops.MAX_TABLE + 1), -1, dtype=torch.int32, device=dev)
        ops.decode_attn_quant_paged(q, kp, ks, vp, vs, pos, big, qp)
    with pytest.raises(ValueError):                     # q does not match
        ops.decode_attn_quant_paged(q[:3], kp, ks, vp, vs, pos, tbl, qp)


def test_paged_engine_equals_ring_engine_on_the_card(dev):
    """A paged engine at smoke size through the kernels: the ring engine's
    greedy tokens on every decisive step, 1 paged attention launch per
    layer and decode step, none of the ring kernel, and a clean pool."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import engine as teng
    from repro_torch.launch import serve as tserve
    from repro_torch.models import lm
    cfg = smoke_config("qwen3-0.6b")
    params = lm.init_params(cfg, seed=0, device=dev)
    policy = tserve.demo_mixed_policy(cfg)
    reqs = tserve.build_requests(SyntheticLM(cfg), 6, 24, 6, stagger=True,
                                 share_prefix=16)
    kw = dict(slots=3, cache_len=32, prefill_chunk=16, device=dev)
    _, ring, ring_out = tserve.serve_quantized(cfg, params, policy, reqs, **kw)
    n0 = dict(ops.launches)
    _, eng, out = tserve.serve_quantized(cfg, params, policy, reqs, **kw,
                                         kv_layout="paged", page_size=8)
    launched = {k: ops.launches[k] - n0[k] for k in n0}
    assert launched["decode_attn_quant_paged"] == cfg.n_layers * eng.stats.decode_steps
    assert launched["decode_attn_quant"] == 0
    assert eng.stats.prefix_hit_tokens > 0
    eng.pool.check()
    assert all(s is None for s in eng.slots)
    compared = 0
    for rid, c in out.items():
        n, miss = teng.decisive_prefix(c.tokens, ring_out[rid].tokens,
                                       ring.margins[rid], 1e-2)
        assert miss is None, (rid, c.tokens, ring_out[rid].tokens)
        compared += n
    assert compared > 0


def _verify_positions(q_pos, S):
    """(B, S) verify positions ending at each slot's one-token query
    position (a -1 slot stays -1)."""
    qp = q_pos.cpu().numpy()
    v = np.where(qp[:, None] < 0, -1,
                 np.maximum(qp[:, None] - (S - 1) + np.arange(S), 0))
    return torch.from_numpy(v.astype(np.int32)).to(q_pos.device)


def _check_verify(out, S, one, tag):
    """Query j of a verify launch is the one-token launch at q_pos[:, j]."""
    for j in range(S):
        assert torch.equal(out[:, j:j + 1], one(j)), (tag, j)


@pytest.mark.parametrize("S", [1, 2, 5, 8])
@pytest.mark.parametrize("G", [2, 1, 4, 9, 48])
@pytest.mark.parametrize("window", [None, 48])
def test_verify_attn_quant_kernel(dev, S, G, window):
    """The verify kernel against its plain version, and bit for bit
    against S launches of the one-token kernel, in one launch."""
    B, Sc, KV, hd = 4, 320, 8, 128
    rng = np.random.default_rng(S * 10 + G)
    q_pos = np.array([Sc + 37, Sc - 1, Sc // 2, -1], np.int32)
    kc, ks, vc, vs, pos = _ring(rng, B, Sc, KV, hd, dev, np.maximum(q_pos, 0))
    q = torch.from_numpy(rng.standard_normal((B, S, KV * G, hd)).astype(np.float32)).to(dev)
    qp = _verify_positions(torch.from_numpy(q_pos), S).to(dev)
    n0 = dict(ops.launches)
    out = ops.verify_attn_quant(q, kc, ks, vc, vs, pos, qp, window=window)
    torch.cuda.synchronize()
    assert ops.launches["verify_attn_quant"] == n0["verify_attn_quant"] + 1
    assert ops.launches["decode_attn_quant"] == n0["decode_attn_quant"]
    qf = q.reshape(B, S, KV, G, hd) * (hd ** -0.5)
    want = ref.verify_attn_quant_ref(qf, kc, ks, vc, vs, pos, qp,
                                     window).reshape(out.shape)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-6)
    _check_verify(out, S, lambda j: ops.decode_attn_quant(
        q[:, j:j + 1].contiguous(), kc, ks, vc, vs, pos,
        qp[:, j].contiguous(), window=window), (S, G, window))


@pytest.mark.parametrize("ps,rows", [(3, 30), (8, 320), (16, 320),
                                     (64, 128), (8, 4096)])
@pytest.mark.parametrize("S", [1, 2, 5, 8])
@pytest.mark.parametrize("G", [2, 1, 4, 9, 48])
def test_verify_attn_quant_paged_kernel(dev, ps, rows, S, G):
    """The paged verify kernel against its plain version and, bit for bit,
    against S launches of the one-token paged kernel, on permuted, shared
    and unmapped pages."""
    B, KV, hd = 4, 8, 128
    rng = np.random.default_rng(rows + ps + S + G)
    kp, ks, vp, vs, pos, tbl, qp1 = _paged(rng, B, rows // ps, ps, KV, hd, dev)
    q = torch.from_numpy(rng.standard_normal((B, S, KV * G, hd)).astype(np.float32)).to(dev)
    qp = _verify_positions(qp1, S)
    window = 40 if S == 5 else None
    n0 = dict(ops.launches)
    out = ops.verify_attn_quant_paged(q, kp, ks, vp, vs, pos, tbl, qp,
                                      window=window)
    torch.cuda.synchronize()
    assert ops.launches["verify_attn_quant_paged"] == \
        n0["verify_attn_quant_paged"] + 1
    assert ops.launches["decode_attn_quant_paged"] == \
        n0["decode_attn_quant_paged"]
    qf = q.reshape(B, S, KV, G, hd) * (hd ** -0.5)
    want = ref.verify_attn_quant_paged_ref(qf, kp, ks, vp, vs, pos, tbl, qp,
                                           window).reshape(out.shape)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-6)
    _check_verify(out, S, lambda j: ops.decode_attn_quant_paged(
        q[:, j:j + 1].contiguous(), kp, ks, vp, vs, pos, tbl,
        qp[:, j].contiguous(), window=window), (ps, rows, S, G))


# ---------------------------------------------------------------------------
# the split over cache rows (ops.attn_split_rows): edges, masked splits,
# the in-launch combine's tickets, the in-kernel q scale
# ---------------------------------------------------------------------------
def _q(rng, B, S, H, hd, dev):
    return torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(np.float32)).to(dev)


def _ring_to_pages(rng, ring, ps):
    """The slots of ``ring`` as a page pool: slot b's block j in page
    ``perm[b * P + j]`` of a random permutation, so the gathered view is
    ``ring`` itself, bit for bit."""
    kc, ks, vc, vs, pos = ring
    B, Sc = pos.shape
    P = Sc // ps
    perm = torch.from_numpy(rng.permutation(B * P)).to(kc.device)

    def pages(x):
        blocks = x.reshape((B * P, ps) + tuple(x.shape[2:]))
        y = torch.empty_like(blocks)
        y[perm] = blocks
        return y

    return (pages(kc), pages(ks), pages(vc), pages(vs), pages(pos),
            perm.reshape(B, P).to(torch.int32))


def _plain_ring(q, kc, ks, vc, vs, pos, qp, window=None):
    B, S, H, hd = q.shape
    KV = kc.shape[2]
    qf = q.reshape(B, S, KV, H // KV, hd) * (hd ** -0.5)
    return ref.verify_attn_quant_ref(qf, kc, ks, vc, vs, pos,
                                     qp.reshape(B, S), window).reshape(q.shape)


@pytest.mark.parametrize("window", [None, 200])
def test_decode_attn_quant_masked_splits(dev, window):
    """Sc=4096 in 256-row splits: slot 0 has two whole splits evicted; slot
    1 is written up to position 1000, so with a window of 200 only split 3
    attends and every other split is wholly masked; slot 2 is empty and
    queries at -1 (every row masked: the plain version's uniform average);
    slot 3 is a wrapped ring. The paged pool of the same rows gives the
    same bits."""
    B, Sc, KV, G, hd = 4, 4096, 8, 2, 128
    assert ops.attn_split_rows(B, KV, Sc) == 256
    rng = np.random.default_rng(7 + (window or 0))
    q_pos = np.array([Sc - 1, 1000, -1, 3 * Sc + 5], np.int32)
    kc, ks, vc, vs, pos = _ring(rng, B, Sc, KV, hd, dev, q_pos)
    pos[0, 512:1024] = -1
    q = _q(rng, B, 1, KV * G, hd, dev)
    qp = torch.from_numpy(q_pos).to(dev)
    out = ops.decode_attn_quant(q, kc, ks, vc, vs, pos, qp, window=window)
    torch.testing.assert_close(
        out, _plain_ring(q, kc, ks, vc, vs, pos, qp, window),
        rtol=2e-5, atol=2e-6)
    assert bool(torch.isfinite(out).all())
    pages = _ring_to_pages(rng, (kc, ks, vc, vs, pos), 16)
    assert torch.equal(
        ops.decode_attn_quant_paged(q, *pages, qp, window=window), out)


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("S", [1, 5, 8])
def test_verify_attn_quant_splits_as_one_token_launches(dev, layout, S):
    """At Sc=4096 (16 splits a query) verify query j is bit for bit the
    one-token launch at q_pos[:, j], on both layouts."""
    B, Sc, KV, G, hd = 4, 4096, 8, 2, 128
    rng = np.random.default_rng(S + (layout == "paged"))
    q_pos = np.array([Sc + 37, Sc - 1, Sc // 2, -1], np.int32)
    ring = _ring(rng, B, Sc, KV, hd, dev, np.maximum(q_pos, 0))
    paged = layout == "paged"
    cache = _ring_to_pages(rng, ring, 16) if paged else ring
    kern = ops.verify_attn_quant_paged if paged else ops.verify_attn_quant
    one = ops.decode_attn_quant_paged if paged else ops.decode_attn_quant
    q = _q(rng, B, S, KV * G, hd, dev)
    qp = _verify_positions(torch.from_numpy(q_pos), S).to(dev)
    out = kern(q, *cache, qp)
    torch.testing.assert_close(out, _plain_ring(q, *ring, qp), rtol=2e-5,
                               atol=2e-6)
    _check_verify(out, S, lambda j: one(q[:, j:j + 1].contiguous(), *cache,
                                        qp[:, j].contiguous()), (layout, S))


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_split_tickets_reset_between_launches(dev, layout):
    """The same launch gives the same bits again, also after launches of
    other grid sizes (5 splits on 2 slots, a 5-query verify): the block
    that combines a (slot, query, kv head) leaves its ticket at 0."""
    KV, G, hd = 8, 2, 128
    rng = np.random.default_rng(11)
    paged = layout == "paged"

    def launcher(B, Sc, S):
        q_pos = rng.integers(Sc // 2, 2 * Sc, B).astype(np.int32)
        ring = _ring(rng, B, Sc, KV, hd, dev, q_pos)
        cache = _ring_to_pages(rng, ring, 8) if paged else ring
        q = _q(rng, B, S, KV * G, hd, dev)
        if S == 1:
            fn = ops.decode_attn_quant_paged if paged else ops.decode_attn_quant
            qp = torch.from_numpy(q_pos).to(dev)
        else:
            fn = ops.verify_attn_quant_paged if paged else ops.verify_attn_quant
            qp = _verify_positions(torch.from_numpy(q_pos), S).to(dev)
        return lambda: fn(q, *cache, qp)

    big, small, verify = launcher(4, 4096, 1), launcher(2, 320, 1), \
        launcher(4, 1024, 5)
    first = big()
    again = big()
    s1, v1 = small(), verify()
    last = big()
    s2, v2 = small(), verify()
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, last)
    assert torch.equal(s1, s2) and torch.equal(v1, v2)
    assert all(int(t.abs().sum()) == 0 for t in ops._TICKETS.values())


@pytest.mark.parametrize("name", ["decode_attn_quant", "decode_attn_quant_paged",
                                  "verify_attn_quant", "verify_attn_quant_paged"])
def test_kernel_scales_q_as_the_wrapper_did(dev, name):
    """The kernel multiplies q by hd**-0.5 as it loads it: the bits of the
    pre-scale the wrapper used to launch. A launch on q equals a launch on
    ``q * hd**-0.5`` (the card's float32 multiply) with the scale 1."""
    B, Sc, KV, G, hd = 4, 320, 8, 2, 128
    S = 5 if name.startswith("verify") else 1
    rng = np.random.default_rng(len(name))
    q_pos = np.array([Sc + 37, Sc - 1, Sc // 2, -1], np.int32)
    ring = _ring(rng, B, Sc, KV, hd, dev, np.maximum(q_pos, 0))
    if name.endswith("paged"):
        *cache, table = _ring_to_pages(rng, ring, 8)
    else:
        cache, table = ring, None
    q = _q(rng, B, S, KV * G, hd, dev)
    qp = torch.from_numpy(q_pos).to(dev) if S == 1 else \
        _verify_positions(torch.from_numpy(q_pos), S).to(dev)
    out = ops._quant_attn(name, q, *cache, qp, table, None)
    pre = ops._quant_attn(name, q * (hd ** -0.5), *cache, qp, table, None,
                          q_scale=1.0)
    assert torch.equal(out, pre)


# the GQA shapes past 8 query heads per kv head: StarCoder2-7B (36 / 4 heads,
# its 4096-row window) and Granite-20B (48 / 1, multi-query)
WIDE_GQA = [("starcoder2-7b", 4, 9, 4096), ("granite-20b", 1, 48, None)]


@pytest.mark.parametrize("arch,KV,G,window", WIDE_GQA)
@pytest.mark.parametrize("Sc", [320, 4096])
def test_attention_past_eight_query_heads_per_kv_head(dev, arch, KV, G,
                                                      window, Sc):
    """All four launches at G > 8 (query rows in groups of at most 8, a
    block per group): within rtol 2e-5 / atol 2e-6 of the plain versions,
    the paged kernels bit for bit the ring kernels on the gathered view,
    verify bit for bit S one-token launches, the in-kernel q scale bit for
    bit a launch on pre-scaled q; one launch each, the tickets left zero."""
    B, hd, S = 4, 128, 5
    assert ops.attn_query_groups(G)[0] > 1
    rng = np.random.default_rng(G * 1000 + Sc)
    q_pos = np.array([Sc + 37, Sc - 1, Sc // 2, -1], np.int32)
    ring = _ring(rng, B, Sc, KV, hd, dev, np.maximum(q_pos, 0))
    pages = _ring_to_pages(rng, ring, 16)
    q1 = _q(rng, B, 1, KV * G, hd, dev)
    qs = _q(rng, B, S, KV * G, hd, dev)
    qp1 = torch.from_numpy(q_pos).to(dev)
    qp = _verify_positions(torch.from_numpy(q_pos), S).to(dev)
    n0 = dict(ops.launches)
    out = ops.decode_attn_quant(q1, *ring, qp1, window=window)
    out_p = ops.decode_attn_quant_paged(q1, *pages, qp1, window=window)
    ver = ops.verify_attn_quant(qs, *ring, qp, window=window)
    ver_p = ops.verify_attn_quant_paged(qs, *pages, qp, window=window)
    torch.cuda.synchronize()
    for name in ("decode_attn_quant", "decode_attn_quant_paged",
                 "verify_attn_quant", "verify_attn_quant_paged"):
        assert ops.launches[name] == n0[name] + 1, name
    torch.testing.assert_close(
        out, _plain_ring(q1, *ring, qp1[:, None], window), rtol=2e-5,
        atol=2e-6)
    torch.testing.assert_close(ver, _plain_ring(qs, *ring, qp, window),
                               rtol=2e-5, atol=2e-6)
    qf = q1.reshape(B, KV, G, hd) * (hd ** -0.5)
    want_p = ref.decode_attn_quant_paged_ref(qf, *pages, qp1, window)
    torch.testing.assert_close(out_p, want_p.reshape(out_p.shape),
                               rtol=2e-5, atol=2e-6)
    assert torch.equal(out_p, out)         # the gathered view is the ring
    assert torch.equal(ver_p, ver)
    _check_verify(ver, S, lambda j: ops.decode_attn_quant(
        qs[:, j:j + 1].contiguous(), *ring, qp[:, j].contiguous(),
        window=window), (arch, Sc, "ring"))
    _check_verify(ver_p, S, lambda j: ops.decode_attn_quant_paged(
        qs[:, j:j + 1].contiguous(), *pages, qp[:, j].contiguous(),
        window=window), (arch, Sc, "paged"))
    pre = ops._quant_attn("decode_attn_quant", q1 * (hd ** -0.5), *ring, qp1,
                          None, window, q_scale=1.0)
    assert torch.equal(pre, out)
    assert all(int(t.abs().sum()) == 0 for t in ops._TICKETS.values())


@pytest.mark.parametrize("G,hd,offset", [(3, 100, 0), (8, 72, 0), (8, 256, 0),
                                         (5, 4, 0), (2, 128, 4), (1, 64, 8)])
def test_decode_attn_quant_other_widths(dev, G, hd, offset):
    """Head widths off the 16-byte copy (hd % 16 != 0, or codes 4 or 8
    bytes past an aligned address: 4- and 8-byte copies), the 4- and
    8-row register instances, and G=8 at hd=256 (over 48 KB of shared
    memory) against the plain version; the paged pool of the same rows,
    copied 16 bytes at a time where hd allows, gives the same bits."""
    B, Sc, KV = 2, 700, 3
    rng = np.random.default_rng(G * hd + offset)
    q_pos = np.array([Sc + 9, Sc // 3], np.int32)
    kc, ks, vc, vs, pos = _ring(rng, B, Sc, KV, hd, dev, q_pos)

    def shifted(x):
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        y = buf[offset:].view(x.shape)
        y.copy_(x)
        return y

    kc_s, vc_s = shifted(kc), shifted(vc)
    assert kc_s.data_ptr() % 16 == offset % 16
    q = _q(rng, B, 1, KV * G, hd, dev)
    qp = torch.from_numpy(q_pos).to(dev)
    out = ops.decode_attn_quant(q, kc_s, ks, vc_s, vs, pos, qp)
    torch.testing.assert_close(out, _plain_ring(q, kc, ks, vc, vs, pos, qp),
                               rtol=2e-5, atol=2e-6)
    pages = _ring_to_pages(rng, (kc, ks, vc, vs, pos), 7)
    assert torch.equal(ops.decode_attn_quant_paged(q, *pages, qp), out)


@pytest.mark.parametrize("Sc,window", [(2048, 2048), (2048, 48), (320, 48)])
def test_decode_attn_quant_recurrentgemma_shape(dev, Sc, window):
    """recurrentgemma-2b's local attention: one kv head, G = 10 (two query
    groups of 5), hd 256, a ring of its 2048-row window (which masks no
    row of a full ring) and a 48-row window that masks; within rtol 2e-5 /
    atol 2e-6 of the plain version, one launch."""
    B, KV, G, hd = 4, 1, 10, 256
    assert ops.attn_query_groups(G) == (2, 5)
    rng = np.random.default_rng(Sc + window)
    q_pos = np.array([Sc + 600, Sc - 1, Sc // 2, 3], np.int32)
    kc, ks, vc, vs, pos = _ring(rng, B, Sc, KV, hd, dev, q_pos)
    q = _q(rng, B, 1, KV * G, hd, dev)
    qp = torch.from_numpy(q_pos).to(dev)
    n0 = ops.launches["decode_attn_quant"]
    out = ops.decode_attn_quant(q, kc, ks, vc, vs, pos, qp, window=window)
    torch.cuda.synchronize()
    assert ops.launches["decode_attn_quant"] == n0 + 1
    torch.testing.assert_close(
        out, _plain_ring(q, kc, ks, vc, vs, pos, qp[:, None], window),
        rtol=2e-5, atol=2e-6)


def test_decode_attn_quant_deepseek_shape(dev):
    """deepseek-moe-16b's decode attention: MHA, 16 kv heads of 128 with
    one query head each (G = 1), the serve ring of 320 rows; within rtol
    2e-5 / atol 2e-6 of the plain version, one launch."""
    B, KV, G, hd, Sc = 4, 16, 1, 128, 320
    rng = np.random.default_rng(16)
    q_pos = np.array([Sc + 37, Sc - 1, Sc // 2, 3], np.int32)
    kc, ks, vc, vs, pos = _ring(rng, B, Sc, KV, hd, dev, q_pos)
    q = _q(rng, B, 1, KV * G, hd, dev)
    qp = torch.from_numpy(q_pos).to(dev)
    n0 = ops.launches["decode_attn_quant"]
    out = ops.decode_attn_quant(q, kc, ks, vc, vs, pos, qp)
    torch.cuda.synchronize()
    assert ops.launches["decode_attn_quant"] == n0 + 1
    torch.testing.assert_close(
        out, _plain_ring(q, kc, ks, vc, vs, pos, qp[:, None], None),
        rtol=2e-5, atol=2e-6)


def test_verify_wrappers_reject_bad_operands(dev):
    rng = np.random.default_rng(6)
    kc, ks, vc, vs, pos = _ring(rng, 2, 64, 2, 64, dev, np.array([10, 20]))
    q = torch.zeros((2, 3, 4, 64), device=dev)
    qp = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                     # q_pos (B,) for S=3
        ops.verify_attn_quant(q, kc, ks, vc, vs, pos, qp[:, 0].contiguous())
    with pytest.raises(TypeError):                      # q_pos not int32
        ops.verify_attn_quant(q, kc, ks, vc, vs, pos, qp.long())
    with pytest.raises(ValueError):                     # H % KV != 0
        ops.verify_attn_quant(torch.zeros((2, 3, 35, 64), device=dev), kc, ks,
                              vc, vs, pos, qp)
    with pytest.raises(ValueError):                     # mixed devices
        ops.verify_attn_quant(q, kc, ks, vc, vs, pos, qp.cpu())


def test_spec_engine_on_the_card_syncs_only_between_rounds(dev, monkeypatch):
    """A speculative engine at smoke size through the kernels: every round
    runs under ``set_sync_debug_mode("error")`` (the host reads once, after
    it), one verify launch per layer and round and no one-token launch
    inside the verify pass, a rejected draft (so rows were rolled back), and
    the token-at-a-time engine's tokens on every decisive step, on both
    layouts."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import engine as teng
    from repro_torch.launch import serve as tserve
    from repro_torch.models import lm
    cfg = smoke_config("limpq-demo")
    params = lm.init_params(cfg, seed=0, device=dev)
    policy = tserve.demo_mixed_policy(cfg)
    reqs = tserve.build_requests(SyntheticLM(cfg), 5, 24, 8, stagger=True,
                                 share_prefix=16)
    fused, verify = teng.DecodeEngine._spec_fused, \
        teng.DecodeEngine._spec_verify_fn
    rounds, inside = [], []

    def guarded(self, *a):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fused(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def counted(self, *a):
        n0 = dict(ops.launches)
        out = verify(self, *a)
        inside.append({k: ops.launches[k] - n0[k] for k in n0})
        rounds.append(1)
        return out

    monkeypatch.setattr(teng.DecodeEngine, "_spec_fused", guarded)
    monkeypatch.setattr(teng.DecodeEngine, "_spec_verify_fn", counted)
    kw = dict(slots=3, cache_len=40, prefill_chunk=16, device=dev)
    for layout, name in (("ring", "verify_attn_quant"),
                         ("paged", "verify_attn_quant_paged")):
        lay = dict(kv_layout=layout, page_size=8)
        inside.clear()
        sess, eng, out = tserve.serve_quantized(cfg, params, policy, reqs,
                                                speculate=3, **kw, **lay)
        assert eng.stats.spec_rounds == len(inside) > 0
        # traced (the default): each guarded round carries its draft and
        # verify spans, timed by events read after the round's fence, and
        # the trace reconciles with the stats
        from repro_torch.obs import trace as obs_trace
        assert eng.trace is not None
        drafts = [e for e in eng.trace.events if e.name == "spec_draft"]
        assert len(drafts) == eng.stats.spec_rounds
        assert all(e.dur > 0 for e in drafts)
        assert obs_trace.reconcile(eng.trace, eng.stats.as_dict()) == []
        # a rejected draft: the rounds rolled rows back on this layout
        assert eng.stats.spec_accepted_tokens < eng.stats.spec_draft_tokens
        one = "decode_attn_quant" + ("_paged" if layout == "paged" else "")
        assert all(d[name] == cfg.n_layers and d[one] == 0 for d in inside)
        base, base_out = tserve.token_at_a_time(sess, cfg, reqs, eng)
        same, total, compared, bad = tserve.compare_spec(out, base, base_out)
        assert not bad and compared > 0, (layout, same, total, compared)
        if layout == "paged":
            eng.pool.check()


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
                                   (1024, 3072), (4099,), (2048, 5120)])
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


@pytest.mark.parametrize("bits", [2, 4, 6, 8])
@pytest.mark.parametrize("shape", [(64, 4, 2048), (64, 2048, 1408),
                                   (8, 3, 5), (6, 1), (3, 7, 2, 9)])
def test_fake_quant_fwd_with_a_scale_per_slice(dev, bits, shape):
    """A scale per leading slice (deepseek's (64, 1, 1) per-expert scale
    over its decode expert input and an expert weight stack; ragged slices
    that take the scalar path): one launch, bit for bit the plain version
    and the broadcasting Eq. 1; a zero scale meets the 1e-9 floor."""
    rng = np.random.default_rng(bits + len(shape))
    v = torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(
        np.float32)).to(dev)
    qmin, qmax = float(-2 ** (bits - 1)), float(2 ** (bits - 1) - 1)
    s_shape = (shape[0],) + (1,) * (len(shape) - 1)
    s = torch.from_numpy(rng.uniform(0.02, 0.4, s_shape).astype(
        np.float32) / qmax).to(dev)
    s[1] = 0.0
    n0 = ops.launches["fake_quant_fwd"]
    out = ops.fake_quant_fwd(v, s, qmin, qmax)
    torch.cuda.synchronize()
    assert ops.launches["fake_quant_fwd"] == n0 + 1
    assert torch.equal(out, ref.fake_quant_ref(v, s, qmin, qmax))
    sf = torch.clamp(s, min=1e-9)
    assert torch.equal(out, torch.round(torch.clamp(v / sf, qmin, qmax)) * sf)
    # the backward takes the same scales in one launch
    n0 = ops.launches["fake_quant_bwd"]
    dv, ds = ops.fake_quant_bwd(v, s, v, qmin, qmax)
    torch.cuda.synchronize()
    assert ops.launches["fake_quant_bwd"] == n0 + 1
    assert dv.shape == v.shape and ds.shape == (shape[0],)


def _ds_tol_per_slice(v, s, g, qmin, qmax, ds_plain):
    """``_ds_tol`` for each slice of a scale per leading slice: 1e-4 of
    |ds| plus 1e-6 of the slice's sum |g * dsd| (float32 sums in another
    order)."""
    n_s = s.numel()
    sf = torch.clamp(s.reshape(n_s, 1), min=1e-9)
    vs = v.reshape(n_s, -1) / sf
    inside = (vs > qmin) & (vs < qmax)
    c = torch.clamp(vs, qmin, qmax)
    terms = (g.reshape(n_s, -1)
             * torch.where(inside, torch.round(c) - vs, c)).abs().sum(1)
    return 1e-4 * ds_plain.abs() + 1e-6 * terms


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("shape", [(64, 2048, 1408), (64, 256, 2048),
                                   (64, 4, 2048), (8, 3, 5), (6, 1),
                                   (3, 7, 2, 9)])
def test_fake_quant_bwd_with_a_scale_per_slice(dev, bits, shape):
    """The LSQ backward with a scale per leading slice (deepseek's (64, 1,
    1) per-expert scale over an expert stack (64, 2048, 1408) and its
    training expert input (64, 256, 2048); ragged slices that take the
    scalar path): one launch, dv bit for bit the plain version, one ds per
    slice within ``_ds_tol_per_slice``; a zero scale meets the 1e-9
    floor."""
    rng = np.random.default_rng(bits * 10 + len(shape))
    v = torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(
        np.float32)).to(dev)
    # an output gradient with a mean, so each ds is a well-conditioned sum
    g = torch.from_numpy((1 + 0.5 * rng.standard_normal(shape)).astype(
        np.float32)).to(dev)
    qmin, qmax = float(-2 ** (bits - 1)), float(2 ** (bits - 1) - 1)
    s_shape = (shape[0],) + (1,) * (len(shape) - 1)
    s = torch.from_numpy(rng.uniform(0.02, 0.4, s_shape).astype(
        np.float32) / qmax).to(dev)
    s[1] = 0.0
    n0 = ops.launches["fake_quant_bwd"]
    dv, ds = ops.fake_quant_bwd(v, s, g, qmin, qmax)
    torch.cuda.synchronize()
    assert ops.launches["fake_quant_bwd"] == n0 + 1
    dv_p, ds_p = ref.fake_quant_grads_ref(v, s, g, qmin, qmax)
    assert torch.equal(dv, dv_p)
    assert ds.shape == ds_p.shape == (shape[0],)
    assert bool(((ds - ds_p).abs()
                 <= _ds_tol_per_slice(v, s, g, qmin, qmax, ds_p)).all())
    # one scale: the scalar ds of before
    one = s[2].reshape(())
    dv1, ds1 = ops.fake_quant_bwd(v, one, g, qmin, qmax)
    dv1_p, ds1_p = ref.fake_quant_grads_ref(v, one, g, qmin, qmax)
    assert ds1.dim() == 0 and torch.equal(dv1, dv1_p)
    assert abs(float(ds1) - float(ds1_p)) <= _ds_tol(v, one, g, qmin, qmax,
                                                     ds1_p)


def test_moe_qat_step_through_the_kernels_matches_plain(dev):
    """One QAT step of deepseek-moe-16b's smoke config cut to 2 layers (the
    dense layer and one MoE layer of 8 experts) on the card: through the
    fake-quant kernels (the expert stacks' weights and inputs with a scale
    per expert) and through their plain versions. The forward is bit for
    bit, so the loss is equal; the gradients within 1e-4 (relative L2 of
    each leaf: ds sums in another order), every expert bank's included; the
    updated params after one AdamW step within 1e-5."""
    from repro_torch import optim, training
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.models.quant_layers import QuantContext
    from repro_torch.training import value_and_grad
    cfg = smoke_config("deepseek-moe-16b").scaled(n_layers=2)
    ctx = QuantContext.make(cfg.bits, cfg.quant_act_signed,
                            compute_dtype=torch.float32)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in SyntheticLM(cfg).batch(0, 2, 64).items()}
    bits = lm.bits_uniform(cfg, 1)
    params = lm.init_params(cfg, seed=0, device=dev)

    def leaves(tree, pre=""):
        out = {}
        for k, v in tree.items():
            key = f"{pre}/{k}" if pre else k
            out.update(leaves(v, key) if isinstance(v, dict) else {key: v})
        return out

    def run():
        ops.reset_launches()
        loss, _, g = value_and_grad(
            lambda p: lm.loss_fn(p, cfg, batch, bits, ctx, remat=False),
            params)
        opt = optim.adamw(3e-3, clip_norm=1.0)
        step = training.make_train_step(cfg, ctx, opt, bits, remat=False)
        new, _, _ = step(params, opt.init(params), batch)
        torch.cuda.synchronize()
        return loss, leaves(g), leaves(new), dict(ops.launches)

    lk, gk, pk, nk = run()
    with ops.plain_on_cuda("fake_quant_fwd", "fake_quant_bwd"):
        lp, gp, pp, np_ = run()
    assert nk["fake_quant_bwd"] > 0 and np_["fake_quant_bwd"] == 0
    assert torch.equal(lk, lp)
    banks = [k for k in gp if "/moe/" in k and k.endswith(("s_w", "s_a"))
             and "shared" not in k]
    assert len(banks) == 6
    for k in gp:
        rel = float((gk[k] - gp[k]).norm() / gp[k].norm().clamp_min(1e-30))
        assert rel <= 1e-4, (k, rel)
    for k in pp:
        torch.testing.assert_close(pk[k], pp[k], rtol=1e-5, atol=1e-7)


def test_moe_combine_and_expert_layer_repeat_bit_for_bit(dev):
    """The MoE combine at deepseek's widths (64 experts, top-6, d_model
    2048) over 256 tokens whose capacity of 128 drops picks: two equal
    calls on the card equal, and equal to the CPU's evaluation (the same
    adds in the same order). Then a packed MoE layer of the smoke config
    on the card (the expert route's per-expert fake-quant kernel): two
    equal calls bit for bit equal."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import lm, moe as moe_mod
    cfg = get_config("deepseek-moe-16b")
    g = torch.Generator(device=dev).manual_seed(0)
    T = 256
    xf = torch.randn((T, cfg.d_model), generator=g, device=dev)
    w = torch.randn((cfg.d_model, 64), generator=g, device=dev) * 0.02
    xf[:, 0], w[0, 5] = 2.0, 4.0
    r = moe_mod.route(xf, w, cfg.moe)
    assert r.gi.shape == (64, 128) and int(r.keep[5].sum()) == 128
    y = torch.randn((64, 128, cfg.d_model), generator=g, device=dev) \
        * (r.gv * r.keep)[..., None]
    a = moe_mod.combine(y, r.gi, r.keep, r.top_i, T)
    b = moe_mod.combine(y, r.gi, r.keep, r.top_i, T)
    c = moe_mod.combine(y.cpu(), r.gi.cpu(), r.keep.cpu(), r.top_i.cpu(), T)
    assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    small = smoke_config("deepseek-moe-16b")
    sess = serve.build_session(small, lm.init_params(small, seed=0,
                                                     device=dev),
                               serve.demo_mixed_policy(small))
    p = sess.params["sites"]["001"]
    x = torch.randn((4, 1, small.d_model), generator=g, device=dev)
    n0 = ops.launches["fake_quant_fwd"]
    y1, aux1 = moe_mod.moe_ffn(x, p["moe"], small.moe, None, sess.ctx,
                               small.act, small.mlp_gated)
    y2, aux2 = moe_mod.moe_ffn(x, p["moe"], small.moe, None, sess.ctx,
                               small.act, small.mlp_gated)
    torch.cuda.synchronize()
    assert ops.launches["fake_quant_fwd"] - n0 == 2 * 3
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)


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


FLASH_CASES = [(hd, S, causal, window, G) for hd in (32, 64, 128)
               for S in (64, 192)
               for causal, window in ((True, None), (True, 40), (False, None),
                                      (False, 100))
               for G in (1, 2, 4)] + \
    [(128, S, causal, window, G) for S in (320, 2048)
     for causal, window in ((True, None), (True, 512), (False, None))
     for G in (1, 2, 4)] + \
    [(256, S, causal, window, G) for S in (64, 192)
     for causal, window in ((True, None), (True, 40), (False, None),
                            (False, 100))
     for G in (1, 2, 10)] + \
    [(256, 2560, True, 2048, G) for G in (1, 2, 10)] + \
    [(256, 2048, True, None, 10)] + \
    [(80, S, causal, window, G) for S in (64, 192)
     for causal, window in ((True, None), (True, 40), (False, None),
                            (False, 100))
     for G in (1, 2, 4)] + \
    [(80, 2048, causal, None, 1) for causal in (False, True)] + \
    [(hd, 256, causal, window, G) for hd in (32, 64, 80, 128)
     for causal, window in ((True, None), (True, 40), (False, None))
     for G in (1, 3)]


@pytest.mark.parametrize("hd,S,causal,window,G", FLASH_CASES)
def test_flash_fwd_kernel_against_plain(dev, hd, S, causal, window, G):
    """Every instance (hd 32/64/80/128: two query heads per block when G is
    even; one head over 128 positions when G is odd and S % 128 == 0 (S =
    256, 2048), else over 64 (S = 64, 192, 320); hd 256, one query head per
    block over 32-row kv tiles, at recurrentgemma-2b's G = 10 and its
    2048-row local window over a 2560-token prompt; hd 80 at
    hubert-xlarge's bidirectional S = 2048), tiles that the window leaves
    wholly or partly masked, and the causal schedule's long rows at S =
    2048."""
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


@pytest.mark.parametrize("hd", [32, 80, 128])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_fwd_non_causal_window_past_the_q_block(dev, hd, G):
    """A bidirectional window at S > window + q_block: the kernel attends
    every key the mask admits, keys after the query's block among them, as
    the Pallas kernel does. The plain blockwise schedule in 64-row blocks
    slices each q block's keys as if causal (ROADMAP 3), so the plain
    version here runs one block over all S rows."""
    B, S, KV, window = 1, 256, 2, 100
    rng = np.random.default_rng(hd + G)
    q = torch.from_numpy((rng.standard_normal((B, S, KV, G, hd)) * hd ** -0.5)
                         .astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32)).to(dev)
    out, lse = ops.flash_fwd(q, k, v, causal=False, window=window)
    out_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=False, window=window,
                                     q_block=S, kv_block=S)
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
    q96 = torch.zeros((1, 128, 2, 2, 96), device=dev)   # no instance
    kv96 = torch.zeros((1, 128, 2, 96), device=dev)
    with pytest.raises(ValueError, match="hd=96"):
        ops.flash_fwd(q96, kv96, kv96, causal=False)
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


# ---------------------------------------------------------------------------
# RWKV6 wkv
# ---------------------------------------------------------------------------
WKV_CASES = [(1, 32, 1, 16, 16), (2, 64, 4, 32, 32), (4, 96, 8, 64, 32),
             (3, 2048, 2, 64, 32), (1, 256, 64, 64, 32), (2, 160, 16, 64, 16),
             (1, 48, 3, 16, 16), (4, 32, 64, 64, 32), (2, 96, 4, 16, 16),
             (1, 64, 2, 32, 16), (4, 2048, 4, 64, 32), (4, 2048, 8, 8, 16),
             (1, 2048, 64, 64, 32)]


def _wkv_operands(dev, B, S, H, hd, seed, decay=None):
    """Seeded operands; log-decays in -[0.01, 2], or all ``decay``."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    r, k, v = (t(rng.standard_normal((B, S, H, hd))) for _ in range(3))
    lw = t(np.full((B, S, H, hd), decay) if decay is not None
           else -rng.uniform(0.01, 2.0, (B, S, H, hd)))
    u = t(rng.standard_normal((H, hd)) * 0.5)
    s0 = t(rng.standard_normal((B, H, hd, hd)) * 0.3)
    return r, k, v, lw, u, s0


@pytest.mark.parametrize("case", WKV_CASES)
@pytest.mark.parametrize("given_state", [False, True])
@pytest.mark.parametrize("decay", [None, -8.0, -40.0])
def test_wkv_kernel_against_plain(dev, case, given_state, decay):
    """y and the final state against the chunked plain version to 2e-4
    (atol and rtol, the reference's wkv_pallas contract: the cumulative
    sums run in another order), from zero or a given state, with
    log-decays in -[0.01, 2], at log w = -8 and at log w = -40 (where
    e^{-L} alone would overflow within three rows), finite throughout."""
    B, S, H, hd, T = case
    r, k, v, lw, u, s0 = _wkv_operands(dev, B, S, H, hd, sum(case), decay)
    st = s0 if given_state else None
    n0 = ops.launches["wkv"]
    y, state = ops.wkv(r, k, v, lw, u, st, chunk=T)
    torch.cuda.synchronize()
    assert ops.launches["wkv"] == n0 + 1
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    yp, sp = ref.wkv_chunked_ref(r, k, v, lw, u, st, chunk=T)
    assert torch.allclose(y, yp, atol=2e-4, rtol=2e-4), \
        float((y - yp).abs().max())
    assert torch.allclose(state, sp, atol=2e-4, rtol=2e-4), \
        float((state - sp).abs().max())


def test_wkv_wrapper_rejects_bad_operands(dev):
    r, k, v, lw, u, s0 = _wkv_operands(dev, 1, 64, 2, 16, 0)
    with pytest.raises(TypeError):                      # no float64 route
        ops.wkv(r.double(), k.double(), v.double(), lw.double(), u.double())
    with pytest.raises(ValueError, match="multiple"):   # S % chunk
        ops.wkv(r[:, :40].contiguous(), k[:, :40].contiguous(),
                v[:, :40].contiguous(), lw[:, :40].contiguous(), u)
    with pytest.raises(ValueError, match="chunk"):      # chunk 8
        ops.wkv(r, k, v, lw, u, chunk=8)
    wide = [torch.zeros((1, 32, 2, 48), device=dev) for _ in range(4)]
    with pytest.raises(ValueError, match="hd"):         # hd 48
        ops.wkv(*wide, torch.zeros((2, 48), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, lw, u)
    with pytest.raises(ValueError, match="shape"):
        ops.wkv(r, k, v, lw, u, s0[:, :1].contiguous())
    with pytest.raises(ValueError, match="mixed devices"):
        ops.wkv(r, k, v, lw, u.cpu())
    off = torch.zeros(r.numel() + 1, device=dev)[1:].view(r.shape)
    with pytest.raises(ValueError, match="aligned"):    # float4 loads
        ops.wkv(off, k, v, lw, u)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.wkv(r.requires_grad_(), k, v, lw, u)
    r.requires_grad_(False)
    n0 = ops.launches["wkv"]
    with ops.plain_on_cuda("wkv"):                      # float64, plain
        y, _ = ops.wkv(r.double(), k.double(), v.double(), lw.double(),
                       u.double())
    assert ops.launches["wkv"] == n0 and y.dtype == torch.float64


def test_rwkv_engine_on_the_card_launches_wkv_in_prefill_only(dev,
                                                            monkeypatch):
    """A smoke rwkv engine through the kernels: ``wkv`` once per layer in
    each prefill of a multiple of 32 and never in a decode step, every
    decode step under ``set_sync_debug_mode("error")``, and the fake-quant
    reference's tokens on every decisive step."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.scheduler import Request
    from repro_torch.models import lm
    from repro_torch.runtime.session import QuantizedSession
    cfg = smoke_config("rwkv6-7b")
    params = lm.init_params(cfg, seed=0, device=dev)
    policy = tserve.demo_mixed_policy(cfg)
    data = SyntheticLM(cfg)
    lens = [64, 32, 20, 96, 45]
    reqs = [Request(i, data.batch(i, 1, n)["tokens"][0], 6)
            for i, n in enumerate(lens)]
    decode = QuantizedSession.decode
    in_decode = []

    def guarded(self, *a):
        n0 = ops.launches["wkv"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return decode(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            in_decode.append(ops.launches["wkv"] - n0)

    monkeypatch.setattr(QuantizedSession, "decode", guarded)
    kw = dict(slots=2, cache_len=112, prefill_chunk=128, device=dev)
    n0 = dict(ops.launches)
    sess, eng, out = tserve.serve_quantized(cfg, params, policy, reqs, **kw)
    launched = {k: ops.launches[k] - n0[k] for k in n0}
    chunked = sum(n % 32 == 0 for n in lens)
    assert launched["wkv"] == cfg.n_layers * chunked
    assert launched["quant_matmul"] > 0 and launched["quant_matmul_w4"] > 0
    assert len(in_decode) == eng.stats.decode_steps > 0
    assert not any(in_decode)
    assert sess.route_counts.eligible_fp == 0
    compared, bad, _ = tserve.check_greedy(cfg, params, policy, reqs, out,
                                           **kw)
    assert not bad and compared > 0


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_elastic_engine_on_the_card_swaps_without_packing(dev, monkeypatch,
                                                          layout):
    """The elastic engine at smoke size through the kernels: a ramp of
    arrivals downshifts the bank once the slots drain, nothing is packed
    after the bank is built, the matmul kernels and the layout's attention
    kernel launch, no kernel-eligible matmul of any variant falls back to
    dequant-fp, and every completion is bit for bit its variant's
    single-policy packed engine on the card."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import elastic
    from repro_torch.launch import engine as teng
    from repro_torch.launch import serve as tserve
    from repro_torch.models import lm
    from repro_torch.obs import trace as obs_trace
    from repro_torch.runtime import packing
    from repro_torch.runtime.session import (ElasticSession,
                                             QuantizedSession,
                                             bank_fingerprint)
    cfg = smoke_config("limpq-demo")
    params = lm.init_params(cfg, seed=0, device=dev)
    bank = elastic.build_variant_bank(lm.enumerate_qlayers(cfg), cfg.bits,
                                      (3.0, 4.0, 6.0),
                                      family=bank_fingerprint(params))
    sess = ElasticSession(cfg, params, bank.policies,
                          tserve.make_context(cfg), active=bank.full)
    reqs = tserve.build_requests(SyntheticLM(cfg), 8, 16, 6, stagger=True,
                                 arrive_every=1,
                                 share_prefix=8 if layout == "paged" else 0)
    packs = []
    real = packing.pack_linear
    monkeypatch.setattr(packing, "pack_linear",
                        lambda *a, **kw: packs.append(1) or real(*a, **kw))
    ecfg = teng.EngineConfig(slots=2, cache_len=32, prefill_chunk=16,
                             kv_quant="int8", kv_layout=layout)
    eng = teng.DecodeEngine(sess.params, cfg, None, sess.ctx, adapter=sess,
                            device=dev, ecfg=ecfg,
                            elastic=elastic.ElasticController(
                                cfg, bank, slots=2, cache_len=32))
    eng.submit_all(reqs)
    n0 = dict(ops.launches)
    out = eng.run()
    launched = {k: ops.launches[k] - n0[k] for k in n0}
    assert not packs
    st = eng.stats
    assert st.policy_swaps_down >= 1 and st.admissions_deferred_swap >= 1
    attn = "decode_attn_quant" + ("_paged" if layout == "paged" else "")
    assert launched["quant_matmul"] > 0 and launched["quant_matmul_w4"] > 0
    assert launched[attn] > 0
    assert all(c.eligible_fp == 0 for c in sess.variant_route_counts.values())
    assert obs_trace.reconcile(eng.trace, st.as_dict()) == []
    per_variant = {}
    for c in out.values():
        per_variant.setdefault(c.policy_id, []).append(c.rid)
    assert len(per_variant) >= 2
    monkeypatch.setattr(packing, "pack_linear", real)
    for pid, rids in per_variant.items():
        one = QuantizedSession(cfg, params, bank.policies[pid],
                               tserve.make_context(cfg))
        e1 = teng.DecodeEngine(one.params, cfg, None, one.ctx, adapter=one,
                               device=dev, ecfg=ecfg)
        e1.submit_all([r for r in reqs if r.rid in set(rids)])
        o1 = e1.run()
        assert all(o1[r].tokens == out[r].tokens for r in rids), pid
    if layout == "paged":
        eng.pool.check()
