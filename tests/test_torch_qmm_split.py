"""The split-K matmul route's split over K and its launch plumbing, on the
CPU.

``ops.qmm_split_k`` picks the K rows each block of
``csrc/quant_matmul.cu``'s split-K route takes (M <= 16), for int8 and
nib4 weights alike; the wrappers pass it, with the cached workspace, to
one launch. The kernels run only
on the card (``test_torch_cuda.py``); here a stand-in library records what
the wrappers would launch, so the rule and the plumbing -- one launch a
call, the route by M, a workspace that is zeroed once -- are held without
one.
"""
import ctypes

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

from repro_torch.kernels import _build, ops, ref

H100_SMS = 132
# (K, N) of the Qwen3-0.6B projections (wq, wk/wv, wo, mlp_wi/wg, mlp_wo)
# and of the RWKV6-7B ones (receptance and the rest of the time mix,
# channel-mix key, channel-mix value)
QWEN3_KN = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
            (3072, 1024)]
RWKV6_KN = [(4096, 4096), (4096, 14336), (14336, 4096)]


def _n_split(K, ks):
    return -(-K // ks)


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("K,N", QWEN3_KN + RWKV6_KN
                         + [(1, 1), (31, 64), (33, 65), (200, 72), (130, 33),
                            (65536, 16), (4096, 65536)])
def test_split_k_tiles_k_exactly(M, K, N):
    """ks is a positive multiple of the kernel's 32-row step, the slabs
    cover K with no empty one, and one instance's x slab holds ks rows."""
    ks = ops.qmm_split_k(M, K, N)
    assert ks >= ops.QMM_STEP_K and ks % ops.QMM_STEP_K == 0
    n = _n_split(K, ks)
    assert (n - 1) * ks < K <= n * ks
    mr = next(r for r in ops.QMM_ROWS if r >= M)
    assert ks <= (4096 if mr <= 4 else 16384 // mr)


@pytest.mark.parametrize("M", [0, 17, 128])
def test_split_k_refuses_rows_past_the_route(M):
    """The rule serves the split-K route only (1 <= M <= 16)."""
    with pytest.raises(ValueError):
        ops.qmm_split_k(M, 1024, 1024)


@pytest.mark.parametrize("K,N", QWEN3_KN + RWKV6_KN)
def test_split_k_fills_two_waves_at_decode(K, N):
    """At M = 4 (the serve phase's slots) every Qwen3-0.6B and RWKV6-7B
    projection launches at least two waves of the H100's 132 SMs; the
    old design launched ceil(N / 64) blocks (16-224)."""
    assert ops.QMM_TARGET_BLOCKS == 2 * H100_SMS
    ks = ops.qmm_split_k(4, K, N)
    blocks = -(-N // ops.QMM_TILE_N) * _n_split(K, ks)
    assert blocks >= 2 * H100_SMS, (K, N, ks, blocks)


class _Lib:
    """Stands in for the built ``quant_matmul`` library: records each entry
    point's arguments and reports a clean launch."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("qmm_"):
            return lambda *a: self.calls.append((name, a)) or 0
        raise AttributeError(name)


@pytest.fixture
def lib(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(ops, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(ops, "_stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(ops, "_TICKETS", {})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    return lib


def _operands(rng, M, K, N, w4=False):
    x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    if w4:
        w = torch.from_numpy(rng.integers(0, 256, (K // 2, N)).astype(np.uint8))
    else:
        w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8))
    return x, w, torch.tensor(0.0173), torch.tensor([0.0391])


@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 128])
@pytest.mark.parametrize("K,N", [(1024, 3072), (4096, 14336), (130, 33)])
def test_wrapper_launches_once_with_the_split_and_route(lib, M, K, N):
    """One launch a call on the counter and in the library: the split-K
    entry point with ``qmm_split_k``'s rows, the tickets and then the
    partial sums in the cached split scratch (``ops._tickets``) for M <=
    16; the tensor-core entry point above. The scratch is allocated zeroed
    once and never re-zeroed by a call."""
    rng = np.random.default_rng(M + K + N)
    x, w, s_x, s_w = _operands(rng, M, K, N)
    for rep in range(2):
        lib.calls.clear()
        n0 = ops.launches["quant_matmul"]
        out = ops.quant_matmul(x, w, s_x, s_w)
        assert out.shape == (M, N) and out.dtype == torch.float32
        assert ops.launches["quant_matmul"] == n0 + 1
        (name, a), = lib.calls
        ptrs = a[:5]
        assert ptrs == (x.data_ptr(), w.data_ptr(), s_x.data_ptr(),
                        s_w.data_ptr(), out.data_ptr())
        types = _build.SYMBOLS["quant_matmul"][name]
        assert len(a) == len(types)
        if M > 16:
            assert name == "qmm_int8_mma" and a[5:8] == (M, N, K)
            assert not ops._TICKETS
            continue
        assert name == "qmm_int8_splitk"
        tickets, ws_ptr = a[5:7]
        assert a[7:11] == (M, N, K, ops.qmm_split_k(M, K, N))
        (t,) = ops._TICKETS.values()
        n_tiles = -(-N // ops.QMM_TILE_N)
        assert tickets == t.data_ptr() and ws_ptr == t.data_ptr() + 4 * n_tiles
        assert t.dtype == torch.int32 and t.numel() >= n_tiles + M * N
        assert int(t.abs().sum()) == 0
        if rep == 0:
            first = t
        else:
            assert t is first                 # the same buffer, not re-zeroed


def test_workspace_grows_only_when_too_small(lib):
    """A larger call replaces the cached scratch with a larger zeroed one;
    smaller calls after it keep that one."""
    rng = np.random.default_rng(0)
    small = _operands(rng, 4, 256, 64)
    big = _operands(rng, 16, 256, 70000)
    ops.quant_matmul(*small)
    (t0,) = ops._TICKETS.values()
    ops.quant_matmul(*big)
    (t1,) = ops._TICKETS.values()
    assert t1 is not t0 and t1.numel() >= -(-70000 // 64) + 16 * 70000
    ops.quant_matmul(*small)
    (t2,) = ops._TICKETS.values()
    assert t2 is t1


@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 128])
@pytest.mark.parametrize("K,N", [(1024, 3072), (4096, 14336), (202, 40)])
def test_w4_wrapper_launches_once_with_the_split_and_route(lib, M, K, N):
    """``quant_matmul_w4``: one launch a call on the counter and in the
    library, routed by M as ``quant_matmul``: the nib4 split-K entry point
    with ``qmm_split_k``'s rows and the shared split scratch (tickets, then
    partial sums) for M <= 16, the nib4 tensor-core entry point above. The
    scratch is allocated zeroed once and never re-zeroed by a call."""
    rng = np.random.default_rng(M + K + N)
    x, w, s_x, s_w = _operands(rng, M, K, N, w4=True)
    for rep in range(2):
        lib.calls.clear()
        n0 = ops.launches["quant_matmul_w4"]
        out = ops.quant_matmul_w4(x, w, s_x, s_w)
        assert out.shape == (M, N) and out.dtype == torch.float32
        assert ops.launches["quant_matmul_w4"] == n0 + 1
        (name, a), = lib.calls
        assert a[:5] == (x.data_ptr(), w.data_ptr(), s_x.data_ptr(),
                         s_w.data_ptr(), out.data_ptr())
        assert len(a) == len(_build.SYMBOLS["quant_matmul"][name])
        if M > 16:
            assert name == "qmm_w4_mma" and a[5:8] == (M, N, K)
            assert not ops._TICKETS
            continue
        assert name == "qmm_w4_splitk"
        assert a[7:11] == (M, N, K, ops.qmm_split_k(M, K, N))
        (t,) = ops._TICKETS.values()
        n_tiles = -(-N // ops.QMM_TILE_N)
        assert a[5] == t.data_ptr() and a[6] == t.data_ptr() + 4 * n_tiles
        assert t.numel() >= n_tiles + M * N and int(t.abs().sum()) == 0
        if rep == 0:
            first = t
        else:
            assert t is first                 # the same buffer, not re-zeroed


@pytest.mark.parametrize("K,N", QWEN3_KN + RWKV6_KN)
def test_w4_split_fills_two_waves_at_decode(lib, K, N):
    """The nib4 route's split, as its wrapper launches it at M = 4: the same
    rule as int8 (a 32-row step is 16 packed rows), at least two waves of
    the H100's 132 SMs at every Qwen3-0.6B and RWKV6-7B projection, K
    tiled exactly."""
    x = torch.zeros((4, K), dtype=torch.int8)
    w = torch.zeros((K // 2, N), dtype=torch.uint8)
    ops.quant_matmul_w4(x, w, torch.tensor(0.5), torch.tensor(0.5))
    (name, a), = lib.calls
    assert name == "qmm_w4_splitk"
    ks = a[10]
    assert ks % ops.QMM_STEP_K == 0 and (_n_split(K, ks) - 1) * ks < K
    blocks = -(-N // ops.QMM_TILE_N) * _n_split(K, ks)
    assert blocks >= 2 * H100_SMS, (K, N, ks, blocks)


@pytest.mark.parametrize("M", [1, 4, 16, 17, 128])
def test_cpu_routes_are_the_plain_versions(M):
    """On CPU tensors both matmul wrappers return the plain versions bit for
    bit, whatever route the card would take."""
    rng = np.random.default_rng(M)
    x, w, s_x, s_w = _operands(rng, M, 320, 200)
    assert torch.equal(ops.quant_matmul(x, w, s_x, s_w),
                       ref.quant_matmul_ref(x, w, s_x, s_w))
    x, w4, s_x, s_w = _operands(rng, M, 320, 200, w4=True)
    assert torch.equal(ops.quant_matmul_w4(x, w4, s_x, s_w),
                       ref.quant_matmul_w4_ref(x, w4, s_x, s_w))


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_flash_cpu_route_is_the_plain_version(G, causal, window):
    """On CPU tensors ``flash_fwd`` returns its plain version bit for bit
    (every G the kernel serves with one or two query heads per block)."""
    rng = np.random.default_rng(G)
    B, S, KV, hd = 1, 128, 2, 32
    q = torch.from_numpy(rng.standard_normal((B, S, KV, G, hd))
                         .astype(np.float32)) * hd ** -0.5
    k = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    kw = dict(causal=causal, window=window, q_block=64, kv_block=64)
    out, lse = ops.flash_fwd(q, k, v, **kw)
    want, want_lse = ref.flash_fwd_ref(q, k, v, **kw)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
