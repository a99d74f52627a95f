"""The split of the decode-attention kernels over cache rows, on the CPU.

``ops.attn_split_rows`` picks the rows each block of
``csrc/decode_attn_quant.cu`` takes; the wrappers pass it to every entry
point. The kernel itself runs only on the card (``test_torch_cuda.py``);
here a stand-in library records what the wrappers would launch, so the
split's plumbing -- the same rows for every query count and for a paged
launch and the ring launch on its gathered view -- is held without one.
"""
import ctypes

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

from repro_torch.kernels import _build, ops, ref
from repro_torch.runtime.kv_cache import PagedKVCache

H100_SMS = 132


def _n_split(Sc, L):
    return max(1, -(-Sc // L))


@pytest.mark.parametrize("B,KV", [(1, 1), (4, 8), (8, 8), (2, 2), (64, 8)])
@pytest.mark.parametrize("Sc", [1, 63, 64, 65, 320, 1000, 4096, 4097, 32768])
def test_split_rows_tile_the_cache(B, KV, Sc):
    """L is a positive multiple of the 64-row tile, the splits cover Sc with
    no empty one, and the launch spreads a slot's tiles over at most the
    splits its block target asks for and more than half of them (every tile
    its own block when there are fewer tiles than that)."""
    L = ops.attn_split_rows(B, KV, Sc)
    assert L % ops.ATTN_TILE == 0 and L >= ops.ATTN_TILE
    n = _n_split(Sc, L)
    assert (n - 1) * L < Sc <= n * L
    n_tiles = -(-Sc // ops.ATTN_TILE)
    want = -(-ops.ATTN_TARGET_BLOCKS // (B * KV))
    if n_tiles <= want:
        assert (L, n) == (ops.ATTN_TILE, n_tiles)
    else:
        assert want / 2 < n <= want


def test_split_rows_fill_the_card_at_the_serve_shape():
    """Qwen3-0.6B's decode (4 slots, 8 kv heads, a 320-row ring): one tile
    per block, 160 blocks on the H100's 132 SMs (32 without the split);
    at 4096 rows, 256-row splits and 512 blocks."""
    B, KV = 4, 8
    assert ops.ATTN_TARGET_BLOCKS == 4 * H100_SMS
    L = ops.attn_split_rows(B, KV, 320)
    assert (L, B * KV * _n_split(320, L)) == (64, 160)
    assert B * KV * _n_split(320, L) >= H100_SMS
    L = ops.attn_split_rows(B, KV, 4096)
    assert (L, B * KV * _n_split(4096, L)) == (256, 512)


class _Lib:
    """Stands in for the built ``decode_attn_quant`` library: records each
    entry point's arguments and reports a clean launch."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith(("decode_attn", "verify_attn")):
            return lambda *a: self.calls.append((name, a)) or 0
        raise AttributeError(name)


def _inputs(rng, B, S, KV, G, hd, P, ps):
    """A paged pool with a permuted, partly unmapped table, its gathered
    ring view, and S queries per slot (CPU tensors)."""
    n_pages = B * P + 3
    table = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    table[1, P // 2] = -1
    pos = rng.integers(-1, P * ps, (n_pages, ps)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    kp = t(rng.integers(-127, 128, (n_pages, ps, KV, hd)).astype(np.int8))
    vp = t(rng.integers(-127, 128, (n_pages, ps, KV, hd)).astype(np.int8))
    ks = t(rng.uniform(1e-3, 2e-2, (n_pages, ps, KV)).astype(np.float32))
    vs = t(rng.uniform(1e-3, 2e-2, (n_pages, ps, KV)).astype(np.float32))
    paged = (kp, ks, vp, vs, t(pos), t(table))
    d = PagedKVCache(kp, vp, ks, vs, t(pos), t(table)).gather()
    ring = tuple(x.contiguous() for x in (d.k, d.k_scale, d.v, d.v_scale,
                                          d.pos))
    q = t(rng.standard_normal((B, S, KV * G, hd)).astype(np.float32))
    qp = t(rng.integers(-1, P * ps, (B, S)).astype(np.int32))
    return paged, ring, q, qp


@pytest.mark.parametrize("P,ps", [(40, 8), (5, 13), (256, 16), (3, 1)])
def test_wrappers_launch_one_split_for_every_S_and_layout(monkeypatch, P, ps):
    """What the four wrappers hand the kernel, through a stand-in library:
    the same rows per split for the one-token and the verify entry points
    at every S and for the paged launch and the ring launch on its gathered
    view; q as given (no pre-scale launch) with the scale hd**-0.5 as a
    float32 argument; partials for every split when there are several;
    tickets for every (slot, query, kv head)."""
    lib = _Lib()
    monkeypatch.setattr(ops, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(ops, "_stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(ops, "_TICKETS", {})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    B, KV, G, hd = 4, 8, 2, 128
    rng = np.random.default_rng(P * ps)
    want_L = ops.attn_split_rows(B, KV, P * ps)
    n_split = _n_split(P * ps, want_L)
    for S in (1, 5, 8):
        paged, ring, q, qp = _inputs(rng, B, S, KV, G, hd, P, ps)
        calls = [
            (ops.verify_attn_quant, (q, *ring, qp)),
            (ops.verify_attn_quant_paged, (q, *paged, qp)),
        ]
        if S == 1:
            calls += [(ops.decode_attn_quant, (q, *ring, qp[:, 0].contiguous())),
                      (ops.decode_attn_quant_paged,
                       (q, *paged, qp[:, 0].contiguous()))]
        for fn, args in calls:
            lib.calls.clear()
            fn(*args)
            (name, a), = lib.calls
            assert name == fn.__name__
            types = _build.SYMBOLS["decode_attn_quant"][name]
            assert len(a) == len(types) and types[-2] is ctypes.c_float
            n_ptr = 11 if name.endswith("paged") else 10
            assert types[:n_ptr] == [ctypes.c_void_p] * n_ptr
            ptrs, ints, (scale, stream) = a[:n_ptr], a[n_ptr:-2], a[-2:]
            assert ptrs[0] == q.data_ptr()
            assert scale == hd ** -0.5 and stream.value is None
            assert ints[-1] == want_L, (name, S, ints)
            assert tuple(ints[-5:-1]) == (KV, G, hd, 0)
            part, tickets = ptrs[-2], ptrs[-1]
            assert (part is None) == (n_split == 1)
            t = ops._TICKETS[(None, None)]
            assert tickets == t.data_ptr() and t.numel() >= B * S * KV
            assert int(t.abs().sum()) == 0


@pytest.mark.parametrize("G,want", [(1, (1, 1)), (2, (1, 2)), (8, (1, 8)),
                                    (9, (2, 5)), (10, (2, 5)), (36, (5, 8)),
                                    (48, (6, 8)), (17, (3, 6))])
def test_query_groups_cover_every_row(G, want):
    """A kv head's G query rows in ceil(G / 8) balanced groups of at most 8
    rows (csrc/decode_attn_quant.cu's blockIdx.z): every group holds at
    least one row and together they hold G."""
    n, gb = ops.attn_query_groups(G)
    assert (n, gb) == want
    assert gb <= ops.ATTN_MAX_G and (n - 1) * gb < G <= n * gb


@pytest.mark.parametrize("KV,G", [(4, 9), (1, 48), (8, 2)])
def test_wrappers_take_any_query_group_and_ticket_each(monkeypatch, KV, G):
    """Past 8 query heads per kv head the wrappers launch (no refusal on a
    CUDA tensor), hand the kernel G and the split of (B, KV, Sc) alone, and
    give it a zeroed ticket for every (slot, query, kv head, query group)."""
    lib = _Lib()
    monkeypatch.setattr(ops, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(ops, "_stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(ops, "_TICKETS", {})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    B, hd, P, ps, S = 4, 128, 40, 8, 5
    rng = np.random.default_rng(KV * G)
    paged, ring, q, qp = _inputs(rng, B, S, KV, G, hd, P, ps)
    n_grp = ops.attn_query_groups(G)[0]
    for fn, args in [(ops.verify_attn_quant, (q, *ring, qp)),
                     (ops.verify_attn_quant_paged, (q, *paged, qp)),
                     (ops.decode_attn_quant, (q[:, :1].contiguous(), *ring,
                                              qp[:, 0].contiguous())),
                     (ops.decode_attn_quant_paged,
                      (q[:, :1].contiguous(), *paged, qp[:, 0].contiguous()))]:
        lib.calls.clear()
        fn(*args, window=4096)
        (name, a), = lib.calls
        assert name == fn.__name__
        assert tuple(a[-7:-2]) == (KV, G, hd, 4096,
                                   ops.attn_split_rows(B, KV, P * ps))
        t = ops._TICKETS[(None, None)]
        n_q = S if name.startswith("verify") else 1
        assert t.numel() >= B * n_q * KV * n_grp
        assert int(t.abs().sum()) == 0


@pytest.mark.parametrize("name", ["decode_attn_quant", "decode_attn_quant_paged",
                                  "verify_attn_quant", "verify_attn_quant_paged"])
def test_cpu_route_is_the_plain_version_on_prescaled_q(name):
    """On CPU tensors the wrappers still scale q by hd**-0.5 and run the
    plain versions, bit for bit."""
    B, KV, G, hd, P, ps = 3, 2, 2, 16, 5, 4
    S = 3 if name.startswith("verify") else 1
    rng = np.random.default_rng(len(name))
    paged, ring, q, qp = _inputs(rng, B, S, KV, G, hd, P, ps)
    cache = paged if name.endswith("paged") else ring
    qp = qp if S > 1 else qp[:, 0].contiguous()
    got = getattr(ops, name)(q, *cache, qp)
    qf = q.reshape(B, S, KV, G, hd) * (hd ** -0.5)
    plain = getattr(ref, name + "_ref")
    want = plain(qf, *cache, qp, None) if S > 1 else \
        plain(qf[:, 0], *cache, qp, None)
    assert torch.equal(got, want.reshape(B, S, KV * G, hd))
