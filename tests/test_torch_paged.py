"""The paged-KV serving slice, port against the JAX reference, on the CPU.

Cache operations cross over bit for bit: the same numpy cache state and the
same numpy rows go through the reference's ``PagedKVCache`` and the port's
(``interop.paged_cache_from_numpy``), and every field must come out equal.
Paged attention is held to the reference's int8 decode-attention contract
(rtol 2e-5 / atol 2e-6, ``tests/test_quant_attention.py:93``) against the
Pallas kernel in interpret mode; inside the port, paged attention over the
page table equals ring attention over the same rows bit for bit. Engines
compare greedy tokens: exactly within the port, on decisive steps (top-2
margin above 1e-2) across frameworks.

The page pool carries a repair: the reference admits with ``lookup_prefix``
-> ``alloc_with_freed`` -> ``ref(shared)``, and the allocation can drop the
very registry entry that pinned the pages the lookup returned. The port
takes the slot's reference first (``PagePool`` docstring,
``engine._admit_paged``).
"""
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401
from hypothesis import example, given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
from repro.kernels import quant_attention as jqa             # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.launch.scheduler import Request as JRequest       # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.runtime import kv_cache as jkv                    # noqa: E402
from repro.runtime.session import QuantizedSession as JSess  # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch.scheduler import Request as TRequest  # noqa: E402
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.runtime import dispatch as tdisp            # noqa: E402
from repro_torch.runtime import kv_cache as tkv              # noqa: E402
from repro_torch.runtime.session import QuantizedSession as TSess  # noqa: E402

# logits of one forward, JAX vs port (tests/test_torch_serve.py's bound)
LOGIT_ATOL, LOGIT_RTOL = 2e-4, 1e-4
ATTN_RTOL, ATTN_ATOL = 2e-5, 2e-6
DECISIVE = 1e-2
FIELDS = tkv.PagedKVCache._fields


# ---------------------------------------------------------------------------
# page pool: the repaired admission order
# ---------------------------------------------------------------------------
def _pool_workload(max_pages, seed, n_pages, *, ref_first):
    """The reference's random admit/share/release workload
    (``tests/test_page_pool.py``) on the port's pool; ``ref_first`` takes
    the slot's reference on the shared pages before allocating (the port's
    order), else after (the reference's). Returns the pool after a full
    drain."""
    r = np.random.RandomState(seed)
    pool = tkv.PagePool(n_pages, 4)
    vocab = [bytes([b]) * 3 for b in range(4)]
    live = {}
    next_slot = 0
    for _ in range(30):
        pool.check()
        if live and r.rand() < 0.4:
            slot = r.choice(list(live))
            pool.release(live.pop(slot))
            continue
        n = int(r.randint(1, max_pages + 1))
        chain = [b"".join(vocab[r.randint(len(vocab))] for _ in range(j + 1))
                 for j in range(n)]
        for j in range(1, n):   # chains must be prefix-consistent
            chain[j] = chain[j - 1] + chain[j]
        shared = list(pool.lookup_prefix(chain))
        if ref_first:
            pool.ref(shared)
        try:
            fresh, _ = pool.alloc_with_freed(n - len(shared))
        except RuntimeError:
            if ref_first:
                pool.release(shared)
            continue
        if not ref_first:
            pool.ref(shared)
        pages = shared + fresh
        assert len(set(pages)) == len(pages), f"page mapped twice: {pages}"
        pool.register_prefix(chain, pages)
        live[next_slot] = pages
        next_slot += 1
    for pages in live.values():
        pool.release(pages)
    while pool.registered_prefixes:
        pool.drop_lru_prefix()
    return pool


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=1, max_value=4),       # pages per prompt max
       st.integers(min_value=0, max_value=5),       # rng seed
       st.integers(min_value=6, max_value=12))      # pool size
@example(max_pages=3, seed=5, n_pages=8)
def test_port_pool_random_workload_never_leaks(max_pages, seed, n_pages):
    pool = _pool_workload(max_pages, seed, n_pages, ref_first=True)
    pool.check()
    assert pool.free_count == n_pages, "pages leaked after full drain"
    assert pool.unique_pages_in_use == 0


def test_reference_admission_order_refs_a_freed_page():
    """The input hypothesis finds against the reference's pool: allocating
    before taking the reference drops the registry entry that pinned the
    looked-up pages, and ``ref`` then finds one of them free."""
    with pytest.raises(AssertionError, match="ref of free page"):
        _pool_workload(3, 5, 8, ref_first=False)


def test_port_pool_matches_reference_pool_op_for_op():
    """One random operation sequence through both pools: the same ids, free
    lists, refcounts and counts after every operation."""
    r = np.random.RandomState(3)
    pools = [jkv.PagePool(10, 4), tkv.PagePool(10, 4)]
    held = []
    for step in range(60):
        op, cnt = r.randint(5), int(r.randint(1, 4))
        outs = []
        for pool in pools:
            if op == 0:
                try:
                    outs.append(pool.alloc_with_freed(cnt))
                except RuntimeError as e:
                    outs.append(str(e))
            elif op == 1 and held:
                outs.append(pool.release(held[-1]))
            elif op == 2 and held:
                keys = [bytes([k]) * (j + 1) for j, k in
                        enumerate(held[-1][:3])]
                outs.append(pool.register_prefix(keys, held[-1][:3]))
            elif op == 3:
                outs.append(pool.drop_lru_prefix())
            else:
                outs.append(pool.lookup_prefix([bytes([1]), bytes([1, 1])]))
        if op == 0 and not isinstance(outs[0], str):
            held.append(outs[0][0])
        elif op == 1 and held:
            held.pop()
        assert outs[0] == outs[1], (step, op, outs)
        a, b = pools
        assert (a._free, a.refcount, a.available_count, a.unique_pages_in_use,
                a.registered_prefixes) == \
            (b._free, b.refcount, b.available_count, b.unique_pages_in_use,
             b.registered_prefixes), step


# ---------------------------------------------------------------------------
# cache operations, bit for bit
# ---------------------------------------------------------------------------
def _pool_arrays(rng, B, P, ps, KV, hd, n_pages, next_pos, share=2):
    """A paged cache state: page ids permuted at random, slots 1.. sharing
    slot 0's first ``share`` pages, a -1 hole inside slot 2's table and the
    last slot's tail unmapped, positions written up to ``next_pos[b]``, and
    a few evicted rows (pos -1)."""
    perm = list(rng.permutation(n_pages))
    table = np.full((B, P), -1, np.int32)
    for b in range(B):
        for j in range(P - (1 if b == B - 1 else 0)):
            table[b, j] = table[0, j] if (b and j < share) else perm.pop()
    if B > 2:
        table[2, share] = -1
    pos = np.full((n_pages, ps), -1, np.int32)
    for b in range(B):
        for t in range(max(next_pos[b], 0)):
            pid = table[b, t // ps]
            if pid >= 0:
                pos[pid, t % ps] = t
    pos[rng.integers(0, n_pages, 3), rng.integers(0, ps, 3)] = -1
    return dict(
        k=rng.integers(-127, 128, (n_pages, ps, KV, hd)).astype(np.int8),
        v=rng.integers(-127, 128, (n_pages, ps, KV, hd)).astype(np.int8),
        k_scale=rng.uniform(1e-3, 2e-2, (n_pages, ps, KV)).astype(np.float32),
        v_scale=rng.uniform(1e-3, 2e-2, (n_pages, ps, KV)).astype(np.float32),
        pos=pos, page_table=table)


def _both(arrays):
    return (jkv.PagedKVCache(*(jnp.asarray(arrays[f]) for f in FIELDS)),
            interop.paged_cache_from_numpy(arrays, "cpu"))


def _equal(jc, tc, what=""):
    assert type(tc).__name__ == type(jc).__name__, what
    for f in jc._fields:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)),
                                      f"{what}:{f}")


def test_cache_operations_bitwise():
    B, P, ps, KV, hd, n_pages = 4, 4, 4, 2, 8, 20
    rng = np.random.default_rng(0)
    arrays = _pool_arrays(rng, B, P, ps, KV, hd, n_pages, [13, 9, 16, 5])
    jc, tc = _both(arrays)
    _equal(jc.gather(), tc.gather(), "gather")
    _equal(jc.gather_slot(2), tc.gather_slot(2), "gather_slot")
    # one decode row per slot: live, sentinel, unmapped (slot 2's hole) and
    # past capacity
    k_new = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    pos = np.array([13, -1, 2 * ps + 1, P * ps + 3], np.int32)
    jc2 = jc.append(jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos))
    tc2 = tc.append(torch.from_numpy(k_new), torch.from_numpy(v_new),
                    torch.from_numpy(pos))
    _equal(jc2, tc2, "append")
    _equal(jc, tc, "append leaves its input unchanged")
    # a chunk for slot 3 with -1 pad rows
    C = 6
    k_c = rng.standard_normal((1, C, KV, hd)).astype(np.float32)
    v_c = rng.standard_normal((1, C, KV, hd)).astype(np.float32)
    q_pos = np.array([5, 6, 7, 8, -1, -1], np.int32)
    _equal(jc2.append_rows(jnp.asarray(k_c), jnp.asarray(v_c),
                           jnp.asarray(q_pos), 3),
           tc2.append_rows(torch.from_numpy(k_c), torch.from_numpy(v_c),
                           torch.from_numpy(q_pos), 3), "append_rows")
    row = np.array([3, -1, 7, 11], np.int32)
    _equal(jc2.map_slot(1, jnp.asarray(row)),
           tc2.map_slot(1, torch.from_numpy(row)), "map_slot")
    _equal(jc2.evict(0), tc2.evict(0), "evict")
    ids = np.full((n_pages,), -1, np.int32)
    ids[:3] = [4, 0, n_pages - 1]
    _equal(jc2.free_pages(jnp.asarray(ids)),
           tc2.free_pages(torch.from_numpy(ids)), "free_pages")
    assert tc2.inventory() == jc2.inventory()
    # tree accounting: the pool's meta counts once per state tree
    jtree = {"sites": {"0": jc2, "1": jc}}
    ttree = {"sites": {"0": tc2, "1": tc}}
    assert tkv.tree_inventory(ttree) == jkv.tree_inventory(jtree)
    assert tkv.tree_inventory(ttree)["meta"] == 2 * n_pages * 4
    assert tkv.find_paged(ttree) is tc2
    assert tkv.find_paged({"sites": {"0": tkv.init_kv_cache(
        1, 4, KV, hd, quant=True, per_slot=True)}}) is None


@pytest.mark.parametrize("case", ["sentinel", "unmapped", "overflow"])
def test_dropped_write_never_touches_a_live_row(case):
    """A dropped write whose clipped target is the row a live slot writes
    in the same call: the live row holds the live values, the other rows
    are unchanged, and both packages agree bit for bit."""
    ps, P, KV, hd, n_pages = 4, 3, 1, 8, 8
    table = np.array([[5, 2, 6], [5, 0, 1], [3, -1, 4]], np.int32)
    drop_slot = {
        # slot 1 at -1 clips to its position 0: page 5, row 0 -- slot 0's
        # position 0
        "sentinel": (1, -1),
        # slot 2's position 5 is in its unmapped block 1; clipped naively
        # to page 0 it lands on page 0 row 1 -- slot 1 writes there below
        "unmapped": (2, 5),
        # slot 1 past capacity clips to position P*ps-1: page 1, row 3
        "overflow": (1, P * ps + 2),
    }[case]
    pos = np.array([0, 4 + 1, 0], np.int32)      # slot 1 -> page 0, row 1
    if case == "overflow":
        table[0] = [1, 2, 6]                      # slot 0's position 3 ->
        pos[0] = 3                                # page 1, row 3
    b, p = drop_slot
    pos[b] = p
    rng = np.random.default_rng(1)
    arrays = dict(
        k=rng.integers(-127, 128, (n_pages, ps, KV, hd)).astype(np.int8),
        v=rng.integers(-127, 128, (n_pages, ps, KV, hd)).astype(np.int8),
        k_scale=np.full((n_pages, ps, KV), 0.5, np.float32),
        v_scale=np.full((n_pages, ps, KV), 0.25, np.float32),
        pos=np.full((n_pages, ps), -1, np.int32), page_table=table)
    jc, tc = _both(arrays)
    k_new = rng.standard_normal((3, 1, KV, hd)).astype(np.float32)
    v_new = rng.standard_normal((3, 1, KV, hd)).astype(np.float32)
    jn = jc.append(jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos))
    tn = tc.append(torch.from_numpy(k_new), torch.from_numpy(v_new),
                   torch.from_numpy(pos))
    _equal(jn, tn, case)
    kq, ks = tkv.quantize_rows(torch.from_numpy(k_new))
    written = 0
    for s in range(3):
        if s == b:
            continue
        blk = int(pos[s]) // ps
        pid, row = int(table[s, blk]), int(pos[s]) % ps
        assert torch.equal(tn.k[pid, row], kq[s, 0]), (case, s)
        assert float(tn.k_scale[pid, row, 0]) == float(ks[s, 0, 0])
        assert int(tn.pos[pid, row]) == pos[s]
        written += 1
    # exactly the live rows changed
    changed = (tn.pos != tc.pos).sum() + (tn.k_scale != tc.k_scale).sum()
    assert int(changed) == 2 * written, case


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("window", [None, 9])
def test_plain_paged_attention_matches_pallas_interpret(ps, window):
    """The port's plain version (gather + ``decode_attn_quant_ref``)
    against the reference's Pallas kernel in interpret mode, on permuted
    page ids, shared pages, unmapped entries inside and at the end of a
    table row, evicted rows and a slot whose query position is -1."""
    B, P, KV, G, hd = 4, 4, 2, 2, 16
    rng = np.random.default_rng(ps + (window or 0))
    n_pages = B * P + 3
    q_pos = np.array([P * ps - 1, ps + 2, 3 * ps, -1], np.int32)
    arrays = _pool_arrays(rng, B, P, ps, KV, hd, n_pages,
                          [P * ps, ps + 3, 3 * ps + 1, 2 * ps])
    q = rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32)
    jo = jqa.decode_attn_quant_paged(
        jnp.asarray(q), *(jnp.asarray(arrays[f]) for f in
                          ("k", "k_scale", "v", "v_scale", "pos",
                           "page_table")),
        jnp.asarray(q_pos), window=window, interpret=True)
    t = {f: torch.from_numpy(a) for f, a in arrays.items()}
    n0 = ops.launches["decode_attn_quant_paged"]
    to = ops.decode_attn_quant_paged(
        torch.from_numpy(q), t["k"], t["k_scale"], t["v"], t["v_scale"],
        t["pos"], t["page_table"], torch.from_numpy(q_pos), window=window)
    assert ops.launches["decode_attn_quant_paged"] == n0   # plain: no launch
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=ATTN_RTOL,
                               atol=ATTN_ATOL)


def _ring_arrays(rng, B, cap, KV, hd, next_pos):
    """A non-wrapping per-slot int8 ring: row b holds positions
    0..next_pos[b]-1; unwritten rows keep pos -1."""
    kq, ks = tkv.quantize_rows(torch.from_numpy(
        rng.standard_normal((B, cap, KV, hd)).astype(np.float32)))
    vq, vs = tkv.quantize_rows(torch.from_numpy(
        rng.standard_normal((B, cap, KV, hd)).astype(np.float32)))
    pos = np.full((B, cap), -1, np.int32)
    for b, p in enumerate(next_pos):
        pos[b, :max(p, 0)] = np.arange(max(p, 0))
    return tkv.QuantKVCache(kq, vq, ks, vs, torch.from_numpy(pos))


def _paged_from_ring(cache, ps, perm):
    """The ring's rows through a page table: slot b's block j lives in page
    ``perm[b * P + j]`` (the reference's identity map, permuted)."""
    B, cap, KV, hd = cache.k.shape
    P = cap // ps
    inv = np.argsort(perm)

    def pages(a):
        return a.reshape((B * P, ps) + tuple(a.shape[2:]))[inv]

    return tkv.PagedKVCache(
        pages(cache.k), pages(cache.v), pages(cache.k_scale),
        pages(cache.v_scale), pages(cache.pos),
        torch.from_numpy(perm.astype(np.int32).reshape(B, P)))


@pytest.mark.parametrize("kvg", [(1, 2), (2, 2)])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ps", [4, 8])
def test_paged_decode_bitwise_identical_to_ring(kvg, seed, ps):
    """The reference's paged-vs-ring contract
    (``tests/test_quant_attention.py:259``) in the port: the same logical
    rows through a (permuted) page table give bit-identical decode
    attention on the dequant-fp route, and on the fused route too (on the
    CPU its plain version is the ring's plain version on the gathered
    view), and the decode write lands at the same logical row. A sentinel
    (-1) slot is the one write divergence by design: ring clamps the write
    to slot 0, paged drops it."""
    KV, G = kvg
    B, hd, H, P = 3, 8, KV * G, 2
    cap = P * ps
    rng = np.random.default_rng(seed)
    next_pos = [cap - 1, max(1, cap // 2), -1]
    ring = _ring_arrays(rng, B, cap, KV, hd, next_pos)
    paged = _paged_from_ring(ring, ps, rng.permutation(B * P))
    np.testing.assert_array_equal(paged.gather().pos.numpy(), ring.pos.numpy())
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
    k_new = torch.from_numpy(rng.standard_normal((B, 1, KV, hd))
                             .astype(np.float32))
    v_new = torch.from_numpy(rng.standard_normal((B, 1, KV, hd))
                             .astype(np.float32))
    pos = torch.tensor(next_pos, dtype=torch.int32)
    active = [b for b, p in enumerate(next_pos) if p >= 0]
    for route in ("dequant-fp", "fused"):
        with tdisp.force_route("decode_attn", route):
            out_r, c_r = tattn.decode_attention(q, ring, k_new, v_new, pos,
                                                window=None)
            out_p, c_p = tattn.decode_attention(q, paged, k_new, v_new, pos,
                                                window=None)
        assert torch.equal(out_p[active], out_r[active]), route
        g = c_p.gather()
        assert torch.equal(g.pos, c_r.pos), route
        for f in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(g, f)[active],
                               getattr(c_r, f)[active]), (route, f)


def test_append_attention_matches_jax():
    """``append_attention`` on the same numpy chunk and cache state: the
    cache bit for bit, the output to the attention contract."""
    B, P, ps, KV, G, hd, n_pages = 3, 4, 4, 2, 2, 16, 16
    rng = np.random.default_rng(7)
    arrays = _pool_arrays(rng, B, P, ps, KV, hd, n_pages, [9, 6, 11])
    jc, tc = _both(arrays)
    C = 8
    q = rng.standard_normal((1, C, KV * G, hd)).astype(np.float32)
    k = rng.standard_normal((1, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((1, C, KV, hd)).astype(np.float32)
    q_pos = np.array([6, 7, 8, 9, 10, 11, -1, -1], np.int32)
    jo, jn = jattn.append_attention(jnp.asarray(q), jc, jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(q_pos), 1,
                                    window=None)
    to, tn = tattn.append_attention(torch.from_numpy(q), tc,
                                    torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(q_pos), 1, window=None)
    _equal(jn, tn, "append_attention")
    live = q_pos >= 0
    np.testing.assert_allclose(to.numpy()[:, live], np.asarray(jo)[:, live],
                               rtol=ATTN_RTOL, atol=ATTN_ATOL)
    with pytest.raises(TypeError, match="PagedKVCache"):
        tattn.append_attention(torch.from_numpy(q), tc.gather(),
                               torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(q_pos), 1, window=None)


# ---------------------------------------------------------------------------
# session and engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    jcfg = j_smoke("qwen3-0.6b").scaled(head_dim=48)
    tcfg = t_smoke("qwen3-0.6b").scaled(head_dim=48)
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    return jcfg, tcfg, jparams, tparams, jpol, tpol


@pytest.fixture(scope="module")
def jsess(world):
    jcfg, _, jparams, _, jpol, _ = world
    return JSess(jcfg, jparams, jpol)


def test_session_append_matches_jax(world, jsess):
    """``QuantizedSession.append`` for one slot, two chunks (the second
    padded): logits to the serve tolerance; the paged caches' codes,
    v-scales, positions and tables bit for bit, and the k-scales to rtol
    1e-6. The k rows pass qk-norm (rsqrt) and RoPE (cos, sin), which XLA
    and PyTorch round differently in the last bits; a scale is max|k| /
    127, so it inherits them (on this input 21 of 288 k-scales, at most
    2.2e-7 relative, and never a code).
    On identical rows the cache write is bit for bit
    (``test_append_attention_matches_jax``)."""
    jcfg, tcfg, _, tparams, _, tpol = world
    ts = TSess(tcfg, tparams, tpol)
    ps, cap, C = 4, 24, 8
    jlay = jkv.KVCacheLayout(kind="paged", quant="int8", page_size=ps)
    tlay = tkv.KVCacheLayout(kind="paged", quant="int8", page_size=ps)
    jst = jsess.init_state(2, cap, jnp.float32, per_slot=True, layout=jlay)
    tst = ts.init_state(2, cap, torch.float32, per_slot=True, layout=tlay)
    row = np.array([7, 2, 9, 0, 4, 11], np.int32)
    jst = jax.tree.map(lambda c: c.map_slot(1, jnp.asarray(row)), jst,
                       is_leaf=lambda x: isinstance(x, jkv.PagedKVCache))
    tst = {"sites": {k: c.map_slot(1, torch.from_numpy(row))
                     for k, c in tst["sites"].items()}}
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, 13)
    for start in (0, C):
        n = min(C, 13 - start)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = toks[start:start + n]
        qpos = np.full((C,), -1, np.int32)
        qpos[:n] = np.arange(start, start + n)
        jl, jst = jsess.append(jsess.params, jnp.asarray(chunk),
                               jnp.asarray(qpos), jnp.asarray(1, jnp.int32),
                               jnp.asarray(n - 1, jnp.int32), jst)
        tl, tst = ts.append(ts.params, torch.from_numpy(chunk),
                            torch.from_numpy(qpos), 1, n - 1, tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    for key, tc in tst["sites"].items():
        jc = jst["sites"][key]
        for f in jc._fields:
            if f == "k_scale":
                np.testing.assert_allclose(tc.k_scale.numpy(),
                                           np.asarray(jc.k_scale), rtol=1e-6,
                                           atol=0)
            else:
                np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                              np.asarray(getattr(jc, f)),
                                              f"{key}:{f}")


def _shared_prefix_requests(Req):
    """tests/test_engine.py:225's traffic: three prompts share a 16-token
    (2-page) prefix, one does not."""
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 400, size=16)

    def mk(rid, tail, arrival=0):
        toks = np.concatenate(
            [shared, rng.integers(1, 400, size=tail)]).astype(np.int32)
        return Req(rid=rid, tokens=toks, max_new=4, arrival=arrival)

    return [mk(0, 5), mk(1, 3, 1), mk(2, 7, 2),
            Req(rid=3, tokens=rng.integers(1, 400, size=9).astype(np.int32),
                max_new=4, arrival=2)]


def _port_engine(tcfg, tparams, policy, layout, **kw):
    sess = TSess(tcfg, tparams, policy)
    ecfg = teng.EngineConfig(**dict(dict(
        slots=2, cache_len=29, prefill_chunk=16, kv_quant="int8",
        kv_layout=layout, page_size=8), **kw))
    return teng.DecodeEngine(sess.params, tcfg, None, sess.ctx, adapter=sess,
                             ecfg=ecfg, device="cpu")


def test_paged_engine_equals_ring_engine_and_saves_prefill(world):
    _, tcfg, _, tparams, _, tpol = world
    reqs = _shared_prefix_requests(TRequest)
    toks, stats = {}, {}
    for layout in ("ring", "paged"):
        eng = _port_engine(tcfg, tparams, tpol, layout)
        eng.submit_all(reqs)
        out = eng.run()
        toks[layout] = {r.rid: out[r.rid].tokens for r in reqs}
        stats[layout] = eng.stats
        if layout == "paged":
            eng.pool.check()
            assert all(s is None for s in eng.slots)
            assert eng.stats.kv_unique_pages == eng.pool.unique_pages_in_use
    assert toks["paged"] == toks["ring"]
    assert stats["paged"].prefill_flops_saved > 0
    assert stats["ring"].prefill_flops_saved == 0
    assert stats["paged"].prefix_hit_tokens == 2 * 16
    assert stats["paged"].prefill_tokens < stats["ring"].prefill_tokens
    assert stats["paged"].prefill_compiles == 1
    assert stats["paged"].kv_unique_pages > 0
    assert stats["paged"].decode_steps == stats["ring"].decode_steps


def test_paged_engine_matches_jax_paged_engine(world, jsess):
    """The same traffic through the reference's paged engine: the same
    prefix hits and decode steps, and the same greedy tokens on every
    decisive step."""
    jcfg, tcfg, _, tparams, _, tpol = world
    je = jeng.DecodeEngine(
        jsess.params, jcfg, None, jsess.ctx,
        ecfg=jeng.EngineConfig(slots=2, cache_len=29, prefill_chunk=16,
                               kv_quant="int8", kv_layout="paged",
                               page_size=8, trace=False),
        adapter=jsess)
    je.submit_all(_shared_prefix_requests(JRequest))
    jout = je.run()
    te = _port_engine(tcfg, tparams, tpol, "paged")
    te.submit_all(_shared_prefix_requests(TRequest))
    tout = te.run()
    assert te.stats.prefix_hit_tokens == je.stats.prefix_hit_tokens
    assert te.stats.prefill_tokens == je.stats.prefill_tokens
    assert te.stats.decode_steps == je.stats.decode_steps
    assert te.stats.prefill_flops_saved == je.stats.prefill_flops_saved
    compared = 0
    for rid, c in tout.items():
        n, miss = teng.decisive_prefix(jout[rid].tokens, c.tokens,
                                       te.margins[rid], DECISIVE)
        assert miss is None, (rid, jout[rid].tokens, c.tokens)
        compared += n
    assert compared >= 4


def test_small_pool_admission_drops_lru_prefixes(world):
    """A pool of one slot's pages: the second request's prefix hit must
    drop the first request's longer registered chain to find its fresh
    pages. The slot's reference on the shared pages is taken first, so the
    drop cannot free them; the run drains with a clean pool and the ring
    engine's tokens."""
    _, tcfg, _, tparams, _, tpol = world
    rng = np.random.default_rng(5)
    base = rng.integers(1, 400, size=12).astype(np.int32)
    reqs = [TRequest(0, base, 4),
            TRequest(1, np.concatenate([base[:8], [401]]).astype(np.int32),
                     4, arrival=1)]
    kw = dict(slots=1, cache_len=16, page_size=4)
    ring = _port_engine(tcfg, tparams, tpol, "ring", **kw)
    ring.submit_all(reqs)
    want = {r: c.tokens for r, c in ring.run().items()}
    eng = _port_engine(tcfg, tparams, tpol, "paged", n_pages=4, **kw)
    eng.submit_all(reqs[:1])
    eng.run()
    pool = eng.pool
    assert pool.registered_prefixes == 3 and pool.free_count == 1
    eng.submit(reqs[1])
    eng.run()
    pool.check()
    assert eng.stats.prefix_hit_tokens == 8
    assert pool.registered_prefixes == 2          # two chains dropped, two
    got = {r: c.tokens for r, c in eng.completions.items()}  # registered
    assert got == want


def test_paged_engine_validation(world):
    _, tcfg, _, tparams, _, tpol = world
    bits = tlm.bits_from_policy(tcfg, tpol)
    ctx = tserve.make_context(tcfg)
    with pytest.raises(ValueError, match="kv_layout"):
        teng.DecodeEngine(tparams, tcfg, bits, ctx, device="cpu",
                          ecfg=teng.EngineConfig(kv_layout="blocked"))
    # the fake-quant reference adapter has no chunked append path
    with pytest.raises(ValueError, match="append-capable"):
        teng.DecodeEngine(tparams, tcfg, bits, ctx, device="cpu",
                          ecfg=teng.EngineConfig(kv_quant="int8",
                                                 kv_layout="paged"))
    fp = TSess(tcfg, tparams, tpol, kv_quant="none")
    with pytest.raises(ValueError, match="int8"):
        teng.DecodeEngine(fp.params, tcfg, None, fp.ctx, adapter=fp,
                          device="cpu",
                          ecfg=teng.EngineConfig(kv_layout="paged"))
    swa = tcfg.scaled(sliding_window=8)
    sess = TSess(swa, tparams, tpol)
    with pytest.raises(ValueError, match="sliding-window"):
        teng.DecodeEngine(sess.params, swa, None, sess.ctx, adapter=sess,
                          device="cpu",
                          ecfg=teng.EngineConfig(kv_quant="int8",
                                                 kv_layout="paged"))
    with pytest.raises(ValueError, match="paged KV requires"):
        tkv.KVCacheLayout(kind="paged", quant="none")
    with pytest.raises(ValueError, match="requires --kv int8"):
        tserve.check_kv("fp", "paged")
    with pytest.raises(SystemExit, match="requires --kv int8"):
        tserve.main(["--smoke", "--device", "cpu", "--kv", "fp",
                     "--kv-layout", "paged"])


def test_share_prefix_requests_match_the_reference():
    from repro.data import SyntheticLM as JData
    from repro_torch.data import SyntheticLM as TData
    j = jserve.build_requests(JData(j_smoke("qwen3-0.6b")), 5, 16, 4,
                              stagger=True, share_prefix=8)
    t = tserve.build_requests(TData(t_smoke("qwen3-0.6b")), 5, 16, 4,
                              stagger=True, share_prefix=8)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        assert a.max_new == b.max_new
    assert all((r.tokens[:8] == t[0].tokens[:len(r.tokens[:8])]).all()
               for r in t)


def test_serve_cli_paged_on_the_cpu_passes_its_token_check(capsys):
    tserve.main(["--smoke", "--device", "cpu", "--kv-layout", "paged",
                 "--requests", "4", "--slots", "2", "--prompt-len", "16",
                 "--gen", "4", "--stagger", "--check"])
    out = capsys.readouterr().out
    assert "paged KV:" in out and "1 prefill chunk shape(s)" in out
    assert "greedy tokens equal the fake-quant reference" in out


def test_fp_ring_session_serves_through_the_engine(world):
    """``--kv fp``: the session keeps fp ring rows and matches the
    fake-quant graph with plain fp KV bit for bit."""
    _, tcfg, _, tparams, _, tpol = world
    reqs = [TRequest(i, np.random.default_rng(i).integers(
        0, tcfg.vocab, 9).astype(np.int32), 3) for i in range(3)]
    kw = dict(slots=2, cache_len=12, prefill_chunk=16, device="cpu")
    _, eng, out = tserve.serve_quantized(tcfg, tparams, tpol, reqs, kv="fp",
                                         **kw)
    assert eng.stats.decode_attn_route == "fp"
    ref, ref_out = tserve.reference_engine(tcfg, tparams, tpol, reqs, kv="fp",
                                           **kw)
    assert {r: c.tokens for r, c in out.items()} == \
        {r: c.tokens for r, c in ref_out.items()}
    assert ref.ecfg.kv_quant == "none"
