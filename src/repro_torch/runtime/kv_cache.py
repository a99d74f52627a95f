"""KV-cache layouts: fp / int8 ring buffers (``FpKVCache``,
``QuantKVCache``), the pooled int8 paged layout (``PagedKVCache``), and the
host-side page allocator (``PagePool``).

Int8 quantization: decode-time KV rows are quantized at *write* time with a
per-head symmetric scale ``s = max|x| / 127`` (shape ``(..., Sc, KV)``), so
dequantization is exact per row and independent of when later rows arrive.
Numerics contract: ``dequantize(*quantize_rows(x)) == fake_quant_kv(x)``
exactly -- the engine with int8 slots is token-identical to a reference
engine that stores ``fake_quant_kv`` values in an fp cache.

Two position layouts share each container: shared ``pos (Sc,)`` (every batch
row at the same absolute position; what a one-request prefill builds) and
per-slot ``pos (B, Sc)`` (the continuous-batching engine). Caches are
immutable values: ``append``/``evict`` return new caches (``_replace``).

Paged layout = ring + block indirection: slot ``b``'s position space
``[0, P * page_size)`` divides into ``P`` fixed-size pages; token ``t``
lands in physical page ``page_table[b, t // page_size]`` at in-page row
``t % page_size``. ``gather()`` reproduces the dense per-slot ring view bit
for bit (same codes, scales and positions), which is how the paged engine
stays greedy-token-identical to the ring engine. Requests sharing a
page-aligned prompt prefix map the *same* physical pages (refcounted by the
``PagePool``), so prefill of a cached prefix becomes a page-table update.

Writes that JAX drops (``.at[...].set(mode="drop")``: a sentinel ``pos <
0``, an unmapped table entry, a position past capacity) go to one scratch
row appended past the pool for the scatter and cut off after it
(``_drop_scatter``): a dropped write touches no row of any page, even where
its clipped target is a live write's row, and the host never synchronises
to find out which writes drop.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

KV_QMAX = 127.0          # symmetric int8 grid (-127..127; -128 unused)
KV_SCALE_EPS = 1e-8


# ---------------------------------------------------------------------------
# int8 row quantization (write-time scales)
# ---------------------------------------------------------------------------
def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``(..., hd)`` rows onto the symmetric int8 grid with one
    scale per leading index (per token-row, per head)."""
    x32 = x.to(torch.float32)
    s = torch.clamp(x32.abs().amax(dim=-1) / KV_QMAX, min=KV_SCALE_EPS)
    q = torch.clamp(torch.round(x32 / s[..., None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), s


def dequantize(q: torch.Tensor, s: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Exact inverse map of :func:`quantize_rows` codes -> values."""
    return (q.to(torch.float32) * s[..., None]).to(dtype)


def fake_quant_kv(x: torch.Tensor) -> torch.Tensor:
    """Value-level int8 KV quantization (quantize-dequantize in fp) -- the
    reference graph's view of what an int8 slot stores."""
    q, s = quantize_rows(x)
    return dequantize(q, s, x.dtype)


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _ring_append(cache, rows: Dict[str, torch.Tensor], pos: torch.Tensor):
    """The one write sequence of both position layouts. The ring index is
    ``max(pos, 0) % cap``: a negative sentinel position (an inactive engine
    slot riding along in the decode batch) clamps to index 0 and stamps
    ``pos = -1`` there -- never valid to attend -- instead of wrapping to
    ``cap - 1`` and clobbering the ring's tail codes/scales."""
    cap = cache.k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=cache.pos.device)
    slot = torch.remainder(torch.clamp(pos, min=0), cap).long()
    upd = {}
    if cache.pos.dim() == 2:                       # per-slot: pos (B, Sc)
        b = torch.arange(cache.k.shape[0], device=slot.device)
        for f, r in rows.items():
            new = getattr(cache, f).clone()
            new[b, slot] = r[:, 0].to(new.dtype)
            upd[f] = new
        new_pos = cache.pos.clone()
        new_pos[b, slot] = pos
    else:                                          # shared: pos (Sc,)
        for f, r in rows.items():
            new = getattr(cache, f).clone()
            new[:, slot] = r[:, 0].to(new.dtype)
            upd[f] = new
        new_pos = cache.pos.clone()
        new_pos[slot] = pos
    upd["pos"] = new_pos
    return cache._replace(**upd)


def _ring_append_batch(cache, rows: Dict[str, torch.Tensor],
                       pos: torch.Tensor):
    """S rows per slot of the per-slot layout (speculative verify): ``rows``
    values ``(B, S, ...)`` land at absolute positions ``pos (B, S)``, each
    at ring index ``max(pos, 0) % cap`` as in :func:`_ring_append`. A
    sentinel slot (all ``pos = -1``) sends its S writes to index 0 with
    ``pos = -1``: every write there stamps the same -1, and the codes of a
    -1 row are never attended, so which of the duplicate writes lands does
    not matter."""
    cap = cache.k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=cache.pos.device)
    slot = torch.remainder(torch.clamp(pos, min=0), cap).long()
    b = torch.arange(cache.k.shape[0], device=slot.device)[:, None]
    upd = {}
    for f, r in rows.items():
        new = getattr(cache, f).clone()
        new[b, slot] = r.to(new.dtype)
        upd[f] = new
    new_pos = cache.pos.clone()
    new_pos[b, slot] = pos
    upd["pos"] = new_pos
    return cache._replace(**upd)


def _ring_rollback(cache, cut: torch.Tensor):
    """Stamp ``pos = -1`` on per-slot ring rows at positions ``>= cut[b]``
    (``cut (B,)``): the speculative rejection rewind. It reads the position
    stamps only, so it does not depend on where the ring put a row; codes
    and scales stay resident (a -1 row is never attended), and a sentinel
    slot (all -1) is unchanged."""
    cut = torch.as_tensor(cut, dtype=torch.int32, device=cache.pos.device)
    drop = (cache.pos >= 0) & (cache.pos >= cut[:, None])
    return cache._replace(pos=torch.where(drop, torch.full_like(cache.pos, -1),
                                          cache.pos))


def _evict_pos(cache, slot: int):
    """Invalidate one slot's rows by stamping its ``pos`` to -1 (codes and
    scales stay resident; a -1 position is never valid to attend)."""
    pos = cache.pos.clone()
    pos[slot] = -1
    return cache._replace(pos=pos)


# ---------------------------------------------------------------------------
# cache leaves
# ---------------------------------------------------------------------------
class FpKVCache(NamedTuple):
    """Decode-time fp ring buffer."""
    k: torch.Tensor      # (B, Sc, KV, hd)
    v: torch.Tensor
    pos: torch.Tensor    # (Sc,) or (B, Sc) int32 absolute position, -1 = empty

    def append(self, k_new, v_new, pos) -> "FpKVCache":
        """Write one token row per batch row, ``k_new (B, 1, KV, hd)``."""
        return _ring_append(self, {"k": k_new, "v": v_new}, pos)

    def append_batch(self, k_new, v_new, pos) -> "FpKVCache":
        """S rows per slot, ``k_new (B, S, KV, hd)`` at ``pos (B, S)``."""
        return _ring_append_batch(self, {"k": k_new, "v": v_new}, pos)

    def rollback(self, cut) -> "FpKVCache":
        """Invalidate rows at positions ``>= cut (B,)`` (per-slot only)."""
        return _ring_rollback(self, cut)

    def evict(self, slot: int) -> "FpKVCache":
        return _evict_pos(self, slot)

    def inventory(self) -> Dict[str, int]:
        return {"codes": _nbytes(self.k, self.v), "pos": _nbytes(self.pos)}


class QuantKVCache(NamedTuple):
    """Int8 decode-time ring buffer (see module docstring)."""
    k: torch.Tensor          # (B, Sc, KV, hd) int8 codes
    v: torch.Tensor          # (B, Sc, KV, hd) int8 codes
    k_scale: torch.Tensor    # (B, Sc, KV) f32 per-row per-head write-time scale
    v_scale: torch.Tensor    # (B, Sc, KV) f32
    pos: torch.Tensor        # (Sc,) or (B, Sc) int32 absolute position

    def append(self, k_new, v_new, pos) -> "QuantKVCache":
        kq, ks = quantize_rows(k_new)
        vq, vs = quantize_rows(v_new)
        return _ring_append(self, {"k": kq, "v": vq,
                                   "k_scale": ks, "v_scale": vs}, pos)

    def append_batch(self, k_new, v_new, pos) -> "QuantKVCache":
        """S rows per slot at once, ``k_new (B, S, KV, hd)`` at ``pos (B,
        S)``. ``quantize_rows`` reduces over ``hd`` only, so the codes and
        scales are bit for bit those of S single-row appends."""
        kq, ks = quantize_rows(k_new)
        vq, vs = quantize_rows(v_new)
        return _ring_append_batch(self, {"k": kq, "v": vq,
                                         "k_scale": ks, "v_scale": vs}, pos)

    def rollback(self, cut) -> "QuantKVCache":
        """Invalidate rows at positions ``>= cut (B,)`` (per-slot only)."""
        return _ring_rollback(self, cut)

    def evict(self, slot: int) -> "QuantKVCache":
        return _evict_pos(self, slot)

    def inventory(self) -> Dict[str, int]:
        return {"codes": _nbytes(self.k, self.v),
                "scales": _nbytes(self.k_scale, self.v_scale),
                "pos": _nbytes(self.pos)}


def _drop_scatter(buf: torch.Tensor, flat: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` with rows ``flat`` of its first two dims
    (flattened) set to ``vals``; index ``N = buf.shape[0] * buf.shape[1]``
    writes one scratch row that is cut off after the scatter, so such a
    write is dropped without a host-side mask."""
    N = buf.shape[0] * buf.shape[1]
    rows = buf.reshape((N,) + tuple(buf.shape[2:]))
    out = torch.cat([rows, rows[:1]])        # the scratch row's value is moot
    out[flat.reshape(-1)] = vals.reshape((-1,) + tuple(rows.shape[1:])).to(
        out.dtype)
    return out[:N].view(buf.shape)


class PagedKVCache(NamedTuple):
    """Pooled int8 KV pages + per-slot page table (the paged layout).

    One physical page-id space backs every slot: page ``p`` holds
    ``page_size`` consecutive token rows of whichever slot mapped it;
    ``page_table[b, j] = p`` maps slot ``b``'s j-th logical block onto page
    ``p`` (-1 = unmapped). The host-side :class:`PagePool` owns free list
    and refcounts; its page ids are shared by every layer's cache (the
    tables move in lockstep), while each layer stores its own contents.
    """

    k: torch.Tensor           # (n_pages, page_size, KV, hd) int8 codes
    v: torch.Tensor           # (n_pages, page_size, KV, hd) int8 codes
    k_scale: torch.Tensor     # (n_pages, page_size, KV) f32 write-time scales
    v_scale: torch.Tensor     # (n_pages, page_size, KV) f32
    pos: torch.Tensor         # (n_pages, page_size) int32 absolute pos, -1 empty
    page_table: torch.Tensor  # (B, pages_per_slot) int32 page id, -1 unmapped

    @property
    def page_size(self) -> int:
        return self.k.shape[1]

    @property
    def n_pages(self) -> int:
        return self.k.shape[0]

    @property
    def pages_per_slot(self) -> int:
        return self.page_table.shape[-1]

    @property
    def capacity(self) -> int:
        return self.pages_per_slot * self.page_size

    def _target(self, pos: torch.Tensor, table_rows: torch.Tensor):
        """(page id, in-page row) for absolute positions; the sentinel id
        ``n_pages`` for sentinel/unmapped/overflow positions (dropped)."""
        ps, cap = self.page_size, self.capacity
        safe = torch.clamp(pos, 0, cap - 1).long()
        blk, row = safe // ps, safe % ps
        pid = torch.gather(table_rows.long(), -1, blk) \
            if table_rows.dim() == pos.dim() else table_rows.long()[blk]
        ok = (pos >= 0) & (pos < cap) & (pid >= 0)
        return torch.where(ok, pid, self.n_pages), row

    def _flat(self, pos: torch.Tensor, table_rows: torch.Tensor):
        """Flat row index into ``(n_pages * page_size)``; dropped writes
        index the scratch row ``n_pages * page_size``."""
        pid, row = self._target(pos, table_rows)
        return pid * self.page_size + torch.where(pid < self.n_pages, row, 0)

    def _write(self, flat: torch.Tensor, kq, ks, vq, vs,
               pos: torch.Tensor) -> "PagedKVCache":
        return self._replace(
            k=_drop_scatter(self.k, flat, kq),
            v=_drop_scatter(self.v, flat, vq),
            k_scale=_drop_scatter(self.k_scale, flat, ks),
            v_scale=_drop_scatter(self.v_scale, flat, vs),
            pos=_drop_scatter(self.pos, flat, pos))

    def append(self, k_new, v_new, pos) -> "PagedKVCache":
        """One decode token per slot: ``k_new (B, 1, KV, hd)``, per-slot
        positions ``pos (B,)``."""
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.pos.device)
        kq, ks = quantize_rows(k_new)
        vq, vs = quantize_rows(v_new)
        flat = self._flat(pos[:, None], self.page_table)[:, 0]
        return self._write(flat, kq[:, 0], ks[:, 0], vq[:, 0], vs[:, 0], pos)

    def append_batch(self, k_new, v_new, pos) -> "PagedKVCache":
        """S rows per slot (speculative verify): ``k_new (B, S, KV, hd)``
        at per-slot positions ``pos (B, S)``; sentinel, unmapped and
        past-capacity rows drop, as in :meth:`append`."""
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.pos.device)
        kq, ks = quantize_rows(k_new)
        vq, vs = quantize_rows(v_new)
        return self._write(self._flat(pos, self.page_table), kq, ks, vq, vs,
                           pos)

    def rollback(self, cut) -> "PagedKVCache":
        """Clear ``pos`` of each slot's rows at positions ``>= cut[b]``
        (``cut (B,)``), through the slot's table: the speculative rejection
        rewind. Codes and scales stay resident, as in :meth:`free_pages`.
        The cleared rows lie on refcount-1 pages: a cut lands past the
        prompt, and only full prompt pages are ever shared."""
        cut = torch.as_tensor(cut, dtype=torch.int32, device=self.pos.device)
        t = torch.arange(self.capacity, dtype=torch.int32,
                         device=self.pos.device)
        t = t[None].expand(self.page_table.shape[0], -1)
        t = torch.where(t >= cut[:, None], t, torch.full_like(t, -1))
        flat = self._flat(t, self.page_table)
        return self._replace(pos=_drop_scatter(
            self.pos, flat, torch.full_like(t, -1)))

    def append_rows(self, k_new, v_new, q_pos, slot: int) -> "PagedKVCache":
        """Chunked (multi-token) append for one slot: ``k_new (1, C, KV,
        hd)`` rows land at absolute positions ``q_pos (C,)`` (-1 pads are
        dropped) -- prefill as page writes."""
        q_pos = torch.as_tensor(q_pos, dtype=torch.int32,
                                device=self.pos.device)
        kq, ks = quantize_rows(k_new)
        vq, vs = quantize_rows(v_new)
        flat = self._flat(q_pos, self.page_table[slot])
        return self._write(flat, kq[0], ks[0], vq[0], vs[0], q_pos)

    def _gather_rows(self, tbl: torch.Tensor) -> QuantKVCache:
        safe = torch.clamp(tbl, min=0).long()
        flat = tuple(tbl.shape[:-1]) + (tbl.shape[-1] * self.page_size,)

        def g(pages):
            return pages[safe].reshape(flat + tuple(pages.shape[2:]))

        pos = self.pos[safe]
        pos = torch.where((tbl >= 0)[..., None], pos,
                          torch.full_like(pos, -1)).reshape(flat)
        return QuantKVCache(g(self.k), g(self.v), g(self.k_scale),
                            g(self.v_scale), pos)

    def gather(self) -> QuantKVCache:
        """Dense per-slot ring view ``(B, P * page_size, ...)``, bit for bit
        the ring layout's arrays (unmapped blocks carry ``pos = -1``)."""
        return self._gather_rows(self.page_table)

    def gather_slot(self, slot: int) -> QuantKVCache:
        """Dense ``(1, P * page_size, ...)`` view of one slot."""
        return self._gather_rows(self.page_table[slot:slot + 1])

    def _set_table_row(self, slot: int, row) -> "PagedKVCache":
        table = self.page_table.clone()
        table[slot] = torch.as_tensor(row, dtype=torch.int32,
                                      device=table.device)
        return self._replace(page_table=table)

    def map_slot(self, slot: int, table_row) -> "PagedKVCache":
        """Point slot ``slot``'s page list at ``table_row (P,)`` (-1 =
        unmapped): the page-table update that replaces prefix prefill."""
        return self._set_table_row(slot, table_row)

    def evict(self, slot: int) -> "PagedKVCache":
        """Unmap one slot (table row -> -1). Freeing the pages, and clearing
        their ``pos`` rows once the last sharer leaves, is the pool's call,
        through :meth:`free_pages`."""
        return self._set_table_row(slot, -1)

    def free_pages(self, page_ids) -> "PagedKVCache":
        """Clear ``pos`` of freed pages to -1 (ids < 0 or >= ``n_pages``
        are dropped). Load-bearing: a stale ``pos`` row in a recycled page
        would be attendable by its next occupant."""
        ids = torch.as_tensor(page_ids, dtype=torch.long,
                              device=self.pos.device).reshape(-1)
        ids = torch.where((ids < 0) | (ids >= self.n_pages), self.n_pages, ids)
        pos = torch.cat([self.pos, self.pos.new_full((1, self.page_size), -1)])
        pos[ids] = -1
        return self._replace(pos=pos[:self.n_pages])

    def inventory(self) -> Dict[str, int]:
        """Codes / scales / pos of every pooled page, the slot page table,
        and the pool's free list + refcounts (``meta``, one int32 each per
        page; :func:`tree_inventory` counts it once per state tree)."""
        return {"codes": _nbytes(self.k, self.v),
                "scales": _nbytes(self.k_scale, self.v_scale),
                "pos": _nbytes(self.pos),
                "table": _nbytes(self.page_table),
                "meta": 2 * self.n_pages * 4}


CACHE_TYPES = (FpKVCache, QuantKVCache, PagedKVCache)
QUANT_CACHE_TYPES = (QuantKVCache, PagedKVCache)


def init_kv_cache(batch: int, capacity: int, kv_heads: int, hd: int, *,
                  dtype=torch.float32, quant: bool = False,
                  per_slot: bool = False, device=None):
    """A fresh ring cache: int8 codes + scales (``quant``) or fp rows, every
    position empty (-1)."""
    pos_shape = (batch, capacity) if per_slot else (capacity,)
    pos = torch.full(pos_shape, -1, dtype=torch.int32, device=device)
    shape = (batch, capacity, kv_heads, hd)
    if quant:
        return QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
            pos=pos)
    return FpKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device), pos=pos)


def init_paged_kv_cache(n_pages: int, page_size: int, kv_heads: int, hd: int,
                        slots: int, pages_per_slot: int, *,
                        device=None) -> PagedKVCache:
    shape = (n_pages, page_size, kv_heads, hd)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
        v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
        pos=torch.full((n_pages, page_size), -1, dtype=torch.int32,
                       device=device),
        page_table=torch.full((slots, pages_per_slot), -1, dtype=torch.int32,
                              device=device))


@dataclasses.dataclass(frozen=True)
class KVCacheLayout:
    """How a decode state's KV is laid out: ``kind="ring"`` pre-carves a
    fixed-capacity buffer per slot (fp or int8 per ``quant``);
    ``kind="paged"`` pools ``n_pages`` fixed-size int8 pages across slots
    behind a page table (requires ``quant="int8"``)."""

    kind: str = "ring"       # "ring" | "paged"
    quant: str = "none"      # "none" | "fake" | "int8"
    page_size: int = 8       # tokens per page (paged)
    n_pages: int = 0         # pool size; 0 = (batch + 1) * pages_per_slot

    def __post_init__(self):
        if self.kind not in ("ring", "paged"):
            raise ValueError(f"unknown kv layout {self.kind!r}")
        if self.kind == "paged" and self.quant != "int8":
            raise ValueError(
                f"paged KV requires quant='int8', got {self.quant!r}")

    def pages_per_slot(self, capacity: int) -> int:
        return -(-capacity // self.page_size)

    def pool_pages(self, batch: int, capacity: int) -> int:
        return self.n_pages or (batch + 1) * self.pages_per_slot(capacity)

    def alloc(self, batch: int, capacity: int, kv_heads: int, head_dim: int,
              *, dtype=torch.float32, per_slot: bool = False, device=None):
        if self.kind == "paged":
            if not per_slot:
                raise ValueError("paged KV is a per-slot (engine) layout")
            return init_paged_kv_cache(
                self.pool_pages(batch, capacity), self.page_size, kv_heads,
                head_dim, batch, self.pages_per_slot(capacity), device=device)
        return init_kv_cache(batch, capacity, kv_heads, head_dim, dtype=dtype,
                             quant=self.quant == "int8", per_slot=per_slot,
                             device=device)


# ---------------------------------------------------------------------------
# host-side page allocator (free list + refcounts + prefix registry)
# ---------------------------------------------------------------------------
class PagePool:
    """Host bookkeeping for one physical page-id space.

    Pages are reference-counted: a slot mapping a page holds one reference,
    and every registered prefix-chain entry pins its pages with one more, so
    a popular prompt prefix survives its requests. A page is recyclable
    exactly when its refcount hits zero (``release`` returns the freed ids
    so the engine can clear their device-side ``pos`` rows). ``fork`` is
    the copy-on-write seam: a writer holding a shared page (rc > 1) gets a
    fresh page and drops its reference.

    Allocation may drop LRU registry entries, which can unpin pages a
    ``lookup_prefix`` just returned: a caller about to map such pages takes
    its reference on them (``ref``) *before* it allocates (the reference
    engine allocates first, and then ``ref`` can find them free).
    """

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self.refcount = [0] * self.n_pages
        # prefix chain key -> tuple of page ids (each entry pins its pages)
        self._registry: "OrderedDict[bytes, Tuple[int, ...]]" = OrderedDict()

    # -- allocation ---------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh pages (rc 1 each); see :meth:`alloc_with_freed`
        for the variant that reports pages recycled on the way."""
        ids, _ = self.alloc_with_freed(n)
        return ids

    def alloc_with_freed(self, n: int) -> Tuple[List[int], List[int]]:
        """``n`` fresh pages, dropping LRU registered prefixes to make
        room; also returns the ids those drops freed. Raises when the pool
        is truly exhausted."""
        freed: List[int] = []
        while len(self._free) < n and self._registry:
            freed.extend(self.drop_lru_prefix())
        if len(self._free) < n:
            raise RuntimeError(
                f"page pool exhausted: need {n}, "
                f"free {len(self._free)}/{self.n_pages}")
        ids = [self._free.pop() for _ in range(n)]
        for p in ids:
            self.refcount[p] = 1
        return ids, freed

    def ref(self, ids: Sequence[int]) -> None:
        for p in ids:
            assert self.refcount[p] > 0, f"ref of free page {p}"
            self.refcount[p] += 1

    def release(self, ids: Sequence[int]) -> List[int]:
        """Drop one reference per id; returns the ids whose refcount hit
        zero (now back on the free list)."""
        freed: List[int] = []
        for p in ids:
            if p < 0:
                continue
            assert self.refcount[p] > 0, f"double free of page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def fork(self, pid: int) -> Tuple[int, bool, List[int]]:
        """Copy-on-write: exclusive pages (rc 1) return unchanged; shared
        pages allocate a fresh id and drop the caller's reference. Returns
        ``(page_id, needs_copy, freed)``."""
        if self.refcount[pid] <= 1:
            return pid, False, []
        new, freed = self.alloc_with_freed(1)
        self.refcount[pid] -= 1
        return new[0], True, freed

    # -- shared-prefix registry ---------------------------------------------
    def register_prefix(self, chain_keys: Sequence[bytes],
                        page_ids: Sequence[int]) -> None:
        """Pin this prompt's full-page prefix chains: ``chain_keys[j]``
        hashes the first ``(j + 1) * page_size`` tokens and maps to
        ``page_ids[: j + 1]``."""
        for j, key in enumerate(chain_keys):
            if key in self._registry:
                self._registry.move_to_end(key)
                continue
            pages = tuple(page_ids[: j + 1])
            self._registry[key] = pages
            self.ref(pages)

    def lookup_prefix(self, chain_keys: Sequence[bytes]) -> Tuple[int, ...]:
        """Longest registered chain matching this prompt's page-aligned
        prefix; ``()`` on a miss. A hit marks the entry most recently
        used."""
        for j in range(len(chain_keys) - 1, -1, -1):
            pages = self._registry.get(chain_keys[j])
            if pages is not None:
                self._registry.move_to_end(chain_keys[j])
                return pages
        return ()

    def drop_lru_prefix(self) -> List[int]:
        """Unpin the least recently used registry entry; returns any page
        ids that became free."""
        if not self._registry:
            return []
        _, pages = self._registry.popitem(last=False)
        return self.release(pages)

    def flush_prefixes(self) -> List[int]:
        """Unpin every registered prefix chain; returns the freed ids."""
        freed: List[int] = []
        while self._registry:
            freed.extend(self.drop_lru_prefix())
        return freed

    # -- accounting / invariants --------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def unique_pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def registered_prefixes(self) -> int:
        return len(self._registry)

    @property
    def reclaimable_count(self) -> int:
        """Pages pinned only by the prefix registry (no slot maps them):
        what ``alloc_with_freed`` could recover by dropping prefixes."""
        pins: Dict[int, int] = {}
        for pages in self._registry.values():
            for p in pages:
                pins[p] = pins.get(p, 0) + 1
        return sum(1 for p, k in pins.items() if self.refcount[p] == k)

    @property
    def available_count(self) -> int:
        """Worst-case pages an admission could obtain: free plus
        registry-only pages (the scheduler's pressure check)."""
        return self.free_count + self.reclaimable_count

    def meta_bytes(self) -> int:
        """Bytes of the allocator's own state: free list and refcounts, one
        int32 each per page (what ``inventory()`` counts as ``meta``)."""
        return 2 * self.n_pages * 4

    def check(self) -> None:
        """Leak/consistency invariants: free and referenced pages partition
        the pool; free pages have rc 0."""
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        for p in range(self.n_pages):
            if p in free:
                assert self.refcount[p] == 0, f"free page {p} has refs"
            else:
                assert self.refcount[p] > 0, f"leaked page {p} (rc 0, not free)"


# ---------------------------------------------------------------------------
# tree-level accounting
# ---------------------------------------------------------------------------
def _cache_leaves(state):
    """Cache leaves of a nested dict/list state tree, in key order."""
    if isinstance(state, CACHE_TYPES):
        yield state
    elif isinstance(state, dict):
        for k in sorted(state):
            yield from _cache_leaves(state[k])
    elif isinstance(state, (list, tuple)):
        for x in state:
            yield from _cache_leaves(x)


def tree_inventory(state) -> Dict[str, int]:
    """Itemized ``inventory()`` summed over every quantized cache leaf of a
    state tree (zeros when it holds fp caches). The paged pool's ``meta``
    is shared across layers, so it counts once."""
    total = {"codes": 0, "scales": 0, "pos": 0}
    meta_counted = False
    for leaf in _cache_leaves(state):
        if not isinstance(leaf, QUANT_CACHE_TYPES):
            continue
        for part, n in leaf.inventory().items():
            if part == "meta":
                if meta_counted:
                    continue
                meta_counted = True
            total[part] = total.get(part, 0) + n
    return total


def find_paged(state) -> Optional[PagedKVCache]:
    """First ``PagedKVCache`` leaf of a state tree (None when ring)."""
    return next((c for c in _cache_leaves(state)
                 if isinstance(c, PagedKVCache)), None)
