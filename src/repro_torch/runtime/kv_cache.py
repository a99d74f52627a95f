"""Ring KV-cache layouts: fp (``FpKVCache``) and int8 (``QuantKVCache``).

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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

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

    def evict(self, slot: int) -> "QuantKVCache":
        return _evict_pos(self, slot)

    def inventory(self) -> Dict[str, int]:
        return {"codes": _nbytes(self.k, self.v),
                "scales": _nbytes(self.k_scale, self.v_scale),
                "pos": _nbytes(self.pos)}


CACHE_TYPES = (FpKVCache, QuantKVCache)


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
