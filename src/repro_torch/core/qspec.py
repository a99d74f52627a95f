"""QLayer: the unit of mixed-precision search.

A QLayer is one quantized einsum in the network — the LM analog of the
paper's per-conv-layer quantizer. It carries everything the ILP needs
(activated MACs/token for BitOps, weight param count for model size) and
everything the model needs to route indicator banks (segment/unit/path).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class QLayer:
    name: str                  # globally unique, e.g. "blocks.3.attn.wq"
    segment: str               # param segment (scan stack) this lives in
    unit: int                  # index within the segment's stacked dim
    path: Tuple[str, ...]      # param path inside one unit, e.g. ("attn", "wq")
    in_dim: int
    out_dim: int
    n_mats: int                # stacked matrices in the tensor (MoE experts)
    macs_per_token: float      # *activated* MACs per token (top-k for MoE)
    w_params: int              # total weight elements (all mats)
    kind: str                  # attn | mlp | moe | rec | rwkv | cross


def bitops(q: QLayer, bw: int, ba: int, n_tokens: int) -> float:
    """Paper's BitOps(l) = MACs(l) * b_w * b_a (Eq. 3b)."""
    return q.macs_per_token * n_tokens * bw * ba


def model_bits(q: QLayer, bw: int) -> float:
    """Weight-storage bits for the size/compression-rate constraint."""
    return q.w_params * bw


def total_bitops(qlayers: Sequence[QLayer], w_bits: Dict[str, int],
                 a_bits: Dict[str, int], n_tokens: int) -> float:
    return sum(bitops(q, w_bits[q.name], a_bits[q.name], n_tokens) for q in qlayers)


def total_size_bytes(qlayers: Sequence[QLayer], w_bits: Dict[str, int]) -> float:
    return sum(model_bits(q, w_bits[q.name]) for q in qlayers) / 8.0


def fp_bitops(qlayers: Sequence[QLayer], n_tokens: int, fp_bits: int = 32) -> float:
    return sum(bitops(q, fp_bits, fp_bits, n_tokens) for q in qlayers)


def group_by_segment(qlayers: Sequence[QLayer]) -> Dict[Tuple[str, Tuple[str, ...]], List[QLayer]]:
    """Group QLayers by (segment, path) — one group per stacked param tensor,
    ordered by unit index. Used to build per-segment bit-index arrays."""
    groups: Dict[Tuple[str, Tuple[str, ...]], List[QLayer]] = {}
    for q in qlayers:
        groups.setdefault((q.segment, q.path), []).append(q)
    for g in groups.values():
        g.sort(key=lambda q: q.unit)
    return groups
