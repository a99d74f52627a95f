"""Weight packing: searched-grid quantization + sub-8-bit bit-packing.

The storage half of executing an ILP-searched ``MPQPolicy``: every searched
projection is quantized onto its per-layer b-bit signed grid with the exact
rounding of the fake-quant graph (``round(clip(w/s, qmin, qmax))`` with
``s = max(s, 1e-9)``), and the integer codes are bit-packed so device memory
holds ``ceil(n * b / 8)`` bytes -- ``MPQPolicy.size_bytes`` to within
padding. Layouts (byte for byte those of ``repro.runtime.packing``):

* ``int8``      -- b == 8: codes stored as int8 in the weight's own shape.
* ``nib4``      -- b == 4: two codes per byte along the contraction dim
                   (``codes[k//2, n]``; low nibble = even k), the operand
                   of the ``quant_matmul_w4`` kernel.
* ``quad2``     -- b == 2: four codes per byte along the contraction dim.
* ``bitstream`` -- any other b (3, 5, 6): little-endian bitstream over the
                   row-major flattened codes, 1-D uint8.

Codes are stored offset-binary (``u = q - qmin``) so packed bytes are
unsigned; ``unpack_*`` restores the signed grid exactly. This slice packs
unsharded with the trained per-tensor scale broadcast per channel, or, for
an expert stack, the trained per-expert scale in its ``(E, 1, 1)``
broadcast form (bit-exact with the trained fake-quant graph either way).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.quantizer import bit_range

SCALE_EPS = 1e-9  # fake_quant's scale floor -- must match for bit-exactness


# ---------------------------------------------------------------------------
# generic bitstream codec (any bits <= 8)
# ---------------------------------------------------------------------------
def pack_codes(q: torch.Tensor, bits: int, *, signed: bool = True
               ) -> torch.Tensor:
    """Bit-pack integer codes ``q`` (values on the `bits`-wide grid) into a
    little-endian uint8 bitstream of ``ceil(q.numel() * bits / 8)`` bytes."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    qmin, _ = bit_range(bits, signed)
    u = (q.reshape(-1).to(torch.int32) - int(qmin)).to(torch.uint8)
    shifts = torch.arange(bits, dtype=torch.uint8, device=q.device)
    flat = ((u[:, None] >> shifts) & 1).reshape(-1)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    weights = torch.arange(8, dtype=torch.uint8, device=q.device)
    return (flat.reshape(-1, 8) << weights).sum(-1, dtype=torch.int32).to(
        torch.uint8)


def unpack_codes(codes: torch.Tensor, bits: int, n: int, *,
                 signed: bool = True) -> torch.Tensor:
    """Exact inverse of :func:`pack_codes` -> ``(n,)`` int8 codes. Every 8
    codes fill exactly ``bits`` bytes, so the stream unpacks group-wise:
    one little-endian word per group (at most 64 bits), shifted apart."""
    qmin, _ = bit_range(bits, signed)
    groups = -(-n // 8)
    c = codes.to(torch.int64)
    pad = groups * bits - c.numel()
    if pad:
        c = torch.cat([c, c.new_zeros(pad)])
    dev = codes.device
    word = (c.reshape(groups, bits)
            << torch.arange(0, 8 * bits, 8, device=dev)).sum(-1)
    u = (word[:, None] >> torch.arange(0, 8 * bits, bits, device=dev)) \
        & ((1 << bits) - 1)
    return (u.reshape(-1)[:n] + int(qmin)).to(torch.int8)


# ---------------------------------------------------------------------------
# kernel-friendly nibble / crumb layouts (packed along the contraction dim)
# ---------------------------------------------------------------------------
def _pad_rows(q: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-q.shape[-2]) % mult
    if pad:
        zeros = q.new_zeros(tuple(q.shape[:-2]) + (pad, q.shape[-1]))
        q = torch.cat([q, zeros], dim=-2)  # code 0 rows; offset applied after
    return q


def pack_nib4(q: torch.Tensor) -> torch.Tensor:
    """Signed int4 codes ``(..., K, N)`` -> ``(..., ceil(K/2), N)`` uint8,
    two per byte along K (low nibble = even k), offset-binary (q + 8)."""
    u = _pad_rows(q.to(torch.int32) + 8, 2)
    return (u[..., 0::2, :] | (u[..., 1::2, :] << 4)).to(torch.uint8)


def _unpack_rows(codes: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """``8 // bits`` offset-binary codes per byte along K (the low bits hold
    the first row) -> ``(..., k, N)`` int8 codes."""
    per = 8 // bits
    shifts = torch.arange(0, 8, bits, dtype=torch.uint8, device=codes.device)
    u = (codes[..., None, :] >> shifts[:, None]) & ((1 << bits) - 1)
    shape = tuple(codes.shape[:-2]) + (per * codes.shape[-2], codes.shape[-1])
    q = u.reshape(shape)[..., :k, :].to(torch.int8)
    return q - (1 << (bits - 1))


def unpack_nib4(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_nib4` -> ``(..., k, N)`` int8 codes."""
    return _unpack_rows(codes, k, 4)


def pack_quad2(q: torch.Tensor) -> torch.Tensor:
    """Signed int2 codes ``(..., K, N)`` -> ``(..., ceil(K/4), N)`` uint8,
    four per byte along K, offset-binary (q + 2)."""
    u = _pad_rows(q.to(torch.int32) + 2, 4)
    parts = [u[..., i::4, :] << (2 * i) for i in range(4)]
    return (parts[0] | parts[1] | parts[2] | parts[3]).to(torch.uint8)


def unpack_quad2(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_quad2` -> ``(..., k, N)`` int8 codes."""
    return _unpack_rows(codes, k, 2)


def _layout_for(bits: int) -> str:
    return {8: "int8", 4: "nib4", 2: "quad2"}.get(bits, "bitstream")


# ---------------------------------------------------------------------------
# PackedLinear -- the packed param-tree leaf
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PackedLinear:
    """One searched projection in deployable form: packed codes, the f32
    dequant scale (``(out,)`` per channel, or ``(E, 1, 1)`` per expert of
    an ``(E, K, N)`` stack), the trained activation scale (``()``, or
    ``(E,)`` per expert) and the grid metadata."""

    codes: torch.Tensor              # packed weight codes (layout-dependent)
    scale: torch.Tensor              # f32 dequant scale, (out,) | (E, 1, 1)
    s_a: torch.Tensor                # f32 activation scale, () | (E,)
    w_bits: int = 8
    a_bits: int = 8
    a_signed: bool = True
    layout: str = "int8"
    shape: Tuple[int, ...] = ()
    # activation-reuse group: projections with the same input and the same
    # (a_bits, a_signed, trained bank-scale values) share a tag, so dispatch
    # quantizes their common activation once per forward ("" = never reuse)
    a_group: str = ""

    # -- accounting ---------------------------------------------------------
    @property
    def packed_bytes(self) -> int:
        """Device bytes of the weight codes (scales reported separately)."""
        return self.codes.numel() * self.codes.element_size()

    @property
    def scale_bytes(self) -> int:
        return self.scale.numel() * self.scale.element_size()

    @property
    def a_range(self) -> Tuple[float, float]:
        lo, hi = bit_range(self.a_bits, self.a_signed)
        return float(lo), float(hi)

    # -- codes --------------------------------------------------------------
    def unpack(self) -> torch.Tensor:
        """Exact signed integer codes in the weight's original shape."""
        if self.layout == "int8":
            return self.codes
        if self.layout == "nib4":
            return unpack_nib4(self.codes, self.shape[-2])
        if self.layout == "quad2":
            return unpack_quad2(self.codes, self.shape[-2])
        n = 1
        for d in self.shape:
            n *= d
        return unpack_codes(self.codes, self.w_bits, n).reshape(self.shape)

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """Dequantized weight -- bit-exact with the fake-quant graph when
        ``scale`` came from the trained indicator bank."""
        q = self.unpack().to(torch.float32)
        return (q * _broadcast_scale(self.scale, self.shape)).to(dtype)


def _broadcast_scale(s: torch.Tensor, w_shape) -> torch.Tensor:
    """Align a scale against a weight: scalars broadcast plainly, a scale of
    the weight's own rank (the per-expert ``(E, 1, 1)``, already in
    ``fake_quant_indexed``'s trailing-ones form) passes through, a
    per-channel ``(out,)`` vector reshapes onto the LAST dim."""
    if s.dim() in (0, len(w_shape)):
        return s
    if s.dim() == 1 and s.shape[0] == w_shape[-1]:
        return s.reshape((1,) * (len(w_shape) - 1) + (-1,))
    raise ValueError(f"scale shape {tuple(s.shape)} does not align with "
                     f"weight shape {tuple(w_shape)}")


def quantize_to_grid(w: torch.Tensor, bits: int,
                     scale: torch.Tensor) -> torch.Tensor:
    """``round(clip(w/s, qmin, qmax))`` on the signed `bits` grid -- the
    value map of ``core.quantizer.fake_quant`` (including its scale floor),
    so ``codes * s == fake_quant(w, s)`` exactly."""
    qmin, qmax = bit_range(bits, True)
    s = torch.clamp(scale.to(torch.float32), min=SCALE_EPS)
    s = _broadcast_scale(s, w.shape)
    return torch.round(torch.clamp(w.to(torch.float32) / s, qmin, qmax))


def pack_linear(w: torch.Tensor, w_bits: int, s_w, a_bits: int, s_a, *,
                a_signed: bool = True) -> PackedLinear:
    """Quantize ``w`` onto its searched grid and bit-pack the codes.

    ``s_w`` is the trained scale (the selected indicator-bank entry): a
    scalar for a plain projection, or, for an expert stack whose bank
    selects per expert, the ``(E, 1, 1)`` trailing-ones form against ``(E,
    K, N)``, kept as it is; ``s_a`` is ``()`` or per expert ``(E,)``."""
    s = torch.clamp(torch.as_tensor(s_w, device=w.device).to(torch.float32),
                    min=SCALE_EPS)
    if s.dim() == w.dim() and s.numel() > 1:
        scale = s.contiguous()
    elif s.numel() == 1:
        scale = s.reshape(()).expand(w.shape[-1]).contiguous()
    else:
        raise ValueError(f"scale {tuple(s.shape)} is neither per-tensor nor "
                         f"per-expert against weight {tuple(w.shape)}")
    s_a = torch.as_tensor(s_a, device=w.device).to(torch.float32)
    q = quantize_to_grid(w, w_bits, scale)
    layout = _layout_for(w_bits)
    if layout == "int8":
        codes = q.to(torch.int8)
    elif layout == "nib4":
        codes = pack_nib4(q)
    elif layout == "quad2":
        codes = pack_quad2(q)
    else:
        codes = pack_codes(q, w_bits)
    return PackedLinear(
        codes=codes, scale=scale,
        s_a=s_a.reshape(()) if s_a.numel() == 1 else s_a.contiguous(),
        w_bits=int(w_bits), a_bits=int(a_bits), a_signed=bool(a_signed),
        layout=layout, shape=tuple(int(d) for d in w.shape))


# ---------------------------------------------------------------------------
# tree-level accounting
# ---------------------------------------------------------------------------
def packed_leaves(tree):
    """Every ``PackedLinear`` in a nested dict tree."""
    if isinstance(tree, PackedLinear):
        return [tree]
    if isinstance(tree, dict):
        return [pl for v in tree.values() for pl in packed_leaves(v)]
    return []


def tree_packed_bytes(tree) -> int:
    """Measured device bytes of all packed weight codes in ``tree`` -- the
    number the serve gate checks against ``MPQPolicy.size_bytes``."""
    return sum(pl.packed_bytes for pl in packed_leaves(tree))


def tree_scale_bytes(tree) -> int:
    return sum(pl.scale_bytes for pl in packed_leaves(tree))
