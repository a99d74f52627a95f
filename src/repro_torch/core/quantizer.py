"""LSQ-style uniform quantizer, forward values (Eq. 1 of the paper):

    v_q = round(clip(v / s, min_b, max_b)) * s

The value op chain matches ``repro.core.quantizer`` bit for bit, including
the scale floor at 1e-9 and the LSQ gradient-scale wrapper ``s*g + (s -
s*g)``, which is the identity in exact arithmetic but not always in
float32. The straight-through gradients come with the training slice.
"""
from __future__ import annotations

import torch


def grad_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The value of the LSQ grad-scale trick: ``x*g + (x - x*g)``."""
    xs = x * scale
    return xs + (x - xs)


def bit_range(b: int, signed: bool):
    """(qmin, qmax) for bit-width ``b``."""
    if signed:
        return -(2 ** (b - 1)), 2 ** (b - 1) - 1
    return 0, 2 ** b - 1


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def lsq_grad_scale_factor(numel: int, qmax, device=None) -> torch.Tensor:
    """LSQ gradient normalizer g = 1 / sqrt(numel * qmax), in float32 (numel
    enters as a float32 scalar, as in the reference)."""
    n = torch.tensor(float(numel), dtype=torch.float32, device=device)
    q = torch.as_tensor(qmax, dtype=torch.float32, device=device)
    return 1.0 / torch.sqrt(torch.clamp(n * q, min=1.0))


def fake_quant(v: torch.Tensor, s, qmin, qmax, *,
               grad_scale_factor=None) -> torch.Tensor:
    """Quantize-dequantize ``v`` with scale ``s`` (forward values only).
    ``s`` is a scalar or broadcasts against ``v``."""
    s = torch.clamp(torch.as_tensor(s, device=v.device).to(v.dtype), min=1e-9)
    if grad_scale_factor is not None:
        s = grad_scale(s, torch.as_tensor(grad_scale_factor,
                                          device=v.device).to(v.dtype))
    return torch.round(torch.clamp(v / s, qmin, qmax)) * s


def init_scale_from_stats(v: torch.Tensor, qmax) -> torch.Tensor:
    """LSQ statistics init: s0 = 2*E|v| / sqrt(qmax)."""
    return 2.0 * v.to(torch.float32).abs().mean() / torch.sqrt(_f32(qmax, v))


def init_scale_same(b: int) -> torch.Tensor:
    """The paper's same-value init: s_b = 0.1 / b."""
    return torch.tensor(0.1, dtype=torch.float32) / torch.tensor(
        float(b), dtype=torch.float32)
