"""Shared model primitives: norms, activations, RoPE, initializers."""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in f32, cast back to x's dtype, THEN multiply the scale (in
    that dtype) -- the reference's order."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


def norm_init(d: int, norm_type: str, device=None):
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if norm_type == "ln":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(x: torch.Tensor, p, norm_type: str, eps: float) -> torch.Tensor:
    if norm_type == "ln":
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":         # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: F.relu(x).square()
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# RoPE (half-rotation convention)
# ---------------------------------------------------------------------------
def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D//2) or broadcastable
    (..., S, 1, D//2). The first half rotates against the second."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    d2 = x.shape[-1] // 2
    x1, x2 = x32[..., :d2], x32[..., d2:]
    if cos.dim() == 2:       # (S, D//2) -> (S, 1, D//2): broadcast over heads
        cos = cos[:, None, :]
        sin = sin[:, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# init (seeded by an explicit torch.Generator on the target device)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               stacked=(), device=None) -> torch.Tensor:
    shape = tuple(stacked) + (in_dim, out_dim)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * in_dim ** -0.5


def embed_init(gen: torch.Generator, vocab: int, d: int,
               device=None) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                       device=device) * d ** -0.5
