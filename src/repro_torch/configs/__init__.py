"""Architecture registry: ``get_config(name)`` / ``list_archs()``.

Every assigned architecture from the brief plus the paper-representative
demo config. Reduced smoke variants live in ``smoke_config``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    DEFAULT_BITS,
    PINNED_BITS,
    ModelConfig,
    MoEConfig,
    SHAPES,
    SHAPES_BY_NAME,
    ShapeSpec,
    shape_applicable,
)

from repro_torch.configs import (  # noqa: E402
    deepseek_moe_16b,
    granite_20b,
    hubert_xlarge,
    limpq_demo,
    llama32_vision_11b,
    mixtral_8x7b,
    qwen3_0_6b,
    recurrentgemma_2b,
    rwkv6_7b,
    starcoder2_7b,
    yi_9b,
)

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        starcoder2_7b, yi_9b, qwen3_0_6b, granite_20b, llama32_vision_11b,
        mixtral_8x7b, deepseek_moe_16b, hubert_xlarge, rwkv6_7b,
        recurrentgemma_2b, limpq_demo,
    )
}

ASSIGNED_ARCHS = tuple(n for n in _REGISTRY if n != "limpq-demo")


def list_archs(include_demo: bool = False):
    return tuple(_REGISTRY) if include_demo else ASSIGNED_ARCHS


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def smoke_config(name: str) -> ModelConfig:
    """A drastically reduced same-family config for CPU smoke tests."""
    cfg = get_config(name)
    overrides = dict(
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        max_seq_len=256,
    )
    # keep the block pattern but shrink depth to one full repeat (>=2 layers)
    overrides["n_layers"] = max(2, len(cfg.block_pattern))
    if cfg.family == "vlm":
        overrides["n_layers"] = cfg.cross_attn_every  # one self-unit + 1 cross
        overrides["n_image_tokens"] = 16
    if cfg.moe is not None:
        overrides["moe"] = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            n_shared=cfg.moe.n_shared,
            d_ff=64,
            first_dense_layers=cfg.moe.first_dense_layers,
            dense_d_ff=128 if cfg.moe.dense_d_ff else 0,
        )
        overrides["n_layers"] = 2 + cfg.moe.first_dense_layers
    if cfg.sliding_window:
        overrides["sliding_window"] = 64
    if cfg.local_window:
        overrides["local_window"] = 64
    if cfg.lru_width:
        overrides["lru_width"] = 128
    if cfg.family == "ssm":   # rwkv: heads = d_model / 64
        overrides["n_heads"] = 128 // cfg.rwkv_head_dim
        overrides["n_kv_heads"] = overrides["n_heads"]
        overrides["head_dim"] = 0
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **overrides)
