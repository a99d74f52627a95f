"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf]. GQA(kv=8), per-head qk RMS-norm,
head_dim=128 (q_dim 2048 != d_model), tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,
    rope_theta=1e6,
    qk_norm=True,
    mlp_gated=True,
    act="silu",
    tie_embeddings=True,
)
