"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision; unverified].
Text backbone: 40 self-attn layers; an extra cross-attention block (with its
own gated MLP, mllama-style) after every 5th self layer -> 8 cross blocks.
Vision frontend is a STUB: input_specs() supplies precomputed patch
embeddings (B, n_image_tokens, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=5e5,
    mlp_gated=True,
    act="silu",
    cross_attn_every=5,
    n_image_tokens=1600,
    frontend="vision_stub",
)
