"""Granite-20B-Code [arXiv:2405.04324; hf]. MQA (kv=1), plain-gelu MLP
(param count pins this: gated would give ~28B), RoPE per the 'llama-arch'
note in the assignment (upstream gpt_bigcode uses learned positions; RoPE
avoids a 500k-row table — deviation recorded in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    rope_theta=1e4,
    mlp_gated=False,
    act="gelu",
)
