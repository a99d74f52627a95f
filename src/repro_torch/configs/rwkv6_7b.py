"""RWKV6-World-7B 'Finch' [arXiv:2404.05892; hf]. Attention-free: per-layer
time-mix (data-dependent decay wkv recurrence, 64 heads of dim 64) +
channel-mix (d_ff = 3.5x d_model). O(1) decode state -> long_500k applicable."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
    mlp_gated=False,       # channel-mix is its own structure
    act="relu2",
)
