"""StarCoder2-7B [arXiv:2402.19173; hf]. GQA(kv=4), RoPE, plain-gelu MLP,
sliding-window attention (4096, per the HF config) -> long_500k applicable."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    rope_theta=1e5,
    sliding_window=4096,
    mlp_gated=False,
    act="gelu",
    notes="36 heads do not divide the 16-way model axis; attention falls back "
          "to batch-sharded compute (dist/sharding.py).",
)
