"""Yi-9B [arXiv:2403.04652; hf]. Llama-arch GQA(kv=4), gated-silu MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=1e4,
    mlp_gated=True,
    act="silu",
)
