"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf]. 26 layers, repeating
(rec, rec, attn): RG-LRU recurrent blocks with temporal conv1d(4), 1 local
(window 2048) MQA attention per 2 recurrent. Gated-gelu MLP, tied embeddings.
Sub-quadratic -> long_500k applicable."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=2560,
    conv1d_width=4,
    mlp_gated=True,
    act="gelu",
    tie_embeddings=True,
    norm_eps=1e-6,
    notes="10 heads do not divide the 16-way model axis; local attention "
          "falls back to batch-sharded compute.",
)
