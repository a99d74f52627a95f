"""DeepSeekMoE-16B [arXiv:2401.06066; hf]. Fine-grained MoE: 64 routed experts
top-6 + 2 shared experts (d_ff 1408 each); first layer dense (d_ff 10944).
MHA (kv=16)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,             # per-routed-expert hidden dim
    vocab=102400,
    rope_theta=1e4,
    mlp_gated=True,
    act="silu",
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff=1408,
                  first_dense_layers=1, dense_d_ff=10944),
    notes="64 experts shard 4-per-device over the 16-way model axis (EP).",
)
