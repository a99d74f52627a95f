"""Mixtral-8x7B [arXiv:2401.04088; hf]. 8 routed experts top-2, GQA(kv=8),
sliding-window attention (4096) -> long_500k applicable."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,            # per-expert hidden dim
    vocab=32000,
    rope_theta=1e6,
    sliding_window=4096,
    mlp_gated=True,
    act="silu",
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_ff=14336),
    notes="8 experts do not divide the 16-way model axis; experts use "
          "tensor-parallel d_ff sharding instead of expert parallelism.",
)
