"""Paper-representative demo config: a small LM whose layer mix (cheap
narrow projections vs wide MLP matmuls) mirrors the paper's DW-vs-PW-conv
sensitivity contrast. Used by examples/ and benchmarks/ for end-to-end
importance training + ILP search + QAT finetune on CPU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="limpq-demo",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=1024,
    vocab=512,
    mlp_gated=True,
    act="silu",
    max_seq_len=512,
)
