"""HuBERT-XLarge [arXiv:2106.07447; unverified]. Encoder-only (bidirectional)
transformer, MHA, plain-gelu MLP. The conv waveform frontend is a STUB:
input_specs() supplies precomputed frame embeddings. vocab=504 is the
masked-unit prediction codebook. No decode step (encoder-only)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    encoder_only=True,
    mlp_gated=False,
    act="gelu",
    norm_type="ln",
    frontend="audio_stub",
)
