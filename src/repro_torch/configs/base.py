"""Config system: model architecture configs and input-shape specs.

Every assigned architecture is expressed as a ``ModelConfig``. The model code
(`repro_torch.models.lm`) is driven entirely by this dataclass — adding an arch means
adding a config file, not model code.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Bit-width options searched by the paper (first/last layers pinned to 8).
DEFAULT_BITS: Tuple[int, ...] = (2, 3, 4, 5, 6)
PINNED_BITS: int = 8


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0          # routed experts
    top_k: int = 0
    n_shared: int = 0           # always-on shared experts (deepseek-moe)
    d_ff: int = 0               # per-expert hidden dim
    first_dense_layers: int = 0  # leading layers that stay dense
    dense_d_ff: int = 0         # d_ff used by those dense layers


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # positional / attention flavour
    rope_theta: float = 10000.0
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA window (None = full attention)
    causal: bool = True                    # False for encoder-only
    # MLP flavour
    mlp_gated: bool = True       # llama-style gate*up; False -> plain 2-matmul
    act: str = "silu"            # silu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    norm_type: str = "rms"       # rms | ln (hubert/w2v2 use LayerNorm)
    # MoE
    moe: Optional[MoEConfig] = None
    # VLM: insert a cross-attention block after every `cross_attn_every`-th
    # self-attention layer (mllama: 8 extra cross blocks for 40 self layers).
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    # audio (encoder-only, stub frontend provides frame embeddings)
    encoder_only: bool = False
    frontend: str = "none"       # none | audio_stub | vision_stub
    # ssm / hybrid
    block_pattern: Tuple[str, ...] = ("attn",)   # repeated; e.g. (rec,rec,attn)
    local_window: int = 0        # recurrentgemma local-attn window
    lru_width: int = 0           # RG-LRU state width (0 -> d_model)
    conv1d_width: int = 4        # temporal conv width in recurrent block
    rwkv_head_dim: int = 64
    # quantization
    bits: Tuple[int, ...] = DEFAULT_BITS
    quant_act_signed: bool = True   # LM activations are signed (DESIGN.md §8)
    # misc
    max_seq_len: int = 524288
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def n_bits(self) -> int:
        return len(self.bits)

    @property
    def is_subquadratic(self) -> bool:
        """True when a 500k-token context is feasible (skip rule for long_500k)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Skip rules from DESIGN.md §5. Returns (applicable, reason_if_not)."""
    if cfg.encoder_only and shape.is_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "pure full-attention arch; 500k context needs sub-quadratic attention"
    return True, ""
