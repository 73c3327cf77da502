"""Model configuration of the port (port of ``repro.configs.base``).

What the rwkv and dense-attention serving paths read is carried over:
``ModelConfig`` with its vocabulary padding, layer-period and head-width
properties, the attention flavour fields (qkv bias, rope theta, local
window, softcaps, qk norm, m-rope sections, the flash block and the KV
cache storage type), and ``RWKVConfig``.  The MoE and SSM sub-configs,
the encoder fields and the training-policy fields arrive with the slices
that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64          # key/value dim per wkv head
    chunk: int = 128            # chunked-recurrence block length
    ffn_mult: float = 3.5


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single architecture.

    ``layer_pattern`` gives one *period* of the layer stack; the stack is
    ``layer_pattern * (n_layers // len(layer_pattern))``.  The port serves
    the "rwkv" and "attn" kinds so far.
    """

    name: str
    family: str                 # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("attn",)

    # --- attention flavour -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    local_window: int = 0               # sliding-window size for "local"
    attn_softcap: float = 0.0           # gemma2 logit soft-capping
    final_softcap: float = 0.0          # gemma2 final-logit soft-capping
    qk_norm: bool = False               # gemma3 / qwen3 style
    m_rope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) split
    mlp_gated: bool = True
    mlp_act: str = "silu"               # silu | gelu | relu_sq
    rwkv: Optional[RWKVConfig] = None
    tie_embeddings: bool = False
    scale_embeddings: bool = False      # gemma multiplies embeds by sqrt(d)
    vocab_pad_to: int = 256             # pad vocab so it shards over the mesh
    norm_eps: float = 1e-6
    # FLOPs-efficient attention block size (plain flash path) when > 0
    attn_block: int = 0
    kv_cache_dtype: str = "bf16"        # "bf16" | "int8"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"layer pattern period {self.period}")
        return self.n_layers // self.period
