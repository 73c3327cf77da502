"""Model configuration of the port (port of ``repro.configs.base``).

Only what the rwkv serving path reads is carried over: ``ModelConfig``
with its vocabulary padding and layer-period properties, and
``RWKVConfig``.  The MoE and SSM sub-configs, the attention flavours and
the training-policy fields arrive with the slices that read them.
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
    the "rwkv" kind so far.
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
    final_softcap: float = 0.0          # gemma2 final-logit soft-capping
    mlp_gated: bool = True
    mlp_act: str = "silu"               # silu | gelu | relu_sq
    rwkv: Optional[RWKVConfig] = None
    tie_embeddings: bool = False
    scale_embeddings: bool = False      # gemma multiplies embeds by sqrt(d)
    vocab_pad_to: int = 256             # pad vocab so it shards over the mesh
    norm_eps: float = 1e-6

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

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
