"""Model configuration of the port (port of ``repro.configs.base``).

What the rwkv, dense-attention, MoE and hybrid (hymba) serving paths
read is carried over: ``ModelConfig`` with its vocabulary padding,
layer-period and head-width properties, the attention flavour fields
(qkv bias, rope theta, local window, softcaps, qk norm, m-rope sections,
the flash block and the KV cache storage type), its parameter counts,
``MoEConfig``, ``SSMConfig`` and ``RWKVConfig``.  The encoder fields and
the training-policy fields arrive with the slices that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Token group size for GShard-style dispatch; capacity is computed per
    # group so the one-hot dispatch tensors stay bounded.
    group_size: int = 512
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2/SSD-style selective state space head block: a scalar decay
    per head and a (d_state x head_dim) state, the restriction of
    Mamba1's per-(channel, state) decay that admits a chunked form (see
    ``repro_torch.models.ssm``)."""

    d_state: int = 16
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 128


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
    the "rwkv", "attn" and "swa_ssm" kinds so far, "attn" with a dense or
    an MoE MLP.
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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
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

    # ---------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Exact parameter count (embedding included once if tied), by
        the JAX package's formula for the kinds the port serves."""
        d = self.d_model
        total = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * d  # lm head
        for kind in self.layer_pattern * self.n_periods:
            total += self._block_params(kind)
        total += d  # final norm
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            p += self.q_dim + 2 * self.kv_dim
        return p

    def _mlp_params(self) -> int:
        n_mats = 3 if self.mlp_gated else 2
        return n_mats * self.d_model * self.d_ff

    def _block_params(self, kind: str) -> int:
        d = self.d_model
        norms = 2 * d
        if kind == "rwkv":
            a = self.rwkv or RWKVConfig()
            wkv = d * d * 4 + d * d  # r,k,v,g(+output) projections approx
            wkv += d * d             # w (decay) lora-ish projections
            ffn = 2 * d * int(d * a.ffn_mult)
            return wkv + ffn + norms
        if kind == "swa_ssm":
            s = self.ssm or SSMConfig()
            d_in = d * s.expand
            ssm = d * d_in * 2 + d_in * d  # in/out projections (x, z)
            ssm += d_in * (2 * s.d_state) + d_in  # B,C,dt projections-ish
            return self._attn_params() + ssm + self._mlp_params() + norms
        if self.moe is not None:
            router = d * self.moe.n_experts
            experts = self.moe.n_experts * 3 * d * self.d_ff
            return self._attn_params() + router + experts + norms
        return self._attn_params() + self._mlp_params() + norms

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        experts_all = (self.n_layers * self.moe.n_experts * 3
                       * self.d_model * self.d_ff)
        experts_active = (self.n_layers * self.moe.top_k * 3 * self.d_model
                          * self.d_ff)
        return total - experts_all + experts_active
