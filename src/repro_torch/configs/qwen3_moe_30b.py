"""Qwen3-30B-A3B  [moe]  48L d_model=2048 32H (GQA kv=4) d_ff=768,
MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]

30.5B total / ~3.3B active params; QK-norm, head_dim 128.  Copied from
``repro.configs.qwen3_moe_30b`` without the training-policy fields
(FSDP, remat, microbatches, attention sharding).

Prefill runs the ``flash_attention`` CUDA kernel and every decode step of
every layer the ``flash_decode`` CUDA kernel (G = 8 query heads a KV
head); the MoE MLP is the JAX package's dense GShard dispatch and
combine (``repro_torch/models/moe.py``), its expert products batched
cuBLAS matmuls.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    rope_theta=1e6,
    qk_norm=True,
    layer_pattern=("attn",),
    moe=MoEConfig(n_experts=128, top_k=8, capacity_factor=1.25, group_size=512),
)
