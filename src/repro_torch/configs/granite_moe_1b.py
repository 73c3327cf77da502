"""Granite-3.0-1B-A400M  [moe]  24L d_model=1024 16H (GQA kv=8) d_ff=512,
MoE 32 experts top-8, tied embeddings.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

Copied from ``repro.configs.granite_moe_1b`` without the training-policy
fields (remat, microbatches, attention sharding).  Prefill runs the
``flash_attention`` CUDA kernel and decode the ``flash_decode`` CUDA
kernel (16/8 heads of 64: G = 2); the MoE MLP is
``repro_torch/models/moe.py``.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    layer_pattern=("attn",),
    moe=MoEConfig(n_experts=32, top_k=8, capacity_factor=1.25, group_size=512),
    tie_embeddings=True,
)
