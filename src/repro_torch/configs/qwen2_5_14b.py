"""Qwen2.5-14B  [dense]  48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA, QKV bias, rope theta 1e6.  Copied from
``repro.configs.qwen2_5_14b`` without the training-policy fields (FSDP,
remat, microbatches, attention sharding).

Prefill runs the ``flash_attention`` CUDA kernel and every decode step of
every layer the ``flash_decode`` CUDA kernel
(``repro_torch/csrc/flash_attention.cu``); the projections and the MLP
are cuBLAS matmuls.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    layer_pattern=("attn",),
)
