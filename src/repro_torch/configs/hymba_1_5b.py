"""Hymba-1.5B  [hybrid]  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads.
[arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base]  Copied from
``repro.configs.hymba_1_5b`` without the training-policy fields (remat,
microbatches, attention sharding).

Each hybrid layer runs sliding-window attention heads and SSM (Mamba-style)
heads in parallel on the same input and sums their (normed) outputs.  The
release's 3 full-attention layers are modelled as one global layer per
16-layer scan period (period = 1 "attn" + 15 "swa_ssm").  The SSM uses the
SSD scalar-per-head-decay form (``repro_torch.models.ssm``) with
d_state=16.

Prefill runs the ``flash_attention`` CUDA kernel (window 0 on the "attn"
layers, 1024 on the "swa_ssm" layers) and every decode step of every
layer the ``flash_decode`` CUDA kernel, over a 1024-slot ring on the
"swa_ssm" layers (``repro_torch/csrc/flash_attention.cu``); the SSD
mixer, the projections and the MLP are plain PyTorch.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    layer_pattern=("attn",) + ("swa_ssm",) * 15,
    local_window=1024,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, conv_width=4, chunk=128),
    tie_embeddings=True,
)
