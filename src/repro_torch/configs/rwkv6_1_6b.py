"""RWKV6-1.6B (Finch): 24 layers, d_model 2048 (attention-free), 32 wkv
heads of 64, d_ff 7168, vocab 65536, data-dependent decay
[arXiv:2404.05892].  Copied from ``repro.configs.rwkv6_1_6b``.

Prefill runs the chunked form of the wkv recurrence
(:mod:`repro_torch.models.recurrence`); every decode step of every layer
runs the ``rwkv6_step`` CUDA kernel (``repro_torch/csrc/rwkv_step.cu``).
"""

from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    n_layers=24,
    d_model=2048,
    n_heads=32,                 # wkv heads = d_model / rwkv.head_dim
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    layer_pattern=("rwkv",),
    rwkv=RWKVConfig(head_dim=64, chunk=128, ffn_mult=3.5),
    mlp_gated=False,            # rwkv channel-mix is its own 2-matrix block
    mlp_act="relu_sq",
)
