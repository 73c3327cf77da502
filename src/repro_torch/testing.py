"""Reduced configurations for tests and CPU runs (port of
``repro.testing.reduced_config``, rwkv, dense and MoE branches).

``reduced_config(arch)`` shrinks an architecture to a CPU-friendly size
with the same values the JAX package uses, so both packages build the
same model: d_model 64, 4 heads of 16 (2 KV heads for the dense family,
4 wkv heads of 16 with chunk 8 for rwkv), d_ff 128, vocab 503 padded to
512, two layers; an MoE arch gets 8 experts, top 2, capacity factor
1.5, token groups of 16 and d_ff 32.  SSM, encoder-decoder and m-rope
families arrive with their slices.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, MoEConfig, RWKVConfig


def reduced_config(arch: str, **overrides) -> ModelConfig:
    cfg = get_config(arch)
    if cfg.family not in ("rwkv", "dense", "moe"):
        raise NotImplementedError(
            f"{arch}: the port reduces rwkv, dense and MoE configurations "
            f"only so far")
    r: dict = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=503,          # deliberately unaligned: exercises padding
        vocab_pad_to=64,
        layer_pattern=cfg.layer_pattern,
        n_layers=2 * len(cfg.layer_pattern),
    )
    if cfg.local_window:
        r["local_window"] = 16
    if cfg.moe is not None:
        r["moe"] = MoEConfig(n_experts=8, top_k=2, capacity_factor=1.5,
                             group_size=16)
        r["d_ff"] = 32
    if cfg.rwkv is not None:
        r["rwkv"] = RWKVConfig(head_dim=16, chunk=8)
        r["n_kv_heads"] = 4
    r.update(overrides)
    return dataclasses.replace(cfg, **r)
