"""Reduced configurations for tests and CPU runs (port of
``repro.testing.reduced_config``, rwkv branch).

``reduced_config(arch)`` shrinks an architecture to a CPU-friendly size
with the same values the JAX package uses, so both packages build the
same model: d_model 64, 4 wkv heads of 16, chunk 8, vocab 503 padded to
512, two layers.  Other families arrive with their slices.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, RWKVConfig


def reduced_config(arch: str, **overrides) -> ModelConfig:
    cfg = get_config(arch)
    if cfg.rwkv is None:
        raise NotImplementedError(
            f"{arch}: the port reduces rwkv configurations only so far")
    r: dict = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=503,          # deliberately unaligned: exercises padding
        vocab_pad_to=64,
        rwkv=RWKVConfig(head_dim=16, chunk=8),
        layer_pattern=cfg.layer_pattern,
        n_layers=2 * len(cfg.layer_pattern),
    )
    r.update(overrides)
    return dataclasses.replace(cfg, **r)
