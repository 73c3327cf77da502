"""Reduced configurations for tests and CPU runs (port of
``repro.testing.reduced_config``: rwkv, dense, MoE and hybrid).

``reduced_config(arch)`` shrinks an architecture to a CPU-friendly size
with the same values the JAX package uses, so both packages build the
same model: d_model 64, 4 heads of 16 (2 KV heads for the dense family,
4 wkv heads of 16 with chunk 8 for rwkv), d_ff 128, vocab 503 padded to
512, two periods of the layer pattern; an MoE arch gets 8 experts, top
2, capacity factor 1.5, token groups of 16 and d_ff 32; an SSM arch
(hymba) SSD heads of 16 with d_state 4, conv width 4 and chunk 8, and a
sliding window of 16.  A pattern longer than four kinds is shortened to
its distinct kinds, repeated: hymba's ``("attn",) + ("swa_ssm",) * 15``
becomes ``("attn", "swa_ssm") * 2``, so 8 layers.  Encoder-decoder and
m-rope families arrive with their slices.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import (ModelConfig, MoEConfig, RWKVConfig,
                                     SSMConfig)


def reduced_config(arch: str, **overrides) -> ModelConfig:
    cfg = get_config(arch)
    if cfg.family not in ("rwkv", "dense", "moe", "hybrid"):
        raise NotImplementedError(
            f"{arch}: the port reduces rwkv, dense, MoE and hybrid "
            f"configurations only so far")
    r: dict = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=503,          # deliberately unaligned: exercises padding
        vocab_pad_to=64,
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
    if cfg.ssm is not None:
        r["ssm"] = SSMConfig(d_state=4, expand=2, head_dim=16, conv_width=4,
                             chunk=8)
    # shrink the stack to two periods of a (possibly shortened) pattern
    pattern = cfg.layer_pattern
    if len(pattern) > 4:
        kinds = list(dict.fromkeys(pattern))  # unique, order-preserving
        pattern = tuple(kinds) * (4 // max(1, len(kinds)))
        pattern = pattern or cfg.layer_pattern[:4]
    r["layer_pattern"] = pattern
    r["n_layers"] = 2 * len(pattern)
    r.update(overrides)
    return dataclasses.replace(cfg, **r)
