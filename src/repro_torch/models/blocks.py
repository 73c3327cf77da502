"""Block assembly (port of ``repro.models.blocks``): one function per
layer kind.  The port serves the "rwkv" kind (rwkv6 time mix + channel
mix, which handles its own norms); "attn", "local", "swa_ssm" and cross
attention arrive with their slices.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.params import ParamSpec


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"layer kind {kind!r} is not ported yet; the port serves 'rwkv'")


def block_specs(cfg: ModelConfig, kind: str) -> Dict[str, ParamSpec]:
    if kind == "rwkv":
        return rwkv_lib.rwkv_specs(cfg)
    raise _not_ported(kind)


def apply_block(params, x, cfg: ModelConfig, kind: str, *, lengths=None,
                mode: str = "prefill", cache: Optional[Dict] = None,
                tile_plan=None):
    """Returns (x, new_cache_entry).  In prefill mode ``lengths`` (when not
    None) marks each example's true prompt length within a right-padded
    batch: recurrent state updates are the identity on padded steps.
    ``tile_plan`` is this kind's ``tile_plans`` entry (or None)."""
    if kind == "rwkv":
        return rwkv_lib.rwkv_block(
            params, x, cfg, mode=mode, cache=cache,
            lengths=lengths if mode == "prefill" else None,
            tile_plan=tile_plan)
    raise _not_ported(kind)
