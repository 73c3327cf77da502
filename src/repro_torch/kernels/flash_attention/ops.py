"""Model-layout adapters for the flash attention kernels (port of
``repro.kernels.flash_attention.ops``).

They take the model's (B, S, H, hd) layout with separate KV heads.  The
kernels address every operand through strides and read KV head
``h // (H // K)`` themselves, so the adapters pass transposed *views*:
no head expansion (``_expand_kv`` of the JAX package) and no transpose
copy; the prefill output is written in (B, S, H, hd) memory order.
Tile geometry (``bq``/``bk``) comes from a ``tile_plans["attn"]`` entry
when one is passed (:func:`repro_torch.kernels.dispatch.tile_arg`);
:func:`.flash_attention.kernel_tiles` makes it legal for the kernel
(multiples of 64 query rows and of ``SUB`` keys, up to 128 each,
clamped to the lengths) instead of snapping it to a divisor, since the
kernels bounds-check a ragged last tile; :func:`.flash_decode.decode_bk`
does the same for the decode chunk (1 to ``MAX_BK`` slots, clamped to
the cache).  The defaults are the port's: the Pallas defaults (256/512)
suit the TPU's one core, not 132 SMs.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from repro_torch.kernels.dispatch import tile_arg
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, kernel_tiles)
from repro_torch.kernels.flash_attention.flash_decode import (decode_bk,
                                                              flash_decode)

DEFAULT_BQ = 64          # one math warpgroup of 64 query rows (two CTAs an SM)
DEFAULT_BK = 64          # keys a stage of the prefill kernel's K/V ring
DEFAULT_DECODE_BK = 128  # cache slots per decode CTA


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, q_pos=None, kv_pos=None,
              bq: int = 0, bk: int = 0,
              plan: Optional[Mapping[str, object]] = None):
    """q (B, S, H, hd); k, v (B, S, K, hd) -> (B, S, H, hd) bf16.

    ``q_pos``/``kv_pos`` (B, S) enable position-array masking (padded
    prefill buckets); ``plan`` supplies bq/bk tile geometry."""
    S, Skv = q.shape[1], k.shape[1]
    bq, bk = kernel_tiles(tile_arg(plan, "bq", bq or DEFAULT_BQ),
                          tile_arg(plan, "bk", bk or DEFAULT_BK), S, Skv)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), q_pos, kv_pos, causal=causal,
                          window=window, softcap=softcap, bq=bq, bk=bk)
    return out.transpose(1, 2)


def decode(q, k_cache, v_cache, kv_pos, q_pos, *, causal: bool = True,
           window: int = 0, softcap: float = 0.0, bk: int = 0,
           plan: Optional[Mapping[str, object]] = None):
    """Split-KV flash-decoding adapter, mirroring the contract of
    ``repro_torch.models.attention.decode_attention``: q (B, H, hd),
    caches (B, S, K, hd), kv_pos (B, S) with -1 holes, q_pos (B,).
    Returns (B, H, hd) bf16."""
    S = k_cache.shape[1]
    bk = decode_bk(tile_arg(plan, "bk", bk or DEFAULT_DECODE_BK), S)
    out = flash_decode(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2),
                       kv_pos, q_pos, causal=causal, window=window,
                       softcap=softcap, bk=bk)
    return out.to(torch.bfloat16)


__all__ = ["DEFAULT_BQ", "DEFAULT_BK", "DEFAULT_DECODE_BK", "attention",
           "decode"]
