"""Adapter for the W8A16 matmul (port of
``repro.kernels.matmul_int8.ops``): accepts the framework's quantized
leaf convention ({"q": int8 (K, N), "scale": f32 (1, N)}) directly.

Tile geometry (``bm``/``bn``/``bk``) comes from a
``tile_plans["matmul_int8"]`` entry when one is passed
(:func:`repro_torch.kernels.dispatch.tile_arg`);
:func:`.matmul_int8.kernel_tiles` makes it legal for the kernel and
clamps it to the shape instead of snapping it to a divisor, since the
kernel bounds-checks a ragged last tile.  The defaults are the port's:
one 16-row tile and 32 columns a CTA for decode (M <= 16: the most CTAs
on 132 SMs for the weight stream; ``core.dse.best_matmul_plan`` picks it
for five of qwen2.5-14b's seven decode projections), 128 x 128 for
prefill; the Pallas defaults (256/256/512) suit the TPU's one core.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from repro_torch.kernels.dispatch import tile_arg
from repro_torch.kernels.matmul_int8.matmul_int8 import (kernel_tiles,
                                                        matmul_w8a16)

DECODE_TILES = (16, 32, 128)    # bm, bn, bk for M <= 16
PREFILL_TILES = (128, 128, 64)  # bm, bn, bk otherwise


def default_tiles(M: int):
    return DECODE_TILES if M <= 16 else PREFILL_TILES


def qdot(x, leaf, bias=None, *, act: str = "none",
         plan: Optional[Mapping[str, object]] = None):
    """x (..., K) @ quantized leaf -> (..., N) bf16."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = leaf["q"].shape[-1]
    x2 = x.reshape(-1, K).to(torch.bfloat16)
    M = x2.shape[0]
    bm, bn, bk = default_tiles(M)
    bm, bn, bk = kernel_tiles(tile_arg(plan, "bm", bm),
                              tile_arg(plan, "bn", bn),
                              tile_arg(plan, "bk", bk), M, N, K)
    out = matmul_w8a16(x2, leaf["q"], leaf["scale"].reshape(-1), bias,
                       act=act, bm=bm, bn=bn, bk=bk)
    return out.reshape(*lead, N)


__all__ = ["DECODE_TILES", "PREFILL_TILES", "default_tiles", "qdot"]
