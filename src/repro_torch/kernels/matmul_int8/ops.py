"""Adapter for the W8A16 matmul (port of
``repro.kernels.matmul_int8.ops``): accepts the framework's quantized
leaf convention ({"q": int8 (K, N), "scale": f32 (1, N)}) directly.

Geometry comes from a ``tile_plans["matmul_int8"]`` entry when one is
passed (:func:`repro_torch.kernels.dispatch.tile_arg`).  For M <= 16
(decode) the entry's ``splits`` (a key only the port has) sets the
split-K kernel's K splits, clamped to [1, K steps]; a missing or zero
entry means the default geometry (:func:`.matmul_int8.decode_geometry`:
the fewest splits that give 2 CTAs an SM, the geometry
``core.dse.best_matmul_plan`` picks at qwen2.5-14b's decode shapes).
Above, ``bm``/``bn``/``bk`` set the prefill kernel's CTA tile;
:func:`.matmul_int8.kernel_tiles` makes them legal for the kernel and
clamps them to the shape instead of snapping them to a divisor, since
the kernel bounds-checks a ragged last tile.  The default tile is the
one ``core.dse.best_matmul_plan`` picks at the shape
(:func:`prefill_tiles`: 256 x 128 x 64 at qwen2.5-14b's wq/wo, w_gate/
w_up and w_down at M = 2048, 128 x 128 x 64 at wk/wv, where 256-row
tiles would leave half the SMs idle); ``DECODE_TILES`` are only checked,
the decode kernel has its own geometry.  The Pallas defaults (256/256/512)
suit the TPU's one core.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional

import torch

from repro_torch.core import dse
from repro_torch.kernels.dispatch import tile_arg
from repro_torch.kernels.matmul_int8.matmul_int8 import (BK, BMS, BNS,
                                                        DECODE_M, k_steps,
                                                        kernel_tiles,
                                                        matmul_w8a16)

DECODE_TILES = (BMS[0], BNS[0], BK)   # bm, bn, bk for M <= 16 (only checked)


@functools.lru_cache(maxsize=1024)
def prefill_tiles(M: int, N: int, K: int):
    """(bm, bn, bk) of the modeled-fastest prefill tile at (M, N, K)."""
    p = dse.best_matmul_plan(int(M), int(N), int(K))
    return p.bm, p.bn, p.bk


def default_tiles(M: int, N: int, K: int):
    return DECODE_TILES if M <= DECODE_M else prefill_tiles(M, N, K)


def legal_splits(splits: int, K: int) -> Optional[int]:
    """A plan's ``splits`` made legal for the decode kernel: clamped to
    [1, K steps]; zero or negative means the default (None)."""
    splits = int(splits)
    return min(splits, k_steps(K)) if splits > 0 else None


def qdot(x, leaf, bias=None, *, act: str = "none",
         plan: Optional[Mapping[str, object]] = None):
    """x (..., K) @ quantized leaf -> (..., N) bf16."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = leaf["q"].shape[-1]
    x2 = x.reshape(-1, K).to(torch.bfloat16)
    M = x2.shape[0]
    bm, bn, bk = default_tiles(M, N, K)
    bm, bn, bk = kernel_tiles(tile_arg(plan, "bm", bm),
                              tile_arg(plan, "bn", bn),
                              tile_arg(plan, "bk", bk), M, N, K)
    splits = legal_splits(tile_arg(plan, "splits", 0), K)
    out = matmul_w8a16(x2, leaf["q"], leaf["scale"].reshape(-1), bias,
                       act=act, bm=bm, bn=bn, bk=bk, splits=splits)
    return out.reshape(*lead, N)


__all__ = ["DECODE_TILES", "prefill_tiles", "default_tiles", "legal_splits",
           "qdot"]
