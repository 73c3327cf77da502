"""Dispatch of RNNCellConfig workloads onto the fused CUDA kernels
(port of ``repro.kernels.fused_rnn.ops``).

``serve`` is the entry point used by ``repro_torch.core.cells.serve(...,
impl="kernel")`` and the DeepBench entry point.  The CTA tile ``bh`` comes
from the Hopper DSE (:mod:`repro_torch.core.dse`), scored at the batch
actually served, unless a ``tile_plans`` entry passed as ``plan`` sets
it.  ``plan["persistent"]`` selects the weights-resident kernel, with
the DSE's best resident tile unless the plan names one.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import dse
from repro_torch.kernels.dispatch import resolve_impl, tile_arg
from repro_torch.kernels.fused_rnn import ref
from repro_torch.kernels.fused_rnn.fused_rnn import (fused_gru, fused_lstm,
                                                    legal_bh)

F32 = torch.float32


def _weights_for_kernel(cfg, w: Dict) -> Tuple:
    """Split quantized/unquantized weight dicts into kernel operands."""
    s_x = w.get("w_x_scale")
    s_h = w.get("w_h_scale")
    wx, wh = w["w_x"], w["w_h"]
    if s_x is None:
        wx = wx.to(torch.bfloat16)
        s_x = torch.ones(w["b"].shape, dtype=F32, device=wx.device)
    if s_h is None:
        wh = wh.to(torch.bfloat16)
        s_h = torch.ones(w["b"].shape, dtype=F32, device=wh.device)
    return wx, wh, s_x, s_h


def default_bh(cfg, batch: int, persistent: bool = False) -> int:
    """DSE-chosen CTA tile for serving ``batch`` rows of this cell.

    The batch must reach ``best_plan``: the shared-memory working set
    (h staging, partial sums) scales with it.  The persistent search,
    which scores every divisor of H, is kept per (cell, batch)."""
    if persistent:
        return _persistent_bh(cfg, batch)
    return dse.best_plan(cfg, max_batch=batch).bh


@functools.lru_cache(maxsize=256)
def _persistent_bh(cfg, batch: int) -> int:
    return dse.best_plan(cfg, max_batch=batch, persistent=True).bh


def serve(cfg, w: Dict, x_seq: torch.Tensor, *, bh: int = 0,
          state: Optional[Tuple[torch.Tensor, ...]] = None,
          plan: Optional[Mapping[str, object]] = None) -> torch.Tensor:
    """Run T serving steps through the fused kernel.  x_seq (T, B, D),
    on the device the weights lie on; returns y (T, B, H) bf16.

    ``plan`` is a ``tile_plans`` entry: ``bh`` overrides the tile (on the
    card made legal for the mode that runs, :func:`legal_bh`, e.g. a JAX
    plan's whole-H tile; on the CPU, where the plain version runs
    whatever the tile, snapped to a divisor of H), ``persistent: true``
    selects the weights-resident kernel, ``impl`` picks kernel or plain version
    (:func:`repro_torch.kernels.dispatch.resolve_impl`)."""
    T, B, D = x_seq.shape
    H = cfg.hidden
    dev = x_seq.device
    wx, wh, s_x, s_h = _weights_for_kernel(cfg, w)
    if state is None:
        h0 = torch.zeros((B, H), dtype=F32, device=dev)
        c0 = torch.zeros((B, H), dtype=F32, device=dev)
    else:
        h0 = state[0]
        c0 = (state[1] if len(state) > 1
              else torch.zeros((B, H), dtype=F32, device=dev))
    b_h = w.get("b_h", torch.zeros_like(w["b"]))
    if resolve_impl(plan, dev) == "plain":
        if cfg.cell == "lstm":
            return ref.fused_lstm_ref(x_seq, wx, wh, s_x, s_h, w["b"],
                                      h0, c0)[0]
        return ref.fused_gru_ref(x_seq, wx, wh, s_x, s_h, w["b"], b_h, h0)[0]
    persistent = bool((plan or {}).get("persistent", False))
    bh = tile_arg(plan, "bh", bh or 0) or default_bh(cfg, B, persistent)
    bh = (legal_bh(cfg.n_gates, H, bh, wh.element_size(), persistent)
          if dev.type == "cuda" else dse.snap_tile(H, bh))
    if cfg.cell == "lstm":
        y, _, _ = fused_lstm(x_seq, wx, wh, s_x, s_h, w["b"], h0, c0,
                             bh=bh, persistent=persistent)
    else:
        y, _ = fused_gru(x_seq, wx, wh, s_x, s_h, w["b"], b_h, h0,
                         bh=bh, persistent=persistent)
    return y

