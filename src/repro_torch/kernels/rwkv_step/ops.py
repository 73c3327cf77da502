"""Model-layout adapter for the fused RWKV6 step kernel (port of
``repro.kernels.rwkv_step.ops``).

``serve_wkv`` takes the rwkv block's projections ((B, T, d) flat) and
drives the kernel in the (T, B, H, K) layout.  A ``tile_plans["rwkv"]``
entry sets the head tile: its ``bh`` is in hidden units (the DSE cell
model's H rows), converted to whole heads and snapped to a divisor of
the head count, as in the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Optional

from repro_torch.core.dse import snap_tile
from repro_torch.kernels.dispatch import tile_arg
from repro_torch.kernels.rwkv_step.rwkv_step import rwkv6_step


def head_tile(n_heads: int, head_dim: int,
              plan: Optional[Mapping[str, object]]) -> int:
    """Heads per CTA for a plan whose ``bh`` counts hidden units.

    Without a ``bh`` the JAX package puts all heads in one grid step (the
    TPU runs its grid in order on one core); on Hopper that would be one
    CTA per batch row, so the port's default is one head per CTA."""
    bh_units = tile_arg(plan, "bh", 0)
    if not bh_units:
        return 1
    return snap_tile(n_heads, max(1, bh_units // head_dim))


def serve_wkv(r, k, v, w_log, u, state, *, head_dim: int = 64,
              plan: Optional[Mapping[str, object]] = None):
    """r/k/v/w_log: (B, T, d); u: (d,); state: (B, H, hd, hd) f32.
    Returns (y (B, T, d) bf16, state')."""
    B, T, d = r.shape
    H = d // head_dim
    to = lambda x: x.reshape(B, T, H, head_dim).transpose(0, 1)
    y, state = rwkv6_step(to(r), to(k), to(v), to(w_log),
                          u.reshape(H, head_dim), state,
                          bh=head_tile(H, head_dim, plan))
    return y.transpose(0, 1).reshape(B, T, d), state
