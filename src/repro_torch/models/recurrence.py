"""Chunked linear-attention recurrence (port of
``repro.models.recurrence``).

The rwkv6 wkv state recurrence over a (K x V) state S with per-step decay:

    S_t = diag(d_t) S_{t-1} + k_t v_t^T          y_t = q_t . S_{t'}

``chunked_linear_attention`` evaluates it for a whole sequence (prefill):
within a chunk, cumulative log-decays turn it into a masked matmul
(clamped at ``-LOG_CLAMP``, as in the JAX package); across chunks the
per-chunk (decay, increment) pairs are chained.  The JAX package chains
them with a log-depth ``associative_scan``; here a loop over the chunks
applies the same affine maps in order, so only the association of the
f32 products differs.

``linear_attention_step`` is the single-token step (decode).
``linear_attention_step_planned`` routes that step by a tile plan: an
entry's ``impl`` resolves through
:func:`repro_torch.kernels.dispatch.resolve_impl`, and a missing entry
counts as ``{"impl": "auto"}``, so on a CUDA device the ``rwkv6_step``
kernel runs and on the CPU the plain version.  (The JAX package takes its
jnp path whenever the entry is missing.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_impl

F32 = torch.float32
LOG_CLAMP = 30.0


def chunked_linear_attention(
    q: torch.Tensor,                 # (B, H, T, K)
    k: torch.Tensor,                 # (B, H, T, K)
    v: torch.Tensor,                 # (B, H, T, V)
    log_decay: torch.Tensor,         # (B, H, T, K) or (B, H, T, 1); <= 0
    *,
    chunk: int,
    convention: str,                 # "exclusive" (rwkv) | "inclusive" (ssd)
    u: Optional[torch.Tensor] = None,             # (H, K) rwkv bonus
    initial_state: Optional[torch.Tensor] = None,  # (B, H, K, V)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, H, T, V) f32, final_state (B, H, K, V) f32)."""
    B, H, T, K = q.shape
    V = v.shape[-1]
    T_real = T
    chunk = max(1, chunk)
    pad = (-T) % chunk
    if pad:
        # padded steps have decay 1 and k = 0: they leave the state as is
        zpad = lambda x: torch.cat(
            [x, x.new_zeros(x.shape[:2] + (pad,) + x.shape[3:])], dim=2)
        q, k, v, log_decay = zpad(q), zpad(k), zpad(v), zpad(log_decay)
        T = T + pad
    n_c, n = T // chunk, chunk

    ch = lambda x: x.reshape(B, H, n_c, n, x.shape[-1])
    qc, kc, vc = ch(q.to(F32)), ch(k.to(F32)), ch(v.to(F32))
    lw = ch(log_decay.to(F32))
    if lw.shape[-1] == 1:
        lw = lw.expand(B, H, n_c, n, K)

    c_inc = torch.cumsum(lw, dim=3)
    c_exc = c_inc - lw
    cq = c_exc if convention == "exclusive" else c_inc
    cqc = torch.clamp(cq, min=-LOG_CLAMP)
    ckc = torch.clamp(c_inc, min=-LOG_CLAMP)
    qd = qc * torch.exp(cqc)
    kd = kc * torch.exp(-ckc)

    # ---- intra-chunk scores ---------------------------------------------
    scores = torch.einsum("bhcik,bhcjk->bhcij", qd, kd)
    i_idx = torch.arange(n, device=q.device)[:, None]
    j_idx = torch.arange(n, device=q.device)[None, :]
    mask = (j_idx < i_idx) if convention == "exclusive" else (j_idx <= i_idx)
    scores = torch.where(mask, scores, torch.zeros((), dtype=F32,
                                                   device=q.device))
    y = torch.einsum("bhcij,bhcjv->bhciv", scores, vc)
    if u is not None:  # rwkv bonus: the diagonal reads (u*k_i) instead of S
        diag = torch.einsum("bhcik,hk,bhcik->bhci", qc, u.to(F32), kc)
        y = y + diag[..., None] * vc

    # ---- chunk summaries ------------------------------------------------
    total = c_inc[:, :, :, -1, :]                        # (B,H,nc,K)
    rc = torch.clamp(total[:, :, :, None, :] - c_inc, min=-LOG_CLAMP)
    kt = kc * torch.exp(rc)
    A = torch.einsum("bhcjk,bhcjv->bhckv", kt, vc)      # (B,H,nc,K,V)
    D = torch.exp(total)                                 # (B,H,nc,K)

    # ---- inter-chunk state chain: the affine maps applied in order -------
    S = (torch.zeros((B, H, K, V), dtype=F32, device=q.device)
         if initial_state is None else initial_state.to(F32))
    enter = []
    for c in range(n_c):
        enter.append(S)
        S = D[:, :, c, :, None] * S + A[:, :, c]
    S_enter = torch.stack(enter, dim=2)                  # (B,H,nc,K,V)
    y = y + torch.einsum("bhcik,bhckv->bhciv", qd, S_enter)
    y = y.reshape(B, H, T, V)
    if pad:
        y = y[:, :, :T_real]
    return y, S


def linear_attention_step(
    state: torch.Tensor,             # (B, H, K, V)
    q: torch.Tensor,                 # (B, H, K)
    k: torch.Tensor,                 # (B, H, K)
    v: torch.Tensor,                 # (B, H, V)
    log_decay: torch.Tensor,         # (B, H, K) or (B, H, 1)
    *,
    convention: str,
    u: Optional[torch.Tensor] = None,        # (H, K)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence (decode).  Returns (y (B,H,V) f32,
    new_state f32)."""
    state = state.to(F32)
    q, k, v = q.to(F32), k.to(F32), v.to(F32)
    d = torch.exp(log_decay.to(F32).expand(k.shape))
    kv = k[..., None] * v[..., None, :]                   # (B,H,K,V)
    if convention == "exclusive":
        read = state + (u.to(F32)[None, :, :, None] * kv
                        if u is not None else 0.0)
        new_state = d[..., None] * state + kv
    else:  # inclusive (ssd)
        new_state = d[..., None] * state + kv
        read = new_state
    y = torch.einsum("bhk,bhkv->bhv", q, read)
    return y, new_state


def step_impl(tile_plan, device) -> str:
    """"kernel" | "plain" for the decode step's call site: a missing plan
    entry resolves as ``{"impl": "auto"}`` (the kernel on CUDA)."""
    return resolve_impl(tile_plan if tile_plan is not None
                        else {"impl": "auto"}, device)


def linear_attention_step_planned(
    state: torch.Tensor,             # (B, H, K, V)
    q: torch.Tensor,                 # (B, H, K)
    k: torch.Tensor,                 # (B, H, K)
    v: torch.Tensor,                 # (B, H, V)
    log_decay: torch.Tensor,         # (B, H, K)
    *,
    u: Optional[torch.Tensor] = None,        # (H, K)
    tile_plan=None,
    out: Optional[torch.Tensor] = None,      # (B, H, K, V) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exclusive-convention single-token step, routed by a tile plan
    (see :func:`step_impl`).  The kernel takes its head tile from the
    plan's ``bh`` (hidden units -> whole heads).  Returns (y f32, state
    f32) either way; with ``out`` (which may be ``state`` itself) the new
    state is written there and ``out`` is returned."""
    if step_impl(tile_plan, q.device) == "plain":
        y, new_state = linear_attention_step(state, q, k, v, log_decay,
                                             convention="exclusive", u=u)
        return y, (new_state if out is None else out.copy_(new_state))
    from repro_torch.kernels.rwkv_step.ops import head_tile
    from repro_torch.kernels.rwkv_step.rwkv_step import rwkv6_step

    H, K = q.shape[1], q.shape[2]
    y, new_state = rwkv6_step(
        q[None], k[None], v[None],
        log_decay.to(F32).expand(k.shape)[None],
        u.to(F32) if u is not None else q.new_zeros((H, K), dtype=F32),
        state.to(F32), bh=head_tile(H, K, tile_plan), out=out)
    return y[0].to(F32), new_state


__all__ = ["LOG_CLAMP", "chunked_linear_attention", "linear_attention_step",
           "step_impl", "linear_attention_step_planned"]
