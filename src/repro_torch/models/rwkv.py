"""RWKV6 (Finch) block (port of ``repro.models.rwkv``): data-dependent-
decay time mix + channel mix.

Prefill uses the chunked closed form (:mod:`repro_torch.models.recurrence`);
decode runs the single-token step, which on the card is the hand-written
``rwkv6_step`` kernel.  Tensors keep the JAX package's layouts: x is
(B, T, d) bf16, the wkv state (B, H, K, V) f32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dot, groupnorm_heads, rmsnorm,
                                       sigmoid, silu, wcast)
from repro_torch.models.params import ParamSpec
from repro_torch.models.recurrence import (chunked_linear_attention,
                                           linear_attention_step_planned)

F32 = torch.float32
LORA_RANK = 32
DECAY_RANK = 64
N_MIX = 5  # (w, k, v, r, g)

# Leaves read only through ``dot``: the port may store them in bf16 (see
# ``repro_torch.models.lm.LM.serving_params``).  Every other leaf is read
# in f32 (or cast per use) and stays f32.
DOT_LEAVES = frozenset({"lora_a", "wr", "wk", "wv", "wg", "wo", "decay_a",
                        "wk_c", "wv_c", "wr_c"})


def _decay_init(spec: ParamSpec, device) -> torch.Tensor:
    # spread decay half-lives per channel (rwkv-style ratio init)
    d = spec.shape[0]
    ratio = torch.arange(d, dtype=F32, device=device) / max(1, d - 1)
    return (-6.0 + 5.0 * ratio).to(spec.dtype)  # log(-log w) range


def rwkv_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    ff = cfg.d_ff
    z = lambda *s: ParamSpec(tuple(s), F32, init="zeros")
    return {
        "ln1": z(d),
        "ln2": z(d),
        # time-mix ddlerp
        "mu_base": z(d),
        "mu": z(N_MIX, d),
        "lora_a": ParamSpec((d, N_MIX * LORA_RANK), F32),
        "lora_b": ParamSpec((N_MIX, LORA_RANK, d), F32, scale=1e-2),
        # projections
        "wr": ParamSpec((d, d), F32),
        "wk": ParamSpec((d, d), F32),
        "wv": ParamSpec((d, d), F32),
        "wg": ParamSpec((d, d), F32),
        "wo": ParamSpec((d, d), F32),
        # data-dependent decay
        "decay_base": ParamSpec((d,), F32, init="custom",
                                custom_init=_decay_init),
        "decay_a": ParamSpec((d, DECAY_RANK), F32),
        "decay_b": ParamSpec((DECAY_RANK, d), F32, scale=1e-2),
        "bonus": z(d),
        "wkv_norm": z(d),
        # channel mix
        "mu_ck": z(d),
        "mu_cr": z(d),
        "wk_c": ParamSpec((d, ff), F32),
        "wv_c": ParamSpec((ff, d), F32),
        "wr_c": ParamSpec((d, d), F32),
    }


def _shift_seq(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / cached tail at t=0).  x: (B, T, d)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _ddlerp(params, x: torch.Tensor, xs: torch.Tensor, mm_plan=None):
    """Data-dependent token-shift interpolation -> the 5 mixed streams."""
    dx = xs - x
    xb = x + dx * params["mu_base"].to(x.dtype)
    lora = torch.tanh(dot(xb, params["lora_a"], mm_plan))
    B, T = x.shape[:2]
    lora = lora.reshape(B, T, N_MIX, LORA_RANK)
    mix = params["mu"].to(F32) + torch.einsum(
        "btnr,nrd->btnd", lora.to(F32), params["lora_b"].to(F32))
    streams = x[:, :, None, :].to(F32) + dx[:, :, None, :].to(F32) * mix
    return [streams[:, :, i].to(x.dtype) for i in range(N_MIX)]


def _time_mix_inputs(params, x, xs, mm_plan=None):
    xw, xk, xv, xr, xg = _ddlerp(params, x, xs, mm_plan)
    r = dot(xr, params["wr"], mm_plan)
    k = dot(xk, params["wk"], mm_plan)
    v = dot(xv, params["wv"], mm_plan)
    g = silu(dot(xg, params["wg"], mm_plan))
    dd = torch.tanh(dot(xw, params["decay_a"], mm_plan))
    # an f32 product: an int8 decay_b (d_model >= 256) is dequantized to
    # f32 here, where the JAX package's ``.astype`` fails on the dict
    dd = torch.matmul(dd.to(F32), wcast(params["decay_b"], F32))
    log_decay = -torch.exp(
        torch.clamp(params["decay_base"].to(F32) + dd, -8.0, 3.0))
    return r, k, v, g, log_decay


def _heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    B, T, d = x.shape
    return x.reshape(B, T, d // hd, hd).transpose(1, 2)   # (B,H,T,hd)


def _last_valid(x: torch.Tensor, lengths: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """x (B, T, d) -> the last valid token per example (B, d): x[:, -1]
    when lengths is None, else x[b, lengths[b]-1] (right-padded batch)."""
    if lengths is None:
        return x[:, -1, :]
    idx = torch.clamp(lengths.long() - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def time_mix(params, x: torch.Tensor, cfg: ModelConfig, *,
             prev: Optional[torch.Tensor] = None,
             state: Optional[torch.Tensor] = None,
             lengths: Optional[torch.Tensor] = None, mm_plan=None):
    """Full-sequence wkv.  x: (B, T, d).  Returns (out, new_shift,
    new_state).  ``lengths`` (B,) marks true lengths in a right-padded
    batch: padded steps get (decay 1, k 0), so they leave the state as
    it was."""
    hd = cfg.rwkv.head_dim
    H = cfg.d_model // hd
    xs = _shift_seq(x, prev)
    r, k, v, g, log_decay = _time_mix_inputs(params, x, xs, mm_plan)
    if lengths is not None:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < lengths[:, None])[..., None]                  # (B, T, 1)
        k = torch.where(valid, k, torch.zeros((), dtype=k.dtype,
                                              device=k.device))
        log_decay = torch.where(valid, log_decay,
                                torch.zeros((), dtype=F32, device=x.device))
    rh, kh, vh = _heads(r, hd), _heads(k, hd), _heads(v, hd)
    wh = _heads(log_decay, hd)
    u = params["bonus"].to(F32).reshape(H, hd)
    y, new_state = chunked_linear_attention(
        rh, kh, vh, wh, chunk=min(cfg.rwkv.chunk, x.shape[1]),
        convention="exclusive", u=u, initial_state=state)
    y = y.transpose(1, 2).reshape(x.shape)
    y = groupnorm_heads(y.to(x.dtype), params["wkv_norm"], H, cfg.norm_eps)
    out = dot(y * g, params["wo"], mm_plan)
    return out, _last_valid(x, lengths), new_state


def time_mix_step(params, x: torch.Tensor, cfg: ModelConfig, *,
                  prev: torch.Tensor, state: torch.Tensor, tile_plan=None,
                  mm_plan=None):
    """Single-token wkv (decode).  x: (B, 1, d).  The new state is
    written into ``state`` in place (f32, (B, H, K, V))."""
    hd = cfg.rwkv.head_dim
    H = cfg.d_model // hd
    xs = prev[:, None, :]
    r, k, v, g, log_decay = _time_mix_inputs(params, x, xs, mm_plan)
    sq = lambda t: t[:, 0, :].reshape(t.shape[0], H, hd)
    u = params["bonus"].to(F32).reshape(H, hd)
    y, _ = linear_attention_step_planned(
        state, sq(r), sq(k), sq(v), sq(log_decay), u=u, tile_plan=tile_plan,
        out=state)
    y = y.reshape(x.shape[0], 1, cfg.d_model)
    y = groupnorm_heads(y.to(x.dtype), params["wkv_norm"], H, cfg.norm_eps)
    out = dot(y * g, params["wo"], mm_plan)
    return out, x[:, 0, :], state


def channel_mix(params, x: torch.Tensor, cfg: ModelConfig, *,
                prev: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None, mm_plan=None):
    """Squared-relu channel mix.  Returns (out, new_shift)."""
    xs = _shift_seq(x, prev)
    dx = xs - x
    xk = x + dx * params["mu_ck"].to(x.dtype)
    xr = x + dx * params["mu_cr"].to(x.dtype)
    kk = torch.square(torch.relu(dot(xk, params["wk_c"], mm_plan)))
    r = sigmoid(dot(xr, params["wr_c"], mm_plan))
    out = r * dot(kk, params["wv_c"], mm_plan)
    return out, _last_valid(x, lengths)


def rwkv_block(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
               cache: Optional[Dict] = None,
               lengths: Optional[torch.Tensor] = None, tile_plan=None,
               mm_plan=None):
    """Full rwkv block.  Returns (x, cache): decode writes the new state
    and shifts into ``cache`` in place and returns it, prefill returns a
    new cache.  ``lengths`` masks padded steps of a right-padded prefill
    batch (see time_mix).  ``tile_plan`` (a ``tile_plans["rwkv"]`` entry)
    routes the decode step, ``mm_plan`` (the ``"matmul_int8"`` entry)
    every int8 weight's ``dot``."""
    if mode == "decode":
        h, tm_shift, _ = time_mix_step(
            params, rmsnorm(x, params["ln1"], cfg.norm_eps), cfg,
            prev=cache["tm_shift"], state=cache["wkv_state"],
            tile_plan=tile_plan, mm_plan=mm_plan)
        x = x + h
        h, cm_shift = channel_mix(
            params, rmsnorm(x, params["ln2"], cfg.norm_eps), cfg,
            prev=cache["cm_shift"], mm_plan=mm_plan)
        x = x + h
        # the shifts are read above (as x_{t-1}); overwrite them last
        cache["tm_shift"].copy_(tm_shift)
        cache["cm_shift"].copy_(cm_shift)
        return x, cache
    prev_tm = cache["tm_shift"] if cache else None
    prev_cm = cache["cm_shift"] if cache else None
    state = cache["wkv_state"] if cache else None
    h, tm_shift, state = time_mix(
        params, rmsnorm(x, params["ln1"], cfg.norm_eps), cfg,
        prev=prev_tm, state=state, lengths=lengths, mm_plan=mm_plan)
    x = x + h
    h, cm_shift = channel_mix(
        params, rmsnorm(x, params["ln2"], cfg.norm_eps), cfg,
        prev=prev_cm, lengths=lengths, mm_plan=mm_plan)
    x = x + h
    return x, {"wkv_state": state.to(F32), "tm_shift": tm_shift,
               "cm_shift": cm_shift}
