"""SSD-form selective state-space block, hymba's mamba heads (port of
``repro.models.ssm``).

Mamba1's per-(channel, state) decay matrix A[d, n] admits no parallel
form without materialising a (T, d_inner, d_state) tensor.  The JAX
package uses the Mamba2/SSD restriction, a scalar decay per head and a
(d_state x head_dim) state, which reduces exactly to scalar-decay chunked
linear attention with q = C_t, k = B_t, v = dt_t * x_t; the port copies
it.  hymba's ssm_state=16 is preserved.

Numerics follow the JAX package op for op: the depthwise conv adds its
shifted bf16 products one at a time, rounding after each add; ``silu``
is the bf16 expansion of :func:`repro_torch.models.layers.silu`;
``softplus`` is ``jnp.logaddexp(x, 0)`` in f32.  Prefill runs
:func:`repro_torch.models.recurrence.chunked_linear_attention` and
decode :func:`repro_torch.models.recurrence.linear_attention_step`, both
with the inclusive convention.  No Pallas kernel exists for either in the
JAX package, so both stay plain PyTorch here (the ``rwkv6_step`` kernel
runs the exclusive convention with a bonus, another recurrence).

At decode :func:`ssm_mixer` writes ``conv_state`` and ``ssd_state`` into
the cache's own tensors (``copy_``), so a CUDA graph of the step keeps
their addresses.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dot, groupnorm_heads, silu
from repro_torch.models.params import ParamSpec
from repro_torch.models.recurrence import (chunked_linear_attention,
                                           linear_attention_step)

F32 = torch.float32


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.d_model * cfg.ssm.expand


def _n_ssm_heads(cfg: ModelConfig) -> int:
    return _d_inner(cfg) // cfg.ssm.head_dim


def _dt_bias_init(spec: ParamSpec, device) -> torch.Tensor:
    # softplus^-1 of dt in [1e-3, 1e-1], log-spaced (mamba init).  Like
    # the JAX package's, it reads ``spec.shape[0]`` after stacking, so the
    # leaf holds one value per layer.
    n = spec.shape[0]
    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), n,
                                  dtype=F32, device=device))
    return torch.log(torch.expm1(dt)).to(spec.dtype)


def _a_log_init(spec: ParamSpec, device) -> torch.Tensor:
    # one value per layer, as ``_dt_bias_init``
    n = spec.shape[0]
    return torch.log(torch.linspace(1.0, 16.0, n, dtype=F32,
                                    device=device)).to(spec.dtype)


def ssm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, s = cfg.d_model, cfg.ssm
    di, nh = _d_inner(cfg), _n_ssm_heads(cfg)
    return {
        "w_in": ParamSpec((d, 2 * di), F32),
        "conv_kernel": ParamSpec((s.conv_width, di), F32, scale=0.5),
        "conv_bias": ParamSpec((di,), F32, init="zeros"),
        "w_bc": ParamSpec((di, 2 * s.d_state), F32),
        "w_dt": ParamSpec((d, nh), F32),
        "dt_bias": ParamSpec((nh,), F32, init="custom",
                             custom_init=_dt_bias_init),
        "a_log": ParamSpec((nh,), F32, init="custom",
                           custom_init=_a_log_init),
        "d_skip": ParamSpec((nh,), F32, init="ones"),
        "ssm_norm": ParamSpec((di,), F32, init="zeros"),
        "w_out": ParamSpec((di, d), F32),
    }


def _causal_depthwise_conv(x: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor,
                           tail: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv along time via shifted adds (no conv
    primitive), in x's dtype with a rounding after every op.

    x: (B, T, di); kernel: (W, di); tail: (B, W-1, di) previous inputs."""
    W = kernel.shape[0]
    B, T, di = x.shape
    pad = (x.new_zeros((B, W - 1, di)) if tail is None
           else tail.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                       # (B, T+W-1, di)
    out = torch.zeros_like(x)
    for w in range(W):
        out = out + xp[:, w:w + T, :] * kernel[w].to(x.dtype)
    return out + bias.to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``jnp.logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)) (``torch.nn.functional.softplus`` switches to the
    identity above a threshold and so differs)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssm_inputs(params, x: torch.Tensor, cfg: ModelConfig, conv_tail,
                lengths: Optional[torch.Tensor] = None, mm_plan=None):
    """Shared prefill/decode input computation.

    Returns (q, k, v, log_decay, x_heads, z, new_conv_tail).

    ``lengths`` (B,) marks true per-example lengths in a right-padded
    prefill batch; the conv tail is then gathered at the last valid
    positions (zeros before t=0, matching the causal-conv zero padding).
    Only supported for fresh prefills (conv_tail None)."""
    s = cfg.ssm
    di, nh = _d_inner(cfg), _n_ssm_heads(cfg)
    B, T, _ = x.shape
    xz = dot(x, params["w_in"], mm_plan)
    xi, z = torch.split(xz, di, dim=-1)
    xc = _causal_depthwise_conv(xi, params["conv_kernel"],
                                params["conv_bias"], conv_tail)
    w1 = s.conv_width - 1
    if lengths is not None:
        src = (lengths.to(torch.int64)[:, None] - w1
               + torch.arange(w1, device=x.device)[None, :])   # (B, W-1)
        idx = torch.clamp(src, min=0)[:, :, None].expand(B, w1, di)
        tail = torch.gather(xi, 1, idx)
        new_tail = torch.where((src >= 0)[:, :, None], tail,
                               torch.zeros((), dtype=xi.dtype,
                                           device=x.device))
    elif conv_tail is not None:
        new_tail = torch.cat([conv_tail.to(x.dtype), xi], dim=1)[:, -w1:, :]
    else:
        new_tail = xi[:, -w1:, :]
    xc = silu(xc)
    bc = dot(xc, params["w_bc"], mm_plan).to(F32)
    b_t, c_t = torch.split(bc, s.d_state, dim=-1)          # (B,T,N) each
    dt = _softplus(torch.matmul(x.to(F32), params["w_dt"].to(F32))
                   + params["dt_bias"].to(F32))             # (B,T,nh)
    log_decay = -torch.exp(params["a_log"].to(F32)) * dt    # (B,T,nh) <= 0
    xh = xc.reshape(B, T, nh, s.head_dim)
    v = xh.to(F32) * dt[..., None]                          # (B,T,nh,hd)
    # broadcast shared B/C across heads: (B, nh, T, N)
    q = c_t[:, None].expand(B, nh, T, s.d_state)
    k = b_t[:, None].expand(B, nh, T, s.d_state)
    vv = v.permute(0, 2, 1, 3)                              # (B,nh,T,hd)
    ld = log_decay.permute(0, 2, 1)[..., None]              # (B,nh,T,1)
    return q, k, vv, ld, xh, z, new_tail


def _finish(params, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
            cfg: ModelConfig, mm_plan=None) -> torch.Tensor:
    """y: (B,nh,T,hd) -> gated, normed, projected out (B,T,d)."""
    B, nh, T, hd = y.shape
    y = y + (params["d_skip"].to(F32)[None, :, None, None]
             * xh.permute(0, 2, 1, 3).to(F32))
    y = y.permute(0, 2, 1, 3).reshape(B, T, nh * hd)
    y = groupnorm_heads(y.to(z.dtype), params["ssm_norm"], nh, cfg.norm_eps)
    y = y * silu(z)
    return dot(y, params["w_out"], mm_plan)


def ssm_mixer(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
              cache: Optional[Dict] = None,
              lengths: Optional[torch.Tensor] = None, mm_plan=None):
    """SSD mixer.  x: (B, T, d).  Returns (out (B,T,d), cache).

    Decode reads ``cache["conv_state"]``/``["ssd_state"]`` and writes the
    step's into them in place, returning ``cache``; prefill returns a new
    ``{"conv_state", "ssd_state"}``.  ``lengths`` masks padded steps of
    a right-padded prefill batch: padded steps get (decay 1, k 0) so the
    ssd_state carries through unchanged.  ``mm_plan`` routes int8 weights
    of the ``dot`` products (:func:`repro_torch.models.layers.dot`)."""
    s = cfg.ssm
    if mode == "decode":
        conv_tail, state = cache["conv_state"], cache["ssd_state"]
        q, k, v, ld, xh, z, new_tail = _ssm_inputs(params, x, cfg, conv_tail,
                                                   mm_plan=mm_plan)
        y, new_state = linear_attention_step(
            state, q[:, :, 0], k[:, :, 0], v[:, :, 0], ld[:, :, 0],
            convention="inclusive")
        out = _finish(params, y[:, :, None, :], xh, z, cfg, mm_plan)
        # both states are read above; overwrite them last
        conv_tail.copy_(new_tail)
        state.copy_(new_state)
        return out, cache

    conv_tail = cache["conv_state"] if cache else None
    state = cache["ssd_state"] if cache else None
    q, k, v, ld, xh, z, new_tail = _ssm_inputs(params, x, cfg, conv_tail,
                                               lengths=lengths,
                                               mm_plan=mm_plan)
    if lengths is not None:
        T = x.shape[1]
        valid = (torch.arange(T, device=x.device)[None, None, :, None]
                 < lengths.to(torch.int64)[:, None, None, None])  # (B,1,T,1)
        zero = torch.zeros((), dtype=F32, device=x.device)
        k = torch.where(valid, k, zero)
        ld = torch.where(valid, ld, zero)
    y, new_state = chunked_linear_attention(
        q, k, v, ld, chunk=min(s.chunk, x.shape[1]),
        convention="inclusive", initial_state=state)
    out = _finish(params, y, xh, z, cfg, mm_plan)
    return out, {"conv_state": new_tail, "ssd_state": new_state.to(F32)}


__all__ = ["ssm_specs", "ssm_mixer"]
