"""Shared layers (port of ``repro.models.layers``): weight casts, the
bf16 matmul with f32 accumulation, RMS norms, rotary position embeddings,
the MLP, embedding and logit head.

``dot`` keeps the JAX package's numerics: bf16 operands, exact products
summed in f32, the result rounded to bf16.  ``torch.matmul`` on bf16
does exactly that on the CPU and, with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
False, on the card.  These large products stay ``torch.matmul``, as the
JAX package left them to XLA.

An int8 weight leaf (``{"q", "scale"}``, from
``repro_torch.core.quant.quantize_tree``) is routed by the
``tile_plans["matmul_int8"]`` entry each ``dot`` is given: where it
resolves to "kernel" (a missing entry is "auto": the kernel on CUDA),
the product runs on the hand-written ``matmul_w8a16`` kernel, which
scales after the exact int8 sums; otherwise, as in the JAX package, the
weight is dequantized to bf16 (``wcast``) and multiplied.  The two differ
by bf16 roundings.  (The JAX package always dequantizes.)  Rope and the
silu-gated MLP serve the dense attention slice; m-rope and the gelu /
relu_sq MLP arrive with the slices that need them.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_impl
from repro_torch.models.params import ParamSpec

F32 = torch.float32
BF16 = torch.bfloat16


def wcast(w, dtype) -> torch.Tensor:
    """Weight view: plain tensor -> cast (a no-op when stored in
    ``dtype``); int8-quantized dict -> dequantize."""
    if isinstance(w, dict):
        return (w["q"].to(F32) * w["scale"].to(F32)).to(dtype)
    return w.to(dtype)


def dot(x: torch.Tensor, w, plan=None) -> torch.Tensor:
    """x @ w with f32 accumulation, result in x.dtype.  ``plan`` is the
    ``tile_plans["matmul_int8"]`` entry; it routes int8 leaves only."""
    if isinstance(w, dict) and resolve_impl(plan, x.device) == "kernel":
        if x.dtype != BF16:
            raise ValueError(f"dot: the matmul_w8a16 route takes bf16 "
                             f"activations, got {x.dtype}")
        from repro_torch.kernels.matmul_int8 import ops as mm_ops

        return mm_ops.qdot(x, w, plan=plan)
    return torch.matmul(x, wcast(w, x.dtype))


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for bf16 operands with the f32 sum kept as the result (no
    rounding to bf16).  On the card one cuBLAS call with an f32 output;
    on the CPU the exact bf16 values multiplied in f32."""
    if x.is_cuda:
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=F32)
        return y.reshape(*lead, w.shape[-1])
    return torch.matmul(x.to(F32), w.to(F32))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Logistic as the JAX package computes it: 1 / (1 + exp(-x)) with
    every op in x's dtype (XLA rounds each to bf16), so bf16 results
    match bit for bit; ``torch.sigmoid`` rounds once and differs in the
    last bit of about a third of the values."""
    return torch.reciprocal(1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), in x's dtype."""
    return x * sigmoid(x)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1 + scale) parametrization (gemma/llama style)."""
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(dtype)


def groupnorm_heads(x: torch.Tensor, scale: torch.Tensor, n_heads: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS normalization of a (..., n_heads * head_dim) tensor
    (RWKV's wkv output GroupNorm)."""
    dtype = x.dtype
    *lead, d = x.shape
    x = x.reshape(*lead, n_heads, d // n_heads).to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = (x * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * (1.0 + scale.to(F32))).to(dtype)


def rope_frequencies(head_dim: int, theta: float) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=F32) / half))


@functools.lru_cache(maxsize=16)
def _freqs_on(head_dim: int, theta: float, device: torch.device):
    """:func:`rope_frequencies`, computed once on the CPU and kept on each
    device it is asked for (no host-to-device copy per call)."""
    return rope_frequencies(head_dim, theta).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard RoPE.  x: (B, S, H, D), positions: (B, S) int32.  Every
    step in f32 in the JAX package's order, rounded to x's dtype once."""
    freqs = _freqs_on(x.shape[-1], theta, x.device)                # (D/2,)
    angles = positions.to(F32)[..., None] * freqs                 # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)
    return out.to(x.dtype)


def mlp_specs(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    specs = {"w_up": ParamSpec((d, f), F32), "w_down": ParamSpec((f, d), F32)}
    if cfg.mlp_gated:
        specs["w_gate"] = ParamSpec((d, f), F32)
    return specs


def mlp(params, x: torch.Tensor, cfg: ModelConfig,
        mm_plan=None) -> torch.Tensor:
    """The (gated) MLP.  The port serves ``mlp_act="silu"`` so far, with
    the JAX-faithful bf16 :func:`silu` applied to the rounded product
    (not fused into the kernel's epilogue, which would round once, in
    f32, unlike JAX).  ``mm_plan`` routes int8 weights (see :func:`dot`)."""
    if cfg.mlp_act != "silu":
        raise NotImplementedError(
            f"mlp_act={cfg.mlp_act!r} is not ported yet; the port serves "
            f"'silu'")
    up = dot(x, params["w_up"], mm_plan)
    if cfg.mlp_gated:
        h = silu(dot(x, params["w_gate"], mm_plan)) * up
    else:
        h = silu(up)
    return dot(h, params["w_down"], mm_plan)


def embed_specs(cfg: ModelConfig):
    v, d = cfg.padded_vocab, cfg.d_model
    specs = {"embedding": ParamSpec((v, d), F32, scale=1.0)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), F32)
    return specs


def embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = params["embedding"].to(BF16)[tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final logits (f32).  An int8 ``lm_head`` is dequantized here
    (``wcast``) on every path: the head keeps the f32 sum as its result,
    and the W8A16 kernel rounds its output to bf16."""
    if cfg.tie_embeddings:
        w = wcast(params["embedding"], x.dtype).T
    else:
        w = wcast(params["lm_head"], x.dtype)
    logits = dot_f32(x, w)
    if cfg.final_softcap > 0.0:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits


__all__ = ["wcast", "dot", "dot_f32", "sigmoid", "silu", "rmsnorm",
           "groupnorm_heads", "rope_frequencies", "apply_rope", "mlp_specs",
           "mlp", "embed_specs", "embed", "unembed"]
