"""Mixed-precision storage: int8 symmetric quantization and blocked
floating point (port of ``repro.core.quant``).

Weights are stored int8 with an f32 scale per output slice; the kernels
widen them exactly and accumulate in f32.  ``blocked_fp`` emulates
Brainwave's shared-exponent block format for the DeepBench accuracy
comparison.  The weight-tree helpers of the JAX module serve the LM and
arrive with its slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32
INT8_MAX = 127.0


def quantize_int8(x: torch.Tensor, axis: int = -1,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization along ``axis``.

    Returns (q int8, scale f32) with x ~= q * scale (scale broadcastable).
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
    codes equal the JAX package's bit for bit."""
    xf = x.to(F32)
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / INT8_MAX
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(F32) * scale.to(F32)).to(dtype)


def quantize_kv(kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) tensors: scale per leading index (per token, per head)."""
    return quantize_int8(kv, axis=-1)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return dequantize_int8(q, scale, torch.bfloat16)


def blocked_fp(x: torch.Tensor, block: int = 16, mantissa_bits: int = 4,
               axis: int = -1) -> torch.Tensor:
    """Round to a shared-exponent block format along ``axis``.

    Each block of ``block`` values shares one exponent (max exponent in the
    block); each value keeps a sign and ``mantissa_bits`` of mantissa."""
    xf = x.to(F32)
    moved = torch.movedim(xf, axis, -1)
    n = moved.shape[-1]
    pad = (-n) % block
    if pad:
        moved = torch.cat(
            [moved, moved.new_zeros(moved.shape[:-1] + (pad,))], dim=-1)
    blocks = moved.reshape(moved.shape[:-1] + (-1, block))
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    exp = torch.floor(torch.log2(torch.clamp(amax, min=1e-30)))
    step = torch.exp2(exp - (mantissa_bits - 1))
    q = (torch.round(blocks / step) * step).reshape(moved.shape)
    if pad:
        q = q[..., :n]
    return torch.movedim(q, -1, axis).to(x.dtype)
