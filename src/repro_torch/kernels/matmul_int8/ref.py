"""Plain PyTorch version of the W8A16 matmul kernel (port of
``repro.kernels.matmul_int8.ref.matmul_w8a16_ref``).

x is rounded to bf16 and multiplied by the int8 codes widened exactly to
bf16; every product of a bf16 and an int8 value is exact in f32, and the
sums run in f32 (an f32 matmul of those exact values, with TF32 off on
the card).  Then the per-column scale, the bias, the epilogue, and one
rounding to bf16.  ``jax.nn.gelu`` defaults to the tanh approximation,
so ``gelu`` here is ``approximate="tanh"``.
"""

from __future__ import annotations

from typing import Optional

import torch

F32 = torch.float32
BF16 = torch.bfloat16

EPILOGUES = {
    "none": lambda x: x,
    "silu": torch.nn.functional.silu,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "relu": torch.relu,
}


def matmul_w8a16_plain(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       act: str = "none") -> torch.Tensor:
    """x (M, K); w_q (K, N) int8; scale (N,) f32; bias (N,) f32 or None.
    Returns act(x @ (w_q * scale) + bias) as (M, N) bf16."""
    out = torch.matmul(x.to(BF16).to(F32), w_q.to(BF16).to(F32))
    out = out * scale.to(F32)[None, :]
    if bias is not None:
        out = out + bias.to(F32)[None, :]
    return EPILOGUES[act](out).to(BF16)


def matmul_w8a16_split_plain(x: torch.Tensor, w_q: torch.Tensor,
                             scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             ranges, act: str = "none") -> torch.Tensor:
    """The decode kernel's order of sums in plain PyTorch: an f32 partial
    product over each K range [k0, k1) of ``ranges``, the partials added
    in the order given, then the scale, bias, act and one rounding."""
    xf, wf = x.to(BF16).to(F32), w_q.to(BF16).to(F32)
    out = None
    for k0, k1 in ranges:
        part = torch.matmul(xf[:, k0:k1], wf[k0:k1])
        out = part if out is None else out + part
    out = out * scale.to(F32)[None, :]
    if bias is not None:
        out = out + bias.to(F32)[None, :]
    return EPILOGUES[act](out).to(BF16)


__all__ = ["EPILOGUES", "matmul_w8a16_plain", "matmul_w8a16_split_plain"]
