"""Mixed-precision storage: int8 symmetric quantization and blocked
floating point (port of ``repro.core.quant``).

Weights are stored int8 with an f32 scale per output slice; the kernels
widen them exactly and accumulate in f32.  ``blocked_fp`` emulates
Brainwave's shared-exponent block format for the DeepBench accuracy
comparison.  ``quantize_tree``/``serving_specs`` turn an LM's weight
tree into the int8 serving layout that ``repro_torch.models.layers.dot``
consumes (``{"q": int8, "scale": f32}`` leaves).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

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


# ---------------------------------------------------------------------------
# Weight-tree quantization for serving
# ---------------------------------------------------------------------------

# Eligibility: matmul weights with a reasonably wide output dim and enough
# input rows for stable per-channel scales.  Embedding tables stay wide
# (gather path, accuracy-sensitive); norm scales / biases are 1-D anyway.
_MIN_OUT_DIM = 256
_MIN_IN_DIM = 64


def should_quantize(path: str, shape, dtype) -> bool:
    """The JAX package's rule, to the letter: decided by the leaf's path
    (its ``keystr``, so "embedding" anywhere in it excludes the leaf), its
    rank, its last two dims and a float dtype."""
    if "embedding" in path:
        return False
    return (len(shape) >= 2 and shape[-1] >= _MIN_OUT_DIM
            and shape[-2] >= _MIN_IN_DIM
            and dtype in (torch.float32, torch.bfloat16))


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys: "['a']['b']"."""
    return "".join(f"[{k!r}]" for k in path)


def _quantize_leaf(x: torch.Tensor):
    """{q, scale} of one eligible leaf, reduced over axis -2.  A stacked
    leaf (L, K, N) is quantized one layer at a time: its scales are per
    (layer, column), so this equals the single call bit for bit, with one
    layer's f32 copy alive instead of the whole stack's."""
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[:-2] + (1,) + x.shape[-1:], dtype=F32,
                        device=x.device)
    flat_x = x.reshape((-1,) + tuple(x.shape[-2:]))
    flat_q = q.view(flat_x.shape)
    flat_s = scale.view((flat_x.shape[0], 1, x.shape[-1]))
    for i in range(flat_x.shape[0]):
        flat_q[i], flat_s[i] = quantize_int8(flat_x[i], axis=-2)
    return {"q": q, "scale": scale}


def quantize_tree(params: Any, *, consume: bool = False) -> Any:
    """Quantize every eligible matmul weight to {q: int8, scale: f32};
    ineligible float leaves are cast to bf16 (norm scales, rwkv's ``mu*``,
    ``decay_base`` and ``bonus`` included) and other leaves kept.

    Reduction happens over the *input* (second-to-last) dim so each output
    channel has its own scale, the layout the W8A16 kernel reads.  With
    ``consume=True`` each leaf is removed from ``params`` as soon as its
    served form exists, so a tree on the card is converted with one leaf
    of headroom instead of a second tree; ``params`` is left empty."""
    def walk(tree, path):
        out = {}
        for key in list(tree):
            val, sub = tree[key], path + (key,)
            if isinstance(val, dict):
                out[key] = walk(val, sub)
            elif not should_quantize(_keystr(sub), tuple(val.shape),
                                     val.dtype):
                out[key] = (val.to(torch.bfloat16)
                            if val.dtype.is_floating_point else val)
            else:
                out[key] = _quantize_leaf(val)
            if consume:
                del tree[key]
            del val
        return out
    return walk(params, ())


def serving_specs(specs: Any, int8: bool = False) -> Any:
    """Transform a ParamSpec tree into its serving layout: bf16 storage, or
    {q: int8, scale: f32} dict-leaves for eligible weights when int8."""
    from repro_torch.models.params import ParamSpec

    def conv(path, s):
        if isinstance(s, dict):
            return {k: conv(path + (k,), v) for k, v in s.items()}
        if not s.dtype.is_floating_point:
            return s
        bf = dataclasses.replace(s, dtype=torch.bfloat16)
        if not int8 or not should_quantize(_keystr(path), s.shape, s.dtype):
            return bf
        scale_shape = tuple(s.shape[:-2]) + (1,) + tuple(s.shape[-1:])
        return {"q": dataclasses.replace(s, dtype=torch.int8),
                "scale": ParamSpec(scale_shape, F32, init="ones")}
    return conv((), specs)


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
