"""W8A16 matmul for Hopper (port of
``repro.kernels.matmul_int8.matmul_int8``).

The CUDA source is ``repro_torch/csrc/matmul_int8.cu``; its head note
says what it replaces, what bounds it and how it is laid out.  This
module checks the operands, allocates the output and launches the kernel
through a plain C interface (``ctypes``), on PyTorch's current stream.

On a CPU tensor :func:`matmul_w8a16` runs the plain PyTorch version
(:func:`.ref.matmul_w8a16_plain`); on a CUDA tensor it launches the
kernel or raises.

Geometry: a CTA of 4 warps owns a ``bm`` x ``bn`` output tile (``bm`` in
:data:`BMS`, ``bn`` in :data:`BNS`) and walks K in steps of ``bk`` (a
multiple of 32 up to 128).  Ragged edges are bounds-checked: no length
has to divide by a tile.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels.matmul_int8 import ref

BF16 = torch.bfloat16
F32 = torch.float32
BMS = (16, 32, 64, 128)    # output rows per CTA the kernel is built for
BNS = (32, 64, 128)        # output columns per CTA
BK_STEP, MAX_BK = 32, 128  # K per step: a multiple of 32 up to 128
ACTS = {"none": 0, "silu": 1, "gelu": 2, "relu": 3}
_PAD_H, _PAD_B = 8, 16     # csrc: kPadH (bf16 per row), kPadB (bytes per row)

# Kernel launches: one per call on CUDA tensors.
LAUNCHES: Dict[str, int] = {"matmul_w8a16": 0}


def stages(bm: int) -> int:
    """Pipeline depth of the kernel at this tile (csrc: ``Shape::STAGES``)."""
    return 4 if bm == 16 else 3


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of one CTA (csrc: ``launch``): the ring of x
    (bf16) and int8 w tiles, and the widened [n][k] bf16 w tile, rows
    padded by 16 bytes."""
    return (stages(bm) * (bm * (bk + _PAD_H) * 2 + bk * (bn + _PAD_B))
            + bn * (bk + _PAD_H) * 2)


def kernel_tiles(bm: int, bn: int, bk: int, M: int, N: int, K: int):
    """(bm, bn, bk) the kernel can run, clamped to the shape: the largest
    of :data:`BMS` / :data:`BNS` not above the request, then halved while
    half still covers M / N; bk a multiple of 32 in [32, 128], no larger
    than K rounded up to 32."""
    def pick(want, sizes, n):
        t = max([s for s in sizes if s <= want] or [sizes[0]])
        while t > sizes[0] and t // 2 >= n:
            t //= 2
        return t
    up = -(-K // BK_STEP) * BK_STEP
    bk = min(up, MAX_BK, max(BK_STEP, int(bk) // BK_STEP * BK_STEP))
    return pick(int(bm), BMS, M), pick(int(bn), BNS, N), bk


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("matmul_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.matmul_w8a16_forward.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.matmul_w8a16_forward.restype = i
    return lib


def _launch(x, w_q, scale, bias, act, bm, bn, bk):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"matmul_w8a16: the kernel runs on CUDA tensors, "
                         f"got {dev}")
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError("matmul_w8a16: x must be (M, K) and w_q (K, N)")
    M, K = x.shape
    N = w_q.shape[1]
    if (w_q.shape[0] != K or scale.numel() != N
            or (bias is not None and bias.numel() != N)):
        raise ValueError(
            f"matmul_w8a16: shapes x{tuple(x.shape)} w_q{tuple(w_q.shape)} "
            f"scale{tuple(scale.shape)} bias"
            f"{None if bias is None else tuple(bias.shape)} do not agree")
    if x.dtype != BF16 or w_q.dtype != torch.int8:
        raise ValueError(f"matmul_w8a16: x must be bf16 and w_q int8, got "
                         f"{x.dtype}, {w_q.dtype}")
    if act not in ACTS:
        raise ValueError(f"matmul_w8a16: act {act!r} not in {tuple(ACTS)}")
    if bm not in BMS or bn not in BNS or bk % BK_STEP or not (
            BK_STEP <= bk <= MAX_BK):
        raise ValueError(f"matmul_w8a16: tile bm={bm}, bn={bn}, bk={bk}: bm "
                         f"in {BMS}, bn in {BNS}, bk a multiple of {BK_STEP} "
                         f"up to {MAX_BK} (see kernel_tiles)")
    ops = [scale] if bias is None else [scale, bias]
    if any(t.device != dev for t in [w_q] + ops):
        raise ValueError(f"matmul_w8a16: all operands must be on {dev}")
    x, w_q = x.contiguous(), w_q.contiguous()
    scale = scale.reshape(N).to(F32).contiguous()
    if bias is not None:
        bias = bias.reshape(N).to(F32).contiguous()
    out = torch.empty((M, N), dtype=BF16, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.matmul_w8a16_forward(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            M, N, K, bm, bn, bk, ACTS[act], stream)
    if err != 0:
        raise RuntimeError(
            f"matmul_w8a16 launch failed: error {err} "
            f"({'bad arguments' if err < 0 else 'cudaError'})")
    LAUNCHES["matmul_w8a16"] += 1
    return out


def matmul_w8a16(x, w_q, scale, bias: Optional[torch.Tensor] = None, *,
                 act: str = "none", bm: int = 16, bn: int = 32,
                 bk: int = 128) -> torch.Tensor:
    """x (M, K) bf16; w_q (K, N) int8; scale (N,) f32; bias (N,) f32 or
    None.  Returns act(x @ (w_q * scale) + bias) as (M, N) bf16.
    ``bm``/``bn``/``bk`` are the CTA's tile (:func:`kernel_tiles` makes
    any triple legal)."""
    if x.device.type == "cpu":
        return ref.matmul_w8a16_plain(x, w_q, scale.reshape(-1), bias,
                                      act=act)
    return _launch(x, w_q, scale, bias, act, int(bm), int(bn), int(bk))


__all__ = ["BMS", "BNS", "BK_STEP", "MAX_BK", "ACTS", "LAUNCHES", "stages",
           "smem_bytes", "kernel_tiles", "matmul_w8a16"]
