"""Split-KV flash decoding for Hopper (port of
``repro.kernels.flash_attention.flash_decode``).

The CUDA source is ``repro_torch/csrc/flash_attention.cu``; its head note
says what it replaces, what bounds it and how it is laid out.  One call
launches two kernels on PyTorch's current stream: the per-chunk partials
(m, l, acc) and their log-sum-exp combine (the JAX package keeps the
combine outside its Pallas kernel; here it is the second kernel of the
same source).  ``LAUNCHES`` counts calls.

On a CPU tensor :func:`flash_decode` runs the plain PyTorch version
(:func:`.ref.flash_decode_plain`); on a CUDA tensor it launches the
kernels or raises.  There is one partial kernel and no other path.

Geometry: a CTA owns one chunk of ``bk`` cache slots (1 to ``MAX_BK``)
of one KV head of one batch row and serves all ``H // Hkv`` query heads
of that KV head (at most ``MAX_GROUP``).  It reads the chunk's ``kv_pos``
first and loads and computes only the ``TILE``-slot tiles that hold a
slot the query sees; a chunk with none reads no K or V (its partial is
m = -1e30, l = 0, which the combine weighs by exactly 0), unless the row
sees no key at all, whose answer is the mean of V over every slot.  The
tiles come through a ``STAGES``-slot ring of 16-byte asynchronous copies,
K tiles then V tiles.  The last chunk may be shorter: ``bk`` need not
divide the cache length.  :func:`decode_bk` makes any plan's ``bk``
legal (the model adapter calls it).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import launches
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    BF16, DIMS, _aligned)

F32 = torch.float32
MAX_GROUP = 16      # query heads per KV head (csrc: kMaxGroup)
MAX_BK = 1024       # cache slots a chunk, at most (csrc: kMaxDecodeBK)
TILE = 64           # slots a staged tile (csrc: kDecTile)
STAGES = 4          # ring slots of staged tiles (csrc: kDecStages)

# Kernel launches: one per call on CUDA tensors (partials + combine).
LAUNCHES: Dict[str, int] = launches.register(
    {"flash_decode": 0}, {"flash_decode": ("flash_decode_partial_kernel",)})


def decode_bk(bk: int, S: int) -> int:
    """The chunk the kernel runs for a requested ``bk`` over ``S`` slots:
    ``bk`` clamped to [1, min(S, MAX_BK)].  Idempotent."""
    return max(1, min(int(bk), S, MAX_BK))


def smem_bytes(bk: int, head_dim: int, group: int) -> int:
    """Dynamic shared memory of one CTA (csrc: ``dec_smem_bytes``): the
    ring of staged tiles (rows padded by 16 bytes), the chunk's f32
    scores for ``group`` heads, p in bf16 for the heads rounded up to 8,
    the chunk's positions and tile lists, and the 4 warps' maxima and
    sums of each head."""
    L = -(-bk // TILE) * TILE
    nt8 = -(-group // 8) * 8
    return (STAGES * TILE * (head_dim + 8) * 2 + group * (L + 4) * 4
            + nt8 * (L + 8) * 2 + (L + 2 * (L // TILE) + 1) * 4
            + 2 * 4 * MAX_GROUP * 4)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_forward.argtypes = [p] * 10 + [i] * 8 + [f, f, p]
    lib.flash_decode_forward.restype = i
    return lib


def _launch(q, k, v, kv_pos, q_pos, causal, window, softcap, bk):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode: the kernel runs on CUDA tensors, "
                         f"got {dev}")
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_decode: q must be (B, H, d), k and v "
                         "(B, Hkv, S, d)")
    B, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if (tuple(v.shape) != tuple(k.shape) or k.shape[0] != B
            or k.shape[3] != d or H % Hkv or tuple(kv_pos.shape) != (B, S)
            or tuple(q_pos.shape) != (B,)):
        raise ValueError(
            f"flash_decode: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} kv_pos{tuple(kv_pos.shape)} "
            f"q_pos{tuple(q_pos.shape)} do not agree")
    if d not in DIMS:
        raise ValueError(f"flash_decode: head dim {d}; the kernel is built "
                         f"for {DIMS}")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"flash_decode: {H // Hkv} query heads per KV "
                         f"head; the kernel takes at most {MAX_GROUP}")
    if any(t.dtype != BF16 for t in (q, k, v)):
        raise ValueError(f"flash_decode: q, k, v must be bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != dev for t in (k, v, kv_pos, q_pos)):
        raise ValueError(f"flash_decode: all operands must be on {dev}")
    if not 1 <= bk <= MAX_BK:
        raise ValueError(f"flash_decode: chunk bk={bk}; the kernel takes 1 "
                         f"to {MAX_BK} slots (decode_bk makes a plan's "
                         f"legal)")
    k, v = (t if _aligned(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (k, v))
    if (q.stride(-1) != 1 or q.stride(0) % 2 or q.stride(1) % 2
            or q.data_ptr() % 4):           # q is read as bf16 pairs
        q = q.clone(memory_format=torch.contiguous_format)
    kv_pos = kv_pos.to(torch.int32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    nk = -(-S // bk)
    # the partials in one allocation: m, l (B, H, nk), acc (B, H, nk, d)
    ws = torch.empty(B * H * nk * (d + 2), dtype=F32, device=dev)
    m, l, acc = ws[:B * H * nk], ws[B * H * nk:2 * B * H * nk], ws[
        2 * B * H * nk:]
    out = torch.empty((B, H, d), dtype=F32, device=dev)
    strides = [q.stride(0), q.stride(1)] + [
        s for t in (k, v) for s in (t.stride(0), t.stride(2), t.stride(1))]
    arr = (ctypes.c_longlong * 8)(*strides)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_decode_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
            q_pos.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            out.data_ptr(), ctypes.addressof(arr), B, H, Hkv, S, d, bk,
            int(causal), int(window), float(softcap), 1.0 / math.sqrt(d),
            stream)
    if err != 0:
        raise RuntimeError(
            f"flash_decode launch failed: error {err} "
            f"({'bad arguments' if err < 0 else 'cudaError'})")
    LAUNCHES["flash_decode"] += 1
    return out


def flash_decode(q, k, v, kv_pos, q_pos, *, causal: bool = True,
                 window: int = 0, softcap: float = 0.0, bk: int = 128):
    """q (B, H, d); k, v (B, Hkv, S, d) with H % Hkv == 0; kv_pos (B, S)
    absolute positions (-1 = empty slot); q_pos (B,).  Returns (B, H, d)
    f32: the chunk partials combined."""
    if q.device.type == "cpu":
        return ref.flash_decode_plain(q, k, v, kv_pos, q_pos, causal=causal,
                                      window=window, softcap=softcap, bk=bk)
    return _launch(q, k, v, kv_pos, q_pos, causal, window, softcap, int(bk))


__all__ = ["MAX_GROUP", "MAX_BK", "TILE", "STAGES", "LAUNCHES",
           "decode_bk", "smem_bytes", "flash_decode"]
