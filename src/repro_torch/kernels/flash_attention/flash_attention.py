"""Flash attention forward for Hopper (port of
``repro.kernels.flash_attention.flash_attention``).

The CUDA source is ``repro_torch/csrc/flash_attention.cu``; its head note
says what it replaces, what bounds it and how it is laid out.  This
module checks the operands, allocates the output and launches the kernel
through a plain C interface (``ctypes``), on PyTorch's current stream.

On a CPU tensor :func:`flash_attention` runs the plain PyTorch version
(:func:`.ref.flash_attention_plain`); on a CUDA tensor it launches the
kernel or raises.

Geometry: a CTA owns ``bq`` query rows of one head of one batch row,
one ``wgmma`` warpgroup per 64 rows (``bq`` 64 or 128), and stages
``bk`` keys of K and V at a time by TMA (64 or 128); the online softmax
runs in steps of ``SUB`` keys whatever the tile is, so every ``bq`` and
``bk`` gives the same bits.  The plain version on the CPU steps by
``SUB`` keys too.  A ragged last tile is bounds-checked: no length has to
divide by a tile.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import launches
from repro_torch.kernels.flash_attention import ref

BF16 = torch.bfloat16
DIMS = (16, 32, 64, 128)   # head dims the kernels are built for
SUB = 64                   # keys per online-softmax step (csrc: kSub)
WG_ROWS = 64               # query rows of a math warpgroup (csrc: kWgRows)
MAX_BQ = 128               # query rows per CTA at most (two warpgroups)
MAX_BK = 128               # keys a stage at most (csrc: kMaxBK)
STAGES = 2                 # K/V ring slots (csrc: kStages)

# Kernel launches: one per call on CUDA tensors.
LAUNCHES: Dict[str, int] = launches.register(
    {"flash_attention": 0}, {"flash_attention": ("flash_fwd_kernel",)})


def smem_bytes(bq: int, bk: int, head_dim: int) -> int:
    """Dynamic shared memory of one CTA (csrc: ``fwd_smem_bytes``): the Q
    tile and ``STAGES`` slots of K and V in bf16, plus 1 KB to align the
    base for TMA's swizzle."""
    return 2 * head_dim * (bq + 2 * STAGES * bk) + 1024


def kernel_tiles(bq: int, bk: int, Sq: int, Skv: int):
    """(bq, bk) the kernel can run: bq a multiple of ``WG_ROWS`` up to
    ``MAX_BQ`` and no larger than Sq rounded up to it; bk a multiple of
    ``SUB`` up to ``MAX_BK`` and no larger than Skv rounded up to it."""
    up = lambda n, m: -(-n // m) * m
    bq = min(MAX_BQ, up(Sq, WG_ROWS),
             max(WG_ROWS, int(bq) // WG_ROWS * WG_ROWS))
    bk = min(MAX_BK, up(Skv, SUB), max(SUB, int(bk) // SUB * SUB))
    return bq, bk


def iota_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_forward.argtypes = (
        [p] * 8 + [i] * 10 + [f, f, p])
    lib.flash_attention_forward.restype = i
    return lib


def _aligned(t: torch.Tensor) -> bool:
    """TMA's rule: the feature dim contiguous, the other strides whole 16
    bytes (and not 0 where the dim has more than one entry), the base on
    a 16-byte boundary."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 and (s > 0 or n == 1)
                    for s, n in zip(t.stride()[:-1], t.shape[:-1])))


def _launch(q, k, v, q_pos, kv_pos, causal, window, softcap, bq, bk):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: the kernel runs on CUDA "
                         f"tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, d)")
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if (tuple(v.shape) != tuple(k.shape) or k.shape[0] != B
            or k.shape[3] != d or H % Hkv
            or tuple(q_pos.shape) != (B, Sq)
            or tuple(kv_pos.shape) != (B, Skv)):
        raise ValueError(
            f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} q_pos{tuple(q_pos.shape)} "
            f"kv_pos{tuple(kv_pos.shape)} do not agree")
    if d not in DIMS:
        raise ValueError(f"flash_attention: head dim {d}; the kernel is "
                         f"built for {DIMS}")
    if any(t.dtype != BF16 for t in (q, k, v)):
        raise ValueError(f"flash_attention: q, k, v must be bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != dev for t in (k, v, q_pos, kv_pos)):
        raise ValueError(f"flash_attention: all operands must be on {dev}")
    if bq not in (WG_ROWS, MAX_BQ) or bk not in (SUB, MAX_BK):
        raise ValueError(f"flash_attention: tile bq={bq}, bk={bk}: bq must "
                         f"be {WG_ROWS} or {MAX_BQ}, bk {SUB} or {MAX_BK} "
                         f"(see kernel_tiles)")
    q, k, v = (t if _aligned(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    # the output in the model's (B, Sq, H, d) memory order, returned as a
    # (B, H, Sq, d) view
    out = torch.empty((B, Sq, H, d), dtype=BF16, device=dev).transpose(1, 2)
    # the mean of V over the keys, for rows that see no key (csrc:
    # flash_vmean_kernel, launched first on the same stream)
    vmean = torch.empty((B, Hkv, d), dtype=torch.float32, device=dev)
    strides = [s for t in (q, k, v, out) for s in
               (t.stride(0), t.stride(2), t.stride(1))]
    arr = (ctypes.c_longlong * 12)(*strides)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), vmean.data_ptr(),
            ctypes.addressof(arr),
            B, H, Hkv, Sq, Skv, d, bq, bk, int(causal), int(window),
            float(softcap), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: error {err} "
            f"({'bad arguments' if err < 0 else 'cudaError'})")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, q_pos: Optional[torch.Tensor] = None,
                    kv_pos: Optional[torch.Tensor] = None, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, bq: int = WG_ROWS,
                    bk: int = SUB):
    """q (B, H, Sq, d); k, v (B, Hkv, Skv, d) with H % Hkv == 0 (query
    head h reads KV head h // (H // Hkv)).  Returns (B, H, Sq, d) in q's
    dtype (bf16 on the card).

    ``q_pos``/``kv_pos`` (B, S) int32 are absolute positions (-1 masks the
    slot); absent, they are the iota.  ``bq``/``bk`` are the CTA's query
    rows and staged keys (:func:`kernel_tiles` makes any pair legal)."""
    B, H, Sq, _ = q.shape
    Skv = k.shape[2]
    if q_pos is None:
        q_pos = iota_positions(B, Sq, q.device)
    if kv_pos is None:
        kv_pos = iota_positions(B, Skv, q.device)
    if q.device.type == "cpu":
        return ref.flash_attention_plain(q, k, v, q_pos, kv_pos,
                                         causal=causal, window=window,
                                         softcap=softcap, bk=SUB)
    return _launch(q, k, v, q_pos, kv_pos, causal, window, softcap,
                   int(bq), int(bk))


__all__ = ["DIMS", "SUB", "WG_ROWS", "MAX_BQ", "MAX_BK", "STAGES",
           "LAUNCHES", "smem_bytes",
           "kernel_tiles", "iota_positions", "flash_attention"]
