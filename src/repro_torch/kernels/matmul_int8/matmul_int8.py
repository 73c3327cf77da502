"""W8A16 matmul for Hopper (port of
``repro.kernels.matmul_int8.matmul_int8``).

The CUDA source is ``repro_torch/csrc/matmul_int8.cu``; its head note
says what it replaces, what bounds it and how it is laid out.  This
module checks the operands, allocates the output and launches the kernel
through a plain C interface (``ctypes``), on PyTorch's current stream.

On a CPU tensor :func:`matmul_w8a16` runs the plain PyTorch version
(:func:`.ref.matmul_w8a16_plain`); on a CUDA tensor it launches the
kernel or raises.

Geometry.  For M <= :data:`DECODE_M` (decode) the call runs the split-K
kernel: a grid of ceil(N / :data:`DECODE_BN`) x S CTAs, CTA (n, s) owning
128 output columns and the K rows of split s (:func:`decode_geometry`,
:func:`split_ranges`), then, for S > 1, a reduction kernel over an
(S, M, N) f32 workspace this module allocates.  Above, the prefill
kernel: a CTA owns a ``bm`` x ``bn`` output tile (``bm`` in :data:`BMS`
token rows, ``bn`` in :data:`BNS` columns) and walks K in steps of
:data:`BK`; a loader warp keeps a ring of x and int8 w steps full (TMA),
and two math warpgroups widen their own weight fragments into registers
and run ``wgmma`` (:data:`PREFILL_THREADS`, :func:`smem_bytes`).  Ragged
edges are bounds-checked: no length has to divide by a tile.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import hw
from repro_torch.kernels import launches
from repro_torch.kernels.matmul_int8 import ref

BF16 = torch.bfloat16
F32 = torch.float32
BMS = (64, 128, 256)       # prefill: token rows per CTA (wgmma n)
BNS = (128,)               # prefill: output columns per CTA (2 x wgmma m 64)
BK = 64                    # prefill: K per step, one 128-byte swizzle row of bf16
PREFILL_STAGES = 5         # csrc kPreStages: ring of (x, int8 w) steps
PREFILL_THREADS = 288      # csrc kPreThreads: 2 math warpgroups + a loader warp
ACTS = {"none": 0, "silu": 1, "gelu": 2, "relu": 3}
DECODE_M = 16              # M up to this runs the split-K decode kernel
DECODE_BN = 128            # csrc kDecBN: output columns (row bytes) a CTA
DECODE_KSTEP = 64          # csrc kDecKStep: weight rows a pipeline step (8 KB)
DECODE_STAGES = 4          # csrc kDecStages: ring depth, 3 steps in flight
CTAS_PER_SM = 2            # the default split gives >= this many CTAs an SM

# Kernel launches: "matmul_w8a16" one per call on CUDA tensors, whatever
# number of kernels the call runs (the decode path's reduction included);
# "matmul_w8a16_prefill" one per launch of the prefill kernel (M > 16).
LAUNCHES: Dict[str, int] = launches.register(
    {"matmul_w8a16": 0, "matmul_w8a16_prefill": 0},
    {"matmul_w8a16": ("matmul_w8a16_decode_kernel",
                      "matmul_w8a16_prefill_kernel"),
     "matmul_w8a16_prefill": ("matmul_w8a16_prefill_kernel",)})


def smem_bytes(bm: int, bn: int, bk: int = BK) -> int:
    """Dynamic shared memory of one prefill CTA (csrc: ``Pre::kSmem``): the
    ring of x (bm x bk bf16) and int8 w (bk x bn) steps and 1 KB to align
    the base; 205,824 bytes at 256 x 128 x 64."""
    return PREFILL_STAGES * (bm * bk * 2 + bk * bn) + 1024


def kernel_tiles(bm: int, bn: int, bk: int, M: int, N: int, K: int):
    """(bm, bn, bk) the prefill kernel can run, clamped to the shape: the
    largest of :data:`BMS` / :data:`BNS` not above the request, then
    halved while half still covers M / N; bk is always :data:`BK` (the
    kernel's step, whatever K: a ragged last step is zero-filled)."""
    def pick(want, sizes, n):
        t = max([s for s in sizes if s <= want] or [sizes[0]])
        while t > sizes[0] and t // 2 >= n:
            t //= 2
        return t
    return pick(int(bm), BMS, M), pick(int(bn), BNS, N), BK


def decode_bm(M: int) -> int:
    """Rows of M the decode kernel pads to: one n8 mma tile for M <= 8,
    two above (csrc: the MT template parameter)."""
    return 8 if M <= 8 else 16


def decode_smem_bytes(M: int) -> int:
    """Dynamic shared memory of one decode CTA (csrc: ``dec_smem_bytes``):
    the ring of 64 x 128 int8 weight blocks and of x's 64 columns of
    ``decode_bm(M)`` rows, dense, and 1 KB to align the ring."""
    return DECODE_STAGES * (DECODE_KSTEP * DECODE_BN
                            + decode_bm(M) * DECODE_KSTEP * 2) + 1024


def k_steps(K: int) -> int:
    """Pipeline steps of :data:`DECODE_KSTEP` rows that cover K."""
    return -(-int(K) // DECODE_KSTEP)


def default_splits(N: int, K: int, sms: int = hw.DEFAULT.sms) -> int:
    """The fewest splits that give the grid :data:`CTAS_PER_SM` CTAs an SM
    (so one CTA streams while another fills its ring or sums), at most one
    a K step."""
    strips = -(-int(N) // DECODE_BN)
    want = -(-CTAS_PER_SM * int(sms) // strips)
    return max(1, min(k_steps(K), want))


def split_ranges(K: int, splits: int) -> Tuple[Tuple[int, int], ...]:
    """The K rows [k0, k1) of each split, in order (csrc: ``split_step``):
    split s starts at step floor(s * steps / S), so the ranges are aligned
    to :data:`DECODE_KSTEP`, cover K once, and none is empty while
    S <= the number of steps."""
    n = k_steps(K)
    edge = [s * n // splits * DECODE_KSTEP for s in range(splits + 1)]
    return tuple((edge[s], min(int(K), edge[s + 1])) for s in range(splits))


@dataclasses.dataclass(frozen=True)
class DecodeGeometry:
    """The decode kernel's grid at one shape: ``bm`` rows of M (padded),
    ``bn`` columns and ``kstep`` rows a step, ``splits`` K ranges
    (``ranges``), ``strips`` x ``splits`` CTAs."""

    bm: int
    bn: int
    kstep: int
    splits: int
    strips: int
    ranges: Tuple[Tuple[int, int], ...]

    @property
    def ctas(self) -> int:
        return self.strips * self.splits

    @property
    def steps_per_cta(self) -> int:
        """K steps of the longest split."""
        return max(-(-(k1 - k0) // self.kstep) for k0, k1 in self.ranges)


@functools.lru_cache(maxsize=4096)
def decode_geometry(M: int, N: int, K: int, splits: Optional[int] = None,
                    sms: int = hw.DEFAULT.sms) -> DecodeGeometry:
    """The decode kernel's geometry at (M, N, K): ``splits`` if given (it
    must lie in [1, K steps]), else :func:`default_splits`.  Raises for an
    M the decode kernel does not take or a split count it refuses.
    Cached: a model calls it with the same few shapes every tick."""
    M, N, K = int(M), int(N), int(K)
    if not (1 <= M <= DECODE_M and N >= 1 and K >= 1):
        raise ValueError(f"matmul_w8a16 decode: M={M} N={N} K={K}: the "
                         f"decode kernel takes 1 <= M <= {DECODE_M}")
    S = default_splits(N, K, sms) if splits is None else int(splits)
    if not 1 <= S <= k_steps(K):
        raise ValueError(f"matmul_w8a16 decode: splits={S} not in [1, "
                         f"{k_steps(K)}] (K={K} in steps of {DECODE_KSTEP})")
    return DecodeGeometry(decode_bm(M), DECODE_BN, DECODE_KSTEP, S,
                          -(-N // DECODE_BN), split_ranges(K, S))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return hw.from_device(index).sms


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("matmul_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.matmul_w8a16_forward.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.matmul_w8a16_forward.restype = i
    lib.matmul_w8a16_decode.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.matmul_w8a16_decode.restype = i
    return lib


def _f32_vector(t: torch.Tensor, N: int) -> torch.Tensor:
    if t.dtype == F32 and t.is_contiguous():
        return t
    return t.reshape(N).to(F32).contiguous()


def _launch(x, w_q, scale, bias, act, bm, bn, bk, splits):
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
    if bm not in BMS or bn not in BNS or bk != BK:
        raise ValueError(f"matmul_w8a16: tile bm={bm}, bn={bn}, bk={bk}: bm "
                         f"in {BMS}, bn in {BNS}, bk {BK} (see kernel_tiles)")
    ops = [scale] if bias is None else [scale, bias]
    if any(t.device != dev for t in [w_q] + ops):
        raise ValueError(f"matmul_w8a16: all operands must be on {dev}")
    geo = None
    if M <= DECODE_M:
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        geo = decode_geometry(M, N, K, splits, _sms(index))
    x, w_q = x.contiguous(), w_q.contiguous()
    scale = _f32_vector(scale, N)
    if bias is not None:
        bias = _f32_vector(bias, N)
    out = torch.empty((M, N), dtype=BF16, device=dev)
    lib = _lib()
    b_ptr = None if bias is None else bias.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if geo is None:
            err = lib.matmul_w8a16_forward(
                x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), b_ptr,
                out.data_ptr(), M, N, K, bm, bn, bk, ACTS[act], stream)
        else:
            part = (torch.empty((geo.splits, M, N), dtype=F32, device=dev)
                    if geo.splits > 1 else None)
            err = lib.matmul_w8a16_decode(
                x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), b_ptr,
                out.data_ptr(), None if part is None else part.data_ptr(),
                M, N, K, geo.splits, ACTS[act], stream)
    if err != 0:
        raise RuntimeError(
            f"matmul_w8a16 launch failed: error {err} "
            f"({'bad arguments' if err < 0 else 'cudaError'})")
    LAUNCHES["matmul_w8a16"] += 1
    if geo is None:
        LAUNCHES["matmul_w8a16_prefill"] += 1
    return out


def matmul_w8a16(x, w_q, scale, bias: Optional[torch.Tensor] = None, *,
                 act: str = "none", bm: int = 256, bn: int = 128,
                 bk: int = BK, splits: Optional[int] = None) -> torch.Tensor:
    """x (M, K) bf16; w_q (K, N) int8; scale (N,) f32; bias (N,) f32 or
    None.  Returns act(x @ (w_q * scale) + bias) as (M, N) bf16.
    ``bm``/``bn``/``bk`` are the CTA's tile for M > :data:`DECODE_M`
    (:func:`kernel_tiles` makes any triple legal); ``splits`` the decode
    kernel's K splits for M <= :data:`DECODE_M` (None: the default, see
    :func:`decode_geometry`)."""
    if x.device.type == "cpu":
        return ref.matmul_w8a16_plain(x, w_q, scale.reshape(-1), bias,
                                      act=act)
    return _launch(x, w_q, scale, bias, act, int(bm), int(bn), int(bk),
                   None if splits is None else int(splits))


__all__ = ["BMS", "BNS", "BK", "PREFILL_STAGES", "PREFILL_THREADS", "ACTS",
           "LAUNCHES", "DECODE_M", "DECODE_BN", "DECODE_KSTEP",
           "DECODE_STAGES", "CTAS_PER_SM", "DecodeGeometry", "smem_bytes", "kernel_tiles", "decode_bm",
           "decode_smem_bytes", "k_steps", "default_splits", "split_ranges", "decode_geometry",
           "matmul_w8a16"]
