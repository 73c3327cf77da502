"""Fused RWKV6 serving step for Hopper (port of
``repro.kernels.rwkv_step.rwkv_step``).

The CUDA source is ``repro_torch/csrc/rwkv_step.cu``; its head note says
what it replaces, what bounds it and how it is laid out.  This module
checks the operands, allocates the outputs and launches it through a
plain C interface (``ctypes``), on PyTorch's current stream.

On a CPU tensor :func:`rwkv6_step` runs the plain PyTorch version
(:mod:`.ref`); on a CUDA tensor it launches the kernel or raises.

Geometry (:func:`geometry`): a CTA owns ``bh`` heads x a slab of ``bv``
state columns of one batch row, so the grid is (H/bh * V/bv, B); a
thread keeps :data:`ROWS` rows x :data:`COLS` columns of one head's state
in registers for all T tokens.  y is a new tensor; the state goes to a
new tensor too (the input left as it was) or to the caller's ``out``,
which may be the input state itself: each thread reads its own state
elements before it writes them, and no thread reads another's, so the
in-place call gives the out-of-place call's bits (a card test holds it
so at every head tile and column slab).

Operand types are the decode path's: r, k, v bf16 (outputs of ``dot``),
w_log, u and the state f32.  K and V may each be 16 (reduced configs) or
64 (rwkv6-1.6b).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import hw
from repro_torch.kernels import launches
from repro_torch.kernels.rwkv_step import ref

F32 = torch.float32
BF16 = torch.bfloat16
MAX_THREADS = 256          # threads per CTA at most (csrc: kMaxThreads)
ROWS = 4                   # state rows a thread owns (csrc: kRows)
COLS = 4                   # state columns a thread owns (csrc: kCols)
SLAB_THREADS = 128         # threads a head's slab takes at most by default
DIMS = (16, 64)            # K and V the kernel is instantiated for

# Kernel launches: one per call on CUDA tensors (T tokens run inside).
LAUNCHES: Dict[str, int] = launches.register(
    {"rwkv6_step": 0}, {"rwkv6_step": ("rwkv6_step_kernel",)})


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The kernel's grid at one shape: a CTA owns ``bh`` heads x ``bv``
    columns of one batch row and works on ``hpc`` heads at a time, with
    ``threads`` threads (K/ROWS row groups x bv/COLS column groups x
    hpc); ``grid`` is (H/bh * V/bv, B)."""

    K: int
    V: int
    bh: int
    bv: int
    hpc: int
    threads: int
    grid: Tuple[int, int]

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def _legal_bv(V: int):
    return [bv for bv in range(COLS, V + 1, COLS) if V % bv == 0]


@functools.lru_cache(maxsize=256)
def geometry(B: int, H: int, K: int, V: int, bh: int,
             sms: int = hw.DEFAULT.sms, bv: int = 0) -> Geometry:
    """The grid for (B, H, K, V) at ``bh`` heads a CTA.  ``bv`` (a divisor
    of V, at least :data:`COLS`) if given, else the widest slab of at most
    :data:`SLAB_THREADS` threads a head whose grid puts a CTA on at least
    7/8 of the ``sms`` SMs, or the narrowest where none does.  Raises for
    a ``bh`` that does not divide H or a ``bv`` the kernel does not take.

    At rwkv6-1.6b's decode shape that is bv 16 at B=1 (128 CTAs on 132
    SMs) and bv 32 at B=4 (256 CTAs), the fastest slabs of a sweep on an
    H100 (``launch/rwkv_bench.py --bv``; PERF.md): one CTA a head (bv 64, 32 CTAs at B=1) left
    most SMs idle, and narrower slabs or 8-warp CTAs took longer."""
    B, H, K, V, bh, bv = (int(x) for x in (B, H, K, V, bh, bv))
    if bh < 1 or H % bh:
        raise ValueError(f"rwkv6_step: bh={bh} heads per CTA must divide "
                         f"H={H}")
    legal = _legal_bv(V)
    if not bv:
        fill = [c for c in legal if (K // ROWS) * (c // COLS) <= SLAB_THREADS
                and 8 * B * (H // bh) * (V // c) >= 7 * sms]
        bv = max(fill) if fill else legal[0]
    elif bv not in legal:
        raise ValueError(f"rwkv6_step: bv={bv} columns per CTA must be a "
                         f"divisor of V={V} and a multiple of {COLS}")
    per_head = (K // ROWS) * (bv // COLS)
    hpc = max(1, min(bh, MAX_THREADS // per_head))
    while bh % hpc:
        hpc -= 1
    return Geometry(K, V, bh, bv, hpc, per_head * hpc,
                    ((H // bh) * (V // bv), B))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return hw.from_device(index).sms


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("rwkv_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_step_forward.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.rwkv6_step_forward.restype = i
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_out(out, B, H, K, V, dev) -> None:
    if (tuple(out.shape) != (B, H, K, V) or out.dtype != F32
            or out.device != dev or not out.is_contiguous()
            or out.data_ptr() % 16):
        raise ValueError(
            f"rwkv6_step: out must be a contiguous, 16-byte aligned f32 "
            f"{(B, H, K, V)} tensor on {dev}, got {out.dtype} "
            f"{tuple(out.shape)} on {out.device}")


def _launch(r, k, v, w_log, u, state, bh: int, bv: int, out=None):
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_step: the kernel runs on CUDA tensors, "
                         f"got {dev}")
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError("rwkv6_step: r/k/w_log/v must be (T, B, H, K|V)")
    T, B, H, K = r.shape
    V = v.shape[-1]
    if (tuple(k.shape) != (T, B, H, K) or tuple(w_log.shape) != (T, B, H, K)
            or tuple(v.shape) != (T, B, H, V) or tuple(u.shape) != (H, K)
            or tuple(state.shape) != (B, H, K, V)):
        raise ValueError(
            f"rwkv6_step: shapes r{tuple(r.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} w{tuple(w_log.shape)} u{tuple(u.shape)} "
            f"state{tuple(state.shape)} do not agree")
    if K not in DIMS or V not in DIMS:
        raise ValueError(f"rwkv6_step: K={K}, V={V}; the kernel is built "
                         f"for {DIMS}")
    if any(t.dtype != BF16 for t in (r, k, v)):
        raise ValueError(f"rwkv6_step: r, k, v must be bf16, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != F32 for t in (w_log, u, state)):
        raise ValueError(f"rwkv6_step: w_log, u, state must be f32, got "
                         f"{w_log.dtype}, {u.dtype}, {state.dtype}")
    if any(t.device != dev for t in (k, v, w_log, u, state)):
        raise ValueError(f"rwkv6_step: all operands must be on {dev}")
    geo = geometry(B, H, K, V, int(bh) or 1, _sms(dev.index or 0), bv)
    if out is not None:
        _check_out(out, B, H, K, V, dev)
    r, k, v, w_log, u, state = (_aligned(t) for t in
                                (r, k, v, w_log, u, state))
    y = torch.empty((T, B, H, V), dtype=BF16, device=dev)
    s_out = torch.empty((B, H, K, V), dtype=F32, device=dev) \
        if out is None else out
    if T == 0:
        return y, s_out.copy_(state)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rwkv6_step_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), state.data_ptr(), s_out.data_ptr(), y.data_ptr(),
            T, B, H, K, V, geo.bh, geo.bv, geo.hpc, stream)
    if err != 0:
        raise RuntimeError(
            f"rwkv6_step launch failed: error {err} "
            f"({'bad arguments' if err < 0 else 'cudaError'})")
    LAUNCHES["rwkv6_step"] += 1
    return y, s_out


def rwkv6_step(r, k, v, w_log, u, state, *, bh: int = 0, bv: int = 0,
               out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serve T tokens through the fused recurrence.

    r/k/w_log: (T, B, H, K); v: (T, B, H, V); u: (H, K);
    state: (B, H, K, V) f32.  Returns (y (T, B, H, V) bf16, state' f32).

    ``bh`` is the number of heads one CTA owns (a divisor of H); 0 means
    one head per CTA.  ``bv`` is the number of state columns one CTA owns
    (a divisor of V, at least 4); 0 means :func:`geometry`'s choice.
    Heads and columns are independent and a column's sums run in an order
    fixed by K, so every ``bh`` and ``bv`` gives the same bits.  ``out``
    (B, H, K, V) f32, contiguous, may be given for the new state, and
    may be ``state`` itself (an in-place update); it is returned."""
    if r.device.type == "cpu":
        y, s = ref.rwkv6_step_ref(r, k, v, w_log, u, state)
        return y, (s if out is None else out.copy_(s))
    return _launch(r, k, v, w_log, u, state, bh, bv, out)
