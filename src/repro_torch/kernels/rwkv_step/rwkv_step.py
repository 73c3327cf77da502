"""Fused RWKV6 serving step for Hopper (port of
``repro.kernels.rwkv_step.rwkv_step``).

The CUDA source is ``repro_torch/csrc/rwkv_step.cu``; its head note says
what it replaces, what bounds it and how it is laid out.  This module
checks the operands, allocates the outputs and launches it through a
plain C interface (``ctypes``), on PyTorch's current stream.

On a CPU tensor :func:`rwkv6_step` runs the plain PyTorch version
(:mod:`.ref`); on a CUDA tensor it launches the kernel or raises.

Geometry: a CTA owns ``bh`` heads of one batch row, so the grid is
(H/bh, B); it keeps each head's K x V state in registers, one column per
thread, for all T tokens.  The outputs are new tensors: the state input
is left as it was.

Operand types are the decode path's: r, k, v bf16 (outputs of ``dot``),
w_log, u and the state f32.  K and V may each be 16 (reduced configs) or
64 (rwkv6-1.6b).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels.rwkv_step import ref

F32 = torch.float32
BF16 = torch.bfloat16
MAX_THREADS = 256          # threads per CTA at most (csrc: kMaxThreads)
DIMS = (16, 64)            # K and V the kernel is instantiated for

# Kernel launches: one per call on CUDA tensors (T tokens run inside).
LAUNCHES: Dict[str, int] = {"rwkv6_step": 0}


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("rwkv_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_step_forward.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.rwkv6_step_forward.restype = i
    return lib


def _launch(r, k, v, w_log, u, state, bh: int):
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
    bh = int(bh) or 1
    if bh < 1 or H % bh:
        raise ValueError(f"rwkv6_step: bh={bh} heads per CTA must divide "
                         f"H={H}")
    r, k, v, w_log, u, state = (t.contiguous() for t in
                                (r, k, v, w_log, u, state))
    y = torch.empty((T, B, H, V), dtype=BF16, device=dev)
    s_out = torch.empty((B, H, K, V), dtype=F32, device=dev)
    if T == 0:
        return y, s_out.copy_(state)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rwkv6_step_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), state.data_ptr(), s_out.data_ptr(), y.data_ptr(),
            T, B, H, K, V, bh, stream)
    if err != 0:
        raise RuntimeError(
            f"rwkv6_step launch failed: error {err} "
            f"({'bad arguments' if err < 0 else 'cudaError'})")
    LAUNCHES["rwkv6_step"] += 1
    return y, s_out


def rwkv6_step(r, k, v, w_log, u, state, *, bh: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serve T tokens through the fused recurrence.

    r/k/w_log: (T, B, H, K); v: (T, B, H, V); u: (H, K);
    state: (B, H, K, V) f32.  Returns (y (T, B, H, V) bf16, state' f32).

    ``bh`` is the number of heads one CTA owns (a divisor of H); 0 means
    one head per CTA, which puts B*H CTAs on the card.  Heads are
    independent, so every ``bh`` gives the same bits."""
    if r.device.type == "cpu":
        return ref.rwkv6_step_ref(r, k, v, w_log, u, state)
    return _launch(r, k, v, w_log, u, state, bh)
