"""Fused LSTM/GRU serving kernels for Hopper (port of
``repro.kernels.fused_rnn.fused_rnn``).

The CUDA source is ``repro_torch/csrc/fused_rnn.cu``; its head note says
what it replaces, what bounds it and how it is laid out.  This module
checks the operands, allocates the outputs and launches it through a
plain C interface (``ctypes``), on PyTorch's current stream.

On a CPU tensor the wrappers run the plain PyTorch version
(:mod:`.ref`); on a CUDA tensor they launch the kernel or raise.

Geometry: a CTA of ``THREADS`` threads owns ``bh`` units across all G
gates, so the grid is H/bh CTAs.  Streaming mode (``persistent=False``)
launches one kernel per time step; persistent mode launches one
cooperative kernel for all T with each CTA's weight slice in shared
memory, and raises if the H/bh CTAs cannot be co-resident.

Weight layout: w_x (D, G, H), w_h (H, G, H) int8 or bf16; gate order
(i, j, f, o) for LSTM, (r, z, n) for GRU; scales (G, H) f32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch import hw
from repro_torch.kernels.fused_rnn import ref

F32 = torch.float32
THREADS = 256   # threads per CTA (csrc: kThreads)
VEC = 4         # units per thread slot (csrc: kVec)
BCH = 4         # batch rows per pass (csrc: kBch)

# Kernel launches by kernel: T per streaming call, 1 per persistent call.
LAUNCHES: Dict[str, int] = {"fused_lstm": 0, "fused_lstm_persistent": 0,
                            "fused_gru": 0, "fused_gru_persistent": 0}


def k_split(n_gates: int, bh: int) -> int:
    """Ways the D+H contraction rows are split across a CTA's threads."""
    return max(1, THREADS // (n_gates * bh // VEC))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(n_gates: int, D: int, H: int, bh: int, batch: int,
               wbytes: int, persistent: bool) -> int:
    """Dynamic shared memory of one CTA (csrc: ``layout``): the weight
    slice when persistent, x_t|h_{t-1} staged in bf16, and the f32
    partial sums of the x and h products."""
    R = D + H
    bch = min(batch, BCH)
    w = _align16(R * n_gates * bh * wbytes) if persistent else 0
    red = k_split(n_gates, bh) * bch * n_gates * bh * 4
    return w + _align16(bch * R * 2) + 2 * red


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("fused_rnn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_rnn_forward.argtypes = [i, i] + [p] * 10 + [i] * 7 + [
        ctypes.c_longlong, p]
    lib.fused_rnn_forward.restype = i
    lib.fused_rnn_max_blocks_per_sm.argtypes = [
        i, i, ctypes.c_longlong, ctypes.POINTER(i)]
    lib.fused_rnn_max_blocks_per_sm.restype = i
    return lib


def _check_cuda(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: error {err} "
                           f"({'bad arguments' if err < 0 else 'cudaError'})")


def max_coresident_ctas(n_gates: int, smem: int, device) -> int:
    """CTAs of the persistent kernel the card can hold at once."""
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check_cuda(lib.fused_rnn_max_blocks_per_sm(n_gates, 1, smem,
                                                    ctypes.byref(n)),
                    "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return n.value * sms


def _launch(name: str, G: int, x_seq, w_x, w_h, s_x, s_h, b, b_h, h0, c0,
            bh: int, persistent: bool):
    dev = x_seq.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got {dev}")
    T, B, D = x_seq.shape
    H = w_h.shape[0]
    bh = min(int(bh), H)
    if H % bh or bh % VEC or H % VEC:
        raise ValueError(f"{name}: needs bh | H and 4 | bh, 4 | H "
                         f"(H={H}, bh={bh})")
    if tuple(w_x.shape) != (D, G, H) or tuple(w_h.shape) != (H, G, H):
        raise ValueError(f"{name}: weights {tuple(w_x.shape)}, "
                         f"{tuple(w_h.shape)} do not match D={D}, G={G}, H={H}")
    if w_x.dtype != w_h.dtype or w_x.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"{name}: weights must both be int8 or bf16, got "
                         f"{w_x.dtype}, {w_h.dtype}")
    vecs = [s_x, s_h, b] + ([b_h] if b_h is not None else [])
    if any(tuple(v.shape) != (G, H) for v in vecs):
        raise ValueError(f"{name}: scales and biases must be ({G}, {H})")
    state = [h0] + ([c0] if c0 is not None else [])
    if any(tuple(v.shape) != (B, H) for v in state):
        raise ValueError(f"{name}: state must be ({B}, {H})")
    tensors = [x_seq, w_x, w_h, *vecs, *state]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all operands must be on {dev}")

    x = x_seq.to(torch.bfloat16).contiguous()
    wx, wh = w_x.contiguous(), w_h.contiguous()
    sx, sh, bb = (v.to(F32).contiguous() for v in (s_x, s_h, b))
    bhb = b_h.to(F32).contiguous() if b_h is not None else None
    hbuf = torch.empty((2, B, H), dtype=F32, device=dev)
    hbuf[0].copy_(h0)
    c = c0.to(F32).clone() if c0 is not None else None
    y = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    if T == 0:
        return y, hbuf[0], c
    wbytes = wx.element_size()
    smem = smem_bytes(G, D, H, bh, B, wbytes, persistent)
    optin = hw.smem_budget(hw.from_device(dev))
    if smem > optin:
        raise ValueError(f"{name}: bh={bh} needs {smem} B of shared memory "
                         f"per CTA, the card allows {optin}")
    if persistent:
        cap = max_coresident_ctas(G, smem, dev)
        if H // bh > cap:
            raise ValueError(
                f"{name}: persistent grid of {H // bh} CTAs ({smem} B shared "
                f"memory each) cannot be co-resident; the card holds {cap}")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_rnn_forward(
            G, int(persistent), x.data_ptr(), wx.data_ptr(), wh.data_ptr(),
            sx.data_ptr(), sh.data_ptr(), bb.data_ptr(),
            bhb.data_ptr() if bhb is not None else None, hbuf.data_ptr(),
            c.data_ptr() if c is not None else None, y.data_ptr(),
            T, B, D, H, bh, k_split(G, bh), int(wbytes == 2), smem, stream)
    _check_cuda(err, f"{name} launch")
    if persistent:
        LAUNCHES[name + "_persistent"] += 1
    else:
        LAUNCHES[name] += T
    return y, hbuf[T % 2], c


def fused_lstm(x_seq, w_x, w_h, s_x, s_h, b, h0, c0, *,
               bh: int = 256, persistent: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_seq (T, B, D); w_x (D, 4, H) int8/bf16; s_* (4, H) f32; b (4, H);
    h0/c0 (B, H).  Returns (y (T, B, H) bf16, h_T (B, H) f32, c_T).

    ``bh`` is the number of units one CTA owns (the grid is H/bh CTAs);
    ``persistent=True`` keeps each CTA's weight slice in shared memory
    for all T steps (one cooperative launch)."""
    if x_seq.device.type == "cpu":
        return ref.fused_lstm_ref(x_seq, w_x, w_h, s_x, s_h, b, h0, c0)
    return _launch("fused_lstm", 4, x_seq, w_x, w_h, s_x, s_h, b, None,
                   h0, c0, bh, persistent)


def fused_gru(x_seq, w_x, w_h, s_x, s_h, b_x, b_h, h0, *,
              bh: int = 256, persistent: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_seq (T, B, D); w_x (D, 3, H); s_* (3, H); b_* (3, H); h0 (B, H).
    Returns (y (T, B, H) bf16, h_T (B, H) f32).  See ``fused_lstm`` for
    the ``bh``/``persistent`` contract."""
    if x_seq.device.type == "cpu":
        return ref.fused_gru_ref(x_seq, w_x, w_h, s_x, s_h, b_x, b_h, h0)
    y, hT, _ = _launch("fused_gru", 3, x_seq, w_x, w_h, s_x, s_h, b_x, b_h,
                       h0, None, bh, persistent)
    return y, hT
