"""Plain PyTorch versions of the fused RNN kernels (port of
``repro.kernels.fused_rnn.ref``).

Same numerics as the kernels: x and h rounded to bf16 before the
product, int8 (or bf16) weights widened exactly to f32, f32
accumulation, the per-(gate, unit) scale applied after the sum, y in
bf16 and h_T/c_T in f32.  Products of bf16 by int8/bf16 values are exact
in f32, so the f32 matmul here differs from the kernel only in the order
of the f32 sum.  On a GPU the caller must keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, the default).
"""

from __future__ import annotations

import torch

F32 = torch.float32


def _z(x, h, w_x, w_h, s_x, s_h):
    """Pre-activations (B, G, H) with bf16 operands / f32 accumulation."""
    D, G, H = w_x.shape
    xb = x.to(torch.bfloat16).to(F32)
    hb = h.to(torch.bfloat16).to(F32)
    zx = (xb @ w_x.to(F32).reshape(D, G * H)).reshape(-1, G, H)
    zh = (hb @ w_h.to(F32).reshape(w_h.shape[0], G * H)).reshape(-1, G, H)
    if s_x is not None:
        zx = zx * s_x[None]
    if s_h is not None:
        zh = zh * s_h[None]
    return zx, zh


def fused_lstm_ref(x_seq, w_x, w_h, s_x, s_h, b, h0, c0):
    """x_seq (T, B, D) -> (y (T, B, H) bf16, h_T f32, c_T f32)."""
    wxf = w_x.to(torch.bfloat16) if s_x is None else w_x
    whf = w_h.to(torch.bfloat16) if s_h is None else w_h
    h, c = h0.to(F32), c0.to(F32)
    ys = []
    for x in x_seq:
        zx, zh = _z(x, h, wxf, whf, s_x, s_h)
        z = zx + zh + b[None]
        i = torch.sigmoid(z[:, 0])
        j = torch.tanh(z[:, 1])
        f = torch.sigmoid(z[:, 2])
        o = torch.sigmoid(z[:, 3])
        c = f * c + i * j
        h = o * torch.tanh(c)
        ys.append(h.to(torch.bfloat16))
    return torch.stack(ys), h, c


def fused_gru_ref(x_seq, w_x, w_h, s_x, s_h, b_x, b_h, h0):
    """x_seq (T, B, D) -> (y (T, B, H) bf16, h_T f32)."""
    h = h0.to(F32)
    ys = []
    for x in x_seq:
        zx, zh = _z(x, h, w_x, w_h, s_x, s_h)
        zx = zx + b_x[None]
        zh = zh + b_h[None]
        r = torch.sigmoid(zx[:, 0] + zh[:, 0])
        z = torch.sigmoid(zx[:, 1] + zh[:, 1])
        n = torch.tanh(zx[:, 2] + r * zh[:, 2])
        h = (1 - z) * n + z * h
        ys.append(h.to(torch.bfloat16))
    return torch.stack(ys), h
